"""Ingest observability: rate + latency metrics.

The reference's only observability is a module logger (SURVEY.md §5 metrics
row: debug/info on commit, error on failure). We keep equivalent log points
(in commit/token.py) and add the counters BASELINE.md measures: records/sec
sustained and offset-commit latency percentiles.
"""

from __future__ import annotations

import threading
import time


class RateMeter:
    """Counts events; reports average rate over its lifetime and windows."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._count = 0
            self._t0 = time.perf_counter()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def rate(self) -> float:
        with self._lock:
            dt = time.perf_counter() - self._t0
            return self._count / dt if dt > 0 else 0.0


class LatencyHistogram:
    """Latency percentiles over a bounded window of recent samples.

    Bounded (ring buffer) because streams may run forever
    (idle_timeout_ms=None); recent-window percentiles are also what an
    operator actually wants from a long-lived pipeline.

    ``window_s`` (with an injectable ``clock``) adds a TIME-windowed view
    on top of the cumulative one: samples also land in a bounded ring of
    per-window delta buckets (bucket width ``window_s``, ``n_windows``
    retained), so ``windowed_summary(seconds)`` reports percentiles "over
    the last N seconds" — the signal a burn-rate monitor needs, which the
    cumulative window cannot provide (it never forgets). Window roll is
    clock-driven and bucket-granular: a horizon of S seconds covers the
    current (partial) bucket plus ``ceil(S / window_s) `` completed ones,
    exact under a ManualClock. None (default) keeps the class byte-for-
    byte on its original cumulative-only behavior and cost."""

    def __init__(self, window: int = 8192, *, window_s: float | None = None,
                 n_windows: int = 16, clock=None) -> None:
        from collections import deque

        self._lock = threading.Lock()
        self._samples: "deque[float]" = deque(maxlen=window)
        self._total = 0
        if window_s is not None and window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if n_windows < 1:
            raise ValueError(f"n_windows must be >= 1, got {n_windows}")
        self._window_s = window_s
        self._clock = clock or time.monotonic
        # (bucket_index, [samples]) newest last; bounded by n_windows.
        self._buckets: "deque[tuple[int, list[float]]]" = deque(
            maxlen=n_windows
        )

    def _bucket(self, now: float) -> list:
        """The current window's sample list (lock held)."""
        idx = int(now // self._window_s)
        if not self._buckets or self._buckets[-1][0] != idx:
            self._buckets.append((idx, []))
        return self._buckets[-1][1]

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self._total += 1
            if self._window_s is not None:
                self._bucket(self._clock()).append(seconds)

    def observe_many(self, seconds: float, n: int) -> None:
        """``n`` identical samples under one lock acquisition (the SLO
        inter-token path observes per token at host-sync granularity)."""
        with self._lock:
            self._samples.extend([seconds] * n)
            self._total += n
            if self._window_s is not None:
                self._bucket(self._clock()).extend([seconds] * n)

    def windowed_snapshot(self, seconds: float | None = None) -> list[float]:
        """Samples observed within the last ``seconds`` (default: one
        ``window_s``), at bucket granularity: the current partial bucket
        plus every completed bucket whose window intersects
        ``(now - seconds, now]``. Raises unless time-windowing is on."""
        if self._window_s is None:
            raise ValueError(
                "time-windowed view requires LatencyHistogram(window_s=...)"
            )
        horizon = self._window_s if seconds is None else float(seconds)
        with self._lock:
            now = self._clock()
            # A bucket [idx*w, (idx+1)*w) intersects (now-horizon, now]
            # iff its END is past the horizon start.
            min_idx = int((now - horizon) // self._window_s)
            out: list[float] = []
            for idx, samples in self._buckets:
                if idx >= min_idx:
                    out.extend(samples)
            return out

    def windowed_summary(self, seconds: float | None = None) -> dict:
        """count/p50_ms/p99_ms over the last ``seconds`` (see
        ``windowed_snapshot`` for the bucket-granular roll contract)."""
        samples = self.windowed_snapshot(seconds)
        if not samples:
            return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0}
        s = sorted(samples)

        def pct(q: float) -> float:
            idx = min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))
            return s[idx] * 1e3

        return {"count": len(s), "p50_ms": pct(50), "p99_ms": pct(99)}

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
            idx = min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))
            return s[idx]

    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    def snapshot(self) -> list[float]:
        """Copy of the retained sample window (seconds) — what fleet-level
        aggregation pools across replicas before taking percentiles."""
        with self._lock:
            return list(self._samples)

    def summary(self) -> dict[str, float]:
        return {
            "count": self.count,
            "p50_ms": self.percentile(50) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
        }


def merge_latency_summaries(histograms: "list[LatencyHistogram]") -> dict:
    """Pool several histograms' retained samples into one percentile
    summary (same shape as ``LatencyHistogram.summary``). Percentiles of
    the pooled window, not averages of per-histogram percentiles — a
    replica with 10× the commits weighs 10× the samples."""
    samples: list[float] = []
    total = 0
    for h in histograms:
        samples.extend(h.snapshot())
        total += h.count
    if not samples:
        return {"count": total, "p50_ms": 0.0, "p99_ms": 0.0}
    s = sorted(samples)

    def pct(q: float) -> float:
        idx = min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))
        return s[idx] * 1e3

    return {"count": total, "p50_ms": pct(50), "p99_ms": pct(99)}


class Gauge:
    """Last-observed value (e.g. ingest lag)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def escape_label_value(value) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote, and newline must be escaped or the sample line is unparsable.
    Label VALUES may otherwise be any UTF-8 — tenant names come straight
    from record keys, so this is load-bearing, not cosmetic."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def format_labels(**labels) -> str:
    """Render a label set for ``render_exposition`` entries with values
    escaped: ``format_labels(tenant='a"b', percentile="p50")`` →
    ``tenant="a\\"b",percentile="p50"``. Insertion-ordered (callers pick
    the display order); None values are skipped."""
    return ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in labels.items() if v is not None
    )


def render_exposition(prefix: str, series: list[tuple]) -> str:
    """Prometheus text exposition shared by every metrics set. ``series``:
    (name, type, value) or (name, type, value, help) — value a number, or
    a list of (labels, number) where labels is a pre-rendered label body
    (build dynamic ones with ``format_labels`` so values are escaped).
    Every metric gets a ``# HELP`` and ``# TYPE`` line (help defaults to
    the name with underscores spaced — enough for the conformance
    contract; pass real help text where it adds signal). Counters follow
    the _total convention at the call site; gauges format with :.6g."""
    lines = []
    for entry in series:
        name, mtype, value = entry[:3]
        help_text = entry[3] if len(entry) > 3 else name.replace("_", " ")
        full = f"{prefix}_{name}"
        lines.append(f"# HELP {full} {help_text}")
        lines.append(f"# TYPE {full} {mtype}")
        entries = value if isinstance(value, list) else [("", value)]
        for labels, v in entries:
            label_part = f"{{{labels}}}" if labels else ""
            v_part = f"{v:.6g}" if mtype == "gauge" else f"{v}"
            lines.append(f"{full}{label_part} {v_part}")
    return "\n".join(lines) + "\n"


class ResilienceMetrics:
    """The metric set one ResilientConsumer maintains (resilience/).

    Counters follow the layer's three escalation stages: a *retry* is a
    fault absorbed inside one operation; a *degraded poll* is an
    operation that gave up for this round (empty result, watermark
    intact); a *suppressed* operation never reached the transport at all
    because the circuit was open. ``circuit_state`` is the breaker gauge
    (0 closed / 0.5 half-open / 1 open); ``circuit_opens``/``closes``
    mirror the breaker's transition counters so "opened then closed" is
    assertable from a metrics snapshot alone."""

    def __init__(self) -> None:
        self.retries = RateMeter()  # backoff-scheduled retry attempts
        self.poll_faults = RateMeter()  # retryable poll failures observed
        self.commit_faults = RateMeter()  # retryable commit failures observed
        self.degraded_polls = RateMeter()  # polls that gave up -> []
        self.suppressed_polls = RateMeter()  # fast-failed: circuit open
        self.suppressed_commits = RateMeter()  # fast-failed: circuit open
        self.circuit_opens = RateMeter()
        self.circuit_closes = RateMeter()
        self.circuit_state = Gauge()

    def summary(self) -> dict:
        return {
            "retries": self.retries.count,
            "poll_faults": self.poll_faults.count,
            "commit_faults": self.commit_faults.count,
            "degraded_polls": self.degraded_polls.count,
            "suppressed_polls": self.suppressed_polls.count,
            "suppressed_commits": self.suppressed_commits.count,
            "circuit_opens": self.circuit_opens.count,
            "circuit_closes": self.circuit_closes.count,
            "circuit_state": self.circuit_state.value,
        }

    def render_prometheus(self, prefix: str = "torchkafka_resilience") -> str:
        s = self.summary()
        return render_exposition(prefix, [
            ("retries_total", "counter", s["retries"]),
            ("poll_faults_total", "counter", s["poll_faults"]),
            ("commit_faults_total", "counter", s["commit_faults"]),
            ("degraded_polls_total", "counter", s["degraded_polls"]),
            ("suppressed_polls_total", "counter", s["suppressed_polls"]),
            ("suppressed_commits_total", "counter", s["suppressed_commits"]),
            ("circuit_opens_total", "counter", s["circuit_opens"]),
            ("circuit_closes_total", "counter", s["circuit_closes"]),
            ("circuit_state", "gauge", s["circuit_state"]),
        ])


class StreamMetrics:
    """The metric set one KafkaStream maintains."""

    def __init__(self) -> None:
        self.records = RateMeter()  # records fetched off the broker
        self.batches = RateMeter()  # batches emitted to the consumer
        self.dropped = RateMeter()  # records dropped by the processor
        self.processor_errors = RateMeter()  # drops caused by a RAISING processor
        self.quarantined = RateMeter()  # poison records dead-lettered (resolved)
        self.dlq_delivery_failures = RateMeter()  # DLQ produces that FAILED —
        # the record is lost to the quarantine topic (the stream's guard
        # swallows the exception by contract; this counter is the page)
        self.commit_latency = LatencyHistogram()
        self.commit_failures = RateMeter()
        self.ingest_lag_ms = Gauge()  # append-time -> poll-time of newest record

    def summary(self) -> dict:
        return {
            "records": self.records.count,
            "records_per_s": self.records.rate(),
            "batches": self.batches.count,
            "dropped": self.dropped.count,
            "processor_errors": self.processor_errors.count,
            "quarantined": self.quarantined.count,
            "dlq_delivery_failures": self.dlq_delivery_failures.count,
            "commit": self.commit_latency.summary(),
            "commit_failures": self.commit_failures.count,
            "ingest_lag_ms": round(self.ingest_lag_ms.value, 3),
        }

    def render_prometheus(self, prefix: str = "torchkafka") -> str:
        """Prometheus text exposition of the summary — paste into any
        scrape endpoint. Names follow the counter/gauge conventions
        (_total suffix on monotone counters, unit-suffixed gauges); the
        latency percentiles use a 'percentile' label, not 'quantile',
        which the exposition format reserves for TYPE summary series."""
        s = self.summary()
        return render_exposition(prefix, [
            ("records_total", "counter", s["records"]),
            ("batches_total", "counter", s["batches"]),
            ("dropped_records_total", "counter", s["dropped"]),
            ("processor_errors_total", "counter", s["processor_errors"]),
            ("quarantined_records_total", "counter", s["quarantined"]),
            ("dlq_delivery_failures_total", "counter", s["dlq_delivery_failures"]),
            ("commit_failures_total", "counter", s["commit_failures"]),
            ("commits_total", "counter", s["commit"]["count"]),
            ("records_per_second", "gauge", s["records_per_s"]),
            ("commit_latency_ms", "gauge", [
                ('percentile="p50"', s["commit"]["p50_ms"]),
                ('percentile="p99"', s["commit"]["p99_ms"]),
            ]),
            ("ingest_lag_ms", "gauge", s["ingest_lag_ms"]),
        ])


class BrokerMetrics:
    """The metric set a durable ``InMemoryBroker`` maintains: WAL write
    cost (appends, bytes, fsyncs), recovery outcome (events/records
    replayed, dangling transactions aborted, torn-tail bytes truncated,
    wall-clock to recover), and — when the broker leads a replicated
    cell — the replication plane (frames shipped/applied, quorum
    commits, stale-epoch rejections, elections won) — the operator's
    answer to "what did that broker restart cost and what did it
    salvage". Rendered on the same shared exposition grammar as every
    other metrics class so the fleet endpoint serves it from the same
    scrape."""

    def __init__(self) -> None:
        self.wal_appends = RateMeter()
        self.wal_bytes_written = RateMeter()
        self.wal_fsyncs = RateMeter()
        self.recoveries = RateMeter()
        self.recovery_replayed_events = RateMeter()
        self.recovery_replayed_records = RateMeter()
        self.recovery_aborted_txns = RateMeter()
        self.recovery_truncated_bytes = RateMeter()
        self.recovery_ms = Gauge()  # last recovery's replay wall-clock
        # Replication plane (zero for a bare, cell-less broker).
        self.repl_frames_shipped = RateMeter()
        self.repl_frames_applied = RateMeter()
        self.repl_quorum_commits = RateMeter()
        self.repl_stale_rejections = RateMeter()
        self.elections = RateMeter()

    def summary(self) -> dict:
        return {
            "wal_appends": self.wal_appends.count,
            "wal_bytes_written": self.wal_bytes_written.count,
            "wal_fsyncs": self.wal_fsyncs.count,
            "recoveries": self.recoveries.count,
            "recovery_replayed_events": self.recovery_replayed_events.count,
            "recovery_replayed_records": self.recovery_replayed_records.count,
            "recovery_aborted_txns": self.recovery_aborted_txns.count,
            "recovery_truncated_bytes": self.recovery_truncated_bytes.count,
            "recovery_ms": round(self.recovery_ms.value, 3),
            "repl_frames_shipped": self.repl_frames_shipped.count,
            "repl_frames_applied": self.repl_frames_applied.count,
            "repl_quorum_commits": self.repl_quorum_commits.count,
            "repl_stale_rejections": self.repl_stale_rejections.count,
            "elections": self.elections.count,
        }

    def render_prometheus(self, prefix: str = "torchkafka_broker") -> str:
        s = self.summary()
        return render_exposition(prefix, [
            ("wal_appends_total", "counter", s["wal_appends"]),
            ("wal_bytes_written_total", "counter", s["wal_bytes_written"]),
            ("wal_fsyncs_total", "counter", s["wal_fsyncs"]),
            ("recoveries_total", "counter", s["recoveries"]),
            ("recovery_replayed_events_total", "counter",
             s["recovery_replayed_events"]),
            ("recovery_replayed_records_total", "counter",
             s["recovery_replayed_records"]),
            ("recovery_aborted_txns_total", "counter",
             s["recovery_aborted_txns"]),
            ("recovery_truncated_bytes_total", "counter",
             s["recovery_truncated_bytes"]),
            ("recovery_ms", "gauge", s["recovery_ms"]),
            ("repl_frames_shipped_total", "counter",
             s["repl_frames_shipped"]),
            ("repl_frames_applied_total", "counter",
             s["repl_frames_applied"]),
            ("repl_quorum_commits_total", "counter",
             s["repl_quorum_commits"]),
            ("repl_stale_rejections_total", "counter",
             s["repl_stale_rejections"]),
            ("elections_total", "counter", s["elections"]),
        ])

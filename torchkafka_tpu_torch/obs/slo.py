"""SLO histograms derived from the record-lifecycle trace stream.

Copy of ``torchkafka_tpu/obs/slo.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

The quantities production serving is judged on — time-to-first-token,
inter-token latency, admission queue wait, end-to-end poll→commit — as
bounded-window percentile histograms labeled along three independent
dimensions: priority lane, tenant key, and replica id (independent
dimensions, not a cross product, matching how the fleet's existing
Prometheus labels are shaped). Built on the same
``utils.metrics.LatencyHistogram`` + pooled-sample-window merge the
commit-latency percentiles use, so a fleet-wide view is percentiles of
the pooled samples, never averages of per-label percentiles.
"""

from __future__ import annotations

import threading

from torchkafka_tpu_torch.utils.metrics import (
    LatencyHistogram,
    merge_latency_summaries,
)

#: The derived latency metrics, in exposition order.
METRICS = ("ttft", "itl", "queue_wait", "e2e")

#: Label dimensions each observation fans into (plus the unlabeled "all").
DIMS = ("lane", "tenant", "replica")


class SLOHistograms:
    """Labeled latency histograms for the four serving SLO quantities.

    Label children are created lazily on first observation — the tenant
    population never needs declaring up front, exactly like the fleet's
    per-tenant counters.

    ``window_s`` (+ the injectable ``clock``) turns every child into a
    time-windowed histogram as well (see ``LatencyHistogram``): a bounded
    ring of per-window sample deltas, so ``windowed_summary(seconds)``
    reports percentiles "over the last S seconds" per metric/label — the
    live view the burn-rate monitor evaluates, next to the cumulative
    one. ``expose_windows`` lists the horizons (seconds) ``series()``
    renders as ``<metric>_window_ms{window="..."}`` Prometheus families."""

    def __init__(self, window: int = 8192, *, window_s: float | None = None,
                 n_windows: int = 16, clock=None,
                 expose_windows: tuple = ()) -> None:
        self._window = window
        self._window_s = window_s
        self._n_windows = n_windows
        self._clock = clock
        if expose_windows and window_s is None:
            raise ValueError("expose_windows requires window_s")
        self.expose_windows = tuple(float(w) for w in expose_windows)
        self._lock = threading.Lock()
        # (metric, dim, label) -> LatencyHistogram; dim "" label "" = all.
        self._h: dict[tuple[str, str, str], LatencyHistogram] = {}

    @property
    def windowed(self) -> bool:
        return self._window_s is not None

    @property
    def window_s(self) -> float | None:
        return self._window_s

    def hist(self, metric: str, dim: str = "", label: str = ""
             ) -> LatencyHistogram:
        if metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
        key = (metric, dim, str(label))
        with self._lock:
            h = self._h.get(key)
            if h is None:
                h = self._h[key] = LatencyHistogram(
                    self._window, window_s=self._window_s,
                    n_windows=self._n_windows, clock=self._clock,
                )
            return h

    def observe(self, metric: str, seconds: float, *, lane=None, tenant=None,
                replica=None) -> None:
        self.hist(metric).observe(seconds)
        if lane is not None:
            self.hist(metric, "lane", lane).observe(seconds)
        if tenant is not None:
            self.hist(metric, "tenant", tenant).observe(seconds)
        if replica is not None:
            self.hist(metric, "replica", replica).observe(seconds)

    def observe_many(self, metric: str, seconds: float, n: int, *,
                     lane=None, tenant=None, replica=None) -> None:
        """``n`` identical samples with ONE label lookup per dimension —
        the inter-token-latency hot path (a K-tick sync surfaces K
        tokens at once; per-sample ``observe`` would pay the dict+lock
        walk K times)."""
        self.hist(metric).observe_many(seconds, n)
        if lane is not None:
            self.hist(metric, "lane", lane).observe_many(seconds, n)
        if tenant is not None:
            self.hist(metric, "tenant", tenant).observe_many(seconds, n)
        if replica is not None:
            self.hist(metric, "replica", replica).observe_many(seconds, n)

    def labels(self, metric: str, dim: str) -> list[str]:
        with self._lock:
            return sorted(
                label for (m, d, label) in self._h if m == metric and d == dim
            )

    def summary(self) -> dict:
        """{metric: {"all": {...}, "by_lane": {...}, "by_tenant": {...},
        "by_replica": {...}}} — each leaf a count/p50_ms/p99_ms dict."""
        out: dict = {}
        for metric in METRICS:
            out[metric] = {"all": self.hist(metric).summary()}
            for dim in DIMS:
                out[metric][f"by_{dim}"] = {
                    label: self.hist(metric, dim, label).summary()
                    for label in self.labels(metric, dim)
                }
        return out

    def windowed_summary(self, seconds: float | None = None) -> dict:
        """Same nested shape as ``summary()`` but over the last
        ``seconds`` only (default: one ``window_s`` bucket) — requires
        time-windowing (``window_s=``)."""
        out: dict = {}
        for metric in METRICS:
            out[metric] = {
                "all": self.hist(metric).windowed_summary(seconds)
            }
            for dim in DIMS:
                out[metric][f"by_{dim}"] = {
                    label: self.hist(metric, dim, label).windowed_summary(
                        seconds
                    )
                    for label in self.labels(metric, dim)
                }
        return out

    def series(self) -> list[tuple]:
        """Exposition series for ``utils.metrics.render_exposition``:
        one ``<metric>_ms`` gauge per SLO quantity with percentile +
        dimension labels, plus the sample-count counters; when
        ``expose_windows`` is set, one ``<metric>_window_ms`` gauge per
        horizon with a ``window`` label (seconds) next to them."""
        from torchkafka_tpu_torch.utils.metrics import format_labels

        out: list[tuple] = []
        for metric in METRICS:
            entries = []
            counts = []
            windowed = []
            all_h = self.hist(metric)
            all_s = all_h.summary()
            for pct in ("p50", "p99"):
                entries.append(
                    (format_labels(percentile=pct), all_s[f"{pct}_ms"])
                )
            counts.append(("", all_s["count"]))
            for horizon in self.expose_windows:
                w = all_h.windowed_summary(horizon)
                for pct in ("p50", "p99"):
                    windowed.append((
                        format_labels(window=f"{horizon:g}",
                                      percentile=pct),
                        w[f"{pct}_ms"],
                    ))
            for dim in DIMS:
                for label in self.labels(metric, dim):
                    h = self.hist(metric, dim, label)
                    s = h.summary()
                    for pct in ("p50", "p99"):
                        entries.append((
                            format_labels(**{dim: label, "percentile": pct}),
                            s[f"{pct}_ms"],
                        ))
                    counts.append(
                        (format_labels(**{dim: label}), s["count"])
                    )
                    for horizon in self.expose_windows:
                        w = h.windowed_summary(horizon)
                        for pct in ("p50", "p99"):
                            windowed.append((
                                format_labels(**{
                                    dim: label, "window": f"{horizon:g}",
                                    "percentile": pct,
                                }),
                                w[f"{pct}_ms"],
                            ))
            help_name = metric.replace("_", " ")
            out.append((
                f"{metric}_ms", "gauge", entries,
                f"{help_name} latency percentiles (ms)",
            ))
            out.append((
                f"{metric}_observations_total", "counter", counts,
                f"{help_name} samples observed",
            ))
            if windowed:
                out.append((
                    f"{metric}_window_ms", "gauge", windowed,
                    f"{help_name} latency percentiles over the trailing "
                    "window (ms)",
                ))
        return out

    def pooled(self, metric: str, dim: str = "", label: str = "") -> dict:
        """Percentile summary of one histogram (sugar over ``hist``)."""
        return self.hist(metric, dim, label).summary()


def pooled_slo_summary(slos: "list[SLOHistograms]") -> dict:
    """Fleet-of-fleets aggregation: pool several SLOHistograms' sample
    windows per (metric, dimension, label) with the same merge the
    commit-latency percentiles use (``merge_latency_summaries`` — a
    tracer with 10× the records weighs 10× the samples)."""
    out: dict = {}
    for metric in METRICS:
        out[metric] = {
            "all": merge_latency_summaries([s.hist(metric) for s in slos])
        }
        for dim in DIMS:
            labels = sorted({
                label for s in slos for label in s.labels(metric, dim)
            })
            out[metric][f"by_{dim}"] = {
                label: merge_latency_summaries(
                    [s.hist(metric, dim, label) for s in slos]
                )
                for label in labels
            }
    return out

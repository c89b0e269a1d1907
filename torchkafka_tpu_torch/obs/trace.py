"""Per-record lifecycle tracing for the serving path.

Copy of ``torchkafka_tpu/obs/trace.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

One ``RecordTracer`` observes every record's journey through the server
(or a whole fleet — the fleet shares one tracer and tags events with the
replica id) as a stream of typed ``TraceEvent``s keyed by the record's
``(topic, partition, offset)`` identity. Stage boundaries map 1:1 onto
the serving code's own phase transitions:

    polled           note_fetched registered the record with the ledger
    qos_admitted     the QoS admission queue released it to a slot offer
    deferred         paged admission deferred it on block-pool pressure
    prefill_queued   chunked admission reserved a slot + enqueued suffix
    chunk_scheduled  its first suffix tokens rode a fused chunk tick
    warm_resumed     a journal hint restored emitted tokens at admit
    slot_active      first token exists (admit/prefill/activation done)
    tokens           a tick block produced n new tokens for its slot
    finished         generation retired (EOS or max_new), output emitted
    journal_served   finished entry re-served from a dead replica journal
    committed        the offset commit watermark durably covered it
    quarantined      dead-lettered after exhausting its poison budget
    dropped          retired undecodable (no quarantine configured)

Determinism is a design contract, not an accident: the clock is
INJECTABLE (``ObsConfig.clock`` — a ``resilience.ManualClock`` in tests)
and the tracer adds no ordering of its own, so a same-seed chaos replay
yields an identical event sequence (and, under a manual clock, identical
timestamps — byte-identical traces). ``TraceEvent.signature`` is the
timestamp-free tuple the differential tests compare.

Cost discipline: a server built with ``tracer=None`` pays only the
``is not None`` guards at each call site (measured in
benchmarks/bench_obs.py, budgeted ≤ 50 ns/record); an enabled tracer
appends to a bounded ring (``deque(maxlen=...)``) and optionally streams
JSONL. Derived SLO histograms (obs/slo.py) update inline on the events
that close a latency interval.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Callable, Iterable, NamedTuple

from torchkafka_tpu_torch.obs.slo import SLOHistograms
from torchkafka_tpu_torch.source.records import Record

POLLED = "polled"
QOS_ADMITTED = "qos_admitted"
DEFERRED = "deferred"
PREFILL_QUEUED = "prefill_queued"
CHUNK_SCHEDULED = "chunk_scheduled"
WARM_RESUMED = "warm_resumed"
SLOT_ACTIVE = "slot_active"
TOKENS = "tokens"
FINISHED = "finished"
JOURNAL_SERVED = "journal_served"
COMMITTED = "committed"
QUARANTINED = "quarantined"
DROPPED = "dropped"
# A dead-letter produce FAILED: the record's quarantine copy is NOT
# durable. Terminal observability for the swallowed-DLQ path (the
# stream's guard logs and continues by contract; this event + the
# dlq_delivery_failures counter are what make a broken DLQ visible on
# the trace stream and /metrics instead of stderr only). Not part of
# the happy lifecycle: the record stays open/unresolved.
DLQ_FAILED = "dlq_failed"
# Disaggregated prefill (fleet/prefill.py + serve.py adoption): a
# PREFILL worker published the record's filled-KV handoff onto the
# transfer plane, and a DECODE replica adopted it into a slot without
# running a prompt pass. Together with PREFILL_QUEUED these spell the
# disaggregated admission lifecycle: prefill_queued → handoff → adopted.
PREFILL_HANDOFF = "handoff"
SLOT_ADOPTED = "adopted"
# Not a record stage: a BurnRateMonitor state transition, riding the
# same event stream (topic "slo", offset = transition sequence) so
# overload state changes land in the trace, ordered against the record
# lifecycles that caused them — and replay byte-identically.
BURN_STATE = "burn_state"
# Membership events (topic "fleet", offset = membership sequence): the
# fleet's liveness story on the same stream — a replica joining the
# group, a replica fenced (lease expiry, kill, drain-timeout), and a
# dead replica's journal handed to survivors — ordered against the
# record lifecycles they interrupt or resume.
REPLICA_JOINED = "replica_joined"
REPLICA_FENCED = "replica_fenced"
JOURNAL_HANDOFF = "journal_handoff"
# The broker itself died and was crash-recovered from its write-ahead
# log (ProcessFleet.restart_broker): the one event that interrupts EVERY
# record lifecycle at once, so it rides the same "fleet" stream ordered
# against them.
BROKER_RESTARTED = "broker_restarted"
# An autoscale controller decision (fleet/autoscale.py): the control
# plane's actuation orders ride the "fleet" stream ordered against the
# joins/drains/fences they cause — under a ManualClock the whole control
# loop (load → burn transitions → decisions → scale events) replays
# byte-identically.
SCALE_DECISION = "scale_decision"
# The live model lifecycle (fleet/rollout.py): the rollout state machine
# (pending → canary → rolling → complete | rolled_back) typed on the
# "fleet" stream, ordered against the record lifecycles a swap pauses
# and the fences a stale-version zombie earns. ``rollout_phase`` marks
# every controller phase transition; ``canary_started`` opens the
# shadow-serving slice; ``swapped`` is one replica's atomic weight
# rebind landing (also emitted by the server itself at swap_params);
# ``rolled_back`` is the automatic verdict on a divergent canary.
ROLLOUT_PHASE = "rollout_phase"
CANARY_STARTED = "canary_started"
SWAPPED = "swapped"
ROLLED_BACK = "rolled_back"
# Online draft distillation (torchkafka_tpu/distill): the closed loop's
# control decisions on the same "fleet" stream. ``draft_refresh`` is the
# DistillController's verdict (the windowed live-α crossed the refresh
# gate, or a refresh was rejected — the reason attribute says which);
# ``draft_swapped`` is one replica's draft rebinding landing between
# ticks (no quiesce — the draft only proposes, verification commits).
# Under a ManualClock the whole loop replays byte-identically.
DRAFT_REFRESH = "draft_refresh"
DRAFT_SWAPPED = "draft_swapped"

STAGES = (
    POLLED, QOS_ADMITTED, DEFERRED, PREFILL_QUEUED, CHUNK_SCHEDULED,
    WARM_RESUMED, SLOT_ACTIVE, TOKENS, FINISHED, JOURNAL_SERVED, COMMITTED,
    QUARANTINED, DROPPED, DLQ_FAILED, PREFILL_HANDOFF, SLOT_ADOPTED,
    BURN_STATE, REPLICA_JOINED, REPLICA_FENCED, JOURNAL_HANDOFF,
    SCALE_DECISION, ROLLOUT_PHASE, CANARY_STARTED, SWAPPED, ROLLED_BACK,
    DRAFT_REFRESH, DRAFT_SWAPPED,
)


def _default_tenant(record: Record) -> str:
    """Tenant = the record key (Kafka's partitioning identity) — the same
    rule fleet/qos.py admits by, duplicated here so the tracer needs no
    QoS layer to label a bare StreamingGenerator's traffic."""
    if record.key is None:
        return "anon"
    try:
        return record.key.decode("utf-8")
    except UnicodeDecodeError:
        return record.key.hex()


def _default_lane(record: Record) -> str:
    for k, v in record.headers:
        if k == "lane":
            return "interactive" if v == b"interactive" else "batch"
    return "batch"


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Tracing policy for a server or fleet.

    ``clock``: the monotonic clock every event timestamp reads (None =
    ``time.monotonic``); inject a ``ManualClock.now`` and traces become
    byte-identical across same-seed replays. ``capacity``: ring-buffer
    bound — streams may run forever, traces must not. ``jsonl_path``:
    when set, every event is ALSO appended to this file as one JSON line
    at emit time (offline analysis; the measured-cost tier above the
    ring). ``token_events``: emit per-tick ``tokens`` events (the ITL
    source); off keeps only stage-boundary events for long soaks.

    ``window_s``: bucket width (seconds) for the TIME-windowed SLO view
    (obs/slo.py): percentiles "over the last S seconds" next to the
    cumulative ones — required by a ``BurnRateMonitor``. ``n_windows``
    bounds the delta ring; ``expose_windows`` lists horizons the
    Prometheus exposition renders (default: one ``window_s``)."""

    capacity: int = 65536
    clock: Callable[[], float] | None = None
    jsonl_path: str | None = None
    token_events: bool = True
    tenant_of: Callable[[Record], str] = _default_tenant
    lane_of: Callable[[Record], str] = _default_lane
    window_s: float | None = None
    n_windows: int = 16
    expose_windows: tuple = ()

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.window_s is not None and self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")


class TraceEvent(NamedTuple):
    """One typed span event. ``t`` is the injected clock's reading at
    emit; ``attrs`` is a sorted (key, value) tuple so events hash/compare
    deterministically. A NamedTuple, not a dataclass: the constructor is
    on the per-event hot path and tuple construction is ~5× cheaper."""

    stage: str
    topic: str
    partition: int
    offset: int
    t: float
    attrs: tuple = ()

    @property
    def key(self) -> tuple[str, int, int]:
        return (self.topic, self.partition, self.offset)

    @property
    def signature(self) -> tuple:
        """Everything but the timestamp — what same-seed replay
        differentials compare (wall clocks differ, lifecycles must not)."""
        return (self.stage, self.topic, self.partition, self.offset,
                self.attrs)

    def to_json(self) -> dict:
        d = {
            "stage": self.stage, "topic": self.topic, "p": self.partition,
            "o": self.offset, "t": self.t,
        }
        d.update(dict(self.attrs))
        return d


@dataclasses.dataclass
class RecordTrace:
    """One record's ordered lifecycle view (``RecordTracer.record_trace``)
    with the derived per-record latencies the SLO histograms aggregate."""

    topic: str
    partition: int
    offset: int
    events: list[TraceEvent]

    def _t(self, stage: str) -> float | None:
        for e in self.events:
            if e.stage == stage:
                return e.t
        return None

    def stages(self) -> list[str]:
        return [e.stage for e in self.events]

    @property
    def queue_wait_s(self) -> float | None:
        """poll → QoS admission (None when no QoS layer ran)."""
        t0, t1 = self._t(POLLED), self._t(QOS_ADMITTED)
        return None if t0 is None or t1 is None else max(0.0, t1 - t0)

    @property
    def ttft_s(self) -> float | None:
        """poll → first token (admission + queue + prefill, inclusive)."""
        t0, t1 = self._t(POLLED), self._t(SLOT_ACTIVE)
        return None if t0 is None or t1 is None else max(0.0, t1 - t0)

    @property
    def e2e_s(self) -> float | None:
        """poll → durable offset commit."""
        t0, t1 = self._t(POLLED), self._t(COMMITTED)
        return None if t0 is None or t1 is None else max(0.0, t1 - t0)

    @property
    def itl_s(self) -> list[float]:
        """Per-token inter-token latencies, at host-sync granularity: a
        ``tokens`` event carrying n tokens spreads its interval over n."""
        out: list[float] = []
        prev = self._t(SLOT_ACTIVE)
        for e in self.events:
            if e.stage != TOKENS or prev is None:
                continue
            n = dict(e.attrs).get("n", 1)
            out.extend([max(0.0, e.t - prev) / max(1, n)] * n)
            prev = e.t
        return out


class _Lifecycle:
    """Open per-record state between POLLED and a terminal stage."""

    __slots__ = ("lane", "tenant", "replica", "polled_t", "active_t",
                 "last_tok_t", "finished", "tokens", "warm", "queue_wait")

    def __init__(self, lane: str, tenant: str, replica, t: float) -> None:
        self.lane = lane
        self.tenant = tenant
        self.replica = replica
        self.polled_t = t
        self.active_t: float | None = None
        self.last_tok_t: float | None = None
        self.finished = False
        self.tokens = 0
        self.warm = False  # first token predates this poll (warm resume)
        self.queue_wait: float | None = None


class RecordTracer:
    """The lifecycle tracer: emit-side API for the serving code, read-side
    API (ring, per-record views, SLO summaries, Prometheus) for
    operators and tests. Thread-safe (one lock around ring + lifecycle
    state); the cooperative fleet scheduler never contends it."""

    def __init__(self, config: ObsConfig | None = None, **kw) -> None:
        self.config = config or ObsConfig(**kw)
        self._clock = self.config.clock or time.monotonic
        self._lock = threading.Lock()
        self.events: deque[TraceEvent] = deque(maxlen=self.config.capacity)
        self.dropped_events = 0  # emitted beyond the ring's capacity
        self._emitted = 0
        self._open: dict[tuple[str, int, int], _Lifecycle] = {}
        cfg = self.config
        self.slo = SLOHistograms(
            window_s=cfg.window_s, n_windows=cfg.n_windows,
            clock=self._clock,
            expose_windows=cfg.expose_windows or (
                (cfg.window_s,) if cfg.window_s is not None else ()
            ),
        )
        # Optional obs.BurnRateMonitor: receives per-completion goodput
        # classifications (note_commit) and quarantine events.
        self._monitor = None
        self._membership_seq = 0  # offsets for topic-"fleet" events
        self._jsonl = None
        if self.config.jsonl_path is not None:
            self._jsonl = open(self.config.jsonl_path, "a", encoding="utf-8")

    def attach_monitor(self, monitor) -> None:
        """Bind a ``BurnRateMonitor``: committed lifecycles feed its
        goodput ledger, and its state transitions ride this tracer's
        event stream (``burn_state``)."""
        self._monitor = monitor

    # -------------------------------------------------------------- emit

    def _emit(self, stage: str, topic: str, partition: int, offset: int,
              attrs: tuple) -> float:
        t = self._clock()
        ev = TraceEvent(stage, topic, partition, offset, t, attrs)
        if len(self.events) == self.events.maxlen:
            self.dropped_events += 1
        self.events.append(ev)
        self._emitted += 1
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(ev.to_json()) + "\n")
        return t

    def _life(self, rec: Record, replica) -> _Lifecycle:
        key = (rec.topic, rec.partition, rec.offset)
        life = self._open.get(key)
        if life is None:
            # Tolerate a mid-lifecycle start (tracer attached late, or an
            # event arriving before its POLLED — e.g. a journal-served
            # completion admitted straight from a hint).
            life = _Lifecycle(
                self.config.lane_of(rec), self.config.tenant_of(rec),
                replica, self._clock(),
            )
            self._open[key] = life
        return life

    def polled(self, rec: Record, replica=None) -> None:
        with self._lock:
            lane = self.config.lane_of(rec)
            tenant = self.config.tenant_of(rec)
            t = self._emit(POLLED, rec.topic, rec.partition, rec.offset, (
                ("lane", lane), ("replica", replica), ("tenant", tenant),
            ))
            # Redelivery restarts the lifecycle (the first incarnation's
            # interval died with its replica).
            self._open[(rec.topic, rec.partition, rec.offset)] = _Lifecycle(
                lane, tenant, replica, t
            )

    def qos_admitted(self, rec: Record, lane: str, wait_s: float,
                     replica=None) -> None:
        with self._lock:
            life = self._life(rec, replica)
            life.replica = replica if replica is not None else life.replica
            self._emit(QOS_ADMITTED, rec.topic, rec.partition, rec.offset, (
                ("lane", lane), ("replica", replica),
            ))
            life.queue_wait = max(0.0, wait_s)
            self.slo.observe(
                "queue_wait", life.queue_wait, lane=lane,
                tenant=life.tenant, replica=life.replica,
            )

    def deferred(self, rec: Record, replica=None) -> None:
        with self._lock:
            self._emit(DEFERRED, rec.topic, rec.partition, rec.offset,
                       (("replica", replica),))

    def prefill_queued(self, rec: Record, suffix_tokens: int,
                       replica=None) -> None:
        with self._lock:
            self._emit(PREFILL_QUEUED, rec.topic, rec.partition, rec.offset, (
                ("replica", replica), ("suffix_tokens", suffix_tokens),
            ))

    def chunk_scheduled(self, rec: Record, replica=None) -> None:
        with self._lock:
            self._emit(CHUNK_SCHEDULED, rec.topic, rec.partition, rec.offset,
                       (("replica", replica),))

    def prefill_handoff(self, rec: Record, blocks: int, replica=None) -> None:
        """A PREFILL worker published this record's filled-KV handoff on
        the transfer plane (``blocks`` prompt blocks of payload)."""
        with self._lock:
            self._emit(PREFILL_HANDOFF, rec.topic, rec.partition, rec.offset, (
                ("blocks", blocks), ("replica", replica),
            ))

    def adopted(self, rec: Record, replica=None) -> None:
        """A DECODE replica adopted this record's handoff into a slot —
        no prompt pass ran here; the follow-up ``slot_active`` closes
        TTFT as usual (the first token genuinely exists now)."""
        with self._lock:
            self._emit(SLOT_ADOPTED, rec.topic, rec.partition, rec.offset,
                       (("replica", replica),))

    def warm_resumed(self, rec: Record, tokens_restored: int,
                     replica=None) -> None:
        with self._lock:
            self._emit(WARM_RESUMED, rec.topic, rec.partition, rec.offset, (
                ("replica", replica), ("tokens_restored", tokens_restored),
            ))

    def slot_active(self, rec: Record, replica=None, warm: bool = False) -> None:
        """First token exists for this record: admit dispatch returned
        (dense / legacy-paged) or the activation chunk tick landed
        (chunked). Closes the TTFT interval."""
        with self._lock:
            life = self._life(rec, replica)
            life.replica = replica if replica is not None else life.replica
            t = self._emit(SLOT_ACTIVE, rec.topic, rec.partition, rec.offset, (
                ("replica", replica), ("warm", warm),
            ))
            life.active_t = t
            life.last_tok_t = t
            life.tokens = max(life.tokens, 1)
            life.warm = warm
            if not warm:
                # A warm resume's "first token" was decoded by the dead
                # replica pre-kill; timing it from THIS poll would report
                # a fabricated (and negative-looking) TTFT.
                self.slo.observe(
                    "ttft", max(0.0, t - life.polled_t), lane=life.lane,
                    tenant=life.tenant, replica=life.replica,
                )

    def tokens(self, rec: Record, n_new: int, replica=None) -> None:
        """A tick block surfaced ``n_new`` new tokens for this record
        (host-sync granularity: with ticks_per_sync=K, K tokens arrive
        per event and the interval is spread over them)."""
        if n_new <= 0:
            return
        with self._lock:
            life = self._life(rec, replica)
            if self.config.token_events:
                self._emit(TOKENS, rec.topic, rec.partition, rec.offset, (
                    ("n", n_new), ("replica", replica),
                ))
            if life.last_tok_t is not None:
                per_tok = max(0.0, self._clock() - life.last_tok_t) / n_new
                self.slo.observe_many(
                    "itl", per_tok, n_new, lane=life.lane,
                    tenant=life.tenant, replica=life.replica,
                )
            life.last_tok_t = self._clock()
            life.tokens += n_new

    def finished(self, rec: Record, n_tokens: int, replica=None) -> None:
        with self._lock:
            life = self._life(rec, replica)
            life.finished = True
            self._emit(FINISHED, rec.topic, rec.partition, rec.offset, (
                ("replica", replica), ("tokens", n_tokens),
            ))

    def journal_served(self, rec: Record, n_tokens: int, replica=None) -> None:
        with self._lock:
            life = self._life(rec, replica)
            life.finished = True
            self._emit(JOURNAL_SERVED, rec.topic, rec.partition, rec.offset, (
                ("replica", replica), ("tokens", n_tokens),
            ))

    def quarantined(self, rec: Record, replica=None) -> None:
        with self._lock:
            self._emit(QUARANTINED, rec.topic, rec.partition, rec.offset,
                       (("replica", replica),))
            self._open.pop((rec.topic, rec.partition, rec.offset), None)
            if self._monitor is not None:
                self._monitor.note_quarantined(self.config.tenant_of(rec))

    def dropped(self, rec: Record, replica=None) -> None:
        with self._lock:
            self._emit(DROPPED, rec.topic, rec.partition, rec.offset,
                       (("replica", replica),))
            self._open.pop((rec.topic, rec.partition, rec.offset), None)

    def dlq_failed(self, rec: Record, replica=None) -> None:
        """A dead-letter produce for ``rec`` failed — the quarantine copy
        is NOT durable. The record's lifecycle stays OPEN (it is neither
        served, dropped, nor durably quarantined), which is exactly what
        the trace should say about it."""
        with self._lock:
            self._emit(DLQ_FAILED, rec.topic, rec.partition, rec.offset,
                       (("replica", replica),))

    def note_commit(self, snapshot: dict) -> None:
        """A successful offset commit: every FINISHED lifecycle whose
        offset the committed next-read watermark covers becomes
        COMMITTED (closing the e2e interval) and its state retires —
        exactly the ledger's own durability rule, so the trace can never
        claim a commit the broker did not make."""
        if not snapshot or not self._open:
            return
        with self._lock:
            done = [
                (key, life) for key, life in self._open.items()
                if life.finished
                and key[2] < snapshot.get((key[0], key[1]), -1)
            ]
            for (topic, partition, offset), life in done:
                t = self._emit(COMMITTED, topic, partition, offset,
                               (("replica", life.replica),))
                e2e = max(0.0, t - life.polled_t)
                self.slo.observe(
                    "e2e", e2e, lane=life.lane,
                    tenant=life.tenant, replica=life.replica,
                )
                if self._monitor is not None:
                    ttft = (
                        None
                        if life.warm or life.active_t is None
                        else max(0.0, life.active_t - life.polled_t)
                    )
                    self._monitor.note_completed(
                        life.lane, life.tenant, ttft_s=ttft, e2e_s=e2e,
                        queue_wait_s=life.queue_wait,
                    )
                del self._open[(topic, partition, offset)]

    def replica_joined(self, member: str, replica=None) -> None:
        """A replica became a live group member (spawned, respawned, or
        scaled in). Topic ``fleet``; offset = membership sequence."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            self._emit(REPLICA_JOINED, "fleet", 0, seq, (
                ("member", member), ("replica", replica),
            ))

    def replica_fenced(self, member: str, reason: str = "lease_expired",
                       lease_age_s: float | None = None,
                       replica=None) -> None:
        """A replica was fenced out of the group: its lease expired (a
        real process death — or a zombie too slow to renew), it was
        killed, or it overran a drain timeout. Its partitions rebalance
        to survivors; its stale-generation commits are rejected from
        here on."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            attrs = [("member", member), ("reason", reason),
                     ("replica", replica)]
            if lease_age_s is not None:
                attrs.append(("lease_age_s", round(lease_age_s, 4)))
            self._emit(REPLICA_FENCED, "fleet", 0, seq,
                       tuple(sorted(attrs)))

    def journal_handoff(self, member: str, entries: int,
                        replica=None) -> None:
        """A dead replica's on-disk decode journal was handed to
        survivors (``entries`` live generations become warm-resume
        hints)."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            self._emit(JOURNAL_HANDOFF, "fleet", 0, seq, (
                ("entries", entries), ("member", member),
                ("replica", replica),
            ))

    def broker_restarted(self, replayed_records: int = 0,
                         aborted_txns: int = 0,
                         recovery_ms: float = 0.0) -> None:
        """The hosted broker was crash-recovered from its WAL: how much
        state the log salvaged (records replayed, dangling transactions
        aborted) and how long the replay took. Topic ``fleet``; offset =
        membership sequence — ordered against the joins/fences the
        outage may have triggered."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            self._emit(BROKER_RESTARTED, "fleet", 0, seq, (
                ("aborted_txns", aborted_txns),
                ("recovery_ms", round(recovery_ms, 3)),
                ("replayed_records", replayed_records),
            ))

    def scale_decision(self, role: str, direction: str, reason: str,
                       frm: int, to: int) -> None:
        """An autoscale controller moved ``role``'s target replica count
        ``frm`` → ``to`` (``direction`` up/down) because ``reason``
        (burn / queue / idle). Topic ``fleet``; offset = membership
        sequence — ordered against the joins and drains it causes."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            self._emit(SCALE_DECISION, "fleet", 0, seq, (
                ("direction", direction), ("from", frm),
                ("reason", reason), ("role", role), ("to", to),
            ))

    def rollout_phase(self, phase: str, version: int) -> None:
        """The rollout controller entered ``phase`` for target
        ``version``. Topic ``fleet``; offset = membership sequence —
        ordered against the swaps, fences, and joins the phase drives."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            self._emit(ROLLOUT_PHASE, "fleet", 0, seq, (
                ("phase", phase), ("version", int(version)),
            ))

    def canary_started(self, member: str, version: int,
                       slice_n: int | None = None) -> None:
        """Member ``member`` began shadow-serving a deterministic slice
        under candidate ``version`` — token-diffed against the incumbent
        before any weight anywhere is swapped."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            attrs = [("member", member), ("version", int(version))]
            if slice_n is not None:
                attrs.append(("slice_n", int(slice_n)))
            self._emit(CANARY_STARTED, "fleet", 0, seq,
                       tuple(sorted(attrs)))

    def swapped(self, version: int, member: str | None = None,
                replica=None) -> None:
        """One replica's weights atomically rebound to ``version`` (the
        drain-swap landed: in-flight finished, window committed, journal
        meta flipped, params swapped without recompiling)."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            attrs = [("version", int(version))]
            if member is not None:
                attrs.append(("member", member))
            if replica is not None:
                attrs.append(("replica", replica))
            self._emit(SWAPPED, "fleet", 0, seq, tuple(sorted(attrs)))

    def rolled_back(self, reason: str, version: int) -> None:
        """The rollout of ``version`` was automatically halted and every
        swapped replica ordered back to the incumbent (``reason``:
        canary_divergence / checkpoint_rejected / ...)."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            self._emit(ROLLED_BACK, "fleet", 0, seq, (
                ("reason", reason), ("version", int(version)),
            ))

    def draft_refresh(self, reason: str, version: int,
                      alpha: float | None = None) -> None:
        """The DistillController decided a draft refresh (``reason``:
        alpha_drop / forced) or rejected one (checkpoint_rejected).
        α rounded so the JSONL trace round-trips byte-exact."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            attrs = [("reason", reason), ("version", int(version))]
            if alpha is not None:
                attrs.append(("alpha", round(float(alpha), 4)))
            self._emit(DRAFT_REFRESH, "fleet", 0, seq,
                       tuple(sorted(attrs)))

    def draft_swapped(self, version: int, member: str | None = None,
                      replica=None) -> None:
        """One replica's DRAFT rebound to checkpoint ``version`` between
        ticks — committed tokens unchanged by contract (the draft only
        proposes; the target's verification commits)."""
        with self._lock:
            seq = self._membership_seq
            self._membership_seq += 1
            attrs = [("version", int(version))]
            if member is not None:
                attrs.append(("member", member))
            if replica is not None:
                attrs.append(("replica", replica))
            self._emit(DRAFT_SWAPPED, "fleet", 0, seq,
                       tuple(sorted(attrs)))

    def burn_state(self, seq: int, metric: str, dim: str, label: str,
                   old: str, new: str, fast: float, slow: float) -> None:
        """A BurnRateMonitor state transition as a typed event on the
        shared stream: topic ``slo``, offset = the monitor's transition
        sequence, burn rates rounded so JSONL round-trips byte-exact."""
        with self._lock:
            self._emit(BURN_STATE, "slo", 0, seq, (
                ("dim", dim), ("fast", round(fast, 4)), ("from", old),
                ("label", label), ("metric", metric),
                ("slow", round(slow, 4)), ("to", new),
            ))

    # -------------------------------------------------------------- read

    def __len__(self) -> int:
        return len(self.events)

    @property
    def emitted(self) -> int:
        """Total events emitted (ring may retain fewer)."""
        return self._emitted

    def signature(self) -> list[tuple]:
        """The retained events' timestamp-free signatures, in order — the
        unit of comparison for same-seed replay differentials."""
        with self._lock:
            return [e.signature for e in self.events]

    def record_trace(self, topic: str, partition: int, offset: int
                     ) -> RecordTrace:
        with self._lock:
            evs = [e for e in self.events
                   if e.key == (topic, partition, offset)]
        return RecordTrace(topic, partition, offset, evs)

    def export_jsonl(self, path: str) -> int:
        """Dump the retained ring to ``path`` (one event per line);
        returns the number of events written. Offline-analysis companion
        to the streaming ``jsonl_path`` sink."""
        with self._lock:
            evs = list(self.events)
        with open(path, "w", encoding="utf-8") as f:
            for e in evs:
                f.write(json.dumps(e.to_json()) + "\n")
        return len(evs)

    @staticmethod
    def load_jsonl(path: str) -> list[TraceEvent]:
        out = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                d = json.loads(line)
                attrs = tuple(sorted(
                    (k, v) for k, v in d.items()
                    if k not in ("stage", "topic", "p", "o", "t")
                ))
                out.append(TraceEvent(
                    d["stage"], d["topic"], d["p"], d["o"], d["t"], attrs
                ))
        return out

    def summary(self) -> dict:
        with self._lock:
            stages: dict[str, int] = {}
            for e in self.events:
                stages[e.stage] = stages.get(e.stage, 0) + 1
            open_records = len(self._open)
        return {
            "events": self._emitted,
            "retained": len(self.events),
            "ring_dropped": self.dropped_events,
            "open_records": open_records,
            "stages": stages,
            "slo": self.slo.summary(),
        }

    def render_prometheus(self, prefix: str = "torchkafka_slo") -> str:
        """The SLO histograms plus the tracer's own health counters,
        through the shared exposition renderer."""
        from torchkafka_tpu_torch.utils.metrics import render_exposition

        series = [
            ("trace_events_total", "counter", self._emitted,
             "lifecycle trace events emitted"),
            ("trace_ring_dropped_total", "counter", self.dropped_events,
             "events evicted from the bounded ring"),
            ("trace_open_records", "gauge", len(self._open),
             "records with an open (uncommitted) lifecycle"),
        ]
        series.extend(self.slo.series())
        return render_exposition(prefix, series)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "RecordTracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def events_signature(events: Iterable[TraceEvent]) -> list[tuple]:
    """Timestamp-free signature of an arbitrary event list (e.g. one
    loaded back from JSONL)."""
    return [e.signature for e in events]

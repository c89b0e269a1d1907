"""QoS admission: per-tenant token buckets, priority lanes, backpressure.

Copy of ``torchkafka_tpu/fleet/qos.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

The serving fleet's answer to "which prompt gets a slot when demand
exceeds capacity". Three cooperating mechanisms, all in front of the
generator's admission (the generators themselves stay QoS-blind):

- **Token buckets** rate-limit admission per tenant (tenant read from the
  record KEY by default — Kafka's natural multi-tenant partitioning
  handle). A tenant with no configured rate admits freely; a configured
  tenant admits at most ``rate`` prompts/sec sustained with ``burst``
  headroom. Throttled records stay QUEUED (they were polled and
  ledger-fetched, so the commit watermark stalls below them — re-delivery
  safe), they are never dropped.
- **Priority lanes**: interactive preempts batch for free slots —
  admission always drains the interactive lane before considering batch.
  Within a lane, tenants round-robin so one tenant's flood cannot starve
  another's trickle (head-of-line isolation is per (lane, tenant) queue).
- **Backpressure** is the replica's job (fleet/replica.py): when its slot
  pool is saturated AND its admission queue is at the high-water mark, it
  PAUSES its partitions (Consumer.pause — fetch stops, assignment and
  ledger state keep) and resumes at the low-water mark, so a saturated
  fleet holds a bounded queue instead of buffering the topic into memory.

Time is injectable (``clock``) so token-bucket behavior is exactly
testable with a fake clock; the default is ``time.monotonic``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Mapping

from torchkafka_tpu_torch.source.records import Record, TopicPartition

INTERACTIVE = "interactive"
BATCH = "batch"


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec refill up to ``burst``
    capacity; ``try_acquire`` never blocks (a throttled record stays in
    its admission queue). Thread-safe for the threaded-fleet case."""

    def __init__(
        self, rate: float, burst: float | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/sec, got {rate}")
        self._rate = float(rate)
        self._burst = float(burst) if burst is not None else max(1.0, rate)
        if self._burst < 1.0:
            raise ValueError(f"burst must allow at least one token, got {burst}")
        self._clock = clock
        self._tokens = self._burst  # start full: a fresh tenant is not in debt
        self._t = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self._burst, self._tokens + (now - self._t) * self._rate
            )
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


def default_tenant(record: Record) -> str:
    """Tenant = the record key (Kafka's partitioning identity); keyless
    records pool under one anonymous tenant."""
    if record.key is None:
        return "anon"
    try:
        return record.key.decode("utf-8")
    except UnicodeDecodeError:
        return record.key.hex()


def default_lane(record: Record) -> str:
    """Lane from the ``lane`` record header (``b"interactive"`` wins);
    everything else is batch — unclassified traffic must not preempt."""
    for k, v in record.headers:
        if k == "lane":
            return INTERACTIVE if v == b"interactive" else BATCH
    return BATCH


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    """Admission policy for a serving fleet.

    ``tenant_rates``: prompts/sec per tenant; a missing tenant falls back
    to ``default_rate`` (None = unlimited). ``burst``: bucket capacity
    (None = max(1, rate)). ``max_queue_depth``/``resume_queue_depth``:
    per-replica backpressure high/low water marks (records queued beyond
    the slot pool)."""

    tenant_rates: Mapping[str, float] = dataclasses.field(default_factory=dict)
    default_rate: float | None = None
    burst: float | None = None
    tenant_of: Callable[[Record], str] = default_tenant
    lane_of: Callable[[Record], str] = default_lane
    max_queue_depth: int = 256
    resume_queue_depth: int = 64

    def __post_init__(self) -> None:
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if not 0 <= self.resume_queue_depth <= self.max_queue_depth:
            raise ValueError(
                "resume_queue_depth must sit in [0, max_queue_depth]"
            )


class TenantBuckets:
    """Fleet-shared per-tenant buckets (the rate is a TENANT's budget, not
    a per-replica one — replicas draw from the same bucket)."""

    def __init__(
        self, cfg: QoSConfig, clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._cfg = cfg
        self._clock = clock
        self._buckets: dict[str, TokenBucket | None] = {}
        self._lock = threading.Lock()

    def try_acquire(self, tenant: str) -> bool:
        with self._lock:
            if tenant not in self._buckets:
                rate = self._cfg.tenant_rates.get(tenant, self._cfg.default_rate)
                self._buckets[tenant] = (
                    None if rate is None
                    else TokenBucket(rate, self._cfg.burst, self._clock)
                )
            bucket = self._buckets[tenant]
        return True if bucket is None else bucket.try_acquire()


class AdmissionQueue:
    """One replica's lane/tenant-partitioned admission queue.

    ``push`` classifies and enqueues; ``select(n)`` pops up to ``n``
    admissible records — interactive lane fully first, tenants
    round-robin within a lane, each pop gated by the tenant's (shared)
    token bucket. Records denied by their bucket stay queued in order.
    """

    def __init__(
        self,
        cfg: QoSConfig,
        buckets: TenantBuckets,
        metrics,
        clock: Callable[[], float] = time.monotonic,
        *,
        tracer=None,
        replica: int | None = None,
        overload: Callable[[str, str], bool] | None = None,
        on_overload_defer: Callable[[str, int], None] | None = None,
        prefill_router: Callable[[Record], bool] | None = None,
    ) -> None:
        self._cfg = cfg
        self._buckets = buckets
        self._metrics = metrics
        self._clock = clock
        # Lifecycle tracing (obs.RecordTracer): a pop from this queue is
        # the record's qos_admitted stage boundary; ``replica`` tags it.
        self._tracer = tracer
        self._replica = replica
        # Burn-rate overload hook (obs.BurnRateMonitor.should_defer):
        # ``overload(lane, tenant) -> True`` leaves that tenant's records
        # QUEUED this sweep (deferral, never a drop — the watermark
        # stalls below them exactly like a bucket throttle), so a
        # shedding fleet sheds the batch lane instead of collapsing the
        # interactive SLO with it. ``on_overload_defer(tenant, n)``
        # reports each deferral decision for goodput accounting.
        self._overload = overload
        self._on_overload_defer = on_overload_defer
        # Disaggregated-prefill routing (fleet/prefill.py PrefillRouter
        # .should_hold): the shedding hook re-aimed as a ROUTING
        # decision — ``prefill_router(record) -> True`` keeps the
        # tenant's head-of-line record QUEUED this sweep because its
        # filled-KV handoff is still in flight from a prefill worker;
        # the router releases it on handoff arrival (adoption) or when
        # its patience expires (local-prefill fallback). Hold, never
        # drop: the watermark stalls below held records exactly like
        # throttles and burn deferrals.
        self._prefill_router = prefill_router
        # lane -> tenant -> deque[(record, enqueue_time)]
        self._q: dict[str, dict[str, deque]] = {INTERACTIVE: {}, BATCH: {}}
        self._rr: dict[str, int] = {INTERACTIVE: 0, BATCH: 0}
        self._depth = 0

    def push(self, record: Record) -> None:
        lane = self._cfg.lane_of(record)
        lane = lane if lane in self._q else BATCH
        tenant = self._cfg.tenant_of(record)
        self._q[lane].setdefault(tenant, deque()).append(
            (record, self._clock())
        )
        self._depth += 1
        self._metrics.tenant_queue_depth(tenant).set(
            self.tenant_depth(tenant)
        )

    def depth(self) -> int:
        return self._depth

    def queued(self) -> set:
        """(partition, offset) of every queued record."""
        return {(r.tp, r.offset) for lanes in self._q.values()
                for q in lanes.values() for r, _t in q}

    def tenant_depth(self, tenant: str) -> int:
        return sum(
            len(lane.get(tenant, ())) for lane in self._q.values()
        )

    def prune(self, assigned: set[TopicPartition]) -> int:
        """Drop queued records whose partition this replica no longer owns
        (rebalance took it): their NEW owner re-serves them from the
        committed offset — serving a stale copy here would be pure
        duplicate work behind a commit that can only fail. Returns the
        number dropped from the queue (not from the stream: they remain
        pending in the ledger until the failed-commit partitions age out,
        which is harmless — commits for unowned partitions are rejected
        broker-side)."""
        dropped = 0
        for lanes in self._q.values():
            for tenant, q in lanes.items():
                keep = deque(
                    (r, t) for r, t in q if r.tp in assigned
                )
                dropped += len(q) - len(keep)
                lanes[tenant] = keep
        self._depth -= dropped
        return dropped

    def select(self, n: int) -> list[Record]:
        """Up to ``n`` admissible records, interactive-first, tenant
        round-robin, bucket-gated. Observes lane queue-wait and per-tenant
        admit/throttle counters on the fleet metrics."""
        out: list[Record] = []
        now = self._clock()
        for lane in (INTERACTIVE, BATCH):
            lanes = self._q[lane]
            while len(out) < n:
                tenants = [t for t, q in lanes.items() if q]
                if not tenants:
                    break
                start = self._rr[lane] % len(tenants)
                order = tenants[start:] + tenants[:start]
                self._rr[lane] += 1
                progressed = False
                for tenant in order:
                    if len(out) >= n:
                        break
                    q = lanes[tenant]
                    if not q:
                        continue
                    if self._overload is not None and self._overload(
                        lane, tenant
                    ):
                        # Burn-rate shedding: defer (stay queued, one
                        # decision counted per tenant per sweep, like
                        # throttles) rather than admit into an already-
                        # burning SLO or drop the record.
                        self._metrics.tenant_deferred(tenant).add(1)
                        if self._on_overload_defer is not None:
                            self._on_overload_defer(tenant, 1)
                        continue
                    if self._prefill_router is not None and \
                            self._prefill_router(q[0][0]):
                        # Handoff still in flight: the tenant's FIFO
                        # head waits for its prefill worker (admitting
                        # records BEHIND it would break per-partition
                        # FIFO, so the whole tenant queue holds).
                        continue
                    if not self._buckets.try_acquire(tenant):
                        # Out of tokens: the record stays queued (and the
                        # watermark stalled below it). One throttle event
                        # per denied tenant per sweep, not per record —
                        # the counter measures throttle DECISIONS.
                        self._metrics.tenant_throttled(tenant).add(1)
                        continue
                    rec, t_enq = q.popleft()
                    self._depth -= 1
                    self._metrics.tenant_admitted(tenant).add(1)
                    self._metrics.tenant_queue_depth(tenant).set(
                        self.tenant_depth(tenant)
                    )
                    self._metrics.lane_wait(lane).observe(max(0.0, now - t_enq))
                    if self._tracer is not None:
                        self._tracer.qos_admitted(
                            rec, lane, max(0.0, now - t_enq),
                            replica=self._replica,
                        )
                    out.append(rec)
                    progressed = True
                if not progressed:
                    break
        return out

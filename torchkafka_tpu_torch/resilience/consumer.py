"""ResilientConsumer: the transport hardened against transient faults.

A ``Consumer`` wrapper (the same duck-typed protocol ``ChaosConsumer``
wraps, source/chaos.py) that makes the two broker round-trips on the hot
path — ``poll`` and ``commit`` — survive the faults a production broker
actually throws: connection resets, request timeouts, leadership
elections, whole-broker outages. Everything else (seek, pause, lag,
assignment, close) forwards verbatim; those are control-plane calls whose
failures the caller should see.

Degradation ladder (policy.py + breaker.py do the deciding):

1. **Retry** — a retryable fault (errors.py classification) inside
   ``poll``/``commit`` is retried with full-jitter backoff until the
   policy's attempt or deadline budget runs out. Safe because both
   operations are idempotent: polls re-fetch from the consumer position,
   commits carry absolute next-read offsets.
2. **Degrade** — a poll that exhausts its budget returns ``[]`` (exactly
   what a slow broker looks like), so ``KafkaStream`` idles and the
   serving fleet keeps ticking in-flight generation slots instead of
   crashing; a commit that exhausts its budget raises
   ``CommitFailedError`` — the one failure every commit caller already
   treats as survivable (the reference's contract,
   the reference's src/kafka_dataset.py:131-135): nothing was committed,
   the records re-deliver.
3. **Break** — after ``failure_threshold`` consecutive faults the
   circuit opens: polls and commits fail fast locally (no broker I/O,
   counted as *suppressed*) until the cooldown elapses, then a half-open
   probe decides recovery. While open, the consumer is a clean "no data,
   no commits" citizen — the invariant holder, because an uncommitted
   watermark can only ever cause re-delivery, never loss.

Terminal errors (``ConsumerClosedError``, ``NotAssignedError``, a genuine
rebalance ``CommitFailedError``) propagate untouched on the first throw —
retrying them is at best useless and at worst hides a bug.

Everything is observable through ``metrics`` (utils/metrics.py
``ResilienceMetrics``: retries, faults, degraded/suppressed ops, circuit
transitions + state gauge) and deterministic under test: inject a seeded
policy and a ``ManualClock`` and the whole retry/break/probe schedule
replays exactly.
"""

from __future__ import annotations

import logging
from typing import Mapping

from torchkafka_tpu_torch.errors import CommitFailedError
from torchkafka_tpu_torch.resilience.breaker import OPEN, CircuitBreaker
from torchkafka_tpu_torch.resilience.policy import RetryPolicy
from torchkafka_tpu_torch.source.consumer import Consumer, ConsumerIterMixin
from torchkafka_tpu_torch.source.records import Record, TopicPartition
from torchkafka_tpu_torch.utils.metrics import ResilienceMetrics

_logger = logging.getLogger(__name__)


class ResilientConsumer(ConsumerIterMixin):
    """Wrap any Consumer with retry/backoff, circuit breaking, and
    degraded modes on the poll/commit hot path.

    ``policy``: a RetryPolicy (default: 6 attempts, 50ms base full-jitter
    backoff capped at 2s, 30s per-operation deadline, retrying
    ``BrokerUnavailableError`` and anything self-declared retryable).
    ``breaker``: a CircuitBreaker (default: opens after 5 consecutive
    faults, 30s cooldown, 1 half-open probe) — constructed on the
    policy's clock so one ManualClock drives the whole stack in tests.
    """

    def __init__(
        self,
        inner: Consumer,
        *,
        policy: RetryPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        metrics: ResilienceMetrics | None = None,
    ) -> None:
        self._inner = inner
        self._policy = policy or RetryPolicy()
        self._breaker = breaker or CircuitBreaker(clock=self._policy.clock)
        self.metrics = metrics or ResilienceMetrics()
        # Last breaker state mirrored into metrics — plain attrs, so the
        # per-op happy path compares ints instead of taking RateMeter
        # locks (this sync runs on EVERY poll/commit; measured in
        # benchmarks/bench_pod.py --overhead).
        self._seen_opens = 0
        self._seen_closes = 0
        self._seen_state = 0.0

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def _sync_breaker_metrics(self) -> None:
        """Mirror the breaker's transition counters + state gauge into the
        metrics set, so a snapshot alone proves open-then-closed."""
        b, m = self._breaker, self.metrics
        # Unlocked int reads are safe here: opens/closes only grow, and a
        # missed increment is picked up on the next op's sync.
        d = b.opens - self._seen_opens
        if d > 0:
            self._seen_opens = b.opens
            m.circuit_opens.add(d)
            _logger.warning(
                "circuit OPEN after consecutive transport faults; "
                "degrading (empty polls, fast-failed commits)"
            )
        d = b.closes - self._seen_closes
        if d > 0:
            self._seen_closes = b.closes
            m.circuit_closes.add(d)
            _logger.info("circuit CLOSED: broker recovered")
        code = b.state_code
        if code != self._seen_state:
            self._seen_state = code
            m.circuit_state.set(code)

    # -------------------------------------------------------------- hot path

    def poll(self, max_records: int = 500, timeout_ms: int = 0) -> list[Record]:
        if not self._breaker.allow():
            self.metrics.suppressed_polls.add(1)
            self._sync_breaker_metrics()
            return []
        policy = self._policy
        start = policy.clock()
        attempt = 0
        while True:
            try:
                records = self._inner.poll(
                    max_records=max_records, timeout_ms=timeout_ms
                )
            except BaseException as exc:  # noqa: BLE001 - classified below
                if not policy.classify(exc):
                    # Terminal (closed consumer, protocol errors, bugs): not
                    # a transport fault, so it must not feed outage
                    # detection — and it must RESOLVE an in-flight half-open
                    # probe, or the breaker would wedge with a probe slot
                    # forever occupied.
                    self._breaker.record_success()
                    raise
                self.metrics.poll_faults.add(1)
                self._breaker.record_failure()
                attempt += 1
                delay = policy.backoff_s(attempt - 1)
                if (
                    self._breaker.state == OPEN
                    or attempt >= policy.max_attempts
                    or (
                        policy.deadline_s is not None
                        and (policy.clock() - start) + delay
                        >= policy.deadline_s
                    )
                ):
                    # Degrade, don't crash: an empty poll is exactly what a
                    # slow broker looks like — streams idle, fleets keep
                    # ticking in-flight slots, the watermark stays put.
                    self.metrics.degraded_polls.add(1)
                    self._sync_breaker_metrics()
                    return []
                self.metrics.retries.add(1)
                policy.sleep(delay)
                continue
            self._breaker.record_success()
            self._sync_breaker_metrics()
            return records

    def commit(self, offsets: Mapping[TopicPartition, int] | None = None) -> None:
        if not self._breaker.allow():
            self.metrics.suppressed_commits.add(1)
            self._sync_breaker_metrics()
            # The survivable spelling of "not now": nothing was committed,
            # every caller already treats this as re-delivery, and the
            # broker gets zero load while the circuit is open.
            raise CommitFailedError(
                "circuit open (broker outage declared): commit fast-failed "
                "without committing; offsets stay uncommitted and re-deliver"
            )
        policy = self._policy
        start = policy.clock()
        attempt = 0
        while True:
            try:
                self._inner.commit(offsets)
            except BaseException as exc:  # noqa: BLE001 - classified below
                if not policy.classify(exc):
                    # Incl. a genuine rebalance CommitFailedError: the
                    # broker RESPONDED (protocol rejection, not transport
                    # fault) — resolve any probe, don't count an outage.
                    self._breaker.record_success()
                    raise
                self.metrics.commit_faults.add(1)
                self._breaker.record_failure()
                attempt += 1
                delay = policy.backoff_s(attempt - 1)
                if (
                    self._breaker.state == OPEN
                    or attempt >= policy.max_attempts
                    or (
                        policy.deadline_s is not None
                        and (policy.clock() - start) + delay
                        >= policy.deadline_s
                    )
                ):
                    self._sync_breaker_metrics()
                    raise CommitFailedError(
                        "retry budget exhausted committing through a broker "
                        "fault; offsets stay uncommitted and re-deliver"
                    ) from exc
                self.metrics.retries.add(1)
                policy.sleep(delay)
                continue
            self._breaker.record_success()
            self._sync_breaker_metrics()
            return

    # --------------------------------------------- control plane: forwarded

    def committed(self, tp: TopicPartition) -> int | None:
        return self._inner.committed(tp)

    def position(self, tp: TopicPartition) -> int:
        return self._inner.position(tp)

    def seek(self, tp: TopicPartition, offset: int) -> None:
        self._inner.seek(tp, offset)

    def assignment(self):
        return self._inner.assignment()

    def offsets_for_times(self, times):
        return self._inner.offsets_for_times(times)

    def end_offsets(self, tps):
        return self._inner.end_offsets(tps)

    def lag(self):
        return self._inner.lag()

    def pause(self, *tps: TopicPartition) -> None:
        self._inner.pause(*tps)

    def resume(self, *tps: TopicPartition) -> None:
        self._inner.resume(*tps)

    def paused(self):
        return self._inner.paused()

    def has_paused(self) -> bool:
        fn = getattr(self._inner, "has_paused", None)
        return bool(self._inner.paused()) if fn is None else fn()

    def close(self) -> None:
        self._inner.close()

    def heartbeat(self):
        """Forward the lease renewal verbatim (transport retry lives in
        the inner client; a FencedMemberError must surface untouched —
        retrying a fenced member's heartbeat is a zombie's hope)."""
        fn = getattr(self._inner, "heartbeat", None)
        return None if fn is None else fn()

    # Group metadata (transactional offset commits present it so the
    # broker fences them generation-checked): forwarded where the inner
    # transport has it, None where it does not.

    @property
    def group_id(self):
        return getattr(self._inner, "group_id", None)

    @property
    def member_id(self):
        return getattr(self._inner, "member_id", None)

    @property
    def generation(self):
        return getattr(self._inner, "generation", None)

    # Iteration via ConsumerIterMixin over SELF.poll so the record-at-a-time
    # loop shape rides the resilient path too (same pattern as ChaosConsumer:
    # delegating to iter(inner) would bypass every retry).

    @property
    def _closed(self) -> bool:
        return bool(getattr(self._inner, "_closed", False))

    @property
    def _consumer_timeout_ms(self):
        return getattr(self._inner, "_consumer_timeout_ms", None)

    @property
    def _last_yielded(self):
        return getattr(self._inner, "_last_yielded", None)

"""Deterministic fault injection over any Consumer/Producer — chaos for tests.

The reference's failure story is implicit (SURVEY.md §5: recovery IS the
consumer-group protocol) and it ships no way to exercise it. This wrapper
makes failure a first-class test input: wrap any transport and inject
commit failures, transient empty polls, poll latency, broker-outage
windows, and record corruption — all driven by seeded RNGs, so a failing
fuzz case replays exactly.

    chaos = ChaosConsumer(consumer, seed=7, commit_failure_rate=0.3)
    # stream/commit code runs unchanged; ~30% of commits raise
    # CommitFailedError exactly as a rebalancing broker would.

Determinism is per FAULT TYPE: each fault mode draws from its own RNG
stream, derived from the root seed via ``np.random.SeedSequence`` spawn
keys. That independence is load-bearing for replayable fuzzing — with the
old single shared RNG, adding any new fault mode (or enabling a second
one) consumed draws from the one stream and silently reshuffled the fault
schedule of every existing seed. Now ``seed=7``'s commit-failure schedule
is identical whether or not corruption is also enabled, and future fault
modes append new streams without disturbing these.

The invariants under chaos are the framework's core contract: commit
failures are survivable (the reference swallows CommitFailedError,
the reference's src/kafka_dataset.py:131-135), no record is lost, the
committed watermark never overtakes what was actually processed — and,
with the resilience layer on top (torchkafka_tpu_torch/resilience), outages
degrade instead of crash and poison records exit to a DLQ.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Collection, Mapping, Sequence

import numpy as np

from torchkafka_tpu_torch.errors import (
    BrokerUnavailableError,
    CommitFailedError,
    OutputDeliveryError,
)
from torchkafka_tpu_torch.source.consumer import Consumer, ConsumerIterMixin
from torchkafka_tpu_torch.source.records import Record, TopicPartition

# Registry of per-fault-type RNG streams. ORDER IS FROZEN: stream k is
# derived from spawn key (k,), so appending new fault types preserves
# every existing stream; reordering or inserting would reshuffle replay
# schedules for all existing seeds. Append only.
_FAULT_STREAMS = (
    "commit_failure",  # 0: commit -> CommitFailedError
    "poll_empty",      # 1: poll -> [] despite available records
    "poll_delay",      # 2: poll latency
    "outage",          # 3: broker-outage window start/duration draws
    "send_failure",    # 4: producer send raises (transient)
    "delivery_failure",  # 5: producer handle.get raises (terminal, record lost)
)


def fault_rngs(seed: int) -> dict[str, np.random.Generator]:
    """One independent, deterministic RNG per fault type, derived from the
    root seed (SeedSequence spawn keys — the documented mechanism for
    non-overlapping child streams)."""
    root = np.random.SeedSequence(seed)
    children = root.spawn(len(_FAULT_STREAMS))
    return {
        name: np.random.default_rng(child)
        for name, child in zip(_FAULT_STREAMS, children)
    }


class ChaosConsumer(ConsumerIterMixin):
    """Wraps a Consumer; forwards everything, injecting faults on the way.

    Parameters
    ----------
    commit_failure_rate: probability a ``commit`` raises CommitFailedError
        WITHOUT committing (the broker-rebalanced case — offsets stay
        uncommitted, records re-deliver on restart).
    poll_empty_rate: probability a ``poll`` returns [] despite available
        records (transient fetch hiccup).
    poll_delay_ms: (lo, hi) uniform latency added to every poll — models a
        slow/jittery broker link.
    outages: explicit broker-outage windows as ``(start_op, n_ops)``
        pairs, measured in this consumer's poll+commit call count (the
        deterministic unit — wall time would make replay depend on host
        speed). While an op falls inside a window, poll AND commit raise
        ``BrokerUnavailableError`` — the retryable transport fault the
        resilience layer absorbs.
    outage_rate / outage_ops: seeded outage schedule — each op outside a
        window starts one with probability ``outage_rate``, lasting
        uniform-integer ``outage_ops=(lo, hi)`` ops. Actual windows are
        recorded in ``outage_log`` for replay assertions.
    corrupt_rate: probability a polled record's VALUE is replaced with
        garbage. The draw is a pure function of (seed, topic, partition,
        offset) — NOT of poll order — so a corrupted record re-delivers
        corrupted, exactly like a genuinely poisoned payload on a real
        log (the property the quarantine's retry budget is tested
        against). Corrupted keys are recorded in ``corrupted``.
    corrupt_offsets: explicit poison set of ``(topic, partition, offset)``
        tuples — corrupt exactly these, no RNG involved.
    seed: the determinism handle; same seed → same fault schedule, per
        fault type independently.
    """

    def __init__(
        self,
        inner: Consumer,
        *,
        seed: int = 0,
        commit_failure_rate: float = 0.0,
        poll_empty_rate: float = 0.0,
        poll_delay_ms: tuple[float, float] = (0.0, 0.0),
        outages: Sequence[tuple[int, int]] = (),
        outage_rate: float = 0.0,
        outage_ops: tuple[int, int] = (4, 16),
        corrupt_rate: float = 0.0,
        corrupt_offsets: Collection[tuple[str, int, int]] = (),
    ) -> None:
        for name, rate in (
            ("commit_failure_rate", commit_failure_rate),
            ("poll_empty_rate", poll_empty_rate),
            ("outage_rate", outage_rate),
            ("corrupt_rate", corrupt_rate),
        ):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        if outage_ops[0] < 1 or outage_ops[1] < outage_ops[0]:
            raise ValueError(
                f"outage_ops must be 1 <= lo <= hi, got {outage_ops}"
            )
        for start, n in outages:
            if start < 0 or n < 1:
                raise ValueError(
                    f"outage windows need start >= 0, n_ops >= 1, got "
                    f"({start}, {n})"
                )
        self._inner = inner
        self._seed = seed
        self._rngs = fault_rngs(seed)
        self._commit_failure_rate = commit_failure_rate
        self._poll_empty_rate = poll_empty_rate
        self._poll_delay_ms = poll_delay_ms
        self._outages = tuple(outages)
        self._outage_rate = outage_rate
        self._outage_ops = outage_ops
        self._corrupt_rate = corrupt_rate
        self._corrupt_offsets = set(corrupt_offsets)
        self._op = 0  # poll+commit call counter: the outage timeline
        self._outage_until: int | None = None  # seeded window end (exclusive)
        self.injected_commit_failures = 0
        self.injected_empty_polls = 0
        self.injected_outage_faults = 0
        self.injected_corruptions = 0
        #: Seeded windows actually started, as (start_op, n_ops) — compare
        #: across runs to prove same-seed schedule replay.
        self.outage_log: list[tuple[int, int]] = []
        #: Every (topic, partition, offset) whose value was corrupted.
        self.corrupted: set[tuple[str, int, int]] = set()

    # ------------------------------------------------------------- outages

    def _outage_check(self) -> None:
        """Advance the op clock; raise if this op falls in an outage."""
        op = self._op
        self._op += 1
        for start, n in self._outages:
            if start <= op < start + n:
                self.injected_outage_faults += 1
                raise BrokerUnavailableError(
                    f"injected fault: broker outage (op {op} in explicit "
                    f"window [{start}, {start + n}))"
                )
        if self._outage_until is not None:
            if op < self._outage_until:
                self.injected_outage_faults += 1
                raise BrokerUnavailableError(
                    f"injected fault: broker outage (op {op} < "
                    f"{self._outage_until})"
                )
            self._outage_until = None
        if self._outage_rate and self._rngs["outage"].random() < self._outage_rate:
            lo, hi = self._outage_ops
            n = int(self._rngs["outage"].integers(lo, hi + 1))
            self._outage_until = op + n  # this op is the window's first
            self.outage_log.append((op, n))
            self.injected_outage_faults += 1
            raise BrokerUnavailableError(
                f"injected fault: broker outage starting at op {op} "
                f"for {n} ops"
            )

    # ---------------------------------------------------------- corruption

    def _is_corrupt(self, rec: Record) -> bool:
        key = (rec.topic, rec.partition, rec.offset)
        if key in self._corrupt_offsets:
            return True
        if not self._corrupt_rate:
            return False
        # Derived per-record stream: a pure function of (seed, record
        # identity). Poll order, redelivery, and other fault draws cannot
        # change whether THIS record is poisoned — like a real bad payload.
        draw = np.random.default_rng(
            (self._seed, 0xC0FFEE, zlib.crc32(rec.topic.encode()),
             rec.partition, rec.offset)
        ).random()
        return draw < self._corrupt_rate

    def _maybe_corrupt(self, rec: Record) -> Record:
        if not (self._corrupt_rate or self._corrupt_offsets):
            return rec
        if not self._is_corrupt(rec):
            return rec
        self.injected_corruptions += 1
        self.corrupted.add((rec.topic, rec.partition, rec.offset))
        # Deterministic garbage with a WRONG length: breaks fixed-width
        # decoders and length-prefixed schemas alike, identically on every
        # redelivery.
        garbled = b"\xde\xad" + rec.value[: max(0, len(rec.value) // 2)]
        return dataclasses.replace(rec, value=garbled)

    # ---------------------------------------------------------------- api

    def poll(self, max_records: int = 500, timeout_ms: int = 0) -> list[Record]:
        self._outage_check()
        lo, hi = self._poll_delay_ms
        if hi > 0:
            time.sleep(self._rngs["poll_delay"].uniform(lo, hi) / 1e3)
        if (
            self._poll_empty_rate
            and self._rngs["poll_empty"].random() < self._poll_empty_rate
        ):
            self.injected_empty_polls += 1
            return []
        records = self._inner.poll(max_records=max_records, timeout_ms=timeout_ms)
        if self._corrupt_rate or self._corrupt_offsets:
            records = [self._maybe_corrupt(r) for r in records]
        return records

    def commit(self, offsets: Mapping[TopicPartition, int] | None = None) -> None:
        self._outage_check()
        if (
            self._commit_failure_rate
            and self._rngs["commit_failure"].random() < self._commit_failure_rate
        ):
            self.injected_commit_failures += 1
            # Fail WITHOUT committing: exactly what a generation-bumped
            # broker does — the offsets stay wherever they were.
            raise CommitFailedError("injected fault: group rebalanced")
        self._inner.commit(offsets)

    # Everything else is the inner transport's business.
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
        # The fast-path hint is optional on duck-typed consumers — don't
        # turn its absence on the inner into a crash.
        fn = getattr(self._inner, "has_paused", None)
        return bool(self._inner.paused()) if fn is None else fn()

    def close(self) -> None:
        self._inner.close()

    # Iteration comes from ConsumerIterMixin over SELF.poll, so the
    # record-at-a-time path (the reference's canonical loop shape) goes
    # through the fault injector too — delegating to iter(inner) would
    # silently bypass every fault. The mixin's state hooks proxy to the
    # inner transport so closed/timeout/yield-position semantics match.

    @property
    def _closed(self) -> bool:
        return bool(getattr(self._inner, "_closed", False))

    @property
    def _consumer_timeout_ms(self):
        return getattr(self._inner, "_consumer_timeout_ms", None)

    @property
    def _last_yielded(self):
        return getattr(self._inner, "_last_yielded", None)


@dataclasses.dataclass(frozen=True, slots=True)
class _DoomedSend:
    """A send handle whose record was LOST in flight: get() raises, and
    the record was never appended (unlike a real slow failure, there is
    deliberately nothing to recover — the test point is the caller's
    fail-stop discipline)."""

    reason: str

    def get(self, timeout_s: float | None = None):
        raise OutputDeliveryError(self.reason)


class ChaosProducer:
    """Seeded delivery-fault injection over any Producer.

    - ``send_failure_rate``: ``send`` itself raises
      ``BrokerUnavailableError`` (transient: buffer full against an
      unreachable broker). Nothing was enqueued; the caller's
      leave-uncommitted-and-continue path (serve.py's per-record send
      guard) is what this exercises.
    - ``delivery_failure_rate``: ``send`` returns a handle whose
      ``get()`` raises ``OutputDeliveryError`` and the record is NOT
      produced (terminal: too large, authorization, retries exhausted
      broker-side). This is the fail-stop path — flush/get must refuse
      to commit source offsets past the lost output.

    Independent per-fault RNG streams from the shared registry
    (``fault_rngs``), so producer chaos composes with consumer chaos on
    the same root seed without either reshuffling the other.
    """

    def __init__(
        self,
        inner,
        *,
        seed: int = 0,
        send_failure_rate: float = 0.0,
        delivery_failure_rate: float = 0.0,
    ) -> None:
        for name, rate in (
            ("send_failure_rate", send_failure_rate),
            ("delivery_failure_rate", delivery_failure_rate),
        ):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self._inner = inner
        self._rngs = fault_rngs(seed)
        self._send_failure_rate = send_failure_rate
        self._delivery_failure_rate = delivery_failure_rate
        self.injected_send_failures = 0
        self.injected_delivery_failures = 0

    def send(self, topic, value, **kw):
        if (
            self._send_failure_rate
            and self._rngs["send_failure"].random() < self._send_failure_rate
        ):
            self.injected_send_failures += 1
            raise BrokerUnavailableError(
                "injected fault: producer buffer full, broker unreachable"
            )
        if (
            self._delivery_failure_rate
            and self._rngs["delivery_failure"].random()
            < self._delivery_failure_rate
        ):
            self.injected_delivery_failures += 1
            return _DoomedSend(
                "injected fault: record terminally failed delivery "
                "(never appended)"
            )
        return self._inner.send(topic, value, **kw)

    def flush(self, timeout_s: float | None = None) -> None:
        self._inner.flush(timeout_s)

    def close(self) -> None:
        self._inner.close()

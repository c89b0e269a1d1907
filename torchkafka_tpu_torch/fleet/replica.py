"""One serving replica: a generator + a group-managed consumer + QoS queue.

Copy of ``torchkafka_tpu/fleet/replica.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

A replica is the fleet's unit of failure and of scale. It owns:

- a **group-managed consumer** over the prompt topic — membership is what
  spreads partitions across the fleet and what makes replica death
  recoverable (leave → rebalance → the committed-offset resume point, the
  exact machinery tests/test_pod.py proves for training ingest);
- a **generator** (``StreamingGenerator`` or ``SpecStreamingGenerator``)
  driven through the external-admission surface
  (note_fetched/admit_records/step/flush_commits), never its internal
  poll loop;
- an **admission queue** (fleet/qos.py) between the two.

``pump()`` is one cooperative scheduling quantum: sync assignment, poll,
enqueue, backpressure, bucket-gated admit, one device tick block. It
returns the completions the tick retired and NEVER commits — the fleet
calls ``maybe_flush()`` after it has registered those completions, so the
commit-follows-completion ordering is externally observable (and
assertable) at every commit point.

Lifecycle: ``serving`` → (``start_drain()``) → ``draining`` →
(``finish_drain()``) → ``done``; or ``kill()`` → ``dead`` at any point —
the crash simulation: leave the group WITHOUT committing, abandoning
in-flight slots and queue, exactly what a SIGKILL'd process looks like to
the broker once its session lapses.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np

from torchkafka_tpu_torch.errors import NotAssignedError
from torchkafka_tpu_torch.fleet.qos import AdmissionQueue, QoSConfig
from torchkafka_tpu_torch.source.records import Record

_logger = logging.getLogger(__name__)

SERVING = "serving"
DRAINING = "draining"
DONE = "done"
DEAD = "dead"


class Replica:
    def __init__(
        self,
        rid: int,
        generator,
        consumer,
        queue: AdmissionQueue,
        qos: QoSConfig,
        metrics,
        *,
        commit_every: int = 8,
        max_poll_records: int = 256,
        clock: Callable[[], float] = time.monotonic,
        drop_refetched: bool = False,
    ) -> None:
        self.id = rid
        # Drop a polled record that is still queued here (a kept
        # partition fetched again after a rebalance). Off by default: the
        # JAX package's replica serves both copies, and the in-process
        # fleet keeps its behaviour; the process worker turns it on.
        self._drop_refetched = drop_refetched
        self.gen = generator
        self.consumer = consumer
        self.queue = queue
        self._qos = qos
        self._metrics = metrics
        self._commit_every = commit_every
        self._max_poll = max_poll_records
        self._clock = clock
        self.state = SERVING
        self._since_commit = 0
        self._retry_flush = False  # a survivably-failed flush awaits retry
        self._assigned: frozenset = frozenset()
        # Admission pause (the rollout drain-swap's quiesce): while set,
        # pump() neither polls nor admits — in-flight slots finish
        # through further ticks — but the member STAYS in the group
        # (assignment sync and heartbeats continue), unlike a drain,
        # which leaves. That difference is the whole point: a weight
        # swap must not cost a rebalance.
        self._admission_paused = False

    # ----------------------------------------------------------- lifecycle

    @property
    def runnable(self) -> bool:
        return self.state in (SERVING, DRAINING)

    def start_drain(self) -> None:
        """Stop admitting; in-flight slots finish through further pumps.
        Queued-but-unadmitted records are abandoned UNCOMMITTED — they
        re-deliver to the next incarnation, the loss-free half of the
        drain contract (the replay-free half is finish_drain's commit)."""
        if self.state == SERVING:
            self.state = DRAINING

    @property
    def drain_idle(self) -> bool:
        """Draining and every in-flight generation has retired."""
        return self.state == DRAINING and not self.gen.has_active()

    def finish_drain(self) -> None:
        """Commit everything completed, then leave the group. After this,
        a restarted fleet resumes at the committed watermark with ZERO
        replayed completions (drain acceptance contract). The decode
        journal is synced (flush + fsync) before the consumer leaves:
        a clean drain retires everything so the journal is empty-pruned,
        but a SECOND signal racing this path must still find the disk
        state current.

        The final flush RETRIES on survivable failure: in a fleet-wide
        drain a peer's clean leave bumps the group generation, and a
        replica whose last commit races that rebalance gets
        CommitFailedError — one-shot flushing here would exit rc=0 with
        finished completions stranded uncommitted (replayed on restart,
        LOST if the fleet is retiring for good). flush_commits keeps the
        outbox/cadence intact on failure and the next attempt re-syncs
        the group (assignment() adopts the post-rebalance generation),
        so a bounded retry loop converges; past the budget we fall back
        to the loss-free half of the contract (re-delivery)."""
        deadline = time.monotonic() + 15.0
        while not self.gen.flush_commits():
            if time.monotonic() > deadline:
                _logger.warning(
                    "replica %d drain flush still failing at deadline; "
                    "leaving the tail to re-delivery", self.id,
                )
                break
            time.sleep(0.05)
        self.gen.sync_journal()
        self.consumer.close()
        self.state = DONE

    def pause_admission(self) -> None:
        """Quiesce for an in-place operation (weight hot-swap): stop
        POLLING new work without leaving the group. Pumps keep ticking —
        and keep admitting already-fetched (queued) records — so
        everything the ledger holds pending retires; ``quiesced`` turns
        True once it all has. Queued records must DRAIN rather than
        wait: a fetched-but-unadmitted record is ledger-pending, so any
        completion ordered after it is HELD from the committed view
        (exactly-once outbox) — abandoning the queue would leave those
        outputs uncommittable and the swap's closed-commit-window
        precondition unsatisfiable forever."""
        self._admission_paused = True

    def resume_admission(self) -> None:
        self._admission_paused = False

    @property
    def admission_paused(self) -> bool:
        return self._admission_paused

    @property
    def quiesced(self) -> bool:
        """Paused, queue drained, and no generation in flight — the
        state a hot-swap requires (the commit window is the caller's to
        close via ``maybe_flush(force=True)``): nothing fetched is
        unretired, so one forced flush commits an EMPTY pending set and
        the swap sits exactly between commit windows."""
        return (
            self._admission_paused
            and self.queue.depth() == 0
            and not self.gen.has_active()
        )

    def kill(self) -> None:
        """Crash simulation: leave the group with NOTHING committed beyond
        the last cadence commit. In-flight generations and queued records
        vanish; the rebalance hands the partitions to survivors, whose
        polls resume from this replica's last committed offset — its
        uncommitted prompts re-deliver (at-least-once, per prompt, across
        replica failure)."""
        self.state = DEAD
        try:
            # Consumer.close never commits (the reference's close
            # contract) — it only triggers leave/rebalance.
            self.consumer.close()
        except Exception:  # noqa: BLE001 - a dying replica stays dead
            _logger.exception("replica %d consumer close failed", self.id)

    def close(self) -> None:
        """Voluntary shutdown outside a drain: commit completed work and
        leave (mirrors StreamingGenerator.close)."""
        if self.state in (SERVING, DRAINING):
            self.finish_drain()

    # ---------------------------------------------------------------- pump

    def pump(self) -> list[tuple[Record, np.ndarray]]:
        """One scheduling quantum; returns completions (never commits)."""
        if not self.runnable:
            return []
        self._sync_assignment()
        if self.state == SERVING:
            if not self._admission_paused:
                self._poll_into_queue()
                self._backpressure()
            free = self.gen.free_slots()
            # Paged-pool pressure defers admissions inside the generator
            # (StreamingGenerator.pending_admissions); deferred records
            # hold their future slots and re-offer FIRST (per-partition
            # FIFO), so size new QoS picks by the remainder and keep
            # offering while a backlog exists — an empty offer just
            # drains it as blocks free. Always 0 on dense generators.
            deferred = self.gen.pending_admissions
            room = free - deferred
            picks = self.queue.select(room) if room > 0 else []
            if picks or (deferred and free):
                self.gen.admit_records(picks)
        completions = self.gen.step()
        if completions:
            self._since_commit += len(completions)
            self._metrics.replica_completions(self.id).add(len(completions))
        self._metrics.replica_occupancy(self.id).set(
            1.0 - self.gen.free_slots() / max(1, self.gen.slots)
        )
        return completions

    def maybe_flush(self, force: bool = False) -> None:
        """Cadence commit — called by the fleet AFTER it registered the
        completions the last pump returned, so every commit provably
        follows the completions it covers. A flush that FAILS survivably
        (rebalance, broker outage) is retried on every subsequent call
        until it lands: commit-follows-completion counts completions,
        but a replica whose last completions coincided with an outage
        would otherwise idle forever with its tail uncommitted (and, in
        exactly_once mode, its outputs invisible) — found by the
        broker crash-restart drill."""
        if force or self._retry_flush or self._since_commit >= self._commit_every:
            # ``force`` flushes even at zero counted completions: the
            # exactly-once outbox can hold outputs ORDERED AFTER records
            # that completed in an earlier window (flush_commits'
            # outbox-forces-flush contract) — the hot-swap's
            # close-the-window call must reach it, and flush_commits
            # itself is a no-op when truly nothing is pending.
            if force or self._since_commit or self._retry_flush:
                ok = self.gen.flush_commits()
                self._since_commit = 0
                self._retry_flush = ok is False

    # ------------------------------------------------------------ internal

    def _sync_assignment(self) -> None:
        assigned = frozenset(self.consumer.assignment())
        if assigned != self._assigned:
            dropped = self.queue.prune(set(assigned))
            if dropped:
                _logger.info(
                    "replica %d rebalance: pruned %d queued records for "
                    "departed partitions", self.id, dropped,
                )
            departed = self._assigned - assigned
            if departed:
                # Revocation reset: without it, this replica's ledger
                # keeps the pruned records 'pending', and if a departed
                # partition ever RETURNS (a scale-up's range handed
                # back at scale-down) the stale entries would regress
                # the group's committed watermark at the next flush.
                self.gen.note_partitions_revoked(departed)
            self._assigned = assigned

    def _poll_into_queue(self) -> None:
        if self.queue.depth() >= self._qos.max_queue_depth:
            return
        records = self.consumer.poll(
            max_records=min(
                self._max_poll, self._qos.max_queue_depth - self.queue.depth()
            ),
            timeout_ms=0,
        )
        if records and self._drop_refetched and self.queue.depth():
            # An eager rebalance re-resolves every position from the
            # committed offset, so a partition this replica keeps is
            # fetched again from there: a record still waiting in the
            # queue would be queued, and served, twice. The queued copy
            # stays; its completion is the one the ledger awaits.
            queued = self.queue.queued()
            records = [r for r in records if (r.tp, r.offset) not in queued]
        if records:
            # Ledger BEFORE queue: a queued record must already be pending
            # so no later completion can commit past it (see
            # StreamingGenerator.note_fetched).
            self.gen.note_fetched(records)
            for r in records:
                self.queue.push(r)

    def _backpressure(self) -> None:
        """Pause fetches when saturated (slots full + queue at high water),
        resume at low water. Flags live transport-side (consumer.paused),
        so a rebalance — which clears them — self-heals."""
        try:
            if (
                self.gen.free_slots() == 0
                and self.queue.depth() >= self._qos.max_queue_depth
                and not self.consumer.has_paused()
                and self._assigned
            ):
                self.consumer.pause(*self._assigned)
                self._metrics.backpressure_pauses.add(1)
            elif (
                self.consumer.has_paused()
                and self.queue.depth() <= self._qos.resume_queue_depth
            ):
                self.consumer.resume(*self.consumer.paused())
                self._metrics.backpressure_resumes.add(1)
        except NotAssignedError:
            # Raced a rebalance between assignment() and pause(): the new
            # assignment arrives at the next sync; pause flags were
            # cleared transport-side either way.
            pass

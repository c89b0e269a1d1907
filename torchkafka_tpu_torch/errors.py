"""Exception hierarchy for torchkafka_tpu_torch.

The reference surfaces exactly one failure class to users:
``kafka.errors.CommitFailedError``, which it catches and logs as non-fatal
(the reference's src/kafka_dataset.py:131-135) because a failed commit simply
means the records will be re-delivered (at-least-once delivery). We keep that
contract but define our own transport-independent exceptions so the in-memory
broker, the kafka-python adapter, and any future native client all raise the
same types.
"""

from __future__ import annotations


class TpuKafkaError(Exception):
    """Base class for all torchkafka_tpu_torch errors.

    Every error carries a **retryable / terminal** classification via the
    ``retryable`` class attribute — the contract the resilience layer
    (``torchkafka_tpu_torch/resilience``) keys its retry decisions on:

    - ``retryable = True``: a *transient transport fault* — the operation
      itself was sound and repeating it verbatim can succeed once the
      broker recovers (``BrokerUnavailableError``). Safe to retry because
      the affected operations are idempotent: polls re-fetch from the
      consumer position, commits carry absolute next-read offsets.
    - ``retryable = False`` (default): *terminal for that operation* —
      repeating the identical call cannot help. Either the protocol moved
      on (``CommitFailedError`` after a rebalance: the fix is
      re-delivery, not a retry of the stale-generation commit), the
      caller holds a bug (``NotAssignedError``, ``ConsumerClosedError``),
      or the failure is per-payload (``PoisonRecordError``: the record
      itself is bad and will fail identically forever — the escape hatch
      is the dead-letter quarantine, never a retry loop).

    Terminal is not the same as fatal: ``CommitFailedError`` is terminal
    *and survivable* (the watermark stays put and records re-deliver),
    while ``OutputDeliveryError`` is terminal and fail-stop (crash before
    commit).
    """

    retryable: bool = False


class CommitFailedError(TpuKafkaError):
    """Offset commit was rejected (e.g. after a group rebalance).

    Mirrors kafka-python's ``CommitFailedError`` as used by the reference
    (the reference's src/kafka_dataset.py:22,131). Always survivable:
    uncommitted records are re-delivered to whichever consumer now owns the
    partitions, preserving at-least-once semantics.
    """


class ConsumerClosedError(TpuKafkaError):
    """Operation attempted on a closed consumer."""


class NotAssignedError(TpuKafkaError):
    """Commit/seek referenced a partition this consumer does not own."""


class ProducerClosedError(TpuKafkaError):
    """Operation attempted on a closed producer."""


class OutputDeliveryError(TpuKafkaError):
    """A produced output record terminally failed delivery (retries
    exhausted, too large, authorization). Raised instead of committing
    source offsets past the lost output: fail-stop = crash-before-commit,
    so the affected inputs re-deliver and the output regenerates."""


class BrokerUnavailableError(TpuKafkaError):
    """The broker could not be reached (connection refused/reset, request
    timeout, leadership election in progress). RETRYABLE: polls and
    commits are idempotent, so repeating the operation after a backoff is
    always safe — ``ResilientConsumer`` does exactly that, behind a
    circuit breaker so a long outage degrades (empty polls, fast-failed
    commits) instead of hot-looping. ``ChaosConsumer`` raises this during
    injected outage windows."""

    retryable = True


class ProducerFencedError(TpuKafkaError):
    """This transactional producer's EPOCH is stale: another producer
    re-initialized the same ``transactional.id`` (``init_producer_id``
    bumps the epoch, Kafka's KIP-98 fencing), so every transactional
    operation this handle attempts is a zombie's. TERMINAL: the broker
    already aborted the old epoch's in-flight transaction when the new
    incarnation initialized — nothing produced under the stale epoch can
    ever reach the committed view, and retrying the identical call cannot
    help. The only valid responses are to re-initialize (becoming the
    newest incarnation and fencing the OTHER one) or to exit and let a
    supervisor respawn. The producer-side twin of ``FencedMemberError``:
    the lease protocol fences a consumer's commits, the epoch fences a
    producer's transactions, and the process fleet wires the two to the
    same replica identity."""


class StaleEpochError(TpuKafkaError):
    """A replicated WAL frame (or election probe) carried a LEADER epoch
    older than one this replica has already accepted: the sender is a
    DEPOSED leader — an election it never saw bumped the cell epoch — and
    its frame must be rejected, never applied. TERMINAL for the sender:
    the cell moved on, so retrying the identical append cannot help; the
    only valid responses are to step down (rejoin as a follower of the
    new epoch) or to exit. The cell-level twin of ``ProducerFencedError``:
    the producer epoch fences a zombie transaction, the cell epoch fences
    a zombie leader's entire replication stream."""


class QuorumLostError(BrokerUnavailableError):
    """The leader could not place a WAL frame on a MAJORITY of replicas
    (followers unreachable, or a majority stale-fenced this leader's
    epoch), so the mutation was never acknowledged. RETRYABLE — it
    subclasses ``BrokerUnavailableError`` because the client-side story
    is identical to a broker outage: the operation is idempotent, the
    cell is (re-)electing, and repeating the call after a backoff reaches
    whichever leader the new epoch crowned. Nothing un-acked ever
    surfaces in the committed view, so the retry can never double-apply."""


class TransactionStateError(TpuKafkaError):
    """A transactional operation was issued in the wrong state — produce
    or commit with no open transaction, begin-inside-begin with a
    different outcome pending, offsets on a producer that never
    initialized. TERMINAL (caller bug): Kafka's INVALID_TXN_STATE. The
    transaction protocol is a strict begin → produce*/offsets* →
    commit-or-abort cycle; anything else indicates the caller lost track
    of its own state machine."""


class FencedMemberError(TpuKafkaError):
    """This group member has been FENCED: its heartbeat lease expired (or
    a supervisor fenced it explicitly) and the broker evicted it from the
    group. TERMINAL for the member: the rebalance already bumped the
    generation and handed its partitions to survivors, so nothing it does
    with its old identity can be honored — commits fail generation-checked
    (``CommitFailedError``), heartbeats raise this. The only valid
    responses are to re-join as a fresh member or to exit and let a
    supervisor respawn. Kafka's UNKNOWN_MEMBER_ID, with the lease made
    explicit."""


class JournalLockedError(TpuKafkaError):
    """A decode journal file is exclusively owned by another LIVE process.
    Journal files are single-writer (one replica incarnation each);
    two live processes writing one file would interleave tmp-renames and
    corrupt the warm-failover state. A lock held by a dead process (or by
    this same process) is stale and silently stolen — SIGKILL leaves no
    chance to clean up."""


class PoisonRecordError(TpuKafkaError):
    """A record's *payload* cannot be processed (undecodable bytes,
    schema violation, a processor crash specific to this record).
    TERMINAL PER RECORD: under at-least-once delivery the identical bytes
    re-deliver forever, so retrying is an infinite crash loop — the only
    exits are dropping the record or routing it to a dead-letter topic
    (``resilience.PoisonQuarantine``), after which its offset may retire.
    Transport and broker state are healthy; only this record is not."""


class UnknownTopicError(TpuKafkaError):
    """Topic does not exist on the broker."""


class BarrierError(TpuKafkaError):
    """The pod-wide commit barrier failed.

    The commit path fails *closed* on this: no offsets are committed, so Kafka
    re-delivers the batch — zero uncommitted-batch loss on host preemption.
    """


class CheckpointWireError(TpuKafkaError):
    """A checkpoint frame on the rollout plane failed validation —
    truncated manifest/chunk, CRC mismatch, dtype/shape drift against the
    incumbent tree, or a missing chunk. TERMINAL PER FETCH, never per
    process: the replica rejects the candidate, keeps serving the
    incumbent version, counts the rejection, and a re-published (or
    re-fetched) checkpoint converges — a torn rollout artifact degrades
    the rollout, never the serving path."""


class DistillWireError(TpuKafkaError):
    """A completion frame on the distill topic failed validation — bad
    magic, truncated header/payload, or CRC mismatch. PER RECORD, never
    per trainer: the corpus is at-least-once and self-healing (the
    publisher only ever frames committed tokens), so the trainer drops
    the frame, counts it, and keeps consuming — a torn training record
    costs one sample, never the training loop."""

"""Producer protocol + transports: write records back to Kafka. A copy of
``torchkafka_tpu/source/producer.py``, re-rooted onto the port's
``errors``, ``source.memory``, ``source.records`` and
``resilience.crashpoint``.

Users' pipelines don't end at the training loop: dead letters go to a
quarantine topic, serving results go to an output topic, and
metrics/audit events go somewhere durable. This module closes the loop
with the same transport split as the consumer side: an in-memory
producer over ``InMemoryBroker`` (hermetic tests), and the kafka-python
adapter in ``source/kafka.py`` (copied; it imports cleanly without
kafka-python installed).

Delivery contract: ``send`` is asynchronous-capable — it returns a
``SendHandle`` whose ``get(timeout_s)`` blocks until the record is durable
on the broker and returns its ``RecordMetadata``; ``flush()`` drains
everything in flight. The memory transport resolves synchronously (the
broker append IS durability); the kafka adapter wraps the client's future.
Partitioning matches Kafka's default partitioner: explicit partition wins,
else key-hash, else round-robin.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Protocol, runtime_checkable

from torchkafka_tpu_torch.errors import ProducerClosedError, TransactionStateError
from torchkafka_tpu_torch.source.memory import InMemoryBroker
from torchkafka_tpu_torch.source.records import Record, TopicPartition

_logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True, slots=True)
class RecordMetadata:
    """Where a produced record landed (Kafka's RecordMetadata analog)."""

    topic: str
    partition: int
    offset: int


class SendHandle(Protocol):
    def get(self, timeout_s: float | None = None) -> RecordMetadata: ...


@dataclasses.dataclass(frozen=True, slots=True)
class _ResolvedSend:
    """A send that was durable the moment it returned (memory transport)."""

    metadata: RecordMetadata

    def get(self, timeout_s: float | None = None) -> RecordMetadata:
        return self.metadata


@runtime_checkable
class Producer(Protocol):
    def send(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
        timestamp_ms: int | None = None,
        headers: tuple[tuple[str, bytes], ...] = (),
    ) -> SendHandle: ...

    def flush(self, timeout_s: float | None = None) -> None: ...

    def close(self) -> None: ...


class MemoryProducer:
    """Producer over ``InMemoryBroker`` — the hermetic twin of
    ``MemoryConsumer``. Appends are durable synchronously; partitioning
    (explicit / key-hash / round-robin) is the broker's, which mirrors
    Kafka's default partitioner."""

    def __init__(self, broker: InMemoryBroker) -> None:
        self._broker = broker
        self._closed = False

    def send(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
        timestamp_ms: int | None = None,
        headers: tuple[tuple[str, bytes], ...] = (),
    ) -> SendHandle:
        if self._closed:
            raise ProducerClosedError("producer is closed")
        rec = self._broker.produce(
            topic, value, key=key, partition=partition,
            timestamp_ms=timestamp_ms, headers=headers,
        )
        return _ResolvedSend(RecordMetadata(rec.topic, rec.partition, rec.offset))

    def flush(self, timeout_s: float | None = None) -> None:
        if self._closed:
            raise ProducerClosedError("producer is closed")
        # Synchronous appends: nothing is ever in flight.

    def close(self) -> None:
        self._closed = True


class TransactionalProducer:
    """Kafka-KIP-98-style transactional producer over an
    ``InMemoryBroker`` surface (the object itself or a ``BrokerClient``
    socket proxy — duck-typed alike).

    Construction calls ``init_producer_id(transactional_id)``: it
    acquires a producer id and an EPOCH, and — the fencing half — bumps
    the epoch past any previous holder of the same transactional id,
    aborting whatever transaction that incarnation left open. Two live
    handles can hold the same transactional id only transiently: the
    older one's next transactional call raises the terminal
    ``ProducerFencedError``.

    Cycle: ``begin()`` → ``send(...)``* / ``send_offsets(...)``* →
    ``commit()`` or ``abort()``. Records appended inside a transaction
    are invisible to ``read_committed`` consumers until ``commit()`` and
    are erased from their view forever by ``abort()``;
    ``send_offsets`` buffers consumer offsets that land atomically WITH
    the records — the consume-transform-produce loop's exactly-once
    primitive. ``send`` outside a transaction raises
    ``TransactionStateError`` (this producer has no non-transactional
    mode; use ``MemoryProducer`` for that).

    Error classes: ``ProducerFencedError`` is terminal for this handle
    (another incarnation owns the id — exit or re-init);
    ``CommitFailedError`` out of ``send_offsets``/``commit`` is terminal
    for the TRANSACTION but survivable for the caller (the broker
    aborted it atomically; re-serve and retry in a fresh transaction);
    transport faults surface as the retryable ``BrokerUnavailableError``
    exactly as on every other ``BrokerClient`` path. The named crash
    points (``txn_begin_post`` / ``txn_produce_mid`` / ``txn_pre_commit``
    / ``txn_post_commit_pre_ack``) fire HERE so every user of the class
    — the serving loop, the process fleet, the fuzz suite — pins the
    same death windows."""

    def __init__(self, broker, transactional_id: str) -> None:
        self._broker = broker
        self._txn_id = transactional_id
        self._closed = False
        self._in_txn = False
        self._pid, self._epoch = broker.init_producer_id(transactional_id)

    @property
    def transactional_id(self) -> str:
        return self._txn_id

    @property
    def producer_id(self) -> int:
        return self._pid

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def in_transaction(self) -> bool:
        return self._in_txn

    def _check_open(self) -> None:
        if self._closed:
            raise ProducerClosedError("producer is closed")

    def begin(self) -> None:
        self._check_open()
        from torchkafka_tpu_torch.resilience.crashpoint import crash_hook

        self._broker.begin_txn(self._pid, self._epoch)
        self._in_txn = True
        # Transaction open on the broker, nothing produced: death here
        # must leave no trace once the next incarnation's init aborts it.
        crash_hook("txn_begin_post")

    def send(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
        timestamp_ms: int | None = None,
        headers: tuple[tuple[str, bytes], ...] = (),
    ) -> SendHandle:
        self._check_open()
        if not self._in_txn:
            raise TransactionStateError(
                "send outside a transaction; call begin() first "
                "(TransactionalProducer has no non-transactional mode)"
            )
        from torchkafka_tpu_torch.resilience.crashpoint import crash_hook

        rec = self._broker.txn_produce(
            self._pid, self._epoch, topic, value, key=key,
            partition=partition, timestamp_ms=timestamp_ms, headers=headers,
        )
        # Some of the window's records are in the transaction, the rest
        # never will be: death here must surface NONE of them committed.
        crash_hook("txn_produce_mid")
        return _ResolvedSend(RecordMetadata(rec.topic, rec.partition, rec.offset))

    def send_offsets(
        self,
        group_id: str,
        offsets: Mapping[TopicPartition, int],
        *,
        member_id: str | None = None,
        generation: int | None = None,
    ) -> None:
        """Buffer consumer offsets into the open transaction (they
        commit atomically with its records). ``member_id``/``generation``
        are the consumer's group metadata — present them so the offset
        half is generation-fenced exactly like a plain commit; omit for
        standalone (manual-assignment) consumers."""
        self._check_open()
        if not self._in_txn:
            raise TransactionStateError(
                "send_offsets outside a transaction; call begin() first"
            )
        self._broker.txn_commit_offsets(
            self._pid, self._epoch, group_id, dict(offsets),
            member_id=member_id, generation=generation,
        )

    def commit(self) -> None:
        """Atomically commit records + offsets. On ``CommitFailedError``
        the broker has ALREADY aborted the transaction (atomicity is
        total); this handle's state reflects that — a fresh ``begin()``
        starts clean."""
        self._check_open()
        if not self._in_txn:
            raise TransactionStateError("no transaction to commit")
        from torchkafka_tpu_torch.errors import CommitFailedError
        from torchkafka_tpu_torch.resilience.crashpoint import crash_hook

        # Records + offsets all staged, the atomic flip not yet asked
        # for: death here aborts at recovery — outputs must re-serve.
        crash_hook("txn_pre_commit")
        try:
            self._broker.commit_txn(self._pid, self._epoch)
        except CommitFailedError:
            self._in_txn = False  # broker aborted it atomically
            raise
        except TransactionStateError:
            # The broker has no open transaction for this epoch and no
            # committed ``last`` outcome to answer idempotently: a broker
            # that died and RECOVERED mid-cycle aborted it (begin with no
            # commit marker). Terminal for the transaction, survivable
            # for the caller — same contract as CommitFailedError: this
            # handle's state heals so a fresh begin() re-sends the work.
            self._in_txn = False
            raise
        self._in_txn = False
        # Committed ON the broker, the ack not yet observed by the
        # caller: death here must NOT re-publish at recovery — the
        # committed view already has exactly one copy, and the offsets
        # already moved, so nothing re-delivers.
        crash_hook("txn_post_commit_pre_ack")

    def abort(self) -> bool:
        """Abort the open transaction (no-op returning False when none
        is open — recovery paths abort defensively)."""
        self._check_open()
        if not self._in_txn:
            return False
        self._in_txn = False
        return self._broker.abort_txn(self._pid, self._epoch)

    def flush(self, timeout_s: float | None = None) -> None:
        self._check_open()
        # Broker RPCs are synchronous: nothing is ever in flight. The
        # durability point is commit(), not flush — flushing mid-
        # transaction proves nothing about visibility.

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._in_txn:
            # Kafka's close() aborts an in-flight transaction; so here —
            # best-effort (a dead broker just leaves it for the next
            # incarnation's init fence to abort).
            try:
                self._broker.abort_txn(self._pid, self._epoch)
            except Exception:  # noqa: BLE001 - teardown best-effort
                _logger.debug("abort on close failed", exc_info=True)
            self._in_txn = False


def dead_letter_to_topic(
    producer: Producer, topic: str, *, timeout_s: float | None = 30.0,
    metrics=None, tracer=None,
):
    """Adapt a Producer into a ``KafkaStream(dead_letter=...)`` callback:
    poison records land on a quarantine topic with their provenance and
    the error in headers, key preserved (so compacted/keyed DLQ topics
    keep working).

    The callback BLOCKS on the send handle (``get(timeout_s)``): the
    poison record's offset retires into the source watermark the moment
    this returns, so the quarantine copy must be durable FIRST — an async
    fire-and-forget would let a broker-side send failure (or a crash
    before flush) lose the record permanently with the source already
    committed past it. Failures raise here and land in the stream's DLQ
    guard, which logs and swallows them — a broken DLQ must not take down
    ingest (pipeline/stream.py's dead_letter contract). To make a broken
    DLQ *observable* rather than stderr-only, pass ``metrics`` (an object
    with a ``dlq_delivery_failures`` RateMeter — ``StreamMetrics`` /
    ``ServeMetrics`` both carry one, exported on ``/metrics``) and/or
    ``tracer`` (an ``obs.RecordTracer``; a ``dlq_failed`` span event is
    emitted per failed produce): each failure is counted and traced HERE,
    at the only point that knows it happened, before it re-raises into
    the guard. Poison is rare by definition; the per-record ack
    round-trip is not a hot path."""

    def on_dead_letter(record: Record, exc: BaseException) -> None:
        try:
            producer.send(
                topic,
                record.value,
                key=record.key,
                headers=(
                    ("dlq.error", str(exc).encode()),
                    ("dlq.topic", record.topic.encode()),
                    ("dlq.partition", str(record.partition).encode()),
                    ("dlq.offset", str(record.offset).encode()),
                ),
            ).get(timeout_s)
        except Exception:
            if metrics is not None:
                metrics.dlq_delivery_failures.add(1)
            if tracer is not None:
                tracer.dlq_failed(record)
            raise

    return on_dead_letter

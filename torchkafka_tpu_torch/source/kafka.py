"""kafka-python transport adapter (optional dependency, gated import).

Wraps ``kafka.KafkaConsumer`` behind the framework's Consumer protocol. The
reference constructs KafkaConsumer directly and force-disables auto-commit
(the reference's src/kafka_dataset.py:188-206); we do the same here, and keep
the reference's kwargs-passthrough config philosophy (SURVEY.md §5): every
keyword argument flows verbatim to kafka-python except the forced override.

This module imports cleanly without kafka-python installed; constructing
``KafkaConsumer`` without it raises a clear error.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Sequence

from torchkafka_tpu_torch import errors
from torchkafka_tpu_torch.source.consumer import ConsumerIterMixin
from torchkafka_tpu_torch.source.records import Record, TopicPartition

try:  # pragma: no cover - exercised only where kafka-python is installed
    import kafka as _kafka
    import kafka.errors as _kafka_errors

    HAVE_KAFKA_PYTHON = True
except ImportError:  # pragma: no cover
    _kafka = None
    _kafka_errors = None
    HAVE_KAFKA_PYTHON = False


def _ktp(tp: TopicPartition):
    """Framework TopicPartition → kafka-python's (the one conversion)."""
    return _kafka.TopicPartition(tp.topic, tp.partition)


def _wrap_listener(listener):
    """User listeners receive FRAMEWORK TopicPartitions on both transports;
    kafka-python would hand its own type through, so translate here (and
    subclass its listener base, which subscribe() type-checks)."""
    base = getattr(_kafka, "ConsumerRebalanceListener", object)

    class _Adapter(base):  # type: ignore[misc, valid-type]
        def on_partitions_revoked(self, revoked):
            fn = getattr(listener, "on_partitions_revoked", None)
            if fn is not None:
                fn([TopicPartition(tp.topic, tp.partition) for tp in revoked])

        def on_partitions_assigned(self, assigned):
            fn = getattr(listener, "on_partitions_assigned", None)
            if fn is not None:
                fn([TopicPartition(tp.topic, tp.partition) for tp in assigned])

    return _Adapter()


def _offset_and_metadata(offset: int):
    """kafka-python 2.0.2's OffsetAndMetadata is (offset, metadata); newer
    releases added leader_epoch (the reference's setup.py:9 pins >=2.0.2, so
    both shapes exist in the wild)."""
    try:
        return _kafka.OffsetAndMetadata(offset, None, -1)
    except TypeError:
        return _kafka.OffsetAndMetadata(offset, None)


class KafkaConsumer(ConsumerIterMixin):
    """Consumer-protocol adapter over kafka-python.

    ``assignment=[TopicPartition(...), ...]`` selects manual (mesh-aligned)
    assignment via ``consumer.assign``; otherwise topics are subscribed and
    the broker's group protocol assigns partitions (the reference's mode).
    """

    def __init__(
        self,
        topics: str | Sequence[str] | None = None,
        *,
        pattern: str | None = None,
        assignment: Sequence[TopicPartition] | None = None,
        rebalance_listener=None,
        **kafka_kwargs,
    ) -> None:
        if not HAVE_KAFKA_PYTHON:  # pragma: no cover
            raise ImportError(
                "kafka-python is not installed; install it or use "
                "torchkafka_tpu_torch.source.memory.MemoryConsumer"
            )
        # The invariant the whole framework exists for
        # (the reference's src/kafka_dataset.py:201): offsets are committed by
        # the commit barrier, never by a background auto-commit timer.
        kafka_kwargs["enable_auto_commit"] = False
        if kafka_kwargs.get("group_id") is None:
            # Same contract as MemoryConsumer (commits are per-group), and
            # it surfaces here as a clear error instead of kafka-python's
            # bare `assert group_id` at the first commit.
            raise ValueError("group_id is required (commits are per-group)")
        if pattern is not None and (topics is not None or assignment is not None):
            raise ValueError("pattern is exclusive with topics/assignment")
        if pattern is None and topics is None and assignment is None:
            # Same contract as the memory double: a consumer subscribed to
            # nothing would poll [] forever with no error.
            raise ValueError("one of topics, pattern, or assignment is required")
        topics = (
            []
            if topics is None
            else [topics] if isinstance(topics, str) else list(topics)
        )
        self._closed = False
        self._group_id = kafka_kwargs.get("group_id")
        self._any_paused = False  # O(1) hint for ConsumerIterMixin's hot loop
        # Iteration is built on poll() via ConsumerIterMixin, so the
        # iterator-ending timeout and the yielded-position tracking both live
        # here, not in kafka-python's own (unused) iterator.
        self._consumer_timeout_ms = kafka_kwargs.pop("consumer_timeout_ms", None)
        self._last_yielded: dict[TopicPartition, int] = {}
        if assignment is not None:
            if rebalance_listener is not None:
                raise ValueError(
                    "rebalance_listener is group-mode only (manual "
                    "assignment never rebalances)"
                )
            self._consumer = _kafka.KafkaConsumer(**kafka_kwargs)
            self._consumer.assign(
                [_ktp(tp) for tp in assignment]
            )
        elif pattern is not None:
            self._consumer = _kafka.KafkaConsumer(**kafka_kwargs)
            if rebalance_listener is not None:
                self._consumer.subscribe(
                    pattern=pattern, listener=_wrap_listener(rebalance_listener)
                )
            else:
                self._consumer.subscribe(pattern=pattern)
        elif rebalance_listener is not None:
            # Listener requires the explicit subscribe() path; topics in the
            # constructor would bypass it.
            self._consumer = _kafka.KafkaConsumer(**kafka_kwargs)
            self._consumer.subscribe(
                topics=topics, listener=_wrap_listener(rebalance_listener)
            )
        else:
            self._consumer = _kafka.KafkaConsumer(*topics, **kafka_kwargs)

    @staticmethod
    def _to_record(r) -> Record:
        return Record(
            topic=r.topic,
            partition=r.partition,
            offset=r.offset,
            value=r.value,
            key=r.key,
            timestamp_ms=r.timestamp,
            headers=tuple(r.headers or ()),
        )

    def _check_open(self) -> None:
        """Same closed-consumer contract as the memory double (and the
        transport-conformance suite): a closed consumer refuses the whole
        surface with ConsumerClosedError instead of leaking kafka-python's
        post-close behavior."""
        if self._closed:
            raise errors.ConsumerClosedError("consumer is closed")

    def poll(self, max_records: int = 500, timeout_ms: int = 0) -> list[Record]:
        self._check_open()
        batches = self._consumer.poll(timeout_ms=timeout_ms, max_records=max_records)
        out: list[Record] = []
        for recs in batches.values():
            out.extend(self._to_record(r) for r in recs)
        return out

    def commit(self, offsets: Mapping[TopicPartition, int] | None = None) -> None:
        self._check_open()
        if offsets is None and self._last_yielded:
            # Iterator mode: commit the records handed to the user, NOT the
            # whole fetched buffer (poll() advanced kafka-python's position
            # past records still sitting in the mixin's buffer; committing
            # positions here would lose them on crash).
            offsets = dict(self._last_yielded)
        try:
            if offsets is None:
                self._consumer.commit()
            else:
                self._consumer.commit(
                    {
                        _ktp(tp):
                            _offset_and_metadata(off)
                        for tp, off in offsets.items()
                    }
                )
        except _kafka_errors.CommitFailedError as e:
            # Re-raise as the framework's transport-independent type; callers
            # treat it as non-fatal (the reference's src/kafka_dataset.py:131-135).
            raise errors.CommitFailedError(str(e)) from e

    def committed(self, tp: TopicPartition) -> int | None:
        self._check_open()
        return self._consumer.committed(_ktp(tp))

    @property
    def group_id(self) -> str | None:
        return self._group_id

    @property
    def member_id(self) -> str | None:
        """Group metadata parity with MemoryConsumer: None — on Kafka the
        transaction coordinator fences transactional offset commits
        broker-side, so the client presents only the group id."""
        return None

    @property
    def generation(self) -> int | None:
        return None

    def position(self, tp: TopicPartition) -> int:
        self._check_open()
        return self._consumer.position(_ktp(tp))

    def seek(self, tp: TopicPartition, offset: int) -> None:
        self._check_open()
        self._consumer.seek(_ktp(tp), offset)

    def assignment(self) -> list[TopicPartition]:
        self._check_open()
        return [TopicPartition(tp.topic, tp.partition) for tp in self._consumer.assignment()]

    def offsets_for_times(
        self, times: Mapping[TopicPartition, int]
    ) -> dict[TopicPartition, int | None]:
        found = self._consumer.offsets_for_times(
            {
                _ktp(tp): int(ts)
                for tp, ts in times.items()
            }
        )
        # kafka-python returns {ktp: OffsetAndTimestamp | None}.
        return {
            TopicPartition(ktp.topic, ktp.partition):
                (None if ot is None else int(ot.offset))
            for ktp, ot in found.items()
        }

    def end_offsets(self, tps: Sequence[TopicPartition]) -> dict[TopicPartition, int]:
        ends = self._consumer.end_offsets([_ktp(tp) for tp in tps])
        return {
            TopicPartition(ktp.topic, ktp.partition): int(off)
            for ktp, off in ends.items()
        }

    def lag(self) -> dict[TopicPartition, int]:
        """Per-assigned-partition lag: end offset minus position."""
        tps = self.assignment()
        ends = self.end_offsets(tps)
        return {
            tp: max(0, ends[tp] - self.position(tp)) for tp in tps
        }

    def _check_assigned(self, tps) -> None:
        """Match the memory double's contract (NotAssignedError) instead of
        leaking kafka-python's internal KeyError/IllegalStateError."""
        stray = set(tps) - set(self.assignment())
        if stray:
            raise errors.NotAssignedError(f"not assigned: {sorted(stray)}")

    def pause(self, *tps: TopicPartition) -> None:
        self._check_open()
        self._check_assigned(tps)
        self._consumer.pause(*(_ktp(tp) for tp in tps))
        self._any_paused = True

    def resume(self, *tps: TopicPartition) -> None:
        self._check_open()
        self._check_assigned(tps)
        self._consumer.resume(*(_ktp(tp) for tp in tps))
        # Recompute rather than clear: a partial resume may leave others
        # paused. Rebalances can also drop paused partitions underneath us,
        # so the flag is conservative (may say True when nothing is paused —
        # has_paused callers then pay one full paused() and see the truth).
        self._any_paused = bool(self._consumer.paused())

    def paused(self) -> list[TopicPartition]:
        return sorted(
            TopicPartition(tp.topic, tp.partition) for tp in self._consumer.paused()
        )

    def has_paused(self) -> bool:
        return self._any_paused

    def heartbeat(self) -> None:
        """Interface parity with ``MemoryConsumer.heartbeat``: kafka-python
        maintains the group heartbeat on its own background thread (the
        broker's real session.timeout.ms reaper does the fencing), so the
        explicit renewal is a no-op here — the call exists so fleet code
        written against the memory transport runs unchanged on Kafka."""
        return None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # autocommit=False: never commit on teardown — uncommitted work must
        # be re-delivered (the reference's src/kafka_dataset.py:89).
        self._consumer.close(autocommit=False)

    def __iter__(self) -> Iterator[Record]:
        return super().__iter__()


class _KafkaSendHandle:
    """Wraps kafka-python's FutureRecordMetadata behind SendHandle.get."""

    def __init__(self, future) -> None:
        self._future = future

    def get(self, timeout_s: float | None = None):
        from torchkafka_tpu_torch.source.producer import RecordMetadata

        md = self._future.get(timeout=timeout_s)
        return RecordMetadata(md.topic, md.partition, md.offset)


class KafkaProducer:
    """Producer-protocol adapter over kafka-python's KafkaProducer.

    Same kwargs-passthrough philosophy as the consumer adapter: every
    keyword flows verbatim to the client. ``send`` returns a handle whose
    ``get`` blocks until the broker acks (at the client's configured
    ``acks`` level) — pair with ``flush()`` before committing consumer
    offsets when producing derived records (the classic consume-transform-
    produce ordering: derived records durable BEFORE the source offsets
    commit, so a crash re-derives rather than loses).
    """

    def __init__(self, **kafka_kwargs) -> None:
        if not HAVE_KAFKA_PYTHON:  # pragma: no cover
            raise ImportError(
                "kafka-python is not installed; install it or use "
                "torchkafka_tpu_torch.source.producer.MemoryProducer"
            )
        self._closed = False
        self._producer = _kafka.KafkaProducer(**kafka_kwargs)

    def send(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
        timestamp_ms: int | None = None,
        headers: tuple[tuple[str, bytes], ...] = (),
    ) -> _KafkaSendHandle:
        if self._closed:
            raise errors.ProducerClosedError("producer is closed")
        fut = self._producer.send(
            topic,
            value=value,
            key=key,
            partition=partition,
            timestamp_ms=timestamp_ms,
            # kafka-python takes list[(str, bytes)]; None when absent
            # (older client versions reject an empty list on old brokers).
            headers=list(headers) or None,
        )
        return _KafkaSendHandle(fut)

    def flush(self, timeout_s: float | None = None) -> None:
        if self._closed:
            raise errors.ProducerClosedError("producer is closed")
        self._producer.flush(timeout=timeout_s)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._producer.close()


def _fenced_error_types():
    """kafka-python's producer-fencing error classes, where they exist
    (the transactional API landed in kafka-python 2.1; older releases
    have neither the methods nor the errors)."""
    return tuple(
        t for t in (
            getattr(_kafka_errors, "ProducerFenced", None),
            getattr(_kafka_errors, "ProducerFencedError", None),
            getattr(_kafka_errors, "InvalidProducerEpochError", None),
        ) if t is not None
    )


class KafkaTransactionalProducer:
    """``TransactionalProducer``'s surface mapped onto kafka-python's
    NATIVE transactional API (KafkaProducer(transactional_id=...) +
    init_transactions/begin_transaction/send_offsets_to_transaction/
    commit_transaction/abort_transaction) — Kafka's own EOS does the
    heavy lifting; this adapter only translates types: framework
    ``TopicPartition`` offsets cross into kafka-python's, and the
    client's fencing errors surface as the framework's terminal
    ``ProducerFencedError`` so callers classify identically on every
    transport. Requires kafka-python >= 2.1 (the release that grew
    transactions); constructing on an older client raises a clear error
    rather than failing method-by-method."""

    def __init__(self, transactional_id: str, **kafka_kwargs) -> None:
        if not HAVE_KAFKA_PYTHON:  # pragma: no cover
            raise ImportError(
                "kafka-python is not installed; install it or use "
                "torchkafka_tpu_torch.source.producer.TransactionalProducer "
                "over an InMemoryBroker/BrokerClient"
            )
        if not hasattr(_kafka.KafkaProducer, "init_transactions"):
            raise RuntimeError(
                "this kafka-python has no transactional API "
                "(init_transactions et al. landed in 2.1); upgrade the "
                "client to use KafkaTransactionalProducer"
            )
        self._closed = False
        self._in_txn = False
        self._txn_id = transactional_id
        self._producer = _kafka.KafkaProducer(
            transactional_id=transactional_id, **kafka_kwargs
        )
        self._translate(self._producer.init_transactions)

    def _translate(self, fn, *args, **kwargs):
        fenced = _fenced_error_types()
        try:
            return fn(*args, **kwargs)
        except fenced as e:  # pragma: no cover - needs a live broker race
            raise errors.ProducerFencedError(str(e)) from e
        except _kafka_errors.CommitFailedError as e:  # pragma: no cover
            raise errors.CommitFailedError(str(e)) from e

    @property
    def transactional_id(self) -> str:
        return self._txn_id

    @property
    def in_transaction(self) -> bool:
        return self._in_txn

    def _check_open(self) -> None:
        if self._closed:
            raise errors.ProducerClosedError("producer is closed")

    def begin(self) -> None:
        self._check_open()
        self._translate(self._producer.begin_transaction)
        self._in_txn = True

    def send(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
        timestamp_ms: int | None = None,
        headers: tuple[tuple[str, bytes], ...] = (),
    ) -> _KafkaSendHandle:
        self._check_open()
        if not self._in_txn:
            raise errors.TransactionStateError(
                "send outside a transaction; call begin() first"
            )
        fut = self._translate(
            self._producer.send, topic, value=value, key=key,
            partition=partition, timestamp_ms=timestamp_ms,
            headers=list(headers) or None,
        )
        return _KafkaSendHandle(fut)

    def send_offsets(
        self,
        group_id: str,
        offsets: Mapping[TopicPartition, int],
        *,
        member_id: str | None = None,
        generation: int | None = None,
    ) -> None:
        """``member_id``/``generation`` are accepted for surface parity
        and ignored: kafka-python's send_offsets_to_transaction carries
        the group id, and the BROKER's transaction coordinator does the
        generation fencing (the memory transport checks in-process)."""
        self._check_open()
        if not self._in_txn:
            raise errors.TransactionStateError(
                "send_offsets outside a transaction; call begin() first"
            )
        converted = {
            _ktp(tp): _offset_and_metadata(off) for tp, off in offsets.items()
        }
        self._translate(
            self._producer.send_offsets_to_transaction, converted, group_id
        )

    def commit(self) -> None:
        self._check_open()
        if not self._in_txn:
            raise errors.TransactionStateError("no transaction to commit")
        try:
            self._translate(self._producer.commit_transaction)
        finally:
            self._in_txn = False

    def abort(self) -> bool:
        self._check_open()
        if not self._in_txn:
            return False
        try:
            self._translate(self._producer.abort_transaction)
        finally:
            self._in_txn = False
        return True

    def flush(self, timeout_s: float | None = None) -> None:
        self._check_open()
        self._producer.flush(timeout=timeout_s)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._in_txn:  # pragma: no cover - teardown best-effort
            try:
                self._producer.abort_transaction()
            except Exception:  # noqa: BLE001
                pass
            self._in_txn = False
        self._producer.close()

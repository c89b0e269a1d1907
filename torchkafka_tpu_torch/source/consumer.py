"""The Consumer protocol — the only transport surface the framework uses.

The reference touches exactly four points of kafka-python's ``KafkaConsumer``:
iteration (the reference's src/kafka_dataset.py:156), ``commit()`` (:130),
``close()`` (:89) and construction with ``enable_auto_commit=False`` forced
(:201). This protocol is that surface, made explicit and offset-precise:
``commit`` takes an explicit ``{TopicPartition: next_offset}`` map rather than
"whatever was polled", which is what lets the commit layer commit *exactly*
the records of one batch (SURVEY.md §7 hard part (b)).
"""

from __future__ import annotations

from typing import Iterator, Mapping, Protocol, Sequence, runtime_checkable

from torchkafka_tpu_torch.source.records import Record, TopicPartition


@runtime_checkable
class Consumer(Protocol):
    """Minimal consumer surface. All transports implement this."""

    def poll(self, max_records: int = 500, timeout_ms: int = 0) -> list[Record]:
        """Fetch up to ``max_records`` across assigned partitions.

        Records are returned in per-partition offset order (partitions may be
        interleaved). Returns an empty list if nothing arrived within
        ``timeout_ms``. Never auto-commits — the reference's core invariant
        (the reference's src/kafka_dataset.py:201).
        """
        ...

    def commit(self, offsets: Mapping[TopicPartition, int] | None = None) -> None:
        """Commit explicit next-read offsets; ``None`` commits current positions.

        Raises CommitFailedError if the group rebalanced underneath us; callers
        treat that as non-fatal (records get re-delivered).
        """
        ...

    def committed(self, tp: TopicPartition) -> int | None:
        """Last committed next-read offset for ``tp`` in this group, if any."""
        ...

    def position(self, tp: TopicPartition) -> int:
        """Next offset ``poll`` would fetch for ``tp``."""
        ...

    def seek(self, tp: TopicPartition, offset: int) -> None: ...

    def assignment(self) -> Sequence[TopicPartition]:
        """Partitions currently owned by this consumer."""
        ...

    def offsets_for_times(
        self, times: Mapping[TopicPartition, int]
    ) -> dict[TopicPartition, int | None]:
        """For each partition, the earliest offset whose record timestamp is
        >= the given epoch-ms — ``None`` if every record is older
        (kafka-python's ``offsets_for_times`` surface). Feed the result to
        ``seek`` to replay from a point in time."""
        ...

    def end_offsets(self, tps: Sequence[TopicPartition]) -> dict[TopicPartition, int]:
        """Next-offset-to-be-produced per partition (the log end)."""
        ...

    def lag(self) -> dict[TopicPartition, int]:
        """Per-assigned-partition lag: log end minus position."""
        ...

    def pause(self, *tps: TopicPartition) -> None:
        """Stop fetching from these partitions (``poll`` skips them) without
        losing the assignment — per-partition backpressure."""
        ...

    def resume(self, *tps: TopicPartition) -> None:
        """Undo ``pause``."""
        ...

    def paused(self) -> Sequence[TopicPartition]: ...

    def has_paused(self) -> bool:
        """Cheap O(1) probe for "is anything paused?". The per-record
        iterator hot loop consults this before paying for ``paused()``
        (which allocates a sorted list per call) — pause is rare, the loop
        is not (ADVICE r2)."""
        ...

    def close(self) -> None:
        """Release assignment. NEVER commits on close — uncommitted work must
        be re-delivered (the reference's src/kafka_dataset.py:89)."""
        ...

    def __iter__(self) -> Iterator[Record]: ...


def seek_to_timestamp(consumer: Consumer, timestamp_ms: int) -> dict[TopicPartition, int]:
    """Position every assigned partition at the first record at/after
    ``timestamp_ms``. Partitions whose records are ALL older seek to their
    log end — otherwise a fresh consumer (no committed offsets) would
    resolve them to ``auto_offset_reset`` and replay the entire stale
    partition, the opposite of "replay from this point in time" (the
    standard Kafka pattern: seek the ``offsets_for_times`` result, end
    offset where it returns None). Returns the offsets seeked to.

    The time-travel analog of the reference's "restart with the same
    group_id" resume story (the reference's README.md:92-96): instead of
    resuming at the last commit, replay from a wall-clock point.
    """
    assigned = list(consumer.assignment())
    if not assigned:
        # A group-managed consumer has no assignment until the join
        # completes (first poll); silently seeking nothing would replay the
        # entire stale stream — the exact failure this function prevents.
        from torchkafka_tpu_torch.errors import NotAssignedError

        raise NotAssignedError(
            "no partitions assigned — with a group-managed consumer, poll "
            "once (completing the group join) before seek_to_timestamp"
        )
    found = consumer.offsets_for_times({tp: timestamp_ms for tp in assigned})
    missing = [tp for tp, off in found.items() if off is None]
    ends = consumer.end_offsets(missing) if missing else {}
    seeked: dict[TopicPartition, int] = {}
    for tp, offset in found.items():
        offset = ends[tp] if offset is None else offset
        consumer.seek(tp, offset)
        seeked[tp] = offset
    return seeked


class ConsumerIterMixin:
    """Provides record-at-a-time iteration on top of ``poll`` (the reference's
    ``for record in consumer`` hot-loop shape, the reference's src/kafka_dataset.py:156).

    If the instance has a ``_consumer_timeout_ms`` attribute (kafka-python's
    ``consumer_timeout_ms`` semantics), iteration ends after that long with no
    records; otherwise it blocks until the consumer is closed.
    """

    _ITER_TIMEOUT_MS = 100

    def __iter__(self) -> Iterator[Record]:
        import time as _time

        buf: list[Record] = []
        # Records fetched before their partition was paused: withheld here
        # (kafka-python retains fetched-but-paused records the same way) and
        # re-injected ahead of new fetches once the partition resumes —
        # while paused, poll skips the partition, so nothing newer can
        # overtake them and per-partition order holds. Consults the
        # transport's public paused() so it works for ANY transport; native
        # withholding (kafka-python) only covers records poll hasn't
        # surfaced yet, not ones already in this buffer.
        stash: dict[TopicPartition, list[Record]] = {}
        paused_fn = getattr(self, "paused", None)
        # O(1) "anything paused?" probe — skips the per-record paused()
        # sorted-list allocation in the (overwhelmingly common) case where
        # pause is never used. A non-empty stash forces the full check so
        # resumed partitions re-inject promptly.
        has_paused_fn = getattr(self, "has_paused", None)
        idle_limit_ms = getattr(self, "_consumer_timeout_ms", None)
        # kafka-python semantics: the timeout clock measures time spent
        # *waiting for the next record*, not wall time since the last fetch —
        # time the caller spends processing buffered records must not count.
        wait_start: float | None = None
        while True:
            closed = getattr(self, "_closed", False)
            if paused_fn is None or closed:
                paused = ()
            elif stash or has_paused_fn is None or has_paused_fn():
                paused = set(paused_fn())
            else:
                paused = ()
            if stash:
                for tp in [tp for tp in stash if tp not in paused]:
                    resumed = stash.pop(tp)
                    resumed.reverse()
                    buf.extend(resumed)  # popped (from the end) before new polls
            if not buf:
                if getattr(self, "_closed", False):
                    return
                if wait_start is None:
                    wait_start = _time.monotonic()
                buf = list(self.poll(timeout_ms=self._ITER_TIMEOUT_MS))  # type: ignore[attr-defined]
                if not buf:
                    if (
                        idle_limit_ms is not None
                        and (_time.monotonic() - wait_start) * 1000 >= idle_limit_ms
                    ):
                        return
                    continue
                wait_start = None
                buf.reverse()  # pop from the end, preserve order
            rec = buf.pop()
            if rec.tp in paused:
                stash.setdefault(rec.tp, []).append(rec)
                continue
            # kafka-python iterator semantics: the consumed position advances
            # per record *yielded to the user*, not per record fetched into
            # the buffer — so commit(offsets=None) after iteration covers
            # exactly what the user saw (transports keep _last_yielded).
            ly = getattr(self, "_last_yielded", None)
            if ly is not None:
                ly[rec.tp] = rec.offset + 1
            yield rec

"""Transport-independent record primitives.

The reference iterates raw kafka-python ``ConsumerRecord`` objects straight out
of the consumer (the reference's src/kafka_dataset.py:156) and hands them to
the user's ``_process`` (:159,:173-186). We instead define our own small record
type so that every transport (in-memory broker, kafka-python adapter, future
native client) presents an identical surface to the transform layer, and so
records can cross thread/process boundaries cheaply.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np


class TopicPartition(NamedTuple):
    """A (topic, partition) pair — the unit of assignment and offset commit."""

    topic: str
    partition: int


@dataclasses.dataclass(frozen=True, slots=True)
class Record:
    """One immutable record fetched from a partition.

    ``offset`` is the record's position in its partition log. Commits use
    *next-offset* semantics: committing offset N means "records < N are done",
    matching Kafka's OffsetAndMetadata convention.
    """

    topic: str
    partition: int
    offset: int
    value: bytes
    key: bytes | None = None
    timestamp_ms: int = 0
    headers: tuple[tuple[str, bytes], ...] = ()

    @property
    def tp(self) -> TopicPartition:
        return TopicPartition(self.topic, self.partition)


#: One partition's contiguous poll run: (tp, first_offset, count).
Span = tuple[TopicPartition, int, int]


class ChunkIndex:
    """Columnar identity of one poll chunk: which (partition, offset) each
    row is, without per-row Python objects.

    The ingest hot path's cost at millions of records/sec is not decoding —
    it is per-record bookkeeping (attribute reads, dict hits). A ChunkIndex
    carries the same information as a list[Record] for accounting purposes
    in three arrays built from per-partition spans with O(spans) Python work,
    so the ledger and batcher can operate on slices.
    """

    __slots__ = ("spans", "tps", "tp_idx", "offsets")

    def __init__(
        self,
        spans: list[Span],
        tps: list[TopicPartition],
        tp_idx: np.ndarray,
        offsets: np.ndarray,
    ) -> None:
        self.spans = spans
        self.tps = tps  # unique partitions; tp_idx indexes into this
        self.tp_idx = tp_idx  # [N] int32
        self.offsets = offsets  # [N] int64

    def __len__(self) -> int:
        return int(self.offsets.shape[0])

    @classmethod
    def from_spans(cls, spans: list[Span]) -> "ChunkIndex":
        tps: list[TopicPartition] = []
        ids: dict[TopicPartition, int] = {}
        idx_parts = []
        off_parts = []
        for tp, start, count in spans:
            i = ids.get(tp)
            if i is None:
                i = ids[tp] = len(tps)
                tps.append(tp)
            idx_parts.append(np.full(count, i, np.int32))
            off_parts.append(np.arange(start, start + count, dtype=np.int64))
        if not idx_parts:
            return cls([], [], np.empty(0, np.int32), np.empty(0, np.int64))
        return cls(spans, tps, np.concatenate(idx_parts), np.concatenate(off_parts))

    @classmethod
    def from_records(cls, records: Sequence[Record]) -> "ChunkIndex":
        """Fallback for transports without a span-aware poll: one attribute
        pass over the records, splitting runs on partition change or offset
        gap (compacted topics / transaction markers leave gaps)."""
        spans: list[Span] = []
        run_tp: TopicPartition | None = None
        run_start = 0
        prev = 0
        for r in records:
            tp = r.tp
            if tp != run_tp or r.offset != prev + 1:
                if run_tp is not None:
                    spans.append((run_tp, run_start, prev - run_start + 1))
                run_tp, run_start = tp, r.offset
            prev = r.offset
        if run_tp is not None:
            spans.append((run_tp, run_start, prev - run_start + 1))
        return cls.from_spans(spans)

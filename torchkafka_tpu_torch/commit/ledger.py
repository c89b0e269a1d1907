"""Offset ledger: commit-exactly-the-batch bookkeeping.

The reference commits "whatever was polled" — in the multiprocessing path the
committed offsets can even include records already fetched into the *next*
in-flight batch (SURVEY.md §3, CS-3 coarseness note). The TPU-native design
fixes this with explicit accounting (SURVEY.md §7, hard part (b)):

- ``fetched(r)``  — record r was polled off the broker (enters *pending*).
- ``dropped(r)``  — user transform returned None for r
  (the reference's src/kafka_dataset.py:161-162); r is done, it just never
  appears in a batch.
- ``emitted(r)``  — r is part of a batch handed to the consumer of the stream.

The committable watermark for a partition is the smallest offset still
pending — i.e. fetched but sitting in the carry-over buffer or an
un-emitted partial batch — or the fetch frontier if nothing is pending.
Committing a snapshot therefore never covers a record the user hasn't been
handed, no matter how records interleave with drops and batch boundaries.

Representation: per partition, pending is the interval [low, frontier) minus
a (normally empty) set of out-of-order completions. Kafka partitions are
ordered logs, so fetches arrive offset-ascending and completions almost
always retire ``low`` itself — a couple of integer ops per record, no
per-record set churn. The set only fills on genuinely out-of-order completion
(e.g. interleaved re-delivery), and drains as ``low`` catches up.
"""

from __future__ import annotations

import threading

import numpy as np

from torchkafka_tpu_torch.source.records import Record, TopicPartition


class _Partition:
    __slots__ = ("low", "frontier", "ooo")

    def __init__(self, first_offset: int) -> None:
        self.low = first_offset  # smallest possibly-pending offset
        self.frontier = first_offset  # next-fetch position (exclusive)
        self.ooo: set[int] = set()  # done out-of-order, all in (low, frontier)

    def _skip_gap(self, start: int) -> None:
        """Offsets [frontier, start) will never be delivered (log compaction,
        transaction markers): they must not count as pending."""
        if start > self.frontier:
            if self.low == self.frontier:
                self.low = start
            else:
                self.ooo.update(range(self.frontier, start))

    def fetch(self, offset: int) -> None:
        if offset < self.low:
            # Re-delivery below the done watermark (consumer seeked back):
            # that range is pending again.
            self.low = offset
        else:
            self._skip_gap(offset)
        nxt = offset + 1
        if nxt > self.frontier:
            self.frontier = nxt

    def fetch_span(self, start: int, count: int) -> None:
        """O(1) bulk fetch of the contiguous offsets [start, start+count)."""
        if start < self.low:
            self.low = start
        else:
            self._skip_gap(start)
        if start + count > self.frontier:
            self.frontier = start + count

    def done_run(self, first: int, last: int) -> bool:
        """O(1) bulk done of the contiguous offsets [first, last]; True if
        the fast path applied (run starts exactly at the watermark)."""
        if first == self.low:
            self.low = last + 1
            ooo = self.ooo
            while ooo and self.low in ooo:
                ooo.remove(self.low)
                self.low += 1
            return True
        return False

    def done(self, offset: int) -> None:
        if offset == self.low:
            self.low += 1
            ooo = self.ooo
            while ooo and self.low in ooo:
                ooo.remove(self.low)
                self.low += 1
        elif offset > self.low:
            if offset < self.frontier:
                self.ooo.add(offset)
        # offset < low: already done (re-delivered duplicate) — tolerated,
        # see the at-least-once note in OffsetLedger._done.

    @property
    def committable(self) -> int:
        return self.low  # == frontier when nothing is pending

    @property
    def pending(self) -> int:
        return (self.frontier - self.low) - len(self.ooo)


class OffsetLedger:
    """Tracks per-partition fetch frontiers and pending (un-emitted) offsets.

    Thread-safe: the pipeline's fetch/transform thread mutates it while the
    consuming thread snapshots it at batch-emit time.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._parts: dict[TopicPartition, _Partition] = {}

    def _part(self, tp: TopicPartition, offset: int) -> _Partition:
        part = self._parts.get(tp)
        if part is None:
            part = self._parts[tp] = _Partition(offset)
        return part

    def fetched(self, record: Record) -> None:
        with self._lock:
            self._part(record.tp, record.offset).fetch(record.offset)

    def fetched_many(self, records: list[Record]) -> None:
        """Bulk ``fetched``: one lock acquisition per poll chunk."""
        with self._lock:
            for record in records:
                self._part(record.tp, record.offset).fetch(record.offset)

    def dropped(self, record: Record) -> None:
        self._done(record)

    def emitted(self, record: Record) -> None:
        self._done(record)

    def _done(self, record: Record) -> None:
        # Unknown partitions are tolerated: under at-least-once delivery a
        # record can be re-delivered after a rebalance while its first copy
        # is still in the batcher; both copies eventually resolve, the second
        # as a no-op. Raising would turn a legal re-delivery into a crash.
        with self._lock:
            part = self._parts.get(record.tp)
            if part is not None:
                part.done(record.offset)

    # ------------------------------------------------------- vectorized path

    def fetched_spans(self, spans: list[tuple[TopicPartition, int, int]]) -> None:
        """O(spans) bulk fetch: each span is (tp, start_offset, count) of
        contiguous offsets, as produced by one partition's poll run. The
        per-record cost of ``fetched_many`` (a dict hit and int compares per
        record — the dominant ledger cost at millions of records/sec)
        collapses to one call per partition run."""
        with self._lock:
            for tp, start, count in spans:
                self._part(tp, start).fetch_span(start, count)

    def done_array(self, tp: TopicPartition, offsets: np.ndarray) -> None:
        """Bulk done of a sorted-ascending, unique offset array for one
        partition. Contiguous runs starting at the watermark — the shape
        every in-order batch emit produces — retire in O(1); anything else
        falls back to per-offset handling (re-delivery interleavings)."""
        n = int(offsets.shape[0])
        if n == 0:
            return
        first = int(offsets[0])
        last = int(offsets[-1])
        with self._lock:
            part = self._parts.get(tp)
            if part is None:
                return
            if last - first == n - 1 and part.done_run(first, last):
                return
            for off in offsets.tolist():
                part.done(int(off))

    def drop(self, tps) -> None:
        """Forget every tracked offset of the given partitions — the
        REVOCATION reset. A rebalance that takes a partition away leaves
        its fetched-but-unretired records stranded here (their queued
        copies were pruned; the new owner serves them); if the partition
        later RETURNS, those stale pending entries would hold the
        snapshot below the broker's committed watermark and the next
        commit would REGRESS it (last-write-wins, like Kafka). Dropping
        on revocation makes a comeback start from the fresh fetch
        position; completions of already-in-flight work for a dropped
        partition resolve as tolerated no-ops (see ``_done``)."""
        with self._lock:
            for tp in tps:
                self._parts.pop(tp, None)

    def snapshot(self) -> dict[TopicPartition, int]:
        """Committable next-read offsets right now.

        For each partition: the smallest still-pending offset if any record
        is in flight, else the fetch frontier. Calling this immediately after
        marking a batch ``emitted`` yields offsets covering exactly that
        batch plus any earlier drops — and never a carried-over record.
        """
        with self._lock:
            return {tp: part.committable for tp, part in self._parts.items()}

    def pending_count(self) -> int:
        with self._lock:
            return sum(part.pending for part in self._parts.values())

    def pending_by_partition(self) -> dict[TopicPartition, int]:
        """Per-partition in-flight (fetched-but-unretired) record counts —
        the fleet watermark view's 'how far behind is each replica'."""
        with self._lock:
            return {tp: part.pending for tp, part in self._parts.items()}


def merged_watermarks(
    snapshots: "list[dict[TopicPartition, int]]",
) -> dict[TopicPartition, int]:
    """Fleet-level committable view over several replicas' ledgers.

    Under the consumer-group invariant each partition is owned by exactly
    one member, so the merged view is normally a disjoint union. During a
    handoff window (rebalance mid-redelivery) two ledgers can briefly know
    the same partition; the merge takes the MINIMUM — a watermark that
    never covers another replica's still-pending records, the same
    fail-low rule the per-replica snapshot applies within a partition."""
    out: dict[TopicPartition, int] = {}
    for snap in snapshots:
        for tp, off in snap.items():
            out[tp] = min(out[tp], off) if tp in out else off
    return out

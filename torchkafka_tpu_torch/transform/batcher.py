"""Fixed-shape batch assembly with carry-over accounting.

Copy of ``torchkafka_tpu/transform/batcher.py``, imports re-rooted; its
``jax.tree_util`` use is the port's own ``utils.tree`` (same leaf order).

Replaces the reference's L2 (torch DataLoader collation, SURVEY.md §1) with a
batcher built for XLA's static-shape world. The reference never faced this
problem — DataLoader happily emits ragged final batches; XLA recompiles on
every new shape, so we never change shape. Policies:

- ``block`` (default): only full batches are emitted; a partial tail waits
  for more records. Its records stay *pending* in the ledger, so they are
  excluded from every commit watermark until actually emitted — the
  carry-over rule that makes the reference's round-robin worker↔batch
  correspondence assumption (SURVEY.md §2 quirk 4) unnecessary.
- ``pad``: ``flush()`` zero-pads the tail to the batch size and reports
  ``valid_count``; downstream masks with ``batch.valid_mask()``.

Elements are pytrees of fixed-shape NumPy arrays; leaves are stacked into
preallocated ``[B, ...]`` buffers (one memcpy per element per leaf — the hot
host path; see native/ for the C++ fast path).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

from torchkafka_tpu_torch.commit.ledger import OffsetLedger
from torchkafka_tpu_torch.source.records import ChunkIndex, Record, TopicPartition

from torchkafka_tpu_torch.utils import tree as _tree


@dataclasses.dataclass
class Batch:
    """One host-local batch: stacked arrays + how many rows are real."""

    data: Any  # pytree of np.ndarray with leading dim == batch_size
    valid_count: int
    offsets: dict[TopicPartition, int]  # committable snapshot for this batch

    @property
    def batch_size(self) -> int:
        leaves = _tree.tree_leaves(self.data)
        return int(leaves[0].shape[0]) if leaves else 0

    def valid_mask(self) -> np.ndarray:
        """Boolean [B] mask; rows past valid_count are padding."""
        return np.arange(self.batch_size) < self.valid_count


class Batcher:
    """Accumulates processed elements into fixed-size batches.

    Drives the ledger: ``add`` marks drops, ``_emit`` marks emissions and
    snapshots the committable offsets at exactly that moment.
    """

    def __init__(
        self,
        batch_size: int,
        ledger: OffsetLedger | None = None,
        pad_policy: str = "block",
    ) -> None:
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if pad_policy not in ("block", "pad"):
            raise ValueError(f"pad_policy must be 'block'|'pad', got {pad_policy!r}")
        self.batch_size = batch_size
        self.ledger = ledger if ledger is not None else OffsetLedger()
        self.pad_policy = pad_policy
        self._treedef = None
        self._buffers: list[np.ndarray] | None = None
        self._fill = 0
        # Row identity, columnar: which (partition, offset) occupies each
        # buffered row — the ledger accounting needs nothing more, and arrays
        # keep the per-row cost at memcpy level (no Record objects held).
        self._tp_table: list[TopicPartition] = []
        self._tp_ids: dict[TopicPartition, int] = {}
        self._row_tp = np.empty(batch_size, np.int32)
        self._row_off = np.empty(batch_size, np.int64)

    def _init_buffers(self, element: Any) -> None:
        leaves, treedef = _tree.tree_flatten(element)
        for i, leaf in enumerate(leaves):
            if not isinstance(leaf, np.ndarray):
                leaves[i] = np.asarray(leaf)
        self._treedef = treedef
        self._buffers = [
            np.zeros((self.batch_size, *leaf.shape), dtype=leaf.dtype) for leaf in leaves
        ]

    def add(self, element: Any, record: Record) -> Batch | None:
        """Add one processed element (None = drop). Returns a full Batch when
        the element completes one, else None.

        ``record`` must already be ``ledger.fetched``-registered by the caller
        (the stream does this at poll time).
        """
        if element is None:
            self.ledger.dropped(record)
            return None
        if self._buffers is None:
            self._init_buffers(element)
        leaves = _tree.tree_leaves(element)
        if len(leaves) != len(self._buffers):
            raise ValueError("element structure changed between records")
        for buf, leaf in zip(self._buffers, leaves):
            arr = np.asarray(leaf)
            if arr.shape != buf.shape[1:] or arr.dtype != buf.dtype:
                raise ValueError(
                    f"element leaf shape/dtype {arr.shape}/{arr.dtype} does not "
                    f"match batch buffer {buf.shape[1:]}/{buf.dtype}; processors "
                    f"must emit fixed shapes (pad/truncate per record)"
                )
            buf[self._fill] = arr
        self._row_tp[self._fill] = self._tp_id(record.tp)
        self._row_off[self._fill] = record.offset
        self._fill += 1
        if self._fill == self.batch_size:
            return self._emit()
        return None

    def _tp_id(self, tp: TopicPartition) -> int:
        i = self._tp_ids.get(tp)
        if i is None:
            i = self._tp_ids[tp] = len(self._tp_table)
            self._tp_table.append(tp)
        return i

    def add_many(
        self,
        stacked: Any,
        records: "list[Record] | ChunkIndex",
        keep: np.ndarray | None = None,
    ) -> list[Batch]:
        """Bulk add: the chunk-processor path. ``records`` identifies the
        chunk's rows — a list[Record] or (hot path) a ChunkIndex, which
        carries the same identity as arrays with no per-row objects.
        ``keep`` is an optional boolean [len(records)] mask; False rows are
        drops, and ``stacked`` holds only the kept rows (sum(keep) of them)
        in record order. With no mask, ``stacked`` covers every record.
        ``stacked=None`` means the whole chunk was dropped: every offset is
        retired immediately (a pending-forever chunk would freeze the
        partition's commit watermark).
        Copies land as array slices, not per-record memcpys. Returns every
        full Batch completed by this chunk (possibly several).
        """
        index = (
            records
            if isinstance(records, ChunkIndex)
            else ChunkIndex.from_records(records)
        )
        # Remap the chunk's partition-id space into the batcher's.
        remap = np.fromiter(
            (self._tp_id(tp) for tp in index.tps), np.int32, len(index.tps)
        )
        tp_idx = remap[index.tp_idx] if len(index.tps) else index.tp_idx
        offsets = index.offsets
        if stacked is None:
            # Whole chunk dropped: every offset resolves as a drop NOW, else
            # the records stay pending forever and freeze the partition's
            # commit watermark.
            self._retire(tp_idx, offsets)
            return []
        if keep is not None:
            keep = np.asarray(keep, bool)
            if keep.shape[0] != offsets.shape[0]:
                raise ValueError(
                    f"keep mask has {keep.shape[0]} rows, chunk has {offsets.shape[0]}"
                )
            self._retire(tp_idx[~keep], offsets[~keep])  # drops resolve now
            tp_idx = tp_idx[keep]
            offsets = offsets[keep]
            if offsets.shape[0] == 0:
                return []
        leaves, treedef = _tree.tree_flatten(stacked)
        leaves = [np.asarray(leaf) for leaf in leaves]
        if self._buffers is None:
            self._treedef = treedef
            self._buffers = [
                np.zeros((self.batch_size, *leaf.shape[1:]), dtype=leaf.dtype)
                for leaf in leaves
            ]
        if len(leaves) != len(self._buffers):
            raise ValueError("element structure changed between chunks")
        n = leaves[0].shape[0]
        if n != offsets.shape[0]:
            raise ValueError(f"chunk has {n} rows but {offsets.shape[0]} records")
        out: list[Batch] = []
        i = 0
        while i < n:
            take = min(self.batch_size - self._fill, n - i)
            for buf, leaf in zip(self._buffers, leaves):
                if leaf.shape[1:] != buf.shape[1:] or leaf.dtype != buf.dtype:
                    raise ValueError(
                        f"chunk leaf shape/dtype {leaf.shape[1:]}/{leaf.dtype} does "
                        f"not match batch buffer {buf.shape[1:]}/{buf.dtype}"
                    )
                buf[self._fill : self._fill + take] = leaf[i : i + take]
            self._row_tp[self._fill : self._fill + take] = tp_idx[i : i + take]
            self._row_off[self._fill : self._fill + take] = offsets[i : i + take]
            self._fill += take
            i += take
            if self._fill == self.batch_size:
                out.append(self._emit())
        return out

    def _retire(self, tp_idx: np.ndarray, offsets: np.ndarray) -> None:
        """Mark rows done in the ledger, grouped per partition (each group's
        offsets stay ascending, so the ledger's O(1) run path applies)."""
        if offsets.shape[0] == 0:
            return
        for i in np.unique(tp_idx):
            self.ledger.done_array(self._tp_table[int(i)], offsets[tp_idx == i])

    def flush(self) -> Batch | None:
        """Emit the partial tail (pad policy) or nothing (block policy —
        the tail stays pending and uncommitted)."""
        if self._fill == 0 or self.pad_policy != "pad":
            return None
        return self._emit()

    def flush_tails(self) -> list["Batch"]:
        """Uniform flush surface shared with BucketBatcher (which can hold
        one tail per bucket)."""
        tail = self.flush()
        return [tail] if tail is not None else []

    def _emit(self) -> Batch:
        assert self._buffers is not None
        # Retire the buffered rows from the columnar identity arrays *before*
        # snapshotting, so the snapshot's watermark covers exactly this batch.
        self._retire(self._row_tp[: self._fill], self._row_off[: self._fill])
        batch = Batch(
            data=_tree.tree_unflatten(self._treedef, self._buffers),
            valid_count=self._fill,
            offsets=self.ledger.snapshot(),
        )
        # Fresh buffers: the emitted batch owns the old ones (zero-copy handoff).
        leaves = _tree.tree_leaves(batch.data)
        self._buffers = [np.zeros_like(leaf) for leaf in leaves]
        self._fill = 0
        return batch

    @property
    def pending_in_batch(self) -> int:
        """Elements accumulated but not yet emitted (the carry-over)."""
        return self._fill

    def feed(self, processed: Iterator[tuple[Any, Record]]) -> Iterator[Batch]:
        """Convenience: drain an iterator of (element, record) into batches."""
        for element, record in processed:
            out = self.add(element, record)
            if out is not None:
                yield out

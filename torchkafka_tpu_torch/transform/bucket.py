"""Length-bucketed batching for ragged record streams.

Copy of ``torchkafka_tpu/transform/bucket.py``, imports re-rooted.

XLA compiles static shapes, so ragged text must pad — and padding every
record to the stream's maximum length burns MXU FLOPs and HBM on dead
tokens (a other tokens-mostly-short topic padded to 512 wastes >90% of the
batch). The TPU-idiomatic answer is length bucketing: a few fixed widths,
each its own static shape (one XLA compile per width, cached), rows routed
to the smallest width that fits.

``BucketBatcher`` drops into the stream where ``Batcher`` goes:

- the processor returns a VARIABLE-length 1-D array per record (or None
  to drop);
- rows land in the smallest bucket ≥ their length, padded with
  ``pad_value``; rows longer than the largest bucket are truncated to it
  (the same pad/truncate contract as ``fixed_width``);
- emitted batches are pytrees ``{"tokens": [B, W], "length": [B]}`` — the
  true pre-pad lengths ride along so consumers build attention masks
  without re-deriving them;
- ALL buckets share ONE interval ledger, so commit-exactly-the-batch
  holds even though batches emit out of arrival order across buckets (the
  ledger retires rows individually; a short row emitted early while a
  long row waits in a sparser bucket simply holds the watermark at the
  long row's offset — at-least-once, never a lost or skipped record).

The reference never faced this (its records are opaque blobs and torch
tolerates ragged collation, /root/reference/src/kafka_dataset.py:173-186);
this is net-new TPU-shaped capability on the SURVEY §7 "dynamic record
streams vs XLA static shapes" hard part.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from torchkafka_tpu_torch.commit.ledger import OffsetLedger
from torchkafka_tpu_torch.source.records import Record
from torchkafka_tpu_torch.transform.batcher import Batch, Batcher


class BucketBatcher:
    """Routes variable-length 1-D rows into per-width ``Batcher``s sharing
    one ledger. Same ``add``/``flush_tails`` surface the stream drives."""

    def __init__(
        self,
        batch_size: int,
        boundaries: Sequence[int],
        ledger: OffsetLedger | None = None,
        pad_policy: str = "block",
        pad_value: int = 0,
    ) -> None:
        if isinstance(boundaries, (str, bytes)):
            # '512' would iterate as digit widths [5, 1, 2] — silent data
            # truncation; make it an immediate error instead.
            raise ValueError(
                f"bucket boundaries must be a sequence of ints, got "
                f"{boundaries!r}"
            )
        widths = sorted(set(int(w) for w in boundaries))
        if not widths or widths[0] <= 0:
            raise ValueError(f"bucket boundaries must be positive, got {boundaries}")
        self.ledger = ledger if ledger is not None else OffsetLedger()
        self.pad_policy = pad_policy
        self._widths = widths
        self._pad_value = pad_value
        self._batchers = {
            w: Batcher(batch_size, self.ledger, pad_policy) for w in widths
        }

    def _width_for(self, n: int) -> int:
        for w in self._widths:
            if n <= w:
                return w
        return self._widths[-1]  # longer than the largest bucket: truncate

    def add(self, element: Any, record: Record) -> Batch | None:
        if element is None:
            self.ledger.dropped(record)
            return None
        row = np.asarray(element)
        if row.ndim != 1:
            raise ValueError(
                f"bucketed processors must return 1-D rows, got shape "
                f"{row.shape}; fixed-shape pytrees belong in Batcher"
            )
        w = self._width_for(row.shape[0])
        n = min(row.shape[0], w)
        padded = np.full((w,), self._pad_value, dtype=row.dtype)
        padded[:n] = row[:n]
        return self._batchers[w].add(
            {"tokens": padded, "length": np.int32(n)}, record
        )

    def flush_tails(self) -> list[Batch]:
        """Every bucket's partial tail under the 'pad' policy (ascending
        width order); [] under 'block'."""
        out = []
        for w in self._widths:
            tail = self._batchers[w].flush()
            if tail is not None:
                out.append(tail)
        return out

    # NOTE: deliberately NO single-tail ``flush()`` — multiple buckets can
    # hold tails, and a Batcher-compat flush that returned only the first
    # would still have retired the others' offsets in the shared ledger
    # (committing past undelivered records). Callers must use flush_tails.

    @property
    def pending_in_batch(self) -> int:
        return sum(b.pending_in_batch for b in self._batchers.values())

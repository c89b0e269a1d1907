"""auto_commit: the reference's commit orchestrator, re-implemented.

Same three paths as the reference's src/auto_commit.py:22-72:

1. non-KafkaDataset dataset -> transparent passthrough (:47-48, the 1.0.1
   capability);
2. ``num_workers == 0`` -> yield the batch, then commit — strictly after the
   caller's loop body for that batch returned (:49-58);
3. multiprocessing -> round-robin over the DataLoader's worker processes,
   signaling worker k to commit after yielding the batch it produced (:59-72).

Path 3 inherits the reference's load-bearing assumption (SURVEY.md §2 quirk
4): torch's _MultiProcessingDataLoaderIter hands out batches round-robin in
``_workers`` order. That holds for stock DataLoaders; a sampler/worker that
reorders batches would signal the wrong worker. It also shares the
reference's coarseness: the worker commits *everything it has polled*, which
may include records already fetched for the next in-flight batch — still
at-least-once, but coarser than batch-exact. The TPU-native path
(torchkafka_tpu_torch.pipeline.KafkaStream) has neither problem: it tracks
batch-exact offsets in an OffsetLedger and needs no worker correspondence.
Prefer it for new code; this module exists for migration parity.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterator

from torch.utils.data import DataLoader

from torchkafka_tpu_torch.compat.dataset import KafkaDataset


def auto_commit(dataloader: DataLoader) -> Iterator[Any]:
    """Iterate a DataLoader, committing each batch's offsets after the
    caller is done with it (yield-then-commit, at-least-once)."""
    if not isinstance(dataloader, DataLoader):
        raise TypeError("A DataLoader must be provided.")

    if not isinstance(dataloader.dataset, KafkaDataset):
        # Regular datasets: behave exactly like iterating the DataLoader.
        yield from dataloader
    elif dataloader.num_workers == 0:
        for batch in dataloader:
            yield batch
            # The caller's loop body has run by the time execution resumes
            # here: commit-after-consumption, the core ordering guarantee.
            dataloader.dataset.commit()
    else:
        # Workers only exist once the iterator is created; we need the
        # iterator object itself to reach their process handles.
        batches = iter(dataloader)
        workers = itertools.cycle(batches._workers)  # noqa: SLF001 - see module docstring
        for worker, batch in zip(workers, batches):
            yield batch
            dataloader.dataset.commit_worker(worker)

"""Commit layer: ledger, barrier, tokens — the commit-after-step core."""

from torchkafka_tpu_torch.commit.barrier import CommitBarrier, LocalBarrier, StepFence
from torchkafka_tpu_torch.commit.ledger import OffsetLedger
from torchkafka_tpu_torch.commit.token import CommitSequencer, CommitToken

__all__ = [
    "CommitBarrier",
    "CommitSequencer",
    "CommitToken",
    "LocalBarrier",
    "OffsetLedger",
    "StepFence",
]

"""Checkpoint/resume: train state and stream position, atomically paired."""

from torchkafka_tpu_torch.checkpoint.manager import StreamCheckpointer

__all__ = ["StreamCheckpointer"]

"""Commit barrier: prove the step retired, then line up every process.

Port of ``torchkafka_tpu/commit/barrier.py``. Before a batch's offsets may
commit, the barrier

1. proves the step that consumed the batch has finished on the device: a
   CUDA event recorded on the stream that ran the step, synchronised on
   the host, plus (strict mode) a one-element host read of the step's
   first tensor result;
2. with ``torch.distributed`` initialised over more than one process,
   waits for every process (``torch.distributed.barrier()``);
3. only then lets the commit proceed.

Fail-closed: any failure in either step raises ``BarrierError``; nothing
commits and Kafka re-delivers the batch.

The event must be recorded on the stream that enqueued the step, at the
time the caller hands the step's result over. ``fence(wait_for)`` does that
on the caller's thread and returns a ``StepFence``; the barrier may then
run later on another thread (``CommitToken.commit_async`` runs it on the
stream's commit thread). An event recorded on the commit thread's own
current stream would prove nothing about the step.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from torchkafka_tpu_torch.errors import BarrierError
from torchkafka_tpu_torch.utils.tree import tree_leaves

logger = logging.getLogger(__name__)


class StepFence:
    """What the barrier needs to prove a step retired: the CUDA event
    recorded on the current stream of each device the step's results live
    on, and the first non-empty tensor result (for the strict host read)."""

    def __init__(self, wait_for: Any) -> None:
        tensors = [
            t for t in tree_leaves(wait_for)
            if isinstance(t, torch.Tensor) and t.numel() > 0
        ]
        self.first = tensors[0] if tensors else None
        self.events = []
        for dev in {t.device for t in tensors if t.is_cuda}:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            self.events.append(event)


def _as_fence(wait_for: Any) -> StepFence:
    return wait_for if isinstance(wait_for, StepFence) else StepFence(wait_for)


class CommitBarrier:
    """Callable barrier used by CommitToken before offsets are committed.

    Single-process: only the retirement proof. Multi-process (an
    initialised ``torch.distributed`` group of more than one process): adds
    ``torch.distributed.barrier()``; collectives pair up in call order, so
    every process must commit the same batches in the same order (the
    stream's commit calls are identical across processes)."""

    def __init__(self, name: str = "tpukafka_commit", strict: bool = True) -> None:
        self._name = name
        self._calls = 0
        self._strict = strict

    @staticmethod
    def fence(wait_for: Any) -> StepFence:
        """Record the step's completion events on the CALLER's current
        streams, for a barrier that runs later (possibly on another
        thread)."""
        return _as_fence(wait_for)

    def _retire(self, wait_for: Any) -> None:
        """Prove the step's device work is complete: every fence event
        synchronised, plus — in strict mode — a one-element host read of
        the first tensor result, so a backend that returned from the
        synchronise early, or a step that faulted, cannot pass as retired.
        Cost: one scalar D2H per batch."""
        fence = _as_fence(wait_for)
        for event in fence.events:
            event.synchronize()
        if self._strict and fence.first is not None:
            fence.first.detach().reshape(-1)[0].item()

    def __call__(self, wait_for: Any = None) -> None:
        try:
            if wait_for is not None:
                # Retire the step that consumed the batch: host-side proof the
                # batch's results exist before its offsets become committable.
                self._retire(wait_for)
            self._calls += 1
            if _world_size() > 1:
                torch.distributed.barrier()
        except BarrierError:
            raise
        except Exception as e:
            # Fail closed: a barrier failure means we cannot prove every
            # process finished the step -> nobody commits -> Kafka re-delivers.
            raise BarrierError(
                f"commit barrier {self._name}:{self._calls} failed (no offsets "
                f"committed): {e}"
            ) from e


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class LocalBarrier(CommitBarrier):
    """Barrier that only proves local retirement — explicit single-process
    mode, even inside a process group."""

    def __call__(self, wait_for: Any = None) -> None:
        try:
            if wait_for is not None:
                self._retire(wait_for)
        except Exception as e:
            raise BarrierError(
                f"step retirement failed (no offsets committed): {e}"
            ) from e

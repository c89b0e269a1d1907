"""The collectives of the multi-process train step, by written rule.

The step calls these on plain local tensors (DTensor is used for placement
only; see ``parallel/mesh.py``). Which primitive runs depends on the
group's backend alone, never on a failure:

- **nccl**: on the device. Gather is ``all_gather_into_tensor``,
  reduce-scatter ``reduce_scatter_tensor``, both over the leading dim
  (another dim is moved to the front first).
- **gloo**: on host memory. A CUDA tensor is copied into a pinned host
  buffer, the collective runs there, and the result is copied back to the
  card (one path for CUDA and CPU tensors, measured at the 1b model's 5 GB
  of gradients on the H100; gloo's own CUDA path passed only small
  probes there, and DTensor's all-gather through it ended the process
  with SIGSEGV: ``chip_probe_dist.py``, PERF.md's PR 20 findings). Gather
  is ``all_gather`` of a list, and a reduce-scatter is an ``all_reduce``
  after which each rank keeps its own chunk (twice the bytes of a
  reduce-scatter, and the one reduction every gloo build runs).

``COUNTS`` adds up, per process, the calls, the bytes each call handed to
the group (the full buffer a rank reduces or gathers into) and the host
seconds spent inside them; ``COUNTS.reset()`` zeroes them.
"""

from __future__ import annotations

import time

import torch


class _Counts:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes, "seconds": self.seconds}


COUNTS = _Counts()

# Pinned host buffers for staging, one growing buffer per dtype.
_PINNED: dict[torch.dtype, torch.Tensor] = {}


def backend(group=None) -> str:
    return str(torch.distributed.get_backend(group)).lower()


def group_size(group=None) -> int:
    return torch.distributed.get_world_size(group)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (in a reused buffer)."""
    n = t.numel()
    buf = _PINNED.get(t.dtype)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1), dtype=t.dtype, pin_memory=True)
        _PINNED[t.dtype] = buf
    host = buf[:n].view(t.shape)
    host.copy_(t)
    return host


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and backend(group) == "gloo"


def _account(t: torch.Tensor, t0: float) -> None:
    COUNTS.calls += 1
    COUNTS.bytes += t.numel() * t.element_size()
    COUNTS.seconds += time.perf_counter() - t0


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if group_size(group) == 1:
        return t
    t0 = time.perf_counter()
    if _staged(t, group):
        host = _host(t)
        torch.distributed.all_reduce(host, group=group)
        t.copy_(host)
    else:
        torch.distributed.all_reduce(t, group=group)
    _account(t, t0)
    return t


def all_gather(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    t0 = time.perf_counter()
    if backend(group) == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype, device=t.device)
        torch.distributed.all_gather_into_tensor(out, src, group=group)
        full = out.movedim(0, dim)
    else:
        src = _host(t) if t.is_cuda else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        torch.distributed.all_gather(parts, src, group=group)
        full = torch.cat(parts, dim=dim).to(t.device)
    _account(full, t0)
    return full


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, of which this rank
    keeps its chunk along ``dim`` (chunk i for group rank i)."""
    n = group_size(group)
    if n == 1:
        return t
    me = torch.distributed.get_rank(group)
    t0 = time.perf_counter()
    if backend(group) == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype, device=t.device)
        torch.distributed.reduce_scatter_tensor(out, src, group=group)
        shard = out.movedim(0, dim).contiguous()
    else:
        host = _host(t) if t.is_cuda else t.clone()
        torch.distributed.all_reduce(host, group=group)
        shard = host.chunk(n, dim=dim)[me].to(t.device, copy=True).contiguous()
    _account(t, t0)
    return shard

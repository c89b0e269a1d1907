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

The point-to-point exchange (``ppermute``, the ring's hop) and the
all-to-all (``all_to_all``, Ulysses' head exchange) follow the same rule:
``batch_isend_irecv`` and ``all_to_all_single`` on the device under nccl;
under gloo every tensor, on the card or the CPU, goes through host
staging buffers, the bytes sent and the bytes received each in a buffer of
their own (a send still in flight must not read what a receive writes).
The result is always a fresh tensor on the input's device, so the next
call may reuse the buffers.

Autograd: ``ppermute`` and ``all_to_all`` are differentiable (the
backward runs the inverse exchange); ``copy_to_tp`` and
``reduce_from_tp`` are Megatron's pair for a block split over one group
or several (identity forward and sum backward at the input of a
column-parallel product; sum forward and identity backward after a
row-parallel one): tp, ep and the combined tp × ep region of an expert
layer, the pipeline's input over pp and the router statistics over the
axes that split tokens. ``broadcast`` hands one rank's tensor to its
group; its backward keeps the source's own gradient and gives the
others zeros (the pipeline's output, replicated over pp, whose downstream
each pp rank computes alike: the gradient reaches the last stage once).

``COUNTS`` adds up, per process, the calls, the bytes each call handed to
the group (the full buffer a rank reduces or gathers into, or sends) and
the host seconds spent inside them; ``COUNTS.reset()`` zeroes them.
"""

from __future__ import annotations

import math
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

# Host buffers for staging under gloo, one growing buffer per (dtype, slot,
# pinned): pinned for CUDA tensors. A send and a receive in flight together
# take different slots.
_STAGING: dict[tuple, torch.Tensor] = {}


def backend(group=None) -> str:
    return str(torch.distributed.get_backend(group)).lower()


def group_size(group=None) -> int:
    return torch.distributed.get_world_size(group)


def _staging(shape, dtype: torch.dtype, slot: str, pinned: bool) -> torch.Tensor:
    """A host buffer of ``shape`` in the reused buffer of (dtype, slot,
    pinned), grown on demand; its contents are undefined. The buffer is
    a normal tensor even when it is made under ``torch.inference_mode``
    (a serving tick), so a train step in the same process may write it."""
    n = math.prod(shape)
    key = (dtype, slot, pinned)
    buf = _STAGING.get(key)
    if buf is None or buf.numel() < n:
        with torch.inference_mode(False):
            buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=pinned)
        _STAGING[key] = buf
    return buf[:n].view(shape)


def _host(t: torch.Tensor, slot: str = "send") -> torch.Tensor:
    """A host copy of ``t`` in the staging buffer of ``slot`` (pinned for
    a CUDA tensor)."""
    host = _staging(t.shape, t.dtype, slot, t.is_cuda)
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


def _global(group, group_rank: int) -> int:
    return torch.distributed.get_global_rank(group, group_rank) if group is not None \
        else group_rank


def _exchange_buffers(t: torch.Tensor, group) -> tuple:
    """(send, recv, staged) for an exchange of ``t``'s bytes: on the
    device under nccl; under gloo host staging buffers, one for each
    direction."""
    if backend(group) == "nccl":
        send = t.contiguous()
        return send, torch.empty_like(send), False
    return _host(t, "send"), _staging(t.shape, t.dtype, "recv", t.is_cuda), True


def _ppermute(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    dist = torch.distributed
    n = group_size(group)
    me = dist.get_rank(group)
    dst, src = _global(group, (me + shift) % n), _global(group, (me - shift) % n)
    t0 = time.perf_counter()
    send, recv, staged = _exchange_buffers(t, group)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                    dist.P2POp(dist.irecv, recv, src, group)])
    for w in works:
        w.wait()
    out = recv.to(t.device, copy=True) if staged else recv
    _account(t, t0)
    return out


def _all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size {t.shape[split_dim]} "
                         f"does not split over {n} ranks")
    t0 = time.perf_counter()
    # Leading dim split: rows j·c ... (j+1)·c - 1 go to rank j.
    send, recv, staged = _exchange_buffers(t.movedim(split_dim, 0), group)
    torch.distributed.all_to_all_single(recv, send, group=group)
    got = recv.to(t.device, copy=True) if staged else recv
    pieces = [p.movedim(0, split_dim) for p in got.chunk(n, dim=0)]  # piece j: rank j's
    _account(t, t0)
    return torch.cat(pieces, dim=concat_dim)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(t, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(t, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


def ppermute(t: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Send ``t`` to group rank (me + shift) mod n and return what group
    rank (me - shift) mod n sent (``lax.ppermute`` over a ring): a fresh
    tensor on ``t``'s device. Differentiable: the gradient goes back the
    other way. A shift of a multiple of n moves nothing and returns ``t``."""
    if shift % group_size(group) == 0:
        return t
    return _Ppermute.apply(t, group, shift)


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, group=None) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: split ``t`` along ``split_dim`` into
    n chunks, send chunk j to group rank j, and concatenate what every rank
    sent along ``concat_dim`` in group-rank order. Differentiable: the
    backward is the inverse exchange."""
    if group_size(group) == 1:
        return t
    return _AllToAll.apply(t, split_dim, concat_dim, group)


def _groups(groups) -> tuple:
    """A group or a sequence of groups → the tuple of those with more
    than one rank (None, the default group, counts as one)."""
    seq = tuple(groups) if isinstance(groups, (tuple, list)) else (groups,)
    return tuple(g for g in seq if group_size(g) > 1)


def _sum_over(t: torch.Tensor, groups: tuple) -> torch.Tensor:
    out = t.clone()
    for g in groups:
        all_reduce_(out, g)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        return _sum_over(t, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(t: torch.Tensor, groups) -> torch.Tensor:
    """The input of a column-parallel product (Megatron's f): the identity
    forward; the backward sums the gradient over ``groups`` (a group or a
    sequence of groups, summed in turn), since each rank's part of the
    product contributes a part of it."""
    groups = _groups(groups)
    if not groups:
        return t
    return _CopyTo.apply(t, groups)


def reduce_from_tp(t: torch.Tensor, groups) -> torch.Tensor:
    """The output of a row-parallel product (Megatron's g): the forward
    sums the ranks' partial results over ``groups`` (a group or a sequence
    of groups); the backward is the identity."""
    groups = _groups(groups)
    if not groups:
        return t
    return _ReduceFrom.apply(t, groups)


def _broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of ``group``: a fresh
    tensor of ``t``'s shape on ``t``'s device (the shape and dtype must
    agree across the group)."""
    root = _global(group, src)
    t0 = time.perf_counter()
    if backend(group) == "nccl":
        out = t.contiguous().clone()
        torch.distributed.broadcast(out, root, group=group)
    else:
        host = _host(t) if t.is_cuda else t.contiguous().clone()
        torch.distributed.broadcast(host, root, group=group)
        out = host.to(t.device, copy=True)
    _account(t, t0)
    return out


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, src):
        ctx.is_src = torch.distributed.get_rank(group) == src
        return _broadcast(t, group, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of ``group`` (every rank
    passes a tensor of the same shape and dtype; only the source's values
    are read). Differentiable for a value every rank then uses alike: the
    source keeps its own gradient and the other ranks' inputs get zeros,
    so the gradient reaches the source once, not once per rank. No
    collective runs in the backward."""
    if group_size(group) == 1:
        return t
    return _Broadcast.apply(t, group, src)

"""One controller's host loop run as SPMD ranks of a serving mesh.

The JAX package serves a mesh from one controller: one consumer, one host
loop, and GSPMD spreads the device program over the chips. The port's
mesh is processes, one rank per mesh position, and every rank runs the
same host loop (admission, scheduling, retirement, sampling) on the same
records, so the ranks' device programs line up collective for collective.
What keeps the loops in step is that every decision they take comes from
the same inputs:

- **One consumer.** The mesh's root (every coordinate 0) polls; the
  records are broadcast to every rank, pickled as the wire formats are
  (``MeshConsumer``). So is every other answer a consumer gives the loop
  (assignment, paused partitions).
- **Side effects happen once.** Offset commits, pauses, resumes and
  closes reach the root's consumer only; the server keeps its outputs,
  journal, dead letters and distill frames on the root
  (``serve.StreamingGenerator``).
- **Clock decisions come from the root.** A decision taken from a clock
  (an idle timeout) is taken on the root and broadcast (``agree``), or one
  rank admits in a quantum another skips and the next collective waits
  for ever (the process group's timeout then fails it).

The broadcasts run on the mesh's own axis groups, never the commit
barrier's group (``parallel.multihost.barrier_group``), and only from the
thread that runs the loop.
"""

from __future__ import annotations

import torch


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def is_root(mesh) -> bool:
    """Is this rank the mesh's root (every coordinate 0)?"""
    coord = mesh.get_coordinate()
    return coord is not None and all(int(c) == 0 for c in coord)


def broadcast_root(mesh, obj):
    """The root's ``obj`` on every rank of ``mesh``, pickled: a broadcast
    from coordinate 0 along each axis in turn, so after the last axis
    every rank holds the root's copy (what the others pass is ignored).
    Every rank of the mesh must call."""
    dist = torch.distributed
    buf = [obj]
    sizes = _sizes(mesh)
    for axis in mesh.mesh_dim_names:
        if sizes[axis] > 1:
            g = mesh.get_group(axis)
            dist.broadcast_object_list(buf, src=dist.get_global_rank(g, 0), group=g)
    return buf[0]


def mesh_barrier(mesh) -> None:
    """A barrier over the ranks of ``mesh`` alone: one over each axis group
    in turn (every rank of the mesh must call)."""
    sizes = _sizes(mesh)
    for axis in mesh.mesh_dim_names:
        if sizes[axis] > 1:
            torch.distributed.barrier(group=mesh.get_group(axis))


def agree(mesh, value):
    """The root's ``value`` on every rank (``broadcast_root``); the
    identity without a mesh."""
    return value if mesh is None else broadcast_root(mesh, value)


class MeshConsumer:
    """The root's consumer as every rank of a serving mesh sees it.

    ``inner``: the consumer on the root; None on the other ranks. A call
    that answers the loop (``poll``, ``assignment``, ``paused``,
    ``has_paused``) runs on the root and its answer is broadcast, so every
    rank must make it at the same point of the loop; a call with a side
    effect (``commit``, ``pause``, ``resume``, ``heartbeat``, ``close``)
    runs on the root alone and returns nothing elsewhere. Attributes of
    the consumer (``group_id``, ``member_id``, ...) are the root's, None
    on the other ranks."""

    def __init__(self, inner, mesh) -> None:
        self.root = is_root(mesh)
        if self.root and inner is None:
            raise ValueError("the serving mesh's root rank needs a consumer")
        if not self.root and inner is not None:
            raise ValueError(
                "on a serving mesh only the root rank (every coordinate 0) "
                "takes a consumer; the other ranks pass consumer=None"
            )
        self.inner = inner
        self.mesh = mesh

    def _answer(self, name: str, *args, **kwargs):
        value = getattr(self.inner, name)(*args, **kwargs) if self.root else None
        return broadcast_root(self.mesh, value)

    def poll(self, max_records: int = 1, timeout_ms: int = 0) -> list:
        return self._answer("poll", max_records=max_records, timeout_ms=timeout_ms)

    def assignment(self):
        return self._answer("assignment")

    def paused(self):
        return self._answer("paused")

    def has_paused(self) -> bool:
        return self._answer("has_paused")

    def _effect(self, name: str, *args, **kwargs):
        if self.root:
            return getattr(self.inner, name)(*args, **kwargs)
        return None

    def commit(self, offsets) -> None:
        return self._effect("commit", offsets)

    def pause(self, *tps) -> None:
        return self._effect("pause", *tps)

    def resume(self, *tps) -> None:
        return self._effect("resume", *tps)

    def heartbeat(self) -> None:
        return self._effect("heartbeat")

    def close(self) -> None:
        return self._effect("close")

    def __getattr__(self, name: str):
        if name.startswith("__") or name in ("inner", "root", "mesh"):
            raise AttributeError(name)
        return getattr(self.inner, name) if self.root else None

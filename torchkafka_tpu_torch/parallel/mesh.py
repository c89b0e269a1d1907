"""Process meshes over ``torch.distributed``: port of
``torchkafka_tpu/parallel/mesh.py``.

The JAX package lays a ``jax.sharding.Mesh`` over chips; the port lays a
``torch.distributed.device_mesh.DeviceMesh`` over processes, one rank per
mesh position (a rank runs on the device ``parallel.multihost.initialize``
gave it, its own card or a share of one). Placements take the place of
``NamedSharding``: ``batch_sharding`` gives ``Shard(0)`` over the data
axes and ``Replicate()`` over the others, and ``global_batch`` wraps each
rank's local rows as a ``DTensor`` without moving them, so a reduction
over it is a reduction across processes, as
``jax.make_array_from_process_local_data`` gives.

DTensor is used here for placement only. The train step
(``models/transformer.py make_train_step(cfg, mesh)``) runs its kernels on
each rank's local tensors and issues its collectives itself: DTensor has
no sharding rule for a ``ctypes`` kernel.

A mesh needs a process group. Inside one, every rank must build its
meshes in the same order (``DeviceMesh`` creates a group per axis, a
collective call). Outside one, ``make_mesh`` starts a one-process group on
an in-process store (no network): the single-process case of the JAX
package's ``make_mesh``.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from torchkafka_tpu_torch.utils.tree import tree_map


def process_count() -> int:
    """Ranks in the initialised process group, 1 outside one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank, 0 outside a process group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _mesh_sizes(axes: Mapping[str, int] | None, n: int) -> tuple[list[str], list[int]]:
    """The JAX package's axis arithmetic and errors: at most one -1 axis,
    inferred; the sizes must multiply to ``n``."""
    if axes is None:
        axes = {"data": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known != 0:
            raise ValueError(f"cannot infer -1 axis: {n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {np.prod(sizes)} devices, have {n}")
    return names, sizes


def make_mesh(
    axes: Mapping[str, int] | None = None,
    *,
    devices: Sequence[int] | None = None,
    device: str | torch.device | None = None,
):
    """Build a ``DeviceMesh`` from {axis_name: size}. Default: every rank
    on one ``data`` axis (pure data parallelism).

    ``devices``: the ranks to lay out (default: all of them, in rank
    order); the sizes must multiply to their count, and a single -1 axis
    is inferred, with the JAX package's ``ValueError``s. ``device``: the
    device type of the mesh; None takes the device
    ``multihost.initialize`` gave this rank (CUDA outside a group
    started there, raising without a card)."""
    from torchkafka_tpu_torch.parallel import multihost

    dev = multihost.ensure_group(device)
    ranks = list(devices) if devices is not None else list(range(process_count()))
    names, sizes = _mesh_sizes(axes, len(ranks))
    from torch.distributed.device_mesh import DeviceMesh

    mesh_ranks = torch.tensor(ranks, dtype=torch.int64).reshape(sizes)
    return DeviceMesh(dev.type, mesh_ranks, mesh_dim_names=tuple(names))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``jax.sharding.Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _data_axes(mesh, data_axis: str | Sequence[str]) -> tuple[str, ...]:
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), got {type(mesh).__name__}")
    axes = (data_axis,) if isinstance(data_axis, str) else tuple(data_axis)
    missing = [a for a in axes if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"data axes {missing} are not axes of the mesh {axis_sizes(mesh)}")
    return axes


def batch_sharding(mesh, data_axis: str | Sequence[str] = "data") -> list:
    """Placements for ingest batches, one per mesh axis: the leading
    (batch) dim split over the data axis (or axes, e.g. ``("data",
    "fsdp")``), every other axis replicated."""
    from torch.distributed.tensor import Replicate, Shard

    axes = _data_axes(mesh, data_axis)
    return [Shard(0) if name in axes else Replicate() for name in mesh.mesh_dim_names]


def global_batch(
    host_local: Any,
    mesh,
    data_axis: str | Sequence[str] = "data",
) -> Any:
    """Each rank's local batch tree → a tree of ``DTensor``s sharded over
    the data axes (no copy: each wraps the rank's own rows, on the mesh's
    device). The global leading dim is the local one times the product of
    the data axes; rank r's rows are global rows [r·b, (r+1)·b) when the
    data axes lead the mesh, as ``make_mesh`` lays them out."""
    from torch.distributed.tensor import DTensor

    placements = batch_sharding(mesh, data_axis)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def leaf(x):
        if isinstance(x, DTensor):
            return x
        t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x,
                            device=dev)
        return DTensor.from_local(t, mesh, placements, run_check=False)

    return tree_map(leaf, host_local)


def local_part(x: Any) -> Any:
    """This rank's local tensor of a ``DTensor``: the very tensor object
    the DTensor holds (not an autograd view of it, so an optimizer built
    over it updates the DTensor in place); any other value unchanged."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    with torch.no_grad():
        return x.to_local()


def full_tensor(x: Any) -> Any:
    """The global value of a ``DTensor``, gathered (sharded axes) or
    summed (partial ones) through ``parallel.collectives``' written rules;
    every rank of its mesh must call. Any other value comes back as it
    is. (``DTensor.full_tensor`` of a sharded CUDA DTensor under gloo
    ended the process with SIGSEGV on the card: ``chip_probe_dist.py``.)"""
    from torch.distributed.tensor import DTensor, Shard

    from torchkafka_tpu_torch.parallel import collectives

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    t = x.to_local().detach()
    # Mesh axis 0 splits first, so the innermost axis is gathered first.
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if isinstance(p, Shard):
            t = collectives.all_gather(t, p.dim, mesh.get_group(i))
        elif p.is_partial():
            t = collectives.all_reduce_(t.clone(), mesh.get_group(i))
    return t


def distribute(full: torch.Tensor, mesh, placements: Sequence) -> Any:
    """A ``DTensor`` over ``mesh`` holding this rank's chunk of ``full``
    (the same value on every rank) under ``placements``; no
    communication. Sizes along a sharded dim must divide evenly. A chunk
    is a copy (so ``full`` can be freed); a replicated result shares
    ``full``'s storage."""
    from torch.distributed.tensor import DTensor, Shard

    t = full.detach()
    coord = mesh.get_coordinate()
    sharded = False
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if t.shape[p.dim] % n:
                raise ValueError(
                    f"dim {p.dim} of size {t.shape[p.dim]} does not split over "
                    f"mesh axis {mesh.mesh_dim_names[i]!r} of size {n}")
            t = t.chunk(n, dim=p.dim)[coord[i]]
            sharded = sharded or n > 1
    local = t.contiguous().clone() if sharded else t
    return DTensor.from_local(local, mesh, list(placements), run_check=False)

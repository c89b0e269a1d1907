"""GPipe pipeline parallelism over a ``pp`` mesh axis: port of
``torchkafka_tpu/ops/pipeline.py``.

The stacked-layer parameters ([L, ...] per tensor) shard their layer dim
over ``pp``: stage p owns layers [p·L/P, (p+1)·L/P). The batch splits into
M microbatches and runs the GPipe schedule, M + P - 1 ticks, each stage
applying its local layers to the microbatch it holds and handing the
activation to the next stage (``parallel.collectives.ppermute`` over the
pp group, one hop of a ring).

Each rank is one stage and runs its layers only on the ticks where it
holds a real microbatch (tick t, stage p: t - p in [0, M)). The JAX
package computes every stage on every tick and masks the warm-up and
drain results, because a ``shard_map`` body cannot branch per device; a
rank can, so a stage launches its layers' kernels (K1 forward, K2/K3
backward) (L/P)·M times a step, no more.

Autograd runs through the chain of ticks: each tick's activation is the
previous tick's, passed on unchanged on an idle tick, so every rank's
backward replays the same M + P - 2 hops in reverse (the backward of
``ppermute`` is the reverse hop) and the pp group never waits on a rank
that skipped one. Stage 0 takes microbatch t at tick t < M through a
select whose other branch gets a zero gradient (the JAX package's
``where``); the other stages select the other way, so the input is used
on every rank. The output is the last stage's, broadcast over pp
(``collectives.broadcast``: the gradient reaches the last stage once);
the input's gradient, non-zero on stage 0 alone, is summed over pp
(``copy_to_tp`` over the pp group), so every stage holds the same one, as
the JAX package's psum gives.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from torchkafka_tpu_torch.parallel import collectives


class _Select(torch.autograd.Function):
    """``a`` if ``first`` else ``b``; the branch not taken gets a zero
    gradient, so it stays in the graph (and its producer's backward runs
    on every rank)."""

    @staticmethod
    def forward(ctx, a, b, first):
        ctx.first = first
        return (a if first else b).view_as(a)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g)
        return (g, zero, None) if ctx.first else (zero, g, None)


def gpipe(
    layer_fn: Callable[[torch.Tensor, Mapping], Any],
    layer_params: Mapping,
    x: torch.Tensor,
    *,
    mesh,
    axis: str = "pp",
    microbatches: int | None = None,
    extra_manual: frozenset[str] | set[str] = frozenset(),
    act_spec: Any = None,
    collect_stats: bool = False,
):
    """Pipelined equivalent of the sequential loop of ``layer_fn`` over
    stacked layers.

    layer_fn(act, one_layer) -> act; ``layer_params``: a dict of this
    stage's stacked layers, [L/P, ...] per tensor (with pp = 1, all L);
    ``x``: [B, ...] activations, the same on every stage (this rank's rows
    on a batch-sharded mesh). Returns what the sequential loop returns, up
    to summation order, on every stage.

    ``microbatches`` (default: the pipeline depth P) must divide B, else
    ``ValueError``; deeper M shrinks the bubble (P-1)/(M+P-1). With P = 1
    this is the plain loop.

    ``extra_manual``: mesh axes the layer body runs its own collectives
    over (``{"sp"}`` when attention is ring or Ulysses); the statistics
    below are summed over them too. ``act_spec``: the JAX package's
    PartitionSpec of one activation; here each rank already holds its own
    chunk, so it is accepted and unused.

    ``collect_stats``: layer_fn instead returns (act, stats), stats a
    fixed-shape f32 tensor of per-layer token sums (the MoE router's load
    statistics). gpipe then also returns [L, *stats]: per layer, the
    statistic summed over every microbatch (valid ticks only), over the
    stages (each stage's rows at its layer offset) and over
    ``extra_manual``, the same on every stage. Its backward is the
    identity (``reduce_from_tp``): the caller's use of the sums is
    replicated over those axes.

    Kernel launches: each stage runs its L/P layers on M microbatches, so
    K1 (and K2/K3 in the backward) run (L/P)·M times per rank a step."""
    from torchkafka_tpu_torch.models.transformer import unstack_layers

    n_stages = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get(axis, 1)
    layers = unstack_layers(layer_params)
    if n_stages == 1:
        act, stats = x, []
        for layer in layers:
            out = layer_fn(act, layer)
            act, st = out if collect_stats else (out, None)
            stats.append(st)
        return (act, torch.stack(stats)) if collect_stats else act
    m = microbatches if microbatches is not None else n_stages
    batch = x.shape[0]
    if batch % m != 0:
        raise ValueError(f"batch {batch} not divisible by microbatches {m}")
    group = mesh.get_group(axis)
    stage = torch.distributed.get_rank(group)
    last = n_stages - 1

    x_mb = collectives.copy_to_tp(x, group).reshape(m, batch // m, *x.shape[1:])
    act = torch.zeros_like(x_mb[0])
    outs, stats = [], []
    for t in range(m + n_stages - 1):
        if t < m:
            act = _Select.apply(x_mb[t], act, stage == 0)
        if 0 <= t - stage < m:
            for layer in layers:
                out = layer_fn(act, layer)
                act, st = out if collect_stats else (out, None)
                stats.append(st)
        if t >= last:
            outs.append(act)
        if t < m + n_stages - 2:
            act = collectives.ppermute(act, group, 1)
    out = collectives.broadcast(torch.stack(outs), group, last)
    out = out.reshape(batch, *x.shape[1:])
    if not collect_stats:
        return out
    n_local = len(layers)
    # [M·L/P, ...] in tick order → [L/P, ...] summed over microbatches.
    local = torch.stack(stats).reshape(m, n_local, *stats[0].shape).sum(0)
    full = torch.cat([local.new_zeros((stage * n_local, *local.shape[1:])), local,
                      local.new_zeros(((last - stage) * n_local, *local.shape[1:]))])
    groups = [group] + [mesh.get_group(a) for a in sorted(extra_manual)
                        if a in mesh.mesh_dim_names]
    return out, collectives.reduce_from_tp(full, groups)

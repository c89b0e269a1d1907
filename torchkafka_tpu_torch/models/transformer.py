"""Llama-style decoder (SwiGLU or mixture-of-experts, GQA, RoPE): port of
``torchkafka_tpu/models/transformer.py``, the trunk, the training loss and
the train step.

Parameters keep the JAX package's tree: a plain dict with every per-layer
tensor stacked on a leading ``[L, ...]`` axis under the same names, so
``params_from_numpy`` converts a JAX-initialised tree name for name. The
forward loops over the layer axis (the JAX package's ``lax.scan``);
``cfg.remat`` checkpoints each layer (``torch.utils.checkpoint``, the JAX
package's ``jax.checkpoint`` of the scan body). Attention dispatches to
``ops.flash.flash_attention`` (the CUDA kernels on the card, forward and
backward) or to the dense ``mha``, per ``cfg.attn_impl``. Master weights
stay in ``cfg.param_dtype``; every matmul casts them to ``cfg.dtype``
through differentiable casts, so gradients land on the masters.

``make_train_step`` returns the JAX package's ``(init_fn, step_fn)`` pair;
the step updates the parameters and the optimizer state in place, which is
PyTorch's idiom for the JAX step's buffer donation.

MoE layers route through ``cfg.moe_dispatch``: ``"dense"`` (every expert
computes every token, the one-hot combine keeps the routed ones) or
``"capacity"`` (Switch-style groups with per-expert slots; overflow
drops). Both route top-k with ``lax.top_k``'s tie order. The serving
prefill uses the config's dispatch; the decode read always routes dense
(``models/generate.py _attn_tail``), as in the JAX package.

Meshes: ``Transformer(cfg, mesh)`` and ``make_train_step(cfg, mesh,
opt)`` take a ``parallel.make_mesh`` mesh over the axes ``data``,
``fsdp``, ``tp``, ``sp``, ``pp`` and ``ep``. The parameters are
``DTensor``s laid out per ``param_specs`` (``fsdp`` shards each weight's
model dim, ``tp`` its heads, ``d_ff`` columns and the vocabulary, ``pp``
the stacked layer dim, ``ep`` the expert dim, the rest replicates) and the
batch is split over data × fsdp; the step runs the kernels on each rank's
local tensors (see ``_mesh_train_step``). Under ``tp`` a layer is
Megatron's: each rank computes its q/kv heads and its ``d_ff`` columns,
the outputs of ``wo`` and ``w_down`` are summed over tp in the forward and
the inputs of ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` in the backward
(``parallel.collectives``' ``reduce_from_tp``/``copy_to_tp``). Under
``sp`` each rank runs its chunk of the sequence (RoPE at global positions)
and attention is ring or Ulysses (``cfg.attn_impl``; "auto" is ring).
Under ``pp`` the layers run as a GPipe schedule (``ops.pipeline.gpipe``,
``cfg.pp_microbatches``); the embedding, the final norm and the head stay
outside it, replicated over pp. Under ``ep`` each rank holds E/ep experts
(each one's ``d_ff`` split over tp) and computes them over its rows; the
expert outputs are summed over ep and tp, and the router stays
replicated. The router's load statistics are summed over every axis that
splits tokens (data, fsdp, sp and the pipeline's microbatches) before
``router_aux``, so the aux loss is the global batch's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from torchkafka_tpu_torch.models.quant import QTensor, embed_rows, load_weight
from torchkafka_tpu_torch.ops.attention import (
    _repeat_kv,
    mha,
    ring_attention,
    ulysses_attention,
)
from torchkafka_tpu_torch.ops.xent import dense_softmax_xent, fused_softmax_xent
from torchkafka_tpu_torch.optim import adamw
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.tree import tree_leaves

def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to torchkafka_tpu_torch yet (ROADMAP queue A: {item})"
    )


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8  # < n_heads → grouped-query attention
    d_ff: int = 1376
    max_seq_len: int = 512
    rope_theta: float = 10_000.0
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32  # master weights
    remat: bool = False
    # 'dense' | 'flash' | 'ring' | 'ulysses' | 'auto': auto = ring on a
    # mesh with sp > 1, else the flash kernel on CUDA tensors and the dense
    # mha elsewhere. ring/ulysses need an sp axis above 1.
    attn_impl: str = "auto"
    ring_use_flash: bool | None = None
    n_experts: int = 0
    expert_top_k: int = 2
    router_aux_coef: float = 0.01
    moe_dispatch: str = "dense"
    capacity_factor: float = 1.25
    moe_group_size: int = 256
    pp_microbatches: int | None = None
    ce_block_size: int | None = None
    scan_unroll: int | None = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def __post_init__(self) -> None:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide by n_kv_heads")
        if self.n_experts and self.expert_top_k > self.n_experts:
            raise ValueError("expert_top_k cannot exceed n_experts")
        if self.moe_dispatch not in ("dense", "capacity"):
            raise ValueError(
                f"moe_dispatch must be 'dense' or 'capacity', got "
                f"{self.moe_dispatch!r}"
            )
        if self.capacity_factor <= 0:
            raise ValueError("capacity_factor must be positive")
        if self.moe_group_size < 1:
            raise ValueError("moe_group_size must be >= 1")


def _param_shapes(cfg: TransformerConfig) -> dict:
    dm, dff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, k, dh, v = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size
    if cfg.is_moe:
        ne = cfg.n_experts
        mlp = {
            "router": ((nl, dm, ne), dm),
            "w_gate": ((nl, ne, dm, dff), dm),
            "w_up": ((nl, ne, dm, dff), dm),
            "w_down": ((nl, ne, dff, dm), dff),
        }
    else:
        mlp = {
            "w_gate": ((nl, dm, dff), dm),
            "w_up": ((nl, dm, dff), dm),
            "w_down": ((nl, dff, dm), dff),
        }
    # name → (shape, fan_in) for the scaled-normal leaves.
    return {
        "embed": ((v, dm), dm),
        "wq": ((nl, dm, h, dh), dm),
        "wk": ((nl, dm, k, dh), dm),
        "wv": ((nl, dm, k, dh), dm),
        "wo": ((nl, h, dh, dm), h * dh),
        **mlp,
        "lm_head": ((dm, v), dm),
    }


def param_specs(cfg: TransformerConfig) -> dict:
    """The JAX package's partition specs per tensor, over mesh axes {data,
    fsdp, tp, sp, pp, ep}: a tuple per tensor with one entry per dim, an
    axis name or None (``PartitionSpec``'s entries).

    Megatron 2D layout: the "output features" dim of up-projections
    (wq/wk/wv, w_gate/w_up) and the vocab dim shard over ``tp``; the
    opposing dim shards over ``fsdp`` (ZeRO-3-style weight sharding). MoE
    expert weights add a leading expert dim sharded over ``ep``; the
    stacked layer dim shards over ``pp``. Axes a mesh lacks are stripped
    by ``shardings_for_mesh``."""
    if cfg.is_moe:
        mlp = {
            "router": (None, "fsdp", None),  # [L, D, E] — replicated over ep
            "w_gate": (None, "ep", "fsdp", "tp"),  # [L, E, D, F]
            "w_up": (None, "ep", "fsdp", "tp"),
            "w_down": (None, "ep", "tp", "fsdp"),  # [L, E, F, D]
        }
    else:
        mlp = {
            "w_gate": (None, "fsdp", "tp"),  # [L, D, F]
            "w_up": (None, "fsdp", "tp"),
            "w_down": (None, "tp", "fsdp"),  # [L, F, D]
        }
    layers = {
        "ln1": (None, None),  # [L, D]
        "ln2": (None, None),
        "wq": (None, "fsdp", "tp", None),  # [L, D, H, Dh]
        "wk": (None, "fsdp", "tp", None),  # [L, D, K, Dh]
        "wv": (None, "fsdp", "tp", None),
        "wo": (None, "tp", None, "fsdp"),  # [L, H, Dh, D]
        **mlp,
    }
    return {
        "embed": ("tp", "fsdp"),  # [V, D]
        "layers": {k: ("pp", *v[1:]) for k, v in layers.items()},
        "ln_f": (None,),  # [D]
        "lm_head": ("fsdp", "tp"),  # [D, V]
    }


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def _map_specs(fn, specs):
    if isinstance(specs, Mapping):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def _mesh_axes(mesh) -> dict[str, int]:
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), got {type(mesh).__name__}")
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def shardings_for_mesh(mesh, specs: Any) -> Any:
    """Specs → placements (one per mesh axis: ``Shard(dim)`` where the
    spec names the axis, ``Replicate()`` elsewhere), dropping axis names
    the mesh lacks (the JAX package's ``NamedSharding`` per spec)."""
    from torch.distributed.tensor import Replicate, Shard

    def fix(spec):
        dims: dict[str, int] = {}
        for d, entry in enumerate(spec):
            for name in (entry if isinstance(entry, (tuple, list)) else (entry,)):
                if name is not None and name in mesh.mesh_dim_names:
                    dims[name] = d
        return [Shard(dims[n]) if n in dims else Replicate() for n in mesh.mesh_dim_names]

    return _map_specs(fix, specs)


def batch_spec(mesh) -> tuple:
    """Tokens [B, S]: batch over data(+fsdp), sequence over sp."""
    names = mesh.mesh_dim_names
    daxes = tuple(a for a in ("data", "fsdp") if a in names)
    return (daxes if daxes else None, "sp" if "sp" in names else None)


def opt_shardings_like(opt_state, params, p_shardings, repl):
    """Placements for an optimizer state: a leaf that MIRRORS a parameter
    (its path ends with the parameter's path and the shapes match — AdamW's
    moments) takes that parameter's placements; everything else (step
    counts) ``repl``. ``opt_state``: a tree such as
    ``AdamWState.state_tree()``; ``params``: the parameter tree (global
    shapes)."""
    by_path = {}

    def walk(tree, sh, path):
        if isinstance(tree, Mapping):
            for k in tree:
                walk(tree[k], sh[k], path + (k,))
        else:
            by_path[path] = (tuple(tree.shape), sh)

    walk(params, p_shardings, ())

    def pick(tree, path):
        if isinstance(tree, Mapping):
            return {k: pick(v, path + (k,)) for k, v in tree.items()}
        shape = tuple(getattr(tree, "shape", ()))
        for i in range(len(path)):
            hit = by_path.get(path[i:])
            if hit is not None and hit[0] == shape:
                return hit[1]
        return repl

    return pick(opt_state, ())


def _check_mesh(cfg: TransformerConfig, mesh) -> dict[str, int]:
    """The axis sizes of ``mesh``, checked against ``cfg``: tp must divide
    the q and kv heads, pp the layers and ep the experts (``ValueError``
    otherwise; the JAX package serves heads tp does not divide forward-only
    by its dense dispatch). → {axis: size}."""
    sizes = _mesh_axes(mesh)
    tp = sizes.get("tp", 1)
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide the q heads ({cfg.n_heads}) and the kv "
                         f"heads ({cfg.n_kv_heads})")
    if cfg.n_layers % sizes.get("pp", 1):
        raise ValueError(f"pp={sizes['pp']} must divide n_layers ({cfg.n_layers})")
    if cfg.is_moe and cfg.n_experts % sizes.get("ep", 1):
        raise ValueError(f"ep={sizes['ep']} must divide n_experts ({cfg.n_experts})")
    return sizes


def init_params(
    generator: torch.Generator, cfg: TransformerConfig, device=None
) -> dict:
    """Scaled-normal init (std 1/√fan_in), stacked [L, ...] per layer
    tensor, drawn on ``device`` in ``cfg.param_dtype`` from ``generator``
    (which must live on that device). The numbers differ from the JAX
    package's for the same seed (another generator); tests hand both
    packages one numpy tree through ``params_from_numpy`` instead."""
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=pd, device=dev)
        return w.div_(math.sqrt(fan_in))

    shapes = _param_shapes(cfg)
    ones = lambda *s: torch.ones(s, dtype=pd, device=dev)  # noqa: E731
    layer_names = [n for n in shapes if n not in ("embed", "lm_head")]
    return {
        "embed": norm(*shapes["embed"]),
        "layers": {
            "ln1": ones(cfg.n_layers, cfg.d_model),
            "ln2": ones(cfg.n_layers, cfg.d_model),
            **{n: norm(*shapes[n]) for n in layer_names},
        },
        "ln_f": ones(cfg.d_model),
        "lm_head": norm(*shapes["lm_head"]),
    }


def params_from_numpy(tree: Mapping, cfg: TransformerConfig, device=None) -> dict:
    """The JAX package's parameter tree as numpy arrays (``QTensor``
    leaves included, as any NamedTuple with ``q``/``scale``) → the port's
    tree on ``device``, name for name, every leaf copied."""
    dev = resolve_device(device)

    def leaf(x):
        if hasattr(x, "q") and hasattr(x, "scale"):
            return QTensor(q=leaf(x.q), scale=leaf(x.scale))
        arr = np.array(x)  # a copy: torch never aliases the caller's buffer
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.from_numpy(arr).to(dev)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def layer_at(layers: Mapping, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` layer dict (views, no copies)."""
    return {
        n: QTensor(w.q[i], w.scale[i]) if isinstance(w, QTensor) else w[i]
        for n, w in layers.items()
    }


def unstack_layers(layers: Mapping) -> list[dict]:
    """Every layer of a stacked ``[L, ...]`` layer dict as views, through
    one ``unbind`` per tensor. Under autograd each stacked gradient is then
    assembled once (one stack); indexing layer by layer would instead build
    a zero-filled full-size gradient per layer and add L of them (measured
    on the card: a third of a 1b train step)."""
    cols = {
        n: [QTensor(q, sc) for q, sc in zip(w.q.unbind(0), w.scale.unbind(0))]
        if isinstance(w, QTensor) else w.unbind(0)
        for n, w in layers.items()
    }
    n_layers = len(next(iter(cols.values())))
    return [{n: c[i] for n, c in cols.items()} for i in range(n_layers)]


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, D]; positions: [S] shared across the
    batch, or [B, S] per row (the server's slots sit at different depths)."""
    dim = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim
    )
    angles = positions.float()[..., None] * freqs  # [(B,) S, D/2]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mlp(h: torch.Tensor, layer: Mapping, cfg: TransformerConfig) -> torch.Tensor:
    """Dense SwiGLU MLP (without the residual)."""
    gate = torch.nn.functional.silu(
        torch.einsum("bsd,df->bsf", h, load_weight(layer["w_gate"], cfg.dtype))
    )
    up = torch.einsum("bsd,df->bsf", h, load_weight(layer["w_up"], cfg.dtype))
    return torch.einsum(
        "bsf,fd->bsd", gate * up, load_weight(layer["w_down"], cfg.dtype)
    )


def router_aux(stats: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Switch load-balance loss from routing sufficient statistics.

    stats: [2, E] f32 — row 0 = Σ_tokens routed one-hot (how many of the
    token·top-k assignments landed on each expert), row 1 = Σ_tokens router
    softmax prob per expert. aux = E · Σ_e (routed_e/N) · (probs_e/N),
    minimized at top_k when routing is uniform."""
    e = stats.shape[-1]
    return e * torch.sum((stats[0] / n_tokens) * (stats[1] / n_tokens))


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values in descending
    order, ties broken toward the lower index. ``torch.topk`` promises no
    order among equal values; a stable descending sort keeps equal values
    in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: [...] int → [...] + [n] of ``dtype``, all zeros
    for an index outside [0, n). A comparison, so it never synchronises
    with the host (capturable in a CUDA graph)."""
    classes = torch.arange(n, device=idx.device)
    return (idx[..., None] == classes).to(dtype)


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """This rank's experts on an ep (or tp) mesh: the layer's expert
    weights hold experts [first, first + E_local) (each one's ``d_ff``
    columns this rank's under tp), and the expert outputs are partial sums
    over ``groups`` (ep and tp)."""

    first: int
    groups: tuple


def _expert_in(t: torch.Tensor, shard: ExpertShard | None) -> torch.Tensor:
    """The tokens or combine weights entering this rank's experts: the
    identity forward, their gradient summed over ep and tp backward."""
    if shard is None:
        return t
    from torchkafka_tpu_torch.parallel.collectives import copy_to_tp

    return copy_to_tp(t, shard.groups)


def _expert_out(t: torch.Tensor, shard: ExpertShard | None) -> torch.Tensor:
    """This rank's experts' share of the MoE output, summed over ep and tp."""
    if shard is None:
        return t
    from torchkafka_tpu_torch.parallel.collectives import reduce_from_tp

    return reduce_from_tp(t, shard.groups)


def _moe_mlp(h: torch.Tensor, layer: Mapping, cfg: TransformerConfig,
             shard: ExpertShard | None = None):
    """Top-k routed mixture of SwiGLU experts, dense (one-hot combine)
    dispatch: every expert computes every token and the gate-weighted
    combine keeps the routed ones. Exact w.r.t. the routing — no capacity
    drops. h: [B, S, D] → (output [B, S, D], router stats [2, E] for
    ``router_aux``). ``shard``: this rank's experts on a mesh (the router
    is computed whole on every rank; each rank combines its experts'
    outputs, summed over ep and tp)."""
    f = torch.nn.functional
    logits = torch.einsum("bsd,de->bse", h.float(), layer["router"].float())
    probs = torch.softmax(logits, dim=-1)  # [B, S, E]
    top_vals, top_idx = _top_k(probs, cfg.expert_top_k)
    gates = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)
    onehot = _one_hot(top_idx, cfg.n_experts, probs.dtype)  # [B, S, K, E]
    combine = torch.sum(onehot * gates[..., None], dim=2)  # [B, S, E]
    # Every expert over every token as one batched product over the expert
    # axis ([1, BS, D] @ [E, D, F]): einsum("bsd,edf->ebsf") would first
    # copy each expert weight into a [D, E·F] layout.
    b, s, d = h.shape
    w_gate = load_weight(layer["w_gate"], cfg.dtype)
    x = _expert_in(h, shard).reshape(1, b * s, d)
    if shard is not None:  # this rank's experts' columns (their gradient summed whole)
        combine = _expert_in(combine, shard).narrow(-1, shard.first, w_gate.shape[0])
    gate_e = f.silu(torch.matmul(x, w_gate))
    up_e = torch.matmul(x, load_weight(layer["w_up"], cfg.dtype))  # [E, BS, F]
    out_e = torch.matmul(gate_e * up_e, load_weight(layer["w_down"], cfg.dtype))
    out = torch.einsum("end,ne->nd", out_e, combine.reshape(b * s, -1).to(cfg.dtype))
    out = _expert_out(out.reshape(b, s, d), shard)
    # Load-balance sufficient stats: token-summed routed counts and probs.
    routed = onehot.detach().sum(dim=2)
    stats = torch.stack([routed.sum(dim=(0, 1)), probs.sum(dim=(0, 1))])
    return out, stats


def moe_capacity(cfg: TransformerConfig, n_tokens: int) -> int:
    """Per-expert token slots under capacity dispatch: the even share of
    (token, choice) assignments times ``capacity_factor``, rounded up to a
    multiple of 8 with a floor of 8. The rounding decides which tokens
    drop, so it is part of the contract (the JAX package pads to its
    sublane multiple)."""
    even = n_tokens * cfg.expert_top_k / cfg.n_experts
    cap = int(math.ceil(even * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


@dataclasses.dataclass(frozen=True)
class GroupSpan:
    """This rank's tokens as one part of a capacity group of ``n_g``
    tokens that spans several ranks of the batch axes. ``offsets(counts)``
    maps this rank's per-(tier, expert) assignment counts [K, E] to the
    slots the group's earlier tokens take before them: in tier k, every
    rank's tiers before k and the lower ranks' tier k."""

    n_g: int
    offsets: Callable[[torch.Tensor], torch.Tensor]


def _moe_mlp_capacity(h: torch.Tensor, layer: Mapping, cfg: TransformerConfig,
                      shard: ExpertShard | None = None, span: GroupSpan | None = None):
    """Capacity (Switch-style) dispatch: tokens split into contiguous
    groups of ``moe_group_size`` (the tail group padded with masked rows
    that claim no slot); within a group each expert takes at most
    C = ``moe_capacity(cfg, n_g)`` (token, choice) pairs, in group-major
    order: all primary choices outrank all secondary ones, tokens in
    sequence order within a tier. Overflow drops: the pair contributes
    nothing and the token's residual passes through. Dispatch and combine
    are one-hot einsums over [G, K·n_g, E, C], the JAX package's
    formulation, so the drop set is the same pair for pair. The
    load-balance stats come from the routing before capacity, padded rows
    excluded. h: [B, S, D] → (output [B, S, D], stats [2, E]).

    ``shard``: this rank's experts on a mesh (each computes its experts'
    slots; the outputs are summed over ep and tp). ``span``: this rank's
    tokens are one part of a group spanning ranks (``GroupSpan``); their
    slots start after the group's earlier tokens', so the drop set is the
    global one. The expert MLP is per slot and needs no token exchange."""
    b, s, d = h.shape
    n = b * s
    e, k = cfg.n_experts, cfg.expert_top_k
    if span is None:
        n_g = min(cfg.moe_group_size, n)
        g = -(-n // n_g)
        cap = moe_capacity(cfg, n_g)
    else:  # one group part of n tokens
        n_g, g = n, 1
        cap = moe_capacity(cfg, span.n_g)
    n_pad = g * n_g
    x = h.reshape(n, d)
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
    valid = (torch.arange(n_pad, device=h.device) < n).float()
    logits = x.float() @ layer["router"].float()
    probs = torch.softmax(logits, dim=-1)  # [N_pad, E]
    top_vals, top_idx = _top_k(probs, k)  # [N_pad, K]
    gates = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)

    def to_group_major(t: torch.Tensor) -> torch.Tensor:
        """[N_pad, K] → [G, K·n_g]: all primary choices, then all
        secondary ones, tokens in sequence order within a tier."""
        return t.reshape(g, n_g, k).transpose(1, 2).reshape(g, k * n_g)

    idx_g = to_group_major(top_idx)
    valid_g = to_group_major(valid[:, None].expand(n_pad, k))
    onehot = _one_hot(idx_g, e, torch.float32) * valid_g[..., None]
    if span is None:
        pos = torch.cumsum(onehot, dim=1) - onehot  # slot within (group, expert)
    else:  # within each tier, after the group's earlier tokens
        tiers = onehot.reshape(k, n, e)
        before = span.offsets(tiers.sum(1))  # [K, E]
        pos = (torch.cumsum(tiers, dim=1) - tiers + before[:, None]).reshape(1, k * n, e)
    keep = onehot * (pos < cap)  # overflow drops
    slot = _one_hot(pos.to(torch.int64), cap, torch.float32)
    dispatch = keep[..., None] * slot  # [G, K·n_g, E, C]
    combine = dispatch * to_group_major(gates)[..., None, None]

    w_gate = load_weight(layer["w_gate"], cfg.dtype)
    n_local = w_gate.shape[0]

    def local(t: torch.Tensor) -> torch.Tensor:  # [..., E, C] → this rank's experts
        return t if shard is None else t.narrow(-2, shard.first, n_local)

    disp5 = local(dispatch.reshape(g, k, n_g, e, cap)).to(cfg.dtype)
    comb5 = local(_expert_in(combine.reshape(g, k, n_g, e, cap).to(cfg.dtype), shard))
    x_g = _expert_in(x, shard).reshape(g, n_g, d)
    expert_in = torch.einsum("gknec,gnd->gecd", disp5, x_g)  # [G, E, C, D]
    gate_e = torch.nn.functional.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate))
    up_e = torch.einsum(
        "gecd,edf->gecf", expert_in, load_weight(layer["w_up"], cfg.dtype))
    out_e = torch.einsum(
        "gecf,efd->gecd", gate_e * up_e, load_weight(layer["w_down"], cfg.dtype))
    out = torch.einsum("gknec,gecd->gnd", comb5, out_e)
    out = _expert_out(out.reshape(n_pad, d)[:n].reshape(b, s, d), shard)

    routed = _one_hot(top_idx, e, torch.float32).sum(dim=1) * valid[:, None]
    stats = torch.stack(
        [routed.sum(dim=0), (probs * valid[:, None]).sum(dim=0)]
    )
    return out, stats


def matmul_f32(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """``x @ load_weight(w, dtype)`` with an f32 result (the JAX package's
    ``preferred_element_type=float32``): both operands go to f32 after the
    weight's cast to the compute dtype, so the products of low-precision
    inputs are exact and the sum is f32."""
    return x.float() @ load_weight(w, dtype).float()


class Transformer(nn.Module):
    """The model bound to a config. Parameters are passed per call (the
    dict tree above), so one module serves any weights of its config, as
    the JAX package's functional model does."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        if cfg.attn_impl not in ("auto", "dense", "flash", "ring", "ulysses"):
            raise ValueError(f"attn_impl must be 'auto', 'flash', 'dense', 'ring' or "
                             f"'ulysses', got {cfg.attn_impl!r}")
        sizes = _check_mesh(cfg, mesh) if mesh is not None else {}
        sp = sizes.get("sp", 1)
        if cfg.attn_impl in ("ring", "ulysses") and sp <= 1:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} requires a mesh with an 'sp' "
                f"axis of size > 1 (got sp={sp}); use attn_impl='auto' "
                "to fall back to flash/dense when sp is absent"
            )
        if sp > 1 and cfg.attn_impl in ("dense", "flash"):
            if sizes.get("pp", 1) > 1:
                raise ValueError("a pp mesh with sp>1 requires sequence-parallel "
                                 "attention (attn_impl='ring', 'ulysses', or 'auto')")
            raise ValueError(f"a mesh with sp={sp} runs each rank's chunk of the sequence: "
                             "attn_impl must be 'ring', 'ulysses' or 'auto'")
        self.cfg = cfg
        self.mesh = mesh
        self._sizes = sizes
        self._sp_impl = ("ulysses" if cfg.attn_impl == "ulysses" else "ring") if sp > 1 else None
        self._sp_size = sp
        self._group_cache: dict = {}
        # Flash on a batch- or head-sharded mesh goes through
        # flash_attention_sharded (each rank's K1-K3 on its own rows and
        # heads, no communication).
        self._flash_shard_mesh = (
            mesh if any(sizes.get(a, 1) > 1 for a in ("data", "fsdp", "tp")) else None)

    def init(self, generator: torch.Generator, device=None) -> dict:
        return init_params(generator, self.cfg, device)

    def _group(self, axis: str):
        """The mesh's process group of ``axis`` when it has more than one
        rank, else None (fetched at first use)."""
        if self._sizes.get(axis, 1) == 1:
            return None
        if axis not in self._group_cache:
            self._group_cache[axis] = self.mesh.get_group(axis)
        return self._group_cache[axis]

    def _rank_in(self, axis: str) -> int:
        group = self._group(axis)
        return 0 if group is None else torch.distributed.get_rank(group)

    def _use_flash(self, x: torch.Tensor) -> bool:
        impl = self.cfg.attn_impl
        return impl == "flash" or (impl == "auto" and x.device.type == "cuda")

    def _attention(self, q, k, v):
        """Causal attention over [B, S, ·, Dh] (this rank's heads under tp,
        its sequence chunk under sp): the flash kernel and Ulysses serve
        K < H through the kernel's kv row map; the dense and ring paths
        repeat kv heads, as in the JAX package."""
        cfg = self.cfg
        if self._sp_impl == "ulysses":
            k, v = self._ulysses_kv(q, k, v)
            return ulysses_attention(q, k, v, mesh=self.mesh, causal=True,
                                     use_flash=cfg.ring_use_flash)
        if self._sp_impl == "ring":
            k, v = _repeat_kv(q, k, v)
            return ring_attention(q, k, v, mesh=self.mesh, causal=True,
                                  use_flash=cfg.ring_use_flash)
        if self._use_flash(q):
            from torchkafka_tpu_torch.ops.flash import flash_attention, flash_attention_sharded

            if self._flash_shard_mesh is not None:
                return flash_attention_sharded(q, k, v, self._flash_shard_mesh, True)
            return flash_attention(q, k, v, True)
        k, v = _repeat_kv(q, k, v)
        return mha(q, k, v, causal=True)

    def _ulysses_kv(self, q, k, v):
        """Ulysses exchanges kv heads unrepeated, so their count must divide
        by sp. Under tp this rank's kv heads may not (2 kv heads over tp=2
        and sp=2): repeat them by the least factor that makes them divide
        by sp while still dividing the q heads (the GQA map is kept)."""
        hl, kl, sp = q.shape[2], k.shape[2], self._sp_size
        group = hl // kl
        r = next((r for r in range(1, group + 1) if group % r == 0 and (kl * r) % sp == 0),
                 1)
        if r == 1:
            return k, v
        return k.repeat_interleave(r, dim=2), v.repeat_interleave(r, dim=2)

    def _tp_in(self, h: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel product (identity forward, sum
        over tp backward); the identity without tp."""
        if self._group("tp") is None:
            return h
        from torchkafka_tpu_torch.parallel.collectives import copy_to_tp

        return copy_to_tp(h, self._group("tp"))

    def _tp_out(self, y: torch.Tensor) -> torch.Tensor:
        """The output of a row-parallel product (sum over tp forward,
        identity backward); the identity without tp."""
        if self._group("tp") is None:
            return y
        from torchkafka_tpu_torch.parallel.collectives import reduce_from_tp

        return reduce_from_tp(y, self._group("tp"))

    def _seq_chunk(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the sequence (dim 1) under sp; ``t`` itself
        otherwise."""
        if self._sp_size == 1:
            return t
        s = t.shape[1]
        if s % self._sp_size:
            raise ValueError(f"sequence length {s} does not split over sp={self._sp_size}")
        sl = s // self._sp_size
        i = self._rank_in("sp")
        return t[:, i * sl:(i + 1) * sl]

    def _moe_mlp(self, h: torch.Tensor, layer: Mapping):
        """The MoE MLP through the config's dispatch, over this rank's
        experts on an ep or tp mesh."""
        shard = None
        ep_tp = tuple(g for g in (self._group("ep"), self._group("tp")) if g is not None)
        if ep_tp:
            n_local = (layer["w_gate"].q if isinstance(layer["w_gate"], QTensor)
                       else layer["w_gate"]).shape[0]
            shard = ExpertShard(first=self._rank_in("ep") * n_local, groups=ep_tp)
        if self.cfg.moe_dispatch == "capacity":
            return _moe_mlp_capacity(h, layer, self.cfg, shard,
                                     self._capacity_span(h.shape[0], h.shape[1]))
        return _moe_mlp(h, layer, self.cfg, shard)

    def _batch_ranks(self) -> int:
        return self._sizes.get("data", 1) * self._sizes.get("fsdp", 1)

    def _capacity_span(self, b: int, s: int) -> GroupSpan | None:
        """Where this rank's b x s tokens lie in the JAX package's capacity
        groups: None when every group is within them; a ``GroupSpan`` when
        a group is made of whole ranks of the batch axes (the JAX tests'
        8 x 16 tokens form one group of 128 over two data ranks). The JAX
        package groups the global batch's tokens in row-major order (under
        pp, one global microbatch's; under pp with sp, its sequence chunk,
        the stage's manual view). Groups the port cannot place exactly
        raise ``ValueError``: groups across sp chunks, and pp microbatches
        over a batch-sharded mesh (a rank's microbatch holds other rows
        than the JAX package's global microbatch)."""
        cfg, n_b, sp = self.cfg, self._batch_ranks(), self._sp_size
        pp = self._sizes.get("pp", 1)
        if pp > 1:
            m = cfg.pp_microbatches if cfg.pp_microbatches is not None else pp
            if n_b > 1 and m > 1:
                raise ValueError(
                    f"capacity dispatch under pp with {m} microbatches on a batch-sharded "
                    f"mesh ({n_b} ranks): a rank's microbatch holds other rows than the "
                    "JAX package's global microbatch, whose capacity groups it shares; "
                    "use pp_microbatches=1 or moe_dispatch='dense'")
            seq = s
        else:
            seq = s * sp
        n_loc, n = b * s, b * n_b * seq
        if n == n_loc:  # the JAX package groups these very tokens
            return None
        n_g = min(cfg.moe_group_size, n)
        if pp == 1 and sp > 1 and s % n_g:
            raise ValueError(
                f"capacity groups of {n_g} tokens cross the sp chunks of {s} tokens "
                "(each chunk holds part of a group); use a moe_group_size that divides "
                "the chunk")
        if n_loc % n_g == 0:
            return None
        if n_g % n_loc:
            raise ValueError(f"capacity groups of {n_g} tokens straddle this rank's {n_loc} "
                             "tokens; use a moe_group_size that divides or is a multiple "
                             "of each rank's tokens")
        return GroupSpan(n_g=n_g, offsets=self._span_offsets(n_g // n_loc))

    def _span_offsets(self, span: int):
        """``GroupSpan.offsets`` for groups of ``span`` consecutive ranks of
        the batch axes (data-major, as ``global_batch`` lays rows out): one
        all-gather of every rank's [K, E] counts."""
        from torchkafka_tpu_torch.parallel.collectives import all_gather

        axes = [a for a in ("fsdp", "data") if self._sizes.get(a, 1) > 1]

        def offsets(counts: torch.Tensor) -> torch.Tensor:
            index, stride = 0, 1
            for a in axes:  # fsdp is the faster-moving index
                index += self._rank_in(a) * stride
                stride *= self._sizes[a]
            every = counts[None]
            for a in axes:
                every = all_gather(every[None], 0, self._group(a)).flatten(0, 1)
            first = index // span * span
            members = every[first:first + span]  # this rank's group, [R, K, E]
            per_tier = members.sum(0)
            return (torch.cumsum(per_tier, 0) - per_tier) + members[:index - first].sum(0)

        return offsets

    def _layer(self, x: torch.Tensor, layer: Mapping):
        """One decoder layer → (x, k, v, stats): k (after RoPE) and v are
        what the serving cache captures; stats are the MoE router's [2, E]
        sums for ``router_aux`` (None for a dense MLP)."""
        cfg = self.cfg
        sl = x.shape[1]
        positions = self._rank_in("sp") * sl + torch.arange(sl, device=x.device)  # global
        h = self._tp_in(_rms_norm(x, layer["ln1"]))
        q = torch.einsum("bsd,dhe->bshe", h, load_weight(layer["wq"], cfg.dtype))
        k = torch.einsum("bsd,dke->bske", h, load_weight(layer["wk"], cfg.dtype))
        v = torch.einsum("bsd,dke->bske", h, load_weight(layer["wv"], cfg.dtype))
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        attn = self._attention(q, k, v)
        x = x + self._tp_out(torch.einsum(
            "bshe,hed->bsd", attn, load_weight(layer["wo"], cfg.dtype)
        ))
        h = _rms_norm(x, layer["ln2"])
        if cfg.is_moe:
            mlp_out, stats = self._moe_mlp(h, layer)
            return x + mlp_out, k, v, stats
        return x + self._tp_out(_mlp(self._tp_in(h), layer, cfg)), k, v, None

    def _train_layer(self, x: torch.Tensor, layer: Mapping):
        """One layer for the trunk: (x, stats), checkpointed under
        ``cfg.remat`` (its activations recomputed in the backward)."""

        def body(x):
            x, _, _, stats = self._layer(x, layer)
            return x, stats

        if self.cfg.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(body, x, use_reentrant=False)
        return body(x)

    def trunk(self, params: dict, tokens: torch.Tensor):
        """tokens [B, S] int → (final-norm hidden states [B, S, D] in the
        compute dtype, mean per-layer router aux loss: a 0-d f32 tensor for
        MoE configs, 0.0 otherwise). Everything but the lm_head product —
        split out so ``loss`` can feed the fused blocked CE without ever
        materialising [B, S, V] logits.

        On a mesh, ``tokens`` are this rank's rows at full length and
        ``params`` the step's view of the weights: whole over fsdp, this
        rank's heads and ``d_ff`` columns of each layer weight under tp,
        its layers under pp, its experts under ep, ``embed``/``lm_head``
        whole. Under sp the result covers this rank's chunk of the
        sequence, [B, S/sp, D]. Under pp the layers run through ``gpipe``
        (``cfg.pp_microbatches``) and the result is the last stage's, on
        every stage. The aux loss is the global batch's on every rank: the
        router statistics are summed over the axes that split tokens before
        ``router_aux``."""
        cfg = self.cfg
        n_tokens = tokens.shape[0] * tokens.shape[1] * self._batch_ranks()
        tokens = self._seq_chunk(tokens)
        x = embed_rows(params["embed"], tokens, cfg.dtype)
        token_axes = ("data", "fsdp", "sp")
        if self._sizes.get("pp", 1) > 1:
            from torchkafka_tpu_torch.ops.pipeline import gpipe

            sp = {"sp"} if self._sp_size > 1 else set()
            token_axes = ("data", "fsdp")  # gpipe sums over pp and sp
            if cfg.is_moe:
                x, stats = gpipe(self._train_layer, params["layers"], x, mesh=self.mesh,
                                 microbatches=cfg.pp_microbatches, extra_manual=sp,
                                 collect_stats=True)
            else:
                x = gpipe(lambda a, layer: self._train_layer(a, layer)[0], params["layers"],
                          x, mesh=self.mesh, microbatches=cfg.pp_microbatches,
                          extra_manual=sp)
        else:
            per_layer = []
            for layer in unstack_layers(params["layers"]):
                x, st = self._train_layer(x, layer)
                per_layer.append(st)
            stats = torch.stack(per_layer) if cfg.is_moe else None
        aux = 0.0
        if cfg.is_moe:
            from torchkafka_tpu_torch.parallel.collectives import reduce_from_tp

            # [L, 2, E] token sums → the global batch's (identity backward:
            # every rank's loss carries the same aux).
            stats = reduce_from_tp(stats, [self._group(a) for a in token_axes
                                           if self._group(a) is not None])
            aux = torch.stack([router_aux(st, n_tokens) for st in stats]).mean()
        return _rms_norm(x, params["ln_f"]), aux

    def trunk_kv(self, params: dict, tokens: torch.Tensor, *, x=None, layers=None):
        """The serving prefill's trunk: tokens [B, S] → (final-norm hidden
        states [B, S, D], k, v), k/v each [L, B, S, K, Dh]. An MoE layer
        routes through the config's dispatch, as the JAX package's prefill
        (``model._layer``) does: a capacity config drops here too. ``x``:
        the embedded tokens and ``layers`` the layer views, when the caller
        provides them (a serving mesh's vocab-parallel lookup and its
        layers gathered over fsdp, ``models.generate.ServingShard``)."""
        if x is None:
            x = embed_rows(params["embed"], tokens, self.cfg.dtype)
        ks, vs = [], []
        for layer in unstack_layers(params["layers"]) if layers is None else layers:
            x, k, v, _ = self._layer(x, layer)
            ks.append(k)
            vs.append(v)
        return _rms_norm(x, params["ln_f"]), torch.stack(ks), torch.stack(vs)

    def forward(self, params: dict, tokens: torch.Tensor, *, return_aux: bool = False):
        """tokens [B, S] int → logits [B, S, V] float32 (and, with
        ``return_aux``, the mean per-layer router load-balance loss); under
        sp the logits of this rank's chunk (see ``trunk``)."""
        x, aux = self.trunk(params, tokens)
        logits = matmul_f32(x, params["lm_head"], self.cfg.dtype)
        return (logits, aux) if return_aux else logits

    def _use_fused_ce(self, params: dict) -> bool:
        """Fused blocked CE engages unless disabled, sequence-sharded (as
        the JAX package, whose block scan would serialise over sp), or the
        head is quantized."""
        if self.cfg.ce_block_size == 0 or self._sp_size > 1:
            return False
        return not isinstance(params["lm_head"], QTensor)

    def loss(self, params: dict, tokens: torch.Tensor, mask=None, *, count=None) -> torch.Tensor:
        """Next-token cross-entropy plus ``router_aux_coef`` times the
        router aux loss, a 0-d f32 tensor. mask [B, S] 1=real row/token,
        0=padding (the ingest batcher's valid mask — padded rows must not
        train).

        The forward runs at full length S and the shift happens on the loss
        side: position i predicts token i+1, the final position is masked
        out. The default path is the fused blocked CE (ops/xent.py): full
        [B, S, V] logits are never materialised; quantized heads and
        ``ce_block_size=0`` take the dense path. ``count``: the mean's
        denominator (the global count of predicted positions when this
        call sees one rank's rows); None = this call's. Under sp the
        targets and mask are shifted on the full rows before each rank takes
        its chunk: a chunk's last position predicts the next chunk's first
        token."""
        ce, aux = self.loss_terms(params, tokens, mask, count=count)
        return ce + self.cfg.router_aux_coef * aux

    def loss_terms(self, params: dict, tokens: torch.Tensor, mask=None, *, count=None):
        """(cross-entropy, router aux) of ``loss``; aux is 0.0 for a dense
        MLP or a zero ``router_aux_coef``. On a mesh the cross-entropy is
        this rank's share (over ``count``) and the aux the global batch's,
        the same on every rank."""
        cfg = self.cfg
        x, aux = self.trunk(params, tokens)
        aux = aux if (cfg.is_moe and cfg.router_aux_coef > 0) else 0.0
        targets, m = self.shifted_targets(tokens, mask)
        if self._use_fused_ce(params):
            ce = fused_softmax_xent(
                x, params["lm_head"], targets, m, cfg.ce_block_size, cfg.dtype,
                count=count,
            )
        else:
            ce = dense_softmax_xent(
                x, load_weight(params["lm_head"], cfg.dtype), targets, m,
                cfg.dtype, count=count,
            )
        return ce, aux

    def shifted_targets(self, tokens: torch.Tensor, mask=None):
        """(targets, mask) of the loss: position i predicts token i+1, the
        final position and padded rows carry mask 0; shifted on the full
        rows, then this rank's chunk of the sequence under sp."""
        f = torch.nn.functional
        targets = f.pad(tokens[:, 1:].long(), (0, 1))
        m = torch.ones(tokens.shape, device=tokens.device) if mask is None else mask
        m = f.pad(m[:, 1:].float(), (0, 1))
        return self._seq_chunk(targets), self._seq_chunk(m)


# ----------------------------------------------------------------- train step


def make_train_step(
    cfg: TransformerConfig,
    mesh=None,
    optimizer=None,
    *,
    device=None,
) -> tuple[Callable, Callable]:
    """Build (init_fn, step_fn), the JAX package's pair.

    init_fn(generator) → (params, opt_state): ``init_params`` on
    ``device`` (CUDA unless the caller asks for the CPU) and the
    optimizer's state over those parameters.
    step_fn(params, opt_state, tokens, mask) → (params, opt_state, loss):
    value and gradients of ``Transformer.loss``, then one optimizer update.
    ``params`` and ``opt_state`` are updated IN PLACE and returned (the
    JAX step donates and rebinds them); ``loss`` is a 0-d tensor on the
    device, detached — hand it to ``token.commit(wait_for=loss)``.

    ``optimizer``: an ``optim.adamw(...)``; None means ``adamw(1e-3)``.
    ``mesh``: a ``parallel.make_mesh`` mesh (see ``_mesh_train_step``);
    None is the single-device step."""
    opt = adamw(1e-3) if optimizer is None else optimizer
    if mesh is not None:
        return _mesh_train_step(cfg, mesh, opt, device)
    model = Transformer(cfg)
    dev = resolve_device(device)

    def init_fn(generator: torch.Generator):
        params = init_params(generator, cfg, dev)
        return params, opt.init(params)

    def step_fn(params, opt_state, tokens, mask=None):
        opt_state.check_params(params)
        tokens = torch.as_tensor(tokens, device=dev)
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
        opt_state.zero_grad()
        loss = model.loss(params, tokens, mask)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step_fn


def shard_params(params: Mapping, cfg: TransformerConfig, mesh) -> dict:
    """A full parameter tree (the same values on every rank, e.g. from
    ``params_from_numpy``) → ``DTensor``s laid out per ``param_specs`` on
    ``mesh``: each rank keeps its ``fsdp`` chunk of a sharded weight, and
    a copy of the rest. No communication."""
    from torchkafka_tpu_torch.parallel.mesh import distribute

    placements = shardings_for_mesh(mesh, param_specs(cfg))

    def walk(tree, pl):
        if isinstance(tree, Mapping):
            return {k: walk(v, pl[k]) for k, v in tree.items()}
        return distribute(tree, mesh, pl)

    return walk(params, placements)


# Parameters whose tp shard (the vocabulary) the step gathers, like an
# fsdp shard, so the embedding lookup and the fused CE see the whole
# vocabulary; the layer weights' tp shards stay local (Megatron's layout).
_TP_GATHERED = ("embed", "lm_head")


def _mesh_train_step(cfg: TransformerConfig, mesh, opt, device):
    """The train step over a mesh of data, fsdp, tp, sp, pp and ep axes:
    an explicit SPMD step in which DTensor only records placement.

    Each rank holds its rows of the global batch (split over data ×
    fsdp; ranks that differ only in tp, sp, pp or ep hold the same rows,
    at full length), and each parameter as ``param_specs`` lays it out:
    this rank's chunk of every dim sharded over fsdp, tp, pp (the stacked
    layer dim) or ep (the expert dim), replicated otherwise (the AdamW
    moments follow, being the shapes of what they update). A step:

    1. gathers every fsdp-sharded parameter over fsdp, and ``embed`` and
       ``lm_head`` over tp too (``parallel.collectives.all_gather``), into
       a full tensor that is a fresh autograd leaf; the layer weights keep
       their tp, pp and ep shards, and unsharded parameters are used as
       they are;
    2. sums each rank's count of predicted positions (of its chunk under
       sp) over data, fsdp and sp, so each rank's loss is its masked sum
       over the global count (the JAX package's global mask-weighted
       mean, in shares);
    3. runs ``Transformer.loss_terms`` on the local rows: under tp each
       rank's heads and ``d_ff`` columns (the layer's all-reduces in
       ``copy_to_tp``/``reduce_from_tp``), under sp its sequence chunk
       with ring or Ulysses attention, under pp its stage of the GPipe
       schedule, under ep its experts; K1 in the forward and K2/K3 in the
       backward on this rank's shard, all on local tensors; the gradient
       comes from the rank's share plus ``router_aux_coef`` times the
       global aux;
    4. takes each gathered gradient back to the chunk: this rank's tp
       chunk of ``embed``/``lm_head`` (each tp rank already holds the
       whole gradient), then the reduce-scatter over fsdp
       (``parallel.collectives.reduce_scatter``); then sums every gradient
       over sp and data, and over fsdp where the parameter is not sharded
       there. Never over tp, pp or ep: the backward's collectives leave
       tp, pp and ep peers equal gradients of the parameters they
       replicate (``ln1``/``ln2``/``ln_f`` under tp; ``embed``, ``ln_f``,
       ``lm_head`` under pp, whose input gradient the pipeline sums over
       its stages; the router and attention weights under ep), and a sum
       would count them that many times;
    5. steps AdamW on the local tensors, and sums the cross-entropy shares
       over data, fsdp and sp (not tp, pp or ep: their peers hold the same
       share) into the global loss, plus ``router_aux_coef`` times the
       aux once, which every rank returns.

    Replicas over ``data`` receive the same summed gradients and stay bit
    for bit equal. ``tokens``/``mask``: ``DTensor``s from ``global_batch``
    (their local rows are used) or this rank's rows as plain tensors or
    arrays. ``step_fn.stats`` holds the last step's collective calls,
    bytes and host seconds (``torch.cuda.synchronize()`` before the step
    and before the gradient collectives on the card: the layer's tp, sp,
    pp and ep collectives inside the forward and backward are counted with
    the device time they wait for)."""
    from torchkafka_tpu_torch.parallel import collectives
    from torchkafka_tpu_torch.parallel.mesh import local_part

    sizes = _check_mesh(cfg, mesh)
    model = Transformer(cfg, mesh)
    mesh_dev = (torch.device("cuda", torch.cuda.current_device())
                if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    dev = resolve_device(device) if device is not None else mesh_dev
    if dev.type != mesh_dev.type:
        raise ValueError(f"device {dev} is not the mesh's device type {mesh.device_type!r}")
    names = list(mesh.mesh_dim_names)
    groups = {a: mesh.get_group(a) for a in ("data", "fsdp", "tp", "sp") if sizes.get(a, 1) > 1}
    tp_rank = torch.distributed.get_rank(groups["tp"]) if "tp" in groups else 0
    placements = shardings_for_mesh(mesh, param_specs(cfg))

    def sum_(t: torch.Tensor, axes) -> torch.Tensor:
        for axis in axes:
            if axis in groups:
                collectives.all_reduce_(t, groups[axis])
        return t

    def plan(pl, gather_tp: bool) -> list:
        """[(axis, dim)] to gather, in order: fsdp, then tp."""
        out = []
        for axis in ("fsdp", "tp") if gather_tp else ("fsdp",):
            if axis in groups and pl[names.index(axis)].is_shard():
                out.append((axis, pl[names.index(axis)].dim))
        return out

    plans = {k: (_map_specs(lambda pl: plan(pl, False), v) if k == "layers"
                 else plan(v, k in _TP_GATHERED)) for k, v in placements.items()}

    def init_fn(generator: torch.Generator):
        params = shard_params(init_params(generator, cfg, dev), cfg, mesh)
        return params, opt.init(params)

    def gather(ld):
        t, steps = ld
        if not steps:
            return t
        t = t.detach()
        for axis, dim in steps:
            t = collectives.all_gather(t, dim, groups[axis])
        return t.requires_grad_(True)

    def place_grad(ld, f):
        p, steps = ld
        if not steps:
            sum_(p.grad, ("fsdp", "sp", "data"))
            return
        g = f.grad
        for axis, dim in reversed(steps):
            if axis == "tp":
                g = g.chunk(sizes["tp"], dim=dim)[tp_rank].contiguous()
            else:
                g = collectives.reduce_scatter(g, dim, groups["fsdp"])
        fsdp_done = any(axis == "fsdp" for axis, _ in steps)
        p.grad = sum_(g, ("sp", "data") if fsdp_done else ("fsdp", "sp", "data"))

    def step_fn(params, opt_state, tokens, mask=None):
        opt_state.check_params(params)
        tokens = torch.as_tensor(local_part(tokens), device=dev)
        if mask is not None:
            mask = torch.as_tensor(local_part(mask), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = collectives.COUNTS.as_dict()
        local = _zip_tree(params, plans, lambda p, st: (local_part(p), st))
        # 1. gather
        full = _map_tree(local, gather)
        # 2. the global count of predicted positions
        _, m = model.shifted_targets(tokens, mask)
        count = sum_(m.sum().reshape(1), ("fsdp", "sp", "data")).clamp_min(1.0)[0]
        # 3. the local share of the loss
        opt_state.zero_grad()
        ce, aux = model.loss_terms(full, tokens, mask, count=count)
        (ce + cfg.router_aux_coef * aux).backward()
        # 4. gradients back to each parameter's placement
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _zip_tree(local, full, place_grad)
        loss = sum_(ce.detach().reshape(1), ("fsdp", "sp", "data"))[0]
        if torch.is_tensor(aux):
            loss = loss + cfg.router_aux_coef * aux.detach()
        after = collectives.COUNTS.as_dict()
        step_fn.stats = {k: after[k] - before[k] for k in after}
        # 5. the optimizer on the local tensors
        opt_state.step()
        return params, opt_state, loss

    step_fn.stats = {}
    return init_fn, step_fn


def _map_tree(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _zip_tree(a, b, fn):
    if isinstance(a, Mapping):
        return {k: _zip_tree(a[k], b[k], fn) for k in a}
    return fn(a, b)


def count_params(params: dict) -> int:
    return int(sum(leaf.numel() for leaf in tree_leaves(params)))

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
opt)`` take a ``parallel.make_mesh`` mesh whose axes of size > 1 are
``data`` and ``fsdp``. The parameters are ``DTensor``s laid out per
``param_specs`` (``fsdp`` shards each weight's model dim, the rest
replicates) and the batch is split over data × fsdp; the step runs the
kernels on each rank's local tensors (see ``make_train_step``). Still
raising ``NotImplementedError`` with their ROADMAP queue A titles: ``tp``
and ``sp`` axes and ring/Ulysses attention ("Tensor and sequence
parallelism"), ``pp`` and ``ep`` axes and MoE configs on a mesh of more
than one batch shard ("Pipeline and expert parallelism").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from torchkafka_tpu_torch.models.quant import QTensor, embed_rows, load_weight
from torchkafka_tpu_torch.ops.attention import mha
from torchkafka_tpu_torch.ops.xent import dense_softmax_xent, fused_softmax_xent
from torchkafka_tpu_torch.optim import adamw
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.tree import tree_leaves

TP_SP = "Tensor and sequence parallelism"
PP_EP = "Pipeline and expert parallelism"


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
    # 'dense' | 'flash' | 'auto': auto = the flash kernel on CUDA tensors,
    # the dense mha elsewhere. ('ring'/'ulysses' are the mesh slice's.)
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
    """The mesh paths the port runs: axes of size > 1 among data and fsdp
    only. The rest raise with their ROADMAP queue A titles. → axis sizes."""
    sizes = _mesh_axes(mesh)
    for axis, title in (("tp", TP_SP), ("sp", TP_SP), ("pp", PP_EP), ("ep", PP_EP)):
        if sizes.get(axis, 1) > 1:
            raise _not_ported(f"a mesh with {axis}={sizes[axis]}", title)
    if cfg.is_moe and sizes.get("data", 1) * sizes.get("fsdp", 1) > 1:
        raise _not_ported("MoE configs on a batch-sharded mesh (the router's "
                          "load-balance statistics span the global batch)", PP_EP)
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


def _moe_mlp(h: torch.Tensor, layer: Mapping, cfg: TransformerConfig):
    """Top-k routed mixture of SwiGLU experts, dense (one-hot combine)
    dispatch: every expert computes every token and the gate-weighted
    combine keeps the routed ones. Exact w.r.t. the routing — no capacity
    drops. h: [B, S, D] → (output [B, S, D], router stats [2, E] for
    ``router_aux``)."""
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
    x = h.reshape(1, b * s, d)
    gate_e = f.silu(torch.matmul(x, load_weight(layer["w_gate"], cfg.dtype)))
    up_e = torch.matmul(x, load_weight(layer["w_up"], cfg.dtype))  # [E, BS, F]
    out_e = torch.matmul(gate_e * up_e, load_weight(layer["w_down"], cfg.dtype))
    out = torch.einsum("end,ne->nd", out_e, combine.reshape(b * s, -1).to(cfg.dtype))
    out = out.reshape(b, s, d)
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


def _moe_mlp_capacity(h: torch.Tensor, layer: Mapping, cfg: TransformerConfig):
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
    excluded. h: [B, S, D] → (output [B, S, D], stats [2, E])."""
    b, s, d = h.shape
    n = b * s
    e, k = cfg.n_experts, cfg.expert_top_k
    n_g = min(cfg.moe_group_size, n)
    g = -(-n // n_g)
    n_pad = g * n_g
    cap = moe_capacity(cfg, n_g)
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
    pos = torch.cumsum(onehot, dim=1) - onehot  # slot within (group, expert)
    keep = onehot * (pos < cap)  # overflow drops
    slot = _one_hot(pos.to(torch.int64), cap, torch.float32)
    dispatch = keep[..., None] * slot  # [G, K·n_g, E, C]
    combine = dispatch * to_group_major(gates)[..., None, None]

    disp5 = dispatch.reshape(g, k, n_g, e, cap).to(cfg.dtype)
    comb5 = combine.reshape(g, k, n_g, e, cap).to(cfg.dtype)
    x_g = x.reshape(g, n_g, d)
    expert_in = torch.einsum("gknec,gnd->gecd", disp5, x_g)  # [G, E, C, D]
    gate_e = torch.nn.functional.silu(torch.einsum(
        "gecd,edf->gecf", expert_in, load_weight(layer["w_gate"], cfg.dtype)))
    up_e = torch.einsum(
        "gecd,edf->gecf", expert_in, load_weight(layer["w_up"], cfg.dtype))
    out_e = torch.einsum(
        "gecf,efd->gecd", gate_e * up_e, load_weight(layer["w_down"], cfg.dtype))
    out = torch.einsum("gknec,gecd->gnd", comb5, out_e)
    out = out.reshape(n_pad, d)[:n].reshape(b, s, d)

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
        if cfg.attn_impl in ("ring", "ulysses"):
            raise _not_ported(f"attn_impl={cfg.attn_impl!r}", TP_SP)
        if cfg.attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"attn_impl must be 'auto', 'flash' or 'dense', got "
                             f"{cfg.attn_impl!r}")
        sizes = _check_mesh(cfg, mesh) if mesh is not None else {}
        self.cfg = cfg
        self.mesh = mesh
        # Flash on a batch-sharded mesh goes through flash_attention_sharded
        # (each rank's K1-K3 on its own rows, no communication).
        self._flash_shard_mesh = (
            mesh if sizes.get("data", 1) * sizes.get("fsdp", 1) > 1 else None)

    def init(self, generator: torch.Generator, device=None) -> dict:
        return init_params(generator, self.cfg, device)

    def _use_flash(self, x: torch.Tensor) -> bool:
        impl = self.cfg.attn_impl
        return impl == "flash" or (impl == "auto" and x.device.type == "cuda")

    def _attention(self, q, k, v):
        """Causal attention over [B, S, ·, Dh]: the flash kernel serves
        K < H through its kv row map; the dense path repeats kv heads."""
        if self._use_flash(q):
            from torchkafka_tpu_torch.ops.flash import flash_attention, flash_attention_sharded

            if self._flash_shard_mesh is not None:
                return flash_attention_sharded(q, k, v, self._flash_shard_mesh, True)
            return flash_attention(q, k, v, True)
        rep = q.shape[2] // k.shape[2]
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return mha(q, k, v, causal=True)

    def _moe_mlp(self, h: torch.Tensor, layer: Mapping):
        """The MoE MLP through the config's dispatch."""
        if self.cfg.moe_dispatch == "capacity":
            return _moe_mlp_capacity(h, layer, self.cfg)
        return _moe_mlp(h, layer, self.cfg)

    def _layer(self, x: torch.Tensor, layer: Mapping):
        """One decoder layer → (x, k, v, stats): k (after RoPE) and v are
        what the serving cache captures; stats are the MoE router's [2, E]
        sums for ``router_aux`` (None for a dense MLP)."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)
        h = _rms_norm(x, layer["ln1"])
        q = torch.einsum("bsd,dhe->bshe", h, load_weight(layer["wq"], cfg.dtype))
        k = torch.einsum("bsd,dke->bske", h, load_weight(layer["wk"], cfg.dtype))
        v = torch.einsum("bsd,dke->bske", h, load_weight(layer["wv"], cfg.dtype))
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        attn = self._attention(q, k, v)
        x = x + torch.einsum(
            "bshe,hed->bsd", attn, load_weight(layer["wo"], cfg.dtype)
        )
        h = _rms_norm(x, layer["ln2"])
        if cfg.is_moe:
            mlp_out, stats = self._moe_mlp(h, layer)
            return x + mlp_out, k, v, stats
        return x + _mlp(h, layer, cfg), k, v, None

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
        materialising [B, S, V] logits."""
        cfg = self.cfg
        x = embed_rows(params["embed"], tokens, cfg.dtype)
        n_tokens = tokens.shape[0] * tokens.shape[1]
        auxes = []
        for layer in unstack_layers(params["layers"]):
            x, stats = self._train_layer(x, layer)
            if stats is not None:
                auxes.append(router_aux(stats, n_tokens))
        aux = torch.stack(auxes).mean() if auxes else 0.0
        return _rms_norm(x, params["ln_f"]), aux

    def trunk_kv(self, params: dict, tokens: torch.Tensor):
        """The serving prefill's trunk: tokens [B, S] → (final-norm hidden
        states [B, S, D], k, v), k/v each [L, B, S, K, Dh]. An MoE layer
        routes through the config's dispatch, as the JAX package's prefill
        (``model._layer``) does: a capacity config drops here too."""
        x = embed_rows(params["embed"], tokens, self.cfg.dtype)
        ks, vs = [], []
        for layer in unstack_layers(params["layers"]):
            x, k, v, _ = self._layer(x, layer)
            ks.append(k)
            vs.append(v)
        return _rms_norm(x, params["ln_f"]), torch.stack(ks), torch.stack(vs)

    def forward(self, params: dict, tokens: torch.Tensor, *, return_aux: bool = False):
        """tokens [B, S] int → logits [B, S, V] float32 (and, with
        ``return_aux``, the mean per-layer router load-balance loss)."""
        x, aux = self.trunk(params, tokens)
        logits = matmul_f32(x, params["lm_head"], self.cfg.dtype)
        return (logits, aux) if return_aux else logits

    def _use_fused_ce(self, params: dict) -> bool:
        """Fused blocked CE engages unless disabled or the head is
        quantized."""
        if self.cfg.ce_block_size == 0:
            return False
        return not isinstance(params["lm_head"], QTensor)

    def loss(self, params: dict, tokens: torch.Tensor, mask=None, *, count=None) -> torch.Tensor:
        """Next-token cross-entropy, a 0-d f32 tensor. mask [B, S] 1=real
        row/token, 0=padding (the ingest batcher's valid mask — padded rows
        must not train).

        The forward runs at full length S and the shift happens on the loss
        side: position i predicts token i+1, the final position is masked
        out. The default path is the fused blocked CE (ops/xent.py): full
        [B, S, V] logits are never materialised; quantized heads and
        ``ce_block_size=0`` take the dense path. ``count``: the mean's
        denominator (the global count of predicted positions when this
        call sees one rank's rows); None = this call's."""
        cfg = self.cfg
        x, aux = self.trunk(params, tokens)
        aux = aux if (cfg.is_moe and cfg.router_aux_coef > 0) else 0.0
        f = torch.nn.functional
        targets = f.pad(tokens[:, 1:].long(), (0, 1))
        m = torch.ones(tokens.shape, device=tokens.device) if mask is None else mask
        m = f.pad(m[:, 1:].float(), (0, 1))
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
        return ce + cfg.router_aux_coef * aux


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


def _mesh_train_step(cfg: TransformerConfig, mesh, opt, device):
    """The train step over a mesh of data and fsdp axes: an explicit SPMD
    step in which DTensor only records placement.

    Each rank holds its rows of the global batch (split over data ×
    fsdp), and each parameter as ``param_specs`` lays it out: under
    ``fsdp`` the chunk of its sharded dim that this rank's fsdp index
    names (the AdamW moments follow, being the shapes of what they
    update), replicated otherwise. A step:

    1. gathers every fsdp-sharded parameter over the fsdp axis
       (``parallel.collectives.all_gather``) into a full tensor that is a
       fresh autograd leaf; replicated parameters are used as they are;
    2. sums each rank's count of predicted positions over the batch axes,
       so each rank's loss is its masked sum over the global count (the
       JAX package's global mask-weighted mean, in shares);
    3. runs ``Transformer.loss`` on the local rows: K1 in the forward and
       K2/K3 in the backward on this rank's shard
       (``ops.flash.flash_attention_sharded``), the fused CE, all on local
       tensors;
    4. reduce-scatters each full gradient over fsdp back to the chunk
       (``parallel.collectives.reduce_scatter``), then sums over data;
       replicated parameters' gradients are summed over both axes;
    5. steps AdamW on the local tensors, and sums the loss shares into the
       global loss that every rank returns.

    Replicas over ``data`` receive the same summed gradients and stay bit
    for bit equal. ``tokens``/``mask``: ``DTensor``s from ``global_batch``
    (their local rows are used) or this rank's rows as plain tensors or
    arrays. ``step_fn.stats`` holds the last step's collective calls,
    bytes and host seconds (``torch.cuda.synchronize()`` before them on
    the card, so the backward's device time is not counted in them)."""
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
    groups = {a: mesh.get_group(a) for a in ("data", "fsdp") if sizes.get(a, 1) > 1}
    fsdp_index = names.index("fsdp") if "fsdp" in groups else None
    specs = param_specs(cfg)
    placements = shardings_for_mesh(mesh, specs)

    def batch_sum_(t: torch.Tensor) -> torch.Tensor:
        for axis in ("fsdp", "data"):
            if axis in groups:
                collectives.all_reduce_(t, groups[axis])
        return t

    def fsdp_dim(pl) -> int | None:
        if fsdp_index is None:
            return None
        p = pl[fsdp_index]
        return p.dim if p.is_shard() else None

    def init_fn(generator: torch.Generator):
        params = shard_params(init_params(generator, cfg, dev), cfg, mesh)
        return params, opt.init(params)

    def step_fn(params, opt_state, tokens, mask=None):
        opt_state.check_params(params)
        tokens = torch.as_tensor(local_part(tokens), device=dev)
        if mask is not None:
            mask = torch.as_tensor(local_part(mask), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = collectives.COUNTS.as_dict()
        dims = _map_specs(fsdp_dim, placements)
        local = _zip_tree(params, dims, lambda p, d: (local_part(p), d))
        # 1. gather
        full = _map_tree(local, lambda ld: (
            collectives.all_gather(ld[0].detach(), ld[1], groups["fsdp"])
            .requires_grad_(True) if ld[1] is not None else ld[0]))
        # 2. the global count of predicted positions
        m = (torch.ones(tokens.shape, device=dev) if mask is None else mask.float())
        count = batch_sum_(m[:, 1:].sum().reshape(1)).clamp_min(1.0)[0]
        # 3. the local share of the loss
        opt_state.zero_grad()
        share = model.loss(full, tokens, mask, count=count)
        share.backward()
        # 4. gradients back to each parameter's placement
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        def place_grad(ld, f):
            p, d = ld
            if d is None:
                batch_sum_(p.grad)
                return
            g = collectives.reduce_scatter(f.grad, d, groups["fsdp"])
            if "data" in groups:
                collectives.all_reduce_(g, groups["data"])
            p.grad = g

        _zip_tree(local, full, place_grad)
        loss = batch_sum_(share.detach().reshape(1))[0]
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

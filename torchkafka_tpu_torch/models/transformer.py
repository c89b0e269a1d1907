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

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ring/Ulysses attention and every mesh path (``mesh=``; pipeline
parallelism and expert sharding need one).
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
        if mesh is not None:
            raise _not_ported("mesh=", "mesh and multi-process paths")
        if cfg.attn_impl not in ("auto", "dense", "flash"):
            raise NotImplementedError(
                f"attn_impl={cfg.attn_impl!r} is not ported yet (ROADMAP "
                "queue A: mesh and multi-process paths); use 'auto', 'flash' or 'dense'"
            )
        self.cfg = cfg

    def init(self, generator: torch.Generator, device=None) -> dict:
        return init_params(generator, self.cfg, device)

    def _use_flash(self, x: torch.Tensor) -> bool:
        impl = self.cfg.attn_impl
        return impl == "flash" or (impl == "auto" and x.device.type == "cuda")

    def _attention(self, q, k, v):
        """Causal attention over [B, S, ·, Dh]: the flash kernel serves
        K < H through its kv row map; the dense path repeats kv heads."""
        if self._use_flash(q):
            from torchkafka_tpu_torch.ops.flash import flash_attention

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

    def loss(self, params: dict, tokens: torch.Tensor, mask=None) -> torch.Tensor:
        """Next-token cross-entropy, a 0-d f32 tensor. mask [B, S] 1=real
        row/token, 0=padding (the ingest batcher's valid mask — padded rows
        must not train).

        The forward runs at full length S and the shift happens on the loss
        side: position i predicts token i+1, the final position is masked
        out. The default path is the fused blocked CE (ops/xent.py): full
        [B, S, V] logits are never materialised; quantized heads and
        ``ce_block_size=0`` take the dense path."""
        cfg = self.cfg
        x, aux = self.trunk(params, tokens)
        aux = aux if (cfg.is_moe and cfg.router_aux_coef > 0) else 0.0
        f = torch.nn.functional
        targets = f.pad(tokens[:, 1:].long(), (0, 1))
        m = torch.ones(tokens.shape, device=tokens.device) if mask is None else mask
        m = f.pad(m[:, 1:].float(), (0, 1))
        if self._use_fused_ce(params):
            ce = fused_softmax_xent(
                x, params["lm_head"], targets, m, cfg.ce_block_size, cfg.dtype
            )
        else:
            ce = dense_softmax_xent(
                x, load_weight(params["lm_head"], cfg.dtype), targets, m,
                cfg.dtype,
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
    """Build (init_fn, step_fn), the JAX package's pair without the mesh.

    init_fn(generator) → (params, opt_state): ``init_params`` on
    ``device`` (CUDA unless the caller asks for the CPU) and the
    optimizer's state over those parameters.
    step_fn(params, opt_state, tokens, mask) → (params, opt_state, loss):
    value and gradients of ``Transformer.loss``, then one optimizer update.
    ``params`` and ``opt_state`` are updated IN PLACE and returned (the
    JAX step donates and rebinds them); ``loss`` is a 0-d tensor on the
    device, detached — hand it to ``token.commit(wait_for=loss)``.

    ``optimizer``: an ``optim.adamw(...)``; None means ``adamw(1e-3)``.
    ``mesh``: not ported yet (must be None)."""
    if mesh is not None:
        raise _not_ported("mesh=", "mesh and multi-process paths")
    model = Transformer(cfg)
    opt = adamw(1e-3) if optimizer is None else optimizer
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


def count_params(params: dict) -> int:
    return int(sum(leaf.numel() for leaf in tree_leaves(params)))

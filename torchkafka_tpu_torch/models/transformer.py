"""Llama-style decoder (dense SwiGLU, GQA, RoPE): port of
``torchkafka_tpu/models/transformer.py``, the prefill trunk.

Parameters keep the JAX package's tree: a plain dict with every per-layer
tensor stacked on a leading ``[L, ...]`` axis under the same names, so
``params_from_numpy`` converts a JAX-initialised tree name for name. The
forward loops over the layer axis (the JAX package's ``lax.scan``).
Attention dispatches to ``ops.flash.flash_attention`` (the CUDA kernel on
the card) or to the dense ``mha``, per ``cfg.attn_impl``.

Not ported yet: MoE configs (raise ``NotImplementedError``), the training
loss and train step, ring/Ulysses attention and mesh sharding (ROADMAP
Queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from torchkafka_tpu_torch.models.quant import QTensor, embed_rows, load_weight
from torchkafka_tpu_torch.ops.attention import mha
from torchkafka_tpu_torch.utils.devices import resolve_device

_MOE_TODO = "MoE configs are not ported yet (ROADMAP Queue A, serving follow-up 7)"


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
    # name → (shape, fan_in) for the scaled-normal leaves.
    return {
        "embed": ((v, dm), dm),
        "wq": ((nl, dm, h, dh), dm),
        "wk": ((nl, dm, k, dh), dm),
        "wv": ((nl, dm, k, dh), dm),
        "wo": ((nl, h, dh, dm), h * dh),
        "w_gate": ((nl, dm, dff), dm),
        "w_up": ((nl, dm, dff), dm),
        "w_down": ((nl, dff, dm), dff),
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
    if cfg.is_moe:
        raise NotImplementedError(_MOE_TODO)
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=pd, device=dev)
        return w.div_(math.sqrt(fan_in))

    shapes = _param_shapes(cfg)
    ones = lambda *s: torch.ones(s, dtype=pd, device=dev)  # noqa: E731
    layer_names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
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
    if cfg.is_moe:
        raise NotImplementedError(_MOE_TODO)
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


def matmul_f32(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """``x @ load_weight(w, dtype)`` with an f32 result (the JAX package's
    ``preferred_element_type=float32``): both operands go to f32 after the
    weight's cast to the compute dtype, so the products of low-precision
    inputs are exact and the sum is f32."""
    return x.float() @ load_weight(w, dtype).float()


class Transformer(nn.Module):
    """The prefill trunk bound to a config. Parameters are passed per call
    (the dict tree above), so one module serves any weights of its
    config, as the JAX package's functional model does."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.is_moe:
            raise NotImplementedError(_MOE_TODO)
        if cfg.attn_impl not in ("auto", "dense", "flash"):
            raise NotImplementedError(
                f"attn_impl={cfg.attn_impl!r} is not ported yet (ROADMAP "
                "Queue A: mesh paths); use 'auto', 'flash' or 'dense'"
            )
        self.cfg = cfg

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

    def _layer(self, x: torch.Tensor, layer: Mapping):
        """One decoder layer → (x, k, v): k (after RoPE) and v are what the
        serving cache captures."""
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
        x = x + _mlp(_rms_norm(x, layer["ln2"]), layer, cfg)
        return x, k, v

    def trunk(self, params: dict, tokens: torch.Tensor, capture_kv: bool = False):
        """tokens [B, S] → final-norm hidden states [B, S, D] in the compute
        dtype; with ``capture_kv`` also (k, v), each [L, B, S, K, Dh]."""
        x = embed_rows(params["embed"], tokens, self.cfg.dtype)
        ks, vs = [], []
        for i in range(self.cfg.n_layers):
            x, k, v = self._layer(x, layer_at(params["layers"], i))
            if capture_kv:
                ks.append(k)
                vs.append(v)
        x = _rms_norm(x, params["ln_f"])
        if capture_kv:
            return x, torch.stack(ks), torch.stack(vs)
        return x

    def forward(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] int → logits [B, S, V] float32."""
        return matmul_f32(
            self.trunk(params, tokens), params["lm_head"], self.cfg.dtype
        )

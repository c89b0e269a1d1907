"""Weight-only int8 quantization and the int8 KV-cache groups.

Port of ``torchkafka_tpu/models/quant.py``. Scheme: symmetric absmax,
per output channel (the scale reduces over each weight's contraction
axes), int8 in [-127, 127]:

    scale = max(absmax(w, contraction_axes) / 127, 1e-12)
    q     = clip(round(w / scale), -127, 127)       w ≈ q · scale

``torch.round`` rounds half to even, as ``jnp.round`` does, and every
step runs in f32 in the same order, so the int8 payloads and the scales
match the JAX package byte for byte (``tests/test_torch_kvattn.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from torchkafka_tpu_torch.utils.tree import tree_leaves


class QTensor(NamedTuple):
    q: torch.Tensor  # int8, the original weight's shape
    scale: torch.Tensor  # f32, 1-sized on the contraction axes (broadcasts)


def quantize(w: torch.Tensor, contract_axes: tuple[int, ...]) -> QTensor:
    """Symmetric absmax int8 over ``contract_axes``, one scale per output
    channel."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axes, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def load_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """Tensor or QTensor → compute-dtype tensor. The q·scale product runs
    in f32 and casts once, as in the JAX package."""
    if isinstance(w, QTensor):
        return (w.q.float() * w.scale).to(dtype)
    return w.to(dtype)


def embed_rows(w, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup for tensor or QTensor tables: gather the int8 rows
    first, then scale; the whole table is never dequantized."""
    if isinstance(w, QTensor):
        return (w.q[tokens].float() * w.scale[tokens]).to(dtype)
    return w[tokens].to(dtype)


def quant_kv_groups(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric absmax int8 over the last (head_dim) axis:
    [..., Dh] → (int8 [..., Dh], f32 scale [...]), one scale per
    (position, head) group."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# Contraction axes per weight name (stacked [L, ...] layout); embeddings are
# per row (the gather output dim).
_LAYER_AXES = {
    "wq": (1,), "wk": (1,), "wv": (1,),  # [L, D, H, Dh] contract D
    "wo": (1, 2),  # [L, H, Dh, D] contract (H, Dh)
    "w_gate": (1,), "w_up": (1,),  # [L, D, F]
    "w_down": (1,),  # [L, F, D]
}


def quantize_params(params: dict, cfg) -> dict:
    """Post-training int8 of every matmul and embedding weight; the norms
    stay in their original dtype. Dense configs only: the MoE expert axes
    arrive with the MoE slice."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE configs are not ported yet (ROADMAP Queue A, serving follow-up 7)"
        )
    layers = {}
    for name, w in params["layers"].items():
        if name in ("ln1", "ln2"):
            layers[name] = w
        else:
            layers[name] = quantize(w, _LAYER_AXES[name])
    return {
        "embed": quantize(params["embed"], (1,)),  # [V, D] per row
        "layers": layers,
        "ln_f": params["ln_f"],
        "lm_head": quantize(params["lm_head"], (0,)),  # [D, V] per column
    }


def quantized_nbytes(tree) -> int:
    """Device bytes of a parameter tree; a QTensor leaf counts its int8
    payload and its scales."""
    return sum(
        t.numel() * t.element_size()
        for t in tree_leaves(tree) if isinstance(t, torch.Tensor)
    )

"""Prefill, the cached decode read and sampling: port of
``torchkafka_tpu/models/generate.py``.

``prefill`` reuses the trunk of ``Transformer`` (one implementation of the
layer math, as in the JAX package) and captures each layer's k/v for the
serving cache. ``_attend_cached`` is the decode tail over an M-major
cache ``[B, M, K, Dh]``, in both cache modes: the compute-dtype pool, and
the int8 pool with its scales folded onto the small score/probability
tensors. The server's int8 pool reads through the CUDA kernel instead
(``ops.kvattn``); this read serves the compute-dtype pool.

Not ported yet: the lockstep ``generate`` loop, keyed (threefry-exact)
sampling and the mesh shardings (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from torchkafka_tpu_torch.models.quant import load_weight
from torchkafka_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    _mlp,
    _rms_norm,
    matmul_f32,
)


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, max_len, K, Dh]
    v: torch.Tensor  # [L, B, max_len, K, Dh]


# --------------------------------------------------------------- sampling


def filter_logits(
    logits: torch.Tensor,
    *,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """Temperature → top-k → top-p over [..., V] logits; masked entries go
    to -inf. Ties at either threshold are kept (>= the boundary value), the
    JAX package's rule."""
    logits = logits.float() / float(temperature)
    neg = float("-inf")
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep a token while the cumulative probability BEFORE it is still
        # < p: the minimal prefix whose mass reaches p, never empty.
        keep = (cum - probs) < torch.tensor(top_p, dtype=torch.float32)
        n_keep = keep.int().sum(dim=-1, keepdim=True)
        kth = torch.gather(srt, -1, (n_keep - 1).long())
        logits = torch.where(logits < kth, neg, logits)
    return logits


def sample_logits(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """[..., V] logits → [...] int32 token ids. ``temperature == 0`` is
    greedy argmax (the first maximum, as in JAX); otherwise a categorical
    draw over ``filter_logits`` from ``generator``. The draws are not the
    JAX package's (threefry keys are ROADMAP Queue C item 2)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(
        filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p),
        dim=-1,
    )
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


def check_sampling_params(top_k: int | None, top_p: float | None) -> None:
    """Eager validation of the sampling knobs."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


# ----------------------------------------------------------------- decode


def _attend_cached(
    x, q, cache_k, cache_v, valid, layer, cfg: TransformerConfig,
    k_scale=None, v_scale=None,
):
    """Grouped-query attention over the kv cache, then the output
    projection and the MLP residual. x: [B, S, D]; q: [B, S, H, Dh];
    caches [B, M, K, Dh]; valid: [M], [B, M] or [B, S, M] bool mask of
    readable positions. ``k_scale``/``v_scale`` ([B, M, K] f32): int8 mode,
    the scales folded onto the scores and the probabilities:

        scores[..., m] = (q · k_int8[m]) · k_scale[m]
        out            = (probs · v_scale) @ v_int8

    q·k runs in f32 on the compute-dtype operands (exact products), as the
    JAX package's ``preferred_element_type=float32`` does."""
    b, s, h, dh = q.shape
    kk = cache_k.to(cfg.dtype).float()
    vv = cache_v.to(cfg.dtype).float()
    n_kv = kk.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, dh).float()
    scores = torch.einsum("bskre,bmke->bkrsm", qg, kk)
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    scores = scores / math.sqrt(cfg.head_dim)
    if valid.dim() == 1:
        valid = valid[None, :]
    if valid.dim() == 2:  # [B, M]: one mask for every query position
        vmask = valid[:, None, None, None, :]
    else:  # [B, S, M]: per-query masks
        vmask = valid[:, None, None, :, :]
    scores = torch.where(vmask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    attn = torch.einsum("bkrsm,bmke->bskre", probs.to(cfg.dtype).float(), vv)
    attn = attn.to(cfg.dtype).reshape(b, s, h, dh)
    return _attn_tail(x, attn, layer, cfg)


def _attn_tail(x, attn, layer, cfg: TransformerConfig):
    """Post-attention residual: output projection + the MLP block."""
    x = x + torch.einsum(
        "bshe,hed->bsd", attn, load_weight(layer["wo"], cfg.dtype)
    )
    return x + _mlp(_rms_norm(x, layer["ln2"]), layer, cfg)


def _project_qkv(x, layer, cfg: TransformerConfig):
    """RMSNorm + q/k/v projections for decode queries. x: [B, S, D]."""
    h = _rms_norm(x, layer["ln1"])
    q = torch.einsum("bsd,dhe->bshe", h, load_weight(layer["wq"], cfg.dtype))
    k = torch.einsum("bsd,dke->bske", h, load_weight(layer["wk"], cfg.dtype))
    v = torch.einsum("bsd,dke->bske", h, load_weight(layer["wv"], cfg.dtype))
    return q, k, v


# ---------------------------------------------------------------- prefill


def prefill_model(cfg: TransformerConfig) -> Transformer:
    """The prefill trunk for ``cfg``. A config that asked for sequence-
    parallel attention ('ring'/'ulysses') serves through 'auto', as in the
    JAX package."""
    if cfg.attn_impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(cfg, attn_impl="auto")
    return Transformer(cfg)


def prefill_capture(params, cfg: TransformerConfig, tokens: torch.Tensor,
                    model: Transformer | None = None):
    """tokens [B, S] → (last-position logits [B, V] f32, k, v), k/v each
    [L, B, S, K, Dh] in the compute dtype: the prompt's cache rows, for a
    caller that writes them into its own pool."""
    model = model or prefill_model(cfg)
    x, ks, vs = model.trunk_kv(params, tokens)
    logits = matmul_f32(x[:, -1], params["lm_head"], cfg.dtype)
    return logits, ks, vs


def prefill(params, cfg: TransformerConfig, tokens: torch.Tensor, max_len: int):
    """tokens [B, S] → (last-position logits [B, V] f32, KVCache with
    positions [0, S) filled and the rest zero, [L, B, max_len, K, Dh])."""
    logits, ks, vs = prefill_capture(params, cfg, tokens)
    nl, b, s, kh, dh = ks.shape
    shape = (nl, b, max_len, kh, dh)
    cache_k = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
    cache_v = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
    cache_k[:, :, :s] = ks
    cache_v[:, :, :s] = vs
    return logits, KVCache(cache_k, cache_v)

"""Prefill, the cached decode read, sampling and the lockstep ``generate``
loop: port of ``torchkafka_tpu/models/generate.py``.

``prefill`` reuses the trunk of ``Transformer`` (one implementation of the
layer math, as in the JAX package) and captures each layer's k/v for the
serving cache. ``_attend_cached`` is the decode tail over an M-major
cache ``[B, M, K, Dh]``, in both cache modes: the compute-dtype pool, and
the int8 pool with its scales folded onto the small score/probability
tensors. The server's int8 pool reads through the CUDA kernel instead
(``ops.kvattn``); this read serves the compute-dtype pool.

Sampling draws as the JAX package does: ``jax.random.categorical`` over
the filtered logits, from threefry keys (``utils.prng``), so a key gives
the same tokens in both packages. Not ported yet: the mesh shardings
(ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from torchkafka_tpu_torch.models.quant import embed_rows, load_weight
from torchkafka_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    _mlp,
    _moe_mlp,
    _rms_norm,
    _rope,
    layer_at,
    matmul_f32,
)
from torchkafka_tpu_torch.utils import prng


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
    JAX package's rule. The temperature divides as a tensor on the logits'
    device: CUDA multiplies by the reciprocal of a host scalar instead,
    which can differ in the last bit."""
    temp = torch.full((), float(temperature), dtype=torch.float32,
                      device=logits.device)
    logits = logits.float() / temp
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
    key: torch.Tensor | None,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """[..., V] logits → [...] int32 token ids. ``temperature == 0`` is
    greedy argmax (the first maximum, as in JAX; the key is not used);
    otherwise ``prng.categorical(key, filter_logits(...))``: one key [2]
    draws over the whole array, keys [B, 2] draw row b with key b."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filtered = filter_logits(
        logits, temperature=temperature, top_k=top_k, top_p=top_p
    )
    return prng.categorical(key, filtered).to(torch.int32)


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
    """Post-attention residual: output projection + the MLP block. An MoE
    layer routes exactly (dense dispatch) whatever ``cfg.moe_dispatch``
    says, as the JAX package's decode does: capacity drops are a training
    tradeoff, and every decoded token gets its routed experts."""
    x = x + torch.einsum(
        "bshe,hed->bsd", attn, load_weight(layer["wo"], cfg.dtype)
    )
    h = _rms_norm(x, layer["ln2"])
    if cfg.is_moe:
        return x + _moe_mlp(h, layer, cfg)[0]
    return x + _mlp(h, layer, cfg)


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


# --------------------------------------------------------------- lockstep


def _layer_step(x, layer, cache_k, cache_v, pos: int, cfg: TransformerConfig):
    """One token through one layer at the scalar position ``pos``. x:
    [B, 1, D]; caches [B, max_len, K, Dh], one layer's views, written in
    place at ``pos``; the read covers positions [0, pos]."""
    q, k, v = _project_qkv(x, layer, cfg)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    valid = torch.arange(cache_k.shape[1], device=x.device) <= pos
    return _attend_cached(x, q, cache_k, cache_v, valid, layer, cfg)


def _decode_one(params, cfg: TransformerConfig, cache: KVCache,
                token: torch.Tensor, pos: int) -> torch.Tensor:
    """token [B] → logits [B, V] f32; the cache is written in place."""
    x = embed_rows(params["embed"], token, cfg.dtype)[:, None, :]
    for i in range(cfg.n_layers):
        x = _layer_step(x, layer_at(params["layers"], i), cache.k[i],
                        cache.v[i], pos, cfg)
    x = _rms_norm(x[:, 0], params["ln_f"])
    return matmul_f32(x, params["lm_head"], cfg.dtype)


@torch.inference_mode()
def generate(
    params,
    cfg: TransformerConfig,
    prompt: torch.Tensor,
    max_new: int,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    rng: torch.Tensor | None = None,
) -> torch.Tensor:
    """prompt [B, S] int32 → generated [B, max_new] int32, every row in
    lockstep (greedy when ``temperature == 0``). ``rng``: a ``prng`` key
    (None = ``prng.key(0)``). Token 0 draws with ``rng`` itself; each later
    step does ``key, sub = split(key)`` and draws with ``sub``, the JAX
    package's schedule, so a key gives the same tokens in both packages."""
    check_sampling_params(top_k, top_p)
    batch, seq = prompt.shape
    logits, cache = prefill(params, cfg, prompt, seq + max_new)
    key = prng.key(0, prompt.device) if rng is None else rng.to(prompt.device)

    def pick(lg, k):
        return sample_logits(lg, k, temperature=temperature, top_k=top_k,
                             top_p=top_p)

    tokens = [pick(logits, key)]
    for i in range(max_new - 1):
        key, sub = prng.split(key)
        logits = _decode_one(params, cfg, cache, tokens[-1], seq + i)
        tokens.append(pick(logits, sub))
    return torch.stack(tokens, dim=1)

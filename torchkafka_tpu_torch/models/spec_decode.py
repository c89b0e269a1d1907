"""Speculative decoding: draft proposal, one multi-query verify, greedy
accept. Port of ``torchkafka_tpu/models/spec_decode.py``.

A DRAFT model proposes ``k`` greedy tokens autoregressively; the TARGET
scores all k+1 positions in ONE multi-query step (``_multi_step``) and
accepts the longest draft prefix that matches its own argmax, then emits
one correction/bonus token from its own logits. Every emitted token is
the target's greedy choice, so the output equals ``generate`` (greedy) up
to f32 reduction order for ANY draft sharing the vocab: the draft sets
only the speed, through its acceptance rate.

The draft runs k+1 steps for k proposals: the last only INGESTS proposal
k, so after a full-accept round the draft cache holds an entry at every
accepted position (without it position base+k stays a hole, and the next
round's draft attends over stale k/v; the perfect-draft test catches it,
acceptance falling to about half).

Cache discipline: both caches are written speculatively (the verify
writes all k+1 inputs, the draft all its steps), and rejected positions
stay as stale entries beyond each row's accepted watermark. Every read
masks by position, and the next round writes from the watermark before it
attends, so rollback is the position bookkeeping alone. The caches hold
S + max_new + 2k positions: a round starts at S + emitted - 1 and writes
k+1 positions, with emitted <= max_new + k after its own overshoot.

PyTorch idiom against the JAX package's: the JAX ``lax.while_loop`` over
the round is a host loop with the same carry, each round's per-row
emission count lives in position bookkeeping and a masked one-hot write
into a [B, max_new + k + 1] buffer (no data-dependent shapes), and the
caches are written in place (``index_put_``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from torchkafka_tpu_torch.models.generate import (
    KVCache,
    _attend_cached,
    _project_qkv,
    prefill,
    staged,
)
from torchkafka_tpu_torch.models.quant import QTensor, embed_rows
from torchkafka_tpu_torch.models.transformer import (
    TransformerConfig,
    _rms_norm,
    _rope,
    matmul_f32,
    unstack_layers,
)


def truncated_draft(params, cfg: TransformerConfig, n_layers: int):
    """(draft_params, draft_cfg): the self-speculative layer-skip draft,
    the target's FIRST ``n_layers`` layers with its own embedding, final
    norm and lm_head (shared, not copied). Layer tensors are stacked
    ``[L, ...]``, so truncation is a leading-axis slice of each (a view;
    a ``QTensor`` has each field sliced)."""
    if not (1 <= n_layers <= cfg.n_layers):
        raise ValueError(
            f"n_layers must be in [1, {cfg.n_layers}], got {n_layers}"
        )
    draft_params = dict(params)
    draft_params["layers"] = {
        name: QTensor(w.q[:n_layers], w.scale[:n_layers])
        if isinstance(w, QTensor) else w[:n_layers]
        for name, w in params["layers"].items()
    }
    return draft_params, dataclasses.replace(cfg, n_layers=n_layers)


class SpecStats(NamedTuple):
    """Per-run counters (0-d int tensors)."""

    rounds: torch.Tensor  # verify steps executed
    accepted: torch.Tensor  # draft tokens accepted across all rows/rounds
    proposed: torch.Tensor  # draft tokens proposed across all rows/rounds


def lm_logits(params, cfg: TransformerConfig, x: torch.Tensor, shard=None) -> torch.Tensor:
    """Final norm + LM head: hidden states [..., D] → f32 logits [..., V]
    (``shard``, a ``models.generate.ServingShard``: this rank's head
    columns, all-gathered over tp)."""
    h = _rms_norm(x, params["ln_f"])
    if shard is not None:
        return shard.logits(h, params["lm_head"], cfg.dtype)
    return matmul_f32(h, params["lm_head"], cfg.dtype)


def _multi_step(params, cfg: TransformerConfig, cache: KVCache, tokens,
                pos_b, layers=None, shard=None) -> torch.Tensor:
    """S-query decode step at PER-ROW start positions: tokens [B, S] (token
    s sits at position pos_b + s), pos_b [B]. Writes k/v for all S inputs
    at [pos_b, pos_b + S) of ``cache`` ([L, B, M, K, Dh], in place) before
    any read, and returns f32 logits [B, S, V] (the predictions for
    positions pos_b + s + 1). Query s reads positions [0, pos_b + s]. S=1
    is a per-row decode tick; S=k+1 is the verify. ``layers``: the
    unstacked layer views of ``params`` (``unstack_layers``), when the
    caller keeps them. ``shard``: the rank's ``ServingShard`` on a mesh
    (its slots, heads and stage's layers; the lookup and the head through
    it)."""
    b, s = tokens.shape
    dev = tokens.device
    if shard is None:
        x = embed_rows(params["embed"], tokens, cfg.dtype)  # [B, S, D]
    else:
        x = shard.embed(params["embed"], tokens, cfg.dtype)
    positions = pos_b[:, None] + torch.arange(s, device=dev)[None, :]  # [B, S]
    rows = torch.arange(b, device=dev)[:, None]
    p = positions.long()
    valid = (torch.arange(cache.k.shape[2], device=dev)[None, None, :]
             <= positions[:, :, None])  # [B, S, M] per-query masks
    if layers is None:
        layers = unstack_layers(params["layers"])

    def body(x):
        for i, layer in enumerate(layers):
            q, k, v = _project_qkv(x, layer, cfg)
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            ck, cv = cache.k[i], cache.v[i]
            ck.index_put_((rows, p), k.to(ck.dtype))
            cv.index_put_((rows, p), v.to(cv.dtype))
            x = _attend_cached(x, q, ck, cv, valid, layer, cfg, shard=shard)
        return x

    return lm_logits(params, cfg, staged(shard, x, body), shard)


def accept(tga: torch.Tensor, d: torch.Tensor):
    """Greedy accept: the target's argmax over the k+1 verify positions
    ``tga`` [B, k+1] against the draft's proposals ``d`` [B, k] →
    (n_acc [B], the longest matching prefix; corr [B], the target's token
    at position n_acc: the correction, or the bonus after a full
    accept)."""
    k = d.shape[1]
    match = (tga[:, :k] == d).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)
    corr = torch.gather(tga, 1, n_acc[:, None].long())[:, 0]
    return n_acc, corr


@torch.inference_mode()
def speculative_generate(
    target_params,
    target_cfg: TransformerConfig,
    draft_params,
    draft_cfg: TransformerConfig,
    prompt: torch.Tensor,
    max_new: int,
    *,
    k: int = 4,
):
    """prompt [B, S] int32 → (tokens [B, max_new] int32, SpecStats).

    ``tokens`` is ``generate(target_params, target_cfg, prompt, max_new)``
    (greedy) up to f32 reduction order; the draft sets only the speed.
    ``k``: draft tokens proposed per verify. Quantized (QTensor) trees
    serve unchanged on either side."""
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"draft and target must share a vocab: "
            f"{draft_cfg.vocab_size} != {target_cfg.vocab_size}"
        )
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_new < 2:
        raise ValueError("max_new must be >= 2 (prefill emits token 0)")
    batch, seq = prompt.shape
    dev = prompt.device
    max_len = seq + max_new + 2 * k  # overshoot margin, module docstring
    buf = max_new + k + 1

    t_logits0, t_cache = prefill(target_params, target_cfg, prompt, max_len)
    _d_logits0, d_cache = prefill(draft_params, draft_cfg, prompt, max_len)
    t_layers = unstack_layers(target_params["layers"])
    d_layers = unstack_layers(draft_params["layers"])
    last_tok = torch.argmax(t_logits0, dim=-1).to(torch.int32)  # [B]

    gen = torch.zeros((batch, buf), dtype=torch.int32, device=dev)
    gen[:, 0] = last_tok
    emitted = torch.ones((batch,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    rounds, acc, prop = zero.clone(), zero.clone(), zero.clone()
    idx = torch.arange(buf, device=dev)[None, :]

    while bool((emitted < max_new).any()):
        act = emitted < max_new  # [B]
        base = seq + emitted - 1  # position of the last emitted token
        # k+1 draft steps for k proposals (module docstring).
        tok, d_toks = last_tok, []
        for j in range(k + 1):
            logits = _multi_step(draft_params, draft_cfg, d_cache, tok[:, None],
                                 base + j, d_layers)
            tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            d_toks.append(tok)
        d = torch.stack(d_toks[:k], dim=1)  # [B, k]

        v_in = torch.cat([last_tok[:, None], d], dim=1)  # [B, k+1]
        t_logits = _multi_step(target_params, target_cfg, t_cache, v_in, base,
                               t_layers)
        tga = torch.argmax(t_logits, dim=-1).to(torch.int32)  # [B, k+1]
        n_acc, corr = accept(tga, d)

        # Emit d[:, :n_acc] then the correction/bonus: masked one-hot row
        # writes over the [B, buf] buffer, per row by j <= n_acc and act.
        for j in range(k + 1):
            tok_j = d[:, j] if j < k else corr
            tok_j = torch.where(j < n_acc, tok_j, corr)
            write = act & (j <= n_acc)
            sel = (idx == (emitted + j)[:, None]) & write[:, None]
            gen = torch.where(sel, tok_j[:, None], gen)

        last_tok = torch.where(act, corr, last_tok)
        n_act = act.sum()
        emitted = emitted + torch.where(act, n_acc + 1, 0).to(torch.int32)
        rounds = rounds + (n_act > 0)
        acc = acc + torch.where(act, n_acc, 0).sum()
        prop = prop + k * n_act
    return gen[:, :max_new], SpecStats(rounds, acc, prop)

"""Dense multi-head attention (port of ``torchkafka_tpu/ops/attention.py``
``mha``). Ring and Ulysses sequence parallelism are not ported yet
(ROADMAP queue A: Tensor and sequence parallelism)."""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # finite sentinel: avoids -inf - -inf = nan in a softmax


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, H, D] → [B, Sq, H, D].

    ``q_offset``/``k_offset`` are the global positions of the first row
    of each block (the ring-step contract). Scores and the softmax run in
    f32; the probabilities are cast to v's dtype before the PV product and
    the output is in v's dtype, as in the JAX package."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(q.shape[-1])
    )
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask[None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float()
    ).to(v.dtype)

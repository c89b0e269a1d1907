"""Attention: dense, ring and Ulysses (sequence-parallel): port of
``torchkafka_tpu/ops/attention.py``.

- ``mha``: dense multi-head attention, scores and softmax in f32.
- ``ring_attention``: exact attention over a sequence-parallel mesh axis.
  Each rank holds its [B, S/n, H, D] chunk of q/k/v; the k/v chunks travel
  round the ring (``parallel.collectives.ppermute``) while q stays. On the
  card each ring step runs the flash forward kernel K1 with the chunks'
  global offsets and merges the partial results in f32 through their lse
  (``_RingFlash``); its backward runs K2 and K3 per step against the
  merged o and lse, dq accumulating at home and the dk/dv accumulators
  travelling with their k/v chunk until they arrive home. On the CPU the
  dense online-softmax ring body runs (``_ring_dense_local``),
  differentiable through the exchange itself; ``use_flash=True`` there runs
  the kernels' plain versions.
- ``ulysses_attention``: two all-to-alls trade the sequence split for a
  head split and back (``parallel.collectives.all_to_all``), so each rank
  runs one full-sequence attention over its share of the heads (the flash
  kernels on the card, GQA kv unrepeated).

Calling convention of both (as ``ops.flash.flash_attention_sharded``):
plain local tensors holding this rank's sequence chunk → a local result;
``DTensor``s sharded over the axis on dim 1 → a ``DTensor`` with q's
placements (``to_local``/``from_local`` carry gradients both ways; DTensor
itself never communicates).
"""

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


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """GQA kv heads repeated to q's head count (kv head j serves q heads
    j·rep ... (j+1)·rep - 1)."""
    rep = q.shape[2] // k.shape[2]
    if rep == 1:
        return k, v
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def _gqa_dense(q, k, v, causal: bool):
    k, v = _repeat_kv(q, k, v)
    return mha(q, k, v, causal=causal)


# ------------------------------------------------------------------- ring


def _ring_dense_local(q, k, v, group, causal: bool) -> torch.Tensor:
    """The plain ring body on this rank's chunks [B, Sl, H, D]: the online
    softmax recurrence (running max m, normalizer l) over the n chunks of
    k/v as they arrive, f32 scores and sums, p cast to v's dtype before the
    PV product. Differentiable through ``ppermute``."""
    from torchkafka_tpu_torch.parallel import collectives

    n = collectives.group_size(group)
    me = torch.distributed.get_rank(group)
    b, sl, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q_pos = me * sl + torch.arange(sl, device=q.device)
    out = torch.zeros((b, sl, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sl), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sl), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (me - step) % n  # the chunk k_cur holds after `step` hops
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cur.float()) * scale
        if causal:
            k_pos = src * sl + torch.arange(sl, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cur.dtype).float(), v_cur.float())
        out = out * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if step < n - 1:  # the last hop would bring the chunks home unused
            k_cur = collectives.ppermute(k_cur, group)
            v_cur = collectives.ppermute(v_cur, group)
    denom = torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return (out / denom).to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The ring over the flash kernels: the JAX package's ``_ring_flash``
    custom VJP. Forward: K1 once per ring step (q at offset me·Sl, the
    chunk it holds at src·Sl, fully masked steps included as in the JAX
    package), the partial (o, lse) merged in f32 with logaddexp. Backward:
    delta once from the merged f32 o, then K2 and K3 once per step against
    the merged lse; dq accumulates here in f32, the dk/dv accumulators
    travel with their chunk and are home after n hops. Saved: q, k, v, o,
    lse (O(Sl·D))."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        from torchkafka_tpu_torch.ops.flash import _to_bhsd, flash_fwd_bhsd
        from torchkafka_tpu_torch.parallel import collectives

        n = collectives.group_size(group)
        me = torch.distributed.get_rank(group)
        b, sl, h, d = q.shape
        qb, kb, vb = _to_bhsd(q), _to_bhsd(k), _to_bhsd(v)
        kv = torch.stack([kb, vb])  # one hop moves both
        o = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b * h, sl, 1), _NEG_INF, dtype=torch.float32, device=q.device)
        for step in range(n):
            src = (me - step) % n
            o_p, lse_p = flash_fwd_bhsd(qb, kv[0], kv[1], causal=causal, q_offset=me * sl,
                                        k_offset=src * sl, n_q_heads=h, n_kv_heads=h)
            lse_new = torch.logaddexp(lse, lse_p)
            o = torch.exp(lse - lse_new) * o + torch.exp(lse_p - lse_new) * o_p.float()
            lse = lse_new
            if step < n - 1:
                kv = collectives.ppermute(kv, group)
        ctx.save_for_backward(qb, kb, vb, o, lse)
        ctx.group, ctx.causal, ctx.shape = group, causal, (b, h)
        return o.reshape(b, h, sl, d).transpose(1, 2).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        from torchkafka_tpu_torch.ops.flash import (
            _to_bhsd,
            flash_delta,
            flash_dkv_bhsd,
            flash_dq_bhsd,
        )
        from torchkafka_tpu_torch.parallel import collectives

        qb, kb, vb, o, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        b, h = ctx.shape
        n = collectives.group_size(group)
        me = torch.distributed.get_rank(group)
        sl = qb.shape[1]
        gb = _to_bhsd(g.to(qb.dtype))
        delta = flash_delta(o, gb)
        kv = torch.stack([kb, vb])
        dq = torch.zeros(qb.shape, dtype=torch.float32, device=qb.device)
        dkv = torch.zeros((2, *kb.shape), dtype=torch.float32, device=qb.device)
        for step in range(n):
            src = (me - step) % n
            kw = dict(causal=causal, q_offset=me * sl, k_offset=src * sl,
                      n_q_heads=h, n_kv_heads=h)
            dq += flash_dq_bhsd(qb, kv[0], kv[1], gb, lse, delta, **kw).float()
            dk_p, dv_p = flash_dkv_bhsd(qb, kv[0], kv[1], gb, lse, delta, **kw)
            dkv[0] += dk_p.float()
            dkv[1] += dv_p.float()
            # The accumulators go on with the chunk they belong to; after
            # n hops each is back on the rank that holds that chunk.
            dkv = collectives.ppermute(dkv, group)
            if step < n - 1:
                kv = collectives.ppermute(kv, group)

        def back(x, dtype):
            return x.reshape(b, h, sl, -1).transpose(1, 2).to(dtype)

        return back(dq, qb.dtype), back(dkv[0], kb.dtype), back(dkv[1], vb.dtype), None, None


def _ring_local(q, k, v, group, causal: bool, use_flash: bool | None) -> torch.Tensor:
    """Dispatch of the ring body: the flash kernels per step on CUDA
    tensors (or with ``use_flash=True``, which on the CPU runs their plain
    versions), the dense body otherwise."""
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        return _RingFlash.apply(q, k, v, group, causal)
    return _ring_dense_local(q, k, v, group, causal)


def _on_local(fn, q, k, v):
    """``fn`` on this rank's tensors: plain tensors as they are, DTensors
    through ``to_local``/``from_local`` (q's placements)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return fn(q, k, v)
    out = fn(q.to_local(), k.to_local(), v.to_local())
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False)


def _axis_size(mesh, axis_name: str) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return int(sizes.get(axis_name, 1))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = "sp",
    causal: bool = True,
    use_flash: bool | None = None,
) -> torch.Tensor:
    """Exact sequence-parallel attention over ``mesh[axis_name]``. q/k/v:
    this rank's chunks [B, S/n, H, D] (chunk i of the sequence on the
    axis's rank i), or DTensors sharded so on dim 1 (see the module note).
    ``use_flash``: None = the flash kernels per ring step on CUDA tensors,
    the dense body on the CPU; True/False forces (True on the CPU runs the
    kernels' plain versions). Equal q and kv head counts are required
    (repeat GQA kv first). An axis of size 1 is ``mha``."""
    if q.shape[2] != k.shape[2]:
        raise ValueError(
            "ring_attention requires equal q/kv head counts — repeat kv "
            "heads before the ring (GQA-native reads are a flash_attention "
            "feature; the ring rotates whatever kv it is given)"
        )
    if _axis_size(mesh, axis_name) == 1:
        return _on_local(lambda a, b, c: mha(a, b, c, causal=causal), q, k, v)
    group = mesh.get_group(axis_name)
    return _on_local(lambda a, b, c: _ring_local(a, b, c, group, causal, use_flash), q, k, v)


# ---------------------------------------------------------------- Ulysses


def _ulysses_local(q, k, v, group, causal: bool, use_flash: bool | None) -> torch.Tensor:
    """This rank's chunks [B, Sl, H, D] → the all-to-all to [B, S, H/n, D]
    (kv heads unrepeated), one full-sequence attention over those heads
    (the flash kernels, GQA through their kv row map, or the dense ``mha``
    with kv repeated), and the all-to-all back to [B, Sl, H, D]."""
    from torchkafka_tpu_torch.parallel.collectives import all_to_all

    qh = all_to_all(q, 2, 1, group)
    kh = all_to_all(k, 2, 1, group)
    vh = all_to_all(v, 2, 1, group)
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        from torchkafka_tpu_torch.ops.flash import flash_attention

        out = flash_attention(qh, kh, vh, causal)
    else:
        out = _gqa_dense(qh, kh, vh, causal)
    return all_to_all(out, 1, 2, group)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = "sp",
    causal: bool = True,
    use_flash: bool | None = None,
) -> torch.Tensor:
    """Exact sequence-parallel attention by all-to-all head re-partitioning
    (DeepSpeed-Ulysses): the same contract as ``ring_attention``, but 2
    exchanges around one full-sequence attention a rank. q and kv head
    counts must both divide by the axis size (GQA kv travels unrepeated);
    an axis of size 1 is ``mha`` (kv repeated for GQA)."""
    n = _axis_size(mesh, axis_name)
    if n == 1:
        return _on_local(lambda a, b, c: _gqa_dense(a, b, c, causal), q, k, v)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"ulysses_attention re-partitions heads over {axis_name!r} "
            f"(size {n}): q heads {q.shape[2]} and kv heads "
            f"{k.shape[2]} must both be divisible by it — use "
            "ring_attention for indivisible head counts"
        )
    group = mesh.get_group(axis_name)
    return _on_local(lambda a, b, c: _ulysses_local(a, b, c, group, causal, use_flash),
                     q, k, v)

"""Fused blocked softmax cross-entropy — the lm_head + loss hot path.

Port of ``torchkafka_tpu/ops/xent.py``. On a vocab-sized head the naive
loss materialises two full ``[B, S, V]`` float32 tensors (the logits and
their log-softmax) and keeps one alive for the backward. This op never
does:

- **Blocks over the sequence.** Each block computes ``[B, blk, V]`` f32
  logits from the compute-dtype operands, reduces them to per-token
  logsumexp and target logit, and discards them. Peak memory for the head
  is one block of logits.
- **Gradients inside the blocked forward.** The loss is a scalar and its
  incoming gradient ``g`` enters linearly, so ``dlogits = (softmax −
  onehot(targets))·mask`` is formed while the block's logits are live and
  contracted at once into ``dx`` ([B, S, D], f32) and ``dW`` ([D, V], an
  f32 sum over blocks). The backward only scales both by ``g / count``:
  three head products in all (forward, dx, dW), no ``[B, S, V]``
  residual, no recompute. When no input needs a gradient the forward
  skips the gradient work.

It is plain PyTorch: the JAX package has no Pallas kernel here (XLA fuses
it), and the head products stay ``torch.matmul``. They run on f32 copies
of the compute-dtype operands, so every product is exact and every sum
f32, the JAX package's ``preferred_element_type=float32``.
"""

from __future__ import annotations

import math

import torch

# Peak bytes of f32 block logits to aim for when auto-picking a block size.
_AUTO_BLOCK_BYTES = 256 * 1024 * 1024


def auto_block_size(batch: int, seq: int, vocab: int) -> int:
    """Largest power-of-two sequence block with ≤ _AUTO_BLOCK_BYTES of f32
    block logits, clamped to [16, seq]."""
    budget = max(1, _AUTO_BLOCK_BYTES // (4 * batch * max(vocab, 1)))
    blk = 2 ** int(math.floor(math.log2(budget))) if budget > 1 else 1
    return max(16, min(seq, blk))


def _logits_f32(x: torch.Tensor, wc: torch.Tensor, dtype) -> torch.Tensor:
    """[B, s, D] @ [D, V] in f32 from compute-dtype operands."""
    return x.to(dtype).float() @ wc


def _denominator(mask: torch.Tensor, count) -> torch.Tensor:
    """The mean's denominator: ``count`` when given (a batch-sharded step
    passes the mask sum over every rank, so each rank's share sums to the
    global mean), else this call's mask sum, at least 1."""
    if count is not None:
        return torch.as_tensor(count, dtype=torch.float32, device=mask.device)
    return torch.clamp_min(mask.float().sum(), 1.0)


def dense_softmax_xent(x, w, targets, mask, compute_dtype=torch.bfloat16, count=None):
    """Reference implementation: full-logits masked-mean CE, differentiable
    through autograd. The fallback (quantized heads, ``ce_block_size=0``)
    and the test oracle. ``count``: the denominator, as in
    ``fused_softmax_xent``."""
    logits = _logits_f32(x, w.to(compute_dtype).float(), compute_dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    m = mask.to(nll.dtype)
    return (nll * m).sum() / _denominator(m, count)


def _resolve_block(block_size, batch, seq, vocab) -> int:
    """None → auto. 0/negative is an error here, NOT a dense fallback: the
    'ce_block_size=0 disables fusion' contract lives in Transformer, which
    routes to the dense path before this op is ever called."""
    if block_size is None:
        return auto_block_size(batch, seq, vocab)
    if block_size <= 0:
        raise ValueError(
            f"block_size must be a positive int or None (auto), got "
            f"{block_size}; use the dense CE for an unblocked loss"
        )
    return block_size


def _pad_blocks(x, targets, mask, block):
    """Pad S up to a multiple of ``block`` with mask-0 rows; → (x, targets,
    mask, number of blocks), padded."""
    s = x.shape[1]
    nb = -(-s // block)
    pad = nb * block - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return x, targets, mask, nb


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, mask, block_size, compute_dtype, count):
        b, s, d = x.shape
        v = w.shape[-1]
        blk = _resolve_block(block_size, b, s, v)
        mask = mask.float()
        wc = w.to(compute_dtype).float()
        xp, tp, mp, nb = _pad_blocks(x, targets.long(), mask, blk)
        grads = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        dx = torch.empty((b, nb * blk, d), dtype=torch.float32, device=x.device) if grads else None
        dw = torch.zeros((d, v), dtype=torch.float32, device=x.device) if grads else None
        for i in range(nb):
            sl = slice(i * blk, (i + 1) * blk)
            xx, tt, mm = xp[:, sl], tp[:, sl], mp[:, sl]
            logits = _logits_f32(xx, wc, compute_dtype)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, tt[..., None])[..., 0]
            tot = tot + ((lse - tgt) * mm).sum()
            if grads:
                # d(nll_sum)/d(logits), before the 1/count and incoming-
                # gradient scaling the backward applies (both linear).
                p = torch.exp(logits - lse[..., None])
                p.scatter_add_(-1, tt[..., None], -torch.ones_like(tt[..., None], dtype=p.dtype))
                dlog = (p * mm[..., None]).to(compute_dtype).float()
                dx[:, sl] = dlog @ wc.T
                dw += xx.to(compute_dtype).float().reshape(-1, d).T @ dlog.reshape(-1, v)
        cnt = _denominator(mask, count)
        if grads:
            ctx.save_for_backward(dx[:, :s], dw, cnt)
            ctx.dtypes = (x.dtype, w.dtype)
        return tot / cnt

    @staticmethod
    def backward(ctx, g):
        dx, dw, cnt = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        scale = (g / cnt).float()
        return (
            (dx * scale).to(x_dtype),
            (dw * scale).to(w_dtype),
            None,  # integer targets
            None,  # mask: non-differentiable selection weights
            None,
            None,
            None,  # count: a constant denominator
        )


def fused_softmax_xent(
    x, w, targets, mask, block_size=None, compute_dtype=torch.bfloat16, count=None
):
    """Masked-mean next-token CE over a vocab head, blocked over sequence.

    x: [B, S, D] trunk output; w: [D, V] head (master dtype — cast to
    ``compute_dtype`` inside, so dW comes back in master precision);
    targets: [B, S] int; mask: [B, S] (0 ⇒ position excluded).
    ``count``: the mean's denominator; None = this call's mask sum (at
    least 1). On a batch-sharded mesh each rank passes the mask sum over
    every rank: its loss is then its masked sum over the global count, and
    the ranks' losses (and gradients) add up to the global mean's.
    Matches ``dense_softmax_xent`` to f32-reduction tolerance."""
    return _FusedXent.apply(x, w, targets, mask, block_size, compute_dtype, count)

"""Causal flash-attention forward: port of ``torchkafka_tpu/ops/flash.py``.

``flash_fwd_bhsd`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_fwd.cu`` (it replaces the Pallas ``_flash_kernel``). On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
``flash_fwd_plain``, the plain PyTorch version of the same function, which
the tests hold against the JAX package and which the on-card smoke check
holds the kernel against. There is no fallback from kernel to plain on
the card.

Layout: the public ``flash_attention`` takes ``[B, S, H, D]`` (``mha``'s
layout) and runs the kernel over ``[B·H, S, D]``; K < H kv heads (GQA) are
served by the kernel's kv row map, never by repeating them. The backward
kernels (the TPU package's ``_dq_kernel``/``_dkv_kernel``) arrive with
the training slice; ``lse`` is emitted now because they need it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from torchkafka_tpu_torch.ops import _native

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_D_MAX = 256


def _kv_rows(bh: int, n_q_heads: int, n_kv_heads: int, device) -> torch.Tensor:
    """q row ``b·H + h`` → kv row ``b·K + h // (H/K)``."""
    r = torch.arange(bh, device=device)
    rep = n_q_heads // n_kv_heads
    return (r // n_q_heads) * n_kv_heads + (r % n_q_heads) // rep


def flash_fwd_plain(
    q, k, v, *, causal: bool = True, q_offset: int = 0, k_offset: int = 0,
    n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """Plain PyTorch version of the kernel: q [B·H, Sq, D], k/v [B·K, Sk, D]
    → (o [B·H, Sq, D] in q's dtype, lse [B·H, Sq, 1] f32). One softmax over
    all keys (the kernel's blocks only reorder f32 sums); p is cast to v's
    dtype before the PV product; masked keys contribute exactly 0, so a row
    with no allowed key gives o = 0 and lse ≈ -1e30."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    idx = _kv_rows(bh, n_q_heads, n_kv_heads, q.device)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k[idx].float()) * (
        1.0 / math.sqrt(d)
    )
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = k_offset + torch.arange(sk, device=q.device)
        allowed = (q_pos[:, None] >= k_pos[None, :])[None]
    else:
        allowed = torch.ones((1, sq, sk), dtype=torch.bool, device=q.device)
    s = torch.where(allowed, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v[idx].float())
    return (acc / l).to(q.dtype), m + torch.log(l)


def _check(q, k, v, n_q_heads: int, n_kv_heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(
            f"want q [BH, Sq, D], k/v [BK, Sk, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if n_kv_heads < 1 or n_q_heads % n_kv_heads or q.shape[0] % n_q_heads:
        raise ValueError(
            f"B·H={q.shape[0]} with H={n_q_heads}, K={n_kv_heads}: H must "
            "divide B·H and K must divide H"
        )
    if k.shape[0] != q.shape[0] // n_q_heads * n_kv_heads:
        raise ValueError(f"k rows {k.shape[0]} != B·K for q rows {q.shape[0]}")
    if q.shape[2] != k.shape[2] or q.shape[2] > _D_MAX:
        raise ValueError(f"head dim must match and be <= {_D_MAX}")


def flash_fwd_bhsd(
    q, k, v, *, causal: bool = True, q_offset: int = 0, k_offset: int = 0,
    n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """q [B·H, Sq, D], k/v [B·K, Sk, D] → (o [B·H, Sq, D], lse [B·H, Sq, 1]).

    CUDA tensors launch ``csrc/flash_fwd.cu`` (``flash_fwd_bhsd.launches``
    counts each launch); CPU tensors run ``flash_fwd_plain``."""
    _check(q, k, v, n_q_heads, n_kv_heads)
    if q.device.type == "cpu":
        return flash_fwd_plain(
            q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset,
            n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd kernel needs contiguous q, k and v")
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    fn = _lib().tk_flash_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], bh, sq, k.shape[1], d,
            n_q_heads, n_kv_heads, int(q_offset), int(k_offset),
            int(bool(causal)), 1.0 / math.sqrt(d), stream,
        )
    _native.check(rc, "flash_fwd")
    flash_fwd_bhsd.launches += 1
    return o, lse


flash_fwd_bhsd.launches = 0


def _lib():
    lib = _native.load("flash_fwd")
    fn = lib.tk_flash_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] → contiguous [B·H, S, D] (at B=1 a reshape alone can
    return a strided view)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bhsd(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    *,
    q_offset: int = 0,
    k_offset: int = 0,
    return_lse: bool = False,
):
    """Fused attention, forward only. q: [B, S, H, D]; k, v: [B, S, K, D]
    with K dividing H → [B, S, H, D] (and lse [B·H, S, 1] f32 with
    ``return_lse``). Any S is served; the kernel masks the ragged edge."""
    b, _, h, _ = q.shape
    n_kv = k.shape[2]
    if h % n_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({n_kv})")
    o, lse = flash_fwd_bhsd(
        _to_bhsd(q), _to_bhsd(k), _to_bhsd(v), causal=causal,
        q_offset=q_offset, k_offset=k_offset, n_q_heads=h, n_kv_heads=n_kv,
    )
    out = _from_bhsd(o, b, h)
    return (out, lse) if return_lse else out

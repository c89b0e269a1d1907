"""Fill-bounded int8 decode attention: port of
``torchkafka_tpu/ops/kvattn.py`` ``int8_decode_attention_dynlen``.

``int8_decode_attention_dynlen`` is the wrapper of the hand-written CUDA
kernel ``csrc/kvattn_dynlen.cu`` (it replaces the Pallas
``_kvattn_dynlen_kernel``): single-query attention over a K-major int8
pool that reads only positions ``[0, pos[b]]`` of each slot. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs
``int8_decode_attention_plain``, the plain PyTorch version of the same
function. There is no fallback from kernel to plain on the card.

The other TPU read kernels (the paged block-table read, the v2 full-pool
K-major read and the v1 M-major read) are not ported yet (ROADMAP
Queue B).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from torchkafka_tpu_torch.ops import _native

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_REPS = (1, 2, 4, 8)


def kernel_applicable(head_dim: int, max_len: int, n_rep: int = 1) -> bool:
    """Shapes the CUDA kernel takes: head_dim a multiple of 16 up to 128
    (16-byte row loads, one output column per thread), a non-empty pool
    of any length (the kernel masks the ragged tile), and H/K in
    {1, 2, 4, 8} query rows per kv head."""
    return (
        head_dim % 16 == 0 and 16 <= head_dim <= 128 and max_len >= 1
        and n_rep in _REPS
    )


def dynlen_block(max_len: int) -> int:
    """The TPU kernel's M-block: the largest of (512, 256, 128, 64, 8)
    dividing the pool length (0 if none). The CUDA kernel tiles 128
    positions and masks the last tile, so it serves any pool length; this
    stays for callers that reason in the TPU kernel's block units."""
    for mb in (512, 256, 128, 64, 8):
        if max_len % mb == 0:
            return mb
    return 0


def int8_decode_attention_plain(q, ck_q, ck_s, cv_q, cv_s, pos):
    """Plain PyTorch version of the kernel (same arguments as
    ``int8_decode_attention_dynlen``). q·k runs on the int8 payload cast to
    f32 (exact products), the k-scale lands on the scores and the v-scale
    on the probabilities, which are cast to q's dtype before the PV
    product, as in the TPU kernel; one softmax over the valid positions
    replaces the kernel's per-tile recurrence."""
    b, _, h, dh = q.shape
    n_kv, m = ck_q.shape[1], ck_q.shape[2]
    qg = q[:, 0].reshape(b, n_kv, h // n_kv, dh).float()
    s = torch.einsum("bkrd,bkmd->bkrm", qg, ck_q.float())
    s = s * ck_s[:, :, None, :] * float(1.0 / np.sqrt(dh))
    valid = torch.arange(m, device=q.device)[None, :] <= pos[:, None].long()
    s = torch.where(valid[:, None, None, :], s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pw = (p * cv_s[:, :, None, :]).to(q.dtype).float()
    acc = torch.einsum("bkrm,bkmd->bkrd", pw, cv_q.float())
    return (acc / l).to(q.dtype).reshape(b, 1, h, dh)


def _check(q, ck_q, ck_s, cv_q, cv_s, pos) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode attention is one token per slot, got q {tuple(q.shape)}")
    b, _, h, dh = q.shape
    if ck_q.dim() != 4 or ck_q.shape[0] != b or ck_q.shape[3] != dh:
        raise ValueError(f"want K-major pool [B, K, M, Dh], got {tuple(ck_q.shape)}")
    n_kv, m = ck_q.shape[1], ck_q.shape[2]
    if cv_q.shape != ck_q.shape or ck_s.shape != (b, n_kv, m) or cv_s.shape != (b, n_kv, m):
        raise ValueError("payloads must be [B, K, M, Dh] and scales [B, K, M]")
    if h % n_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({n_kv})")
    if ck_q.dtype != torch.int8 or cv_q.dtype != torch.int8:
        raise ValueError("payloads must be int8")
    if ck_s.dtype != torch.float32 or cv_s.dtype != torch.float32:
        raise ValueError("scales must be float32")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError("pos must be int32 [B]")
    if len({t.device for t in (q, ck_q, ck_s, cv_q, cv_s, pos)}) != 1:
        raise ValueError("all operands must be on one device")


def int8_decode_attention_dynlen(q, ck_q, ck_s, cv_q, cv_s, pos):
    """q [B, 1, H, Dh] against a K-major int8 cache ``ck_q``/``cv_q``
    [B, K, M, Dh] with f32 scales [B, K, M], reading only positions
    ``[0, pos[b]]`` of slot b (``pos``: [B] int32) → [B, 1, H, Dh] in q's
    dtype. CUDA tensors launch ``csrc/kvattn_dynlen.cu``
    (``int8_decode_attention_dynlen.launches`` counts each launch); CPU
    tensors run ``int8_decode_attention_plain``."""
    _check(q, ck_q, ck_s, cv_q, cv_s, pos)
    if q.device.type == "cpu":
        return int8_decode_attention_plain(q, ck_q, ck_s, cv_q, cv_s, pos)
    if q.device.type != "cuda":
        raise ValueError(f"int8 decode attention runs on cuda or cpu, not {q.device}")
    b, _, h, dh = q.shape
    n_kv, m = ck_q.shape[1], ck_q.shape[2]
    if not kernel_applicable(dh, m, h // n_kv):
        raise ValueError(
            f"the CUDA kernel does not take head_dim={dh}, pool_len={m}, "
            f"H/K={h // n_kv} (see kernel_applicable)"
        )
    ops = (q, ck_q, ck_s, cv_q, cv_s, pos)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the int8 decode kernel needs contiguous operands")
    out = torch.empty_like(q)
    fn = _lib().tk_kvattn_dynlen
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            *(t.data_ptr() for t in ops), out.data_ptr(), _DTYPES[q.dtype],
            b, n_kv, h // n_kv, m, dh, float(1.0 / np.sqrt(dh)), stream,
        )
    _native.check(rc, "kvattn_dynlen")
    int8_decode_attention_dynlen.launches += 1
    return out


int8_decode_attention_dynlen.launches = 0


def _lib():
    lib = _native.load("kvattn_dynlen")
    fn = lib.tk_kvattn_dynlen
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib

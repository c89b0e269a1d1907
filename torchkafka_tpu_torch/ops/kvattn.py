"""The int8 decode reads and the paged pool's operators: port of
``torchkafka_tpu/ops/kvattn.py``.

Four hand-written CUDA kernels in three sources, each behind a wrapper
that launches it on a CUDA tensor (or raises) and runs its plain PyTorch
version on a CPU tensor; there is no fallback from kernel to plain on the
card:

- ``int8_decode_attention_dynlen`` → ``csrc/kvattn_dynlen.cu`` (replaces
  the Pallas ``_kvattn_dynlen_kernel``): single-query attention over a
  dense K-major int8 pool that reads only positions ``[0, pos[b]]`` of
  each slot; plain version ``int8_decode_attention_plain``.
- ``int8_paged_decode_attention`` → ``csrc/kvattn_paged.cu`` (replaces
  the Pallas ``_kvattn_paged_kernel``): the same read through per-slot
  block tables over a shared paged pool; plain version
  ``int8_paged_decode_attention_plain``.
- ``int8_decode_attention_kmajor`` and ``int8_decode_attention`` →
  ``csrc/kvattn_full.cu`` (replace the Pallas ``_kvattn_kmajor_kernel``
  and ``_kvattn_kernel``): single-query attention over EVERY position of
  a dense int8 pool under a [B, M] readable-position mask, on the K-major
  [B, K, M, Dh] and the M-major [B, M, K, Dh] layout; plain versions
  ``int8_decode_attention_kmajor_plain`` and
  ``int8_decode_attention_mmajor_plain``. No serving path calls them, as
  in the JAX package: the server's kernel-off int8 read is
  ``models.generate._attend_cached`` on the M-major pool, K8's math in
  plain code.

All four reads share one split-K body (``csrc/kvattn_split.cuh``): the
grid is (n_split, B·K), each block reads one span of L logical positions
of one (slot, kv head), and the last live span of a (slot, kv head)
merges the spans' partials in the same launch. The full-pool reads run it
in its mask mode, where every span is live. ``_split_plan`` picks L and
n_split from the pool or view length alone (the host never reads a
watermark or a mask). The merge counts spans on a persistent int32
buffer, one per (device, CUDA stream), which every launch leaves at zero;
the partials' workspace comes from the caching allocator.

The paged pool's gathers, scatters and ``block_table_attention(_q8)``
are plain PyTorch in both packages. The scatters write IN PLACE
(``index_put_`` on the pool tensor, typically one layer's view); the JAX
package returns updated pools instead. Nothing else aliases a pool, so
the two are equivalent.
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
    (16-byte row chunks, eight lanes a row), a non-empty pool of any
    length (the kernel masks the ragged span and tile), and H/K in
    {1, 2, 4, 8} query rows per kv head."""
    return (
        head_dim % 16 == 0 and 16 <= head_dim <= 128 and max_len >= 1
        and n_rep in _REPS
    )


def dynlen_block(max_len: int) -> int:
    """The TPU kernel's M-block: the largest of (512, 256, 128, 64, 8)
    dividing the pool length (0 if none). The CUDA kernel splits the pool
    into spans (``_split_plan``) and masks the ragged one, so it serves any
    pool length; this stays for callers that reason in the TPU kernel's
    block units."""
    for mb in (512, 256, 128, 64, 8):
        if max_len % mb == 0:
            return mb
    return 0


# ------------------------------------------------------------ split-K plan
_SPAN = 64  # positions a span at least: one kernel tile
_ONE_SPAN_MAX = 256  # pools of up to four tiles run as one span
_MAX_SPLIT = 16  # spans a (slot, kv head) at most; longer pools widen L
_MAX_SPLIT_FULL = 8  # the same for the full-pool reads, whose spans are all live
_KERNEL_MAX_SPLIT = 64  # what the kernel's merge takes (KV_MAX_SPLIT)
# A span length that replaces the planner's (one span when >= the pool):
# for timing what the split buys. Only the on-card smoke check sets it.
_forced_span: int | None = None


def _split_plan(m_len: int, bs: int = 1, *, span: int | None = None,
                max_split: int = _MAX_SPLIT) -> tuple[int, int]:
    """(L, n_split) for a pool or logical view of ``m_len`` positions in
    blocks of ``bs``. The rule, from K4/K5 timed on the H100 at pools of
    192-4096 positions: a pool of up to four 64-position tiles is one span
    (the merge's dependent round trips through device memory cost more
    than two or three tiles in parallel save); a longer one splits into
    spans of L = 64·k positions, the least k that gives at most
    ``max_split`` spans: 16 for the fill-bounded reads, whose spans past a
    slot's watermark exit at once, and 8 (``_MAX_SPLIT_FULL``) for the
    full-pool reads K7/K8, whose spans all read: at the 8b decode shape on
    an NVIDIA H100 (700 W) K7 read a 2048 pool faster in 8 spans of 256
    (0.058 ms) than in 16 of 128 (0.062), 32 of 64, 4 of 512 or one span
    (K8, with one block an SM fewer, fastest in 4 of 512, then 8 of 256),
    and a 192 pool faster in one span than in spans of 64 or 128
    (``chip_smoke.py`` phase ``kvattn_full`` times them; PERF.md).
    Where bs <= L, L rounds up to whole blocks, so a span reads each of its
    table entries once. n_split = ceil(m_len / L), the least count that
    covers the pool. ``span`` forces L (one span when >= m_len). Pure
    Python: the watermarks are not read, so planning needs no sync."""
    if m_len < 1 or bs < 1:
        raise ValueError(f"want m_len >= 1 and bs >= 1, got {m_len}, {bs}")
    if span is None:
        span = m_len if m_len <= _ONE_SPAN_MAX else _SPAN * -(-m_len // (_SPAN * max_split))
    span = min(max(span, 1), m_len)
    if bs <= span:
        span = -(-span // bs) * bs
    n_split = -(-m_len // span)
    if n_split > _KERNEL_MAX_SPLIT:
        raise ValueError(f"{n_split} spans of {span}: the merge takes {_KERNEL_MAX_SPLIT}")
    return span, n_split


# One zeroed int32 counter a (slot, kv head) for the merge, per (device,
# CUDA stream): launches on one stream run in order and each leaves its
# counters at zero, so the buffer is zeroed once, when it is made or grown,
# and every split kernel on the stream can share it: K4, K5, K7, K8 and
# K6's split-K (``ops/qmatmul.py``).
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _counter(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _split_args(q: torch.Tensor, bk: int, rep: int, dh: int, m_len: int, bs: int,
                stream: int, max_split: int = _MAX_SPLIT
                ) -> tuple[int, int, int, int, tuple[torch.Tensor, ...]]:
    """(L, n_split, workspace pointer, counter pointer, tensors to keep
    alive until the launch is queued) for one launch of a split read."""
    span, n_split = _split_plan(m_len, bs, span=_forced_span, max_split=max_split)
    if n_split == 1:
        return span, 1, 0, 0, ()
    ws = torch.empty(bk * n_split * rep * (dh + 2), dtype=torch.float32, device=q.device)
    cnt = _counter(q.device, stream, bk)
    return span, n_split, ws.data_ptr(), cnt.data_ptr(), (ws, cnt)


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
    dtype. CUDA tensors launch ``csrc/kvattn_dynlen.cu``, split as
    ``_split_plan`` says (``int8_decode_attention_dynlen.launches`` counts
    each launch); CPU tensors run ``int8_decode_attention_plain``."""
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
    if ck_q.data_ptr() % 16 or cv_q.data_ptr() % 16:
        raise ValueError("the int8 payloads must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = _lib().tk_kvattn_dynlen
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        span, n_split, ws, cnt, _keep = _split_args(q, b * n_kv, h // n_kv, dh, m, 1,
                                                    stream)
        rc = fn(
            *(t.data_ptr() for t in ops), out.data_ptr(), ws, cnt, _DTYPES[q.dtype],
            b, n_kv, h // n_kv, m, dh, span, n_split, float(1.0 / np.sqrt(dh)), stream,
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
        # q, kq, ks, vq, vs, pos, out, ws, counter; dtype, b, n_kv, rep, m,
        # dh, span, n_split; 1/sqrt(dh); stream.
        fn.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.tk_kvattn_dynlen_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.tk_kvattn_dynlen_attrs.restype = ctypes.c_int
        lib.tk_kvattn_i8_convert.argtypes = [p, p, p]
        lib.tk_kvattn_i8_convert.restype = ctypes.c_int
    return lib


def _attrs(fn, dtype: torch.dtype, rep: int, what: str) -> dict:
    out = (ctypes.c_int * 4)()
    _native.check(fn(_DTYPES[dtype], rep, out), what)
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem"), out))


def dynlen_attrs(dtype: torch.dtype = torch.bfloat16, rep: int = 2) -> dict:
    """The compiled resources of K4's kernel for (dtype, rep):
    {"regs", "local_bytes", "static_smem", "dynamic_smem"} (local bytes > 0
    means spills). Builds the library if needed; needs CUDA."""
    return _attrs(_lib().tk_kvattn_dynlen_attrs, dtype, rep, "kvattn_dynlen attrs")


def i8_convert_table(device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' int8 conversion run on the card for every int8 value:
    (f32 [256], bf16 [256]), entry x for the int8 x - 128."""
    f32 = torch.empty(256, dtype=torch.float32, device=device)
    b16 = torch.empty(256, dtype=torch.bfloat16, device=device)
    with torch.cuda.device(f32.device):
        stream = torch.cuda.current_stream(f32.device).cuda_stream
        rc = _lib().tk_kvattn_i8_convert(f32.data_ptr(), b16.data_ptr(), stream)
    _native.check(rc, "kvattn i8 convert")
    return f32, b16


# ------------------------------------------------------- full pool, masked
# The v2 (K-major) and v1 (M-major) reads visit every position of the pool
# and mask with a [B, M] bool; a masked position scores exactly -1e30, so
# an all-false row averages all M positions uniformly (the reference
# softmax's result), unlike the fill-bounded read, which never sees one.


def int8_decode_attention_kmajor_plain(q, ck_q, ck_s, cv_q, cv_s, valid):
    """Plain PyTorch version of the K-major full-pool kernel (arguments of
    ``int8_decode_attention_kmajor``): the scale-folded read — q·k on the
    int8 payload cast to f32, the k-scale and 1/√Dh on the scores, -1e30
    where ``valid`` is false, a softmax, the v-scale on the probabilities
    rounded to q's dtype before the PV product."""
    b, _, h, dh = q.shape
    n_kv = ck_q.shape[1]
    qg = q[:, 0].reshape(b, n_kv, h // n_kv, dh).float()
    s = torch.einsum("bkrd,bkmd->bkrm", qg, ck_q.float())
    s = s * ck_s[:, :, None, :] * float(1.0 / np.sqrt(dh))
    s = torch.where(valid[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    pw = (p * cv_s[:, :, None, :]).to(q.dtype).float()
    o = torch.einsum("bkrm,bkmd->bkrd", pw, cv_q.float())
    return o.to(q.dtype).reshape(b, 1, h, dh)


def int8_decode_attention_mmajor_plain(q, ck_q, ck_s, cv_q, cv_s, valid):
    """Plain PyTorch version of the M-major full-pool kernel (arguments of
    ``int8_decode_attention``): the same scale-folded read on [B, M, K,
    Dh] payloads and [B, M, K] scales."""
    return int8_decode_attention_kmajor_plain(
        q, ck_q.transpose(1, 2), ck_s.transpose(1, 2), cv_q.transpose(1, 2),
        cv_s.transpose(1, 2), valid,
    )


def _check_full(q, ck_q, ck_s, cv_q, cv_s, valid, kmajor: bool) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode attention is one token per slot, got q {tuple(q.shape)}")
    b, _, h, dh = q.shape
    want = "[B, K, M, Dh]" if kmajor else "[B, M, K, Dh]"
    if ck_q.dim() != 4 or ck_q.shape[0] != b or ck_q.shape[3] != dh:
        raise ValueError(f"want pool {want}, got {tuple(ck_q.shape)}")
    if cv_q.shape != ck_q.shape or ck_s.shape != ck_q.shape[:3] or cv_s.shape != ck_q.shape[:3]:
        raise ValueError(f"payloads must be {want} and scales {want[:-5]}]")
    n_kv, m = (ck_q.shape[1], ck_q.shape[2]) if kmajor else (ck_q.shape[2], ck_q.shape[1])
    if h % n_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({n_kv})")
    if ck_q.dtype != torch.int8 or cv_q.dtype != torch.int8:
        raise ValueError("payloads must be int8")
    if ck_s.dtype != torch.float32 or cv_s.dtype != torch.float32:
        raise ValueError("scales must be float32")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if valid.shape != (b, m) or valid.dtype != torch.bool:
        raise ValueError("valid must be bool [B, M]")
    if len({t.device for t in (q, ck_q, ck_s, cv_q, cv_s, valid)}) != 1:
        raise ValueError("all operands must be on one device")


def _launch_full(q, ck_q, ck_s, cv_q, cv_s, valid, kmajor: bool):
    """Launch ``csrc/kvattn_full.cu`` on CUDA operands (checked by the
    caller), split as ``_split_plan`` says for a full read of the pool →
    [B, 1, H, Dh] in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"int8 decode attention runs on cuda or cpu, not {q.device}")
    b, _, h, dh = q.shape
    n_kv, m = (ck_q.shape[1], ck_q.shape[2]) if kmajor else (ck_q.shape[2], ck_q.shape[1])
    if not kernel_applicable(dh, m, h // n_kv):
        raise ValueError(
            f"the CUDA kernel does not take head_dim={dh}, pool_len={m}, "
            f"H/K={h // n_kv} (see kernel_applicable)"
        )
    ops = (q, ck_q, ck_s, cv_q, cv_s, valid)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the int8 decode kernel needs contiguous operands")
    if ck_q.data_ptr() % 16 or cv_q.data_ptr() % 16:
        raise ValueError("the int8 payloads must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = _lib_full().tk_kvattn_full
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        span, n_split, ws, cnt, _keep = _split_args(q, b * n_kv, h // n_kv, dh, m, 1,
                                                    stream, _MAX_SPLIT_FULL)
        rc = fn(
            *(t.data_ptr() for t in ops), out.data_ptr(), ws, cnt, _DTYPES[q.dtype],
            b, n_kv, h // n_kv, m, dh, span, n_split, int(kmajor),
            float(1.0 / np.sqrt(dh)), stream,
        )
    _native.check(rc, "kvattn_full")
    return out


def int8_decode_attention_kmajor(q, ck_q, ck_s, cv_q, cv_s, valid, *,
                                 slot_block: int | None = None):
    """q [B, 1, H, Dh] against a K-MAJOR int8 pool ``ck_q``/``cv_q`` [B, K,
    M, Dh] with f32 scales [B, K, M] and a readable-position mask ``valid``
    [B, M] (bool, any pattern) → [B, 1, H, Dh] in q's dtype. On prefix
    masks it equals the fill-bounded read. ``slot_block`` is the TPU
    kernel's slots per grid step, validated as there (it must divide B)
    and otherwise unused: it is a VMEM knob, not part of the contract.
    CUDA tensors launch ``csrc/kvattn_full.cu``, split as ``_split_plan``
    says (``int8_decode_attention_kmajor.launches`` counts each launch); CPU
    tensors run ``int8_decode_attention_kmajor_plain``."""
    b = q.shape[0]
    if slot_block and b % slot_block:
        raise ValueError(f"slot_block={slot_block} must divide batch={b}")
    _check_full(q, ck_q, ck_s, cv_q, cv_s, valid, kmajor=True)
    if q.device.type == "cpu":
        return int8_decode_attention_kmajor_plain(q, ck_q, ck_s, cv_q, cv_s, valid)
    out = _launch_full(q, ck_q, ck_s, cv_q, cv_s, valid, kmajor=True)
    int8_decode_attention_kmajor.launches += 1
    return out


int8_decode_attention_kmajor.launches = 0


def int8_decode_attention(q, ck_q, ck_s, cv_q, cv_s, valid):
    """q [B, 1, H, Dh] against an M-MAJOR int8 pool ``ck_q``/``cv_q`` [B, M,
    K, Dh] with f32 scales [B, M, K] and a readable-position mask ``valid``
    [B, M] (bool, any pattern) → [B, 1, H, Dh] in q's dtype: the math of
    the server's kernel-off int8 read. CUDA tensors launch
    ``csrc/kvattn_full.cu``, split as ``_split_plan`` says
    (``int8_decode_attention.launches`` counts each launch); CPU tensors
    run ``int8_decode_attention_mmajor_plain``."""
    _check_full(q, ck_q, ck_s, cv_q, cv_s, valid, kmajor=False)
    if q.device.type == "cpu":
        return int8_decode_attention_mmajor_plain(q, ck_q, ck_s, cv_q, cv_s, valid)
    out = _launch_full(q, ck_q, ck_s, cv_q, cv_s, valid, kmajor=False)
    int8_decode_attention.launches += 1
    return out


int8_decode_attention.launches = 0


def _lib_full():
    lib = _native.load("kvattn_full")
    fn = lib.tk_kvattn_full
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q, kq, ks, vq, vs, valid, out, ws, counter; dtype, b, n_kv, rep,
        # m, dh, span, n_split, kmajor; 1/sqrt(dh); stream.
        fn.argtypes = [p] * 9 + [i] * 9 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.tk_kvattn_full_attrs.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.tk_kvattn_full_attrs.restype = ctypes.c_int
    return lib


def full_attrs(dtype: torch.dtype = torch.bfloat16, rep: int = 4, kmajor: bool = True) -> dict:
    """The compiled resources of K7's (``kmajor``) or K8's kernel for
    (dtype, rep), as ``dynlen_attrs``. Builds the library if needed; needs
    CUDA."""
    fn = _lib_full().tk_kvattn_full_attrs
    return _attrs(lambda d, r, out: fn(d, r, int(kmajor), out), dtype, rep,
                  "kvattn_full attrs")


# ------------------------------------------------------- paged (block-table)
# The paged pool is a SHARED set of fixed-size blocks and each slot maps
# logical positions to physical blocks through its row of a block table
# [B, nblk]; several slots may map the same physical prefix blocks (radix
# sharing). The write is a scatter at (table[pos // bs], pos % bs), the
# gathered read a copy of each slot's nblk blocks into a contiguous
# [B, nblk·bs, ...] logical view, masked to the live length.


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool [NB, bs, ...rest]; table [B, nblk] physical block ids →
    [B, nblk·bs, ...rest]: logical position p of slot b lands at index p."""
    b, nblk = table.shape
    return pool[table.long()].reshape(b, nblk * pool.shape[1], *pool.shape[2:])


def _block_offsets(table, positions, bs):
    blk = torch.gather(table.long(), 1, (positions // bs).long())  # [B, S]
    return blk, (positions % bs).long()


def paged_scatter(pool, table, positions, values) -> torch.Tensor:
    """Write ``values`` [B, S, ...rest] at logical ``positions`` [B, S]
    through ``table`` [B, nblk] into ``pool`` [NB, bs, ...rest], in place;
    returns ``pool``.

    Live slots write only blocks they own privately (sharing is limited
    to whole blocks strictly below any written position — the radix
    contract), so no two live rows collide. Idle rows point every table
    entry at the sink block (``kvcache.SINK_BLOCK``), which no live table
    references; their duplicate writes there leave an arbitrary winner,
    which nothing reads."""
    blk, off = _block_offsets(table, positions, pool.shape[1])
    pool.index_put_((blk, off), values.to(pool.dtype))
    return pool


def paged_gather_kmajor(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``paged_gather`` for K-MAJOR-PER-BLOCK pools: pool [NB, K, bs,
    ...rest] (payload rest=(Dh,), scales rest=()) → [B, nblk·bs, K,
    ...rest], the logical layout ``_attend_cached`` reads."""
    b, nblk = table.shape
    v = pool[table.long()].transpose(2, 3)  # [B, nblk, bs, K, ...rest]
    return v.reshape(b, nblk * pool.shape[2], *v.shape[3:])


def paged_scatter_kmajor(pool, table, positions, values) -> torch.Tensor:
    """``paged_scatter`` for K-major-per-block pools: ``values`` [B, S, K,
    ...rest] written at logical ``positions`` [B, S] into ``pool`` [NB,
    K, bs, ...rest], in place; returns ``pool``. The three index tensors
    broadcast to [B, S, K] explicitly (the JAX spelling ``pool.at[blk, :,
    off]`` moves the broadcast dims to the front)."""
    blk, off = _block_offsets(table, positions, pool.shape[2])
    kidx = torch.arange(pool.shape[1], device=pool.device)[None, None, :]
    pool.index_put_((blk[:, :, None], kidx, off[:, :, None]), values.to(pool.dtype))
    return pool


def _valid(positions: torch.Tensor, m: int) -> torch.Tensor:
    """[B, S, M] per-query masks of readable positions [0, positions]."""
    return torch.arange(m, device=positions.device)[None, None, :] <= positions[:, :, None]


def block_table_attention(x, q, k_new, v_new, pool_k, pool_v, table, positions,
                          layer, cfg, shard=None):
    """One layer of write-then-attend over a compute-dtype paged pool.

    x: [B, S, D]; q/k_new/v_new: [B, S, ·, Dh] (already rope'd); pools
    [NB, bs, K, Dh] (written in place); table [B, nblk]; positions [B, S].
    Every row's k/v is written before any row reads (a chunk's rows
    attend over positions earlier rows of the same chunk write), then
    each query attends over [0, its position] of its slot's gathered view
    through the shared ``_attend_cached`` tail. Returns x. ``shard``: the
    rank's ``models.generate.ServingShard`` (the pools hold its kv heads).
    """
    from torchkafka_tpu_torch.models.generate import _attend_cached

    paged_scatter(pool_k, table, positions, k_new)
    paged_scatter(pool_v, table, positions, v_new)
    ck = paged_gather(pool_k, table)  # [B, M', K, Dh]
    cv = paged_gather(pool_v, table)
    return _attend_cached(x, q, ck, cv, _valid(positions, ck.shape[1]), layer, cfg,
                          shard=shard)


def paged_write_q8(pool_kq, pool_ks, pool_vq, pool_vs, table, positions,
                   k_new, v_new) -> None:
    """The int8 paged pool's write: the fresh k/v [B, S, K, Dh] quantized
    into the shared per-(position, head) groups
    (``models.quant.quant_kv_groups``, the dense int8 pool's) and
    scattered K-major-per-block (payloads [NB, K, bs, Dh], scales
    [NB, K, bs]) in place."""
    from torchkafka_tpu_torch.models.quant import quant_kv_groups

    kq, ks = quant_kv_groups(k_new)  # [B, S, K, Dh] int8, [B, S, K] f32
    vq, vs = quant_kv_groups(v_new)
    for pool, val in ((pool_kq, kq), (pool_ks, ks), (pool_vq, vq), (pool_vs, vs)):
        paged_scatter_kmajor(pool, table, positions, val)


def block_table_attention_q8(x, q, k_new, v_new, pool_kq, pool_ks, pool_vq,
                             pool_vs, table, positions, layer, cfg, shard=None):
    """``block_table_attention`` over the INT8 paged pool: ``paged_write_q8``,
    then the scale-folded ``_attend_cached`` on the gathered view. Returns
    x. ``int8_paged_decode_attention`` replaces only this read on
    decode-only ticks; the write is shared."""
    from torchkafka_tpu_torch.models.generate import _attend_cached

    paged_write_q8(pool_kq, pool_ks, pool_vq, pool_vs, table, positions, k_new, v_new)
    ck = paged_gather_kmajor(pool_kq, table)  # [B, M', K, Dh] int8
    cv = paged_gather_kmajor(pool_vq, table)
    cks = paged_gather_kmajor(pool_ks, table)  # [B, M', K] f32
    cvs = paged_gather_kmajor(pool_vs, table)
    return _attend_cached(x, q, ck, cv, _valid(positions, ck.shape[1]), layer,
                          cfg, k_scale=cks, v_scale=cvs, shard=shard)


def paged_kernel_applicable(head_dim: int, block_size: int, n_rep: int = 1) -> bool:
    """Shapes the CUDA block-table kernel takes: head_dim a multiple of 16
    up to 128 (16-byte row chunks, eight lanes a row), H/K in {1, 2, 4,
    8} query rows per kv head, and any block_size >= 1. A span's tiles
    are assembled from the table entries they cover and each row is
    addressed through its own entry, so blocks smaller or larger than a
    span both work; each block's [bs, Dh] run is
    contiguous, so the 16-byte row loads stay coalesced inside a block
    (block_size 16 — vLLM's default page, and what ``chip_smoke.py``
    serves with — gives 2 KB runs at head_dim 128)."""
    return (
        head_dim % 16 == 0 and 16 <= head_dim <= 128 and block_size >= 1
        and n_rep in _REPS
    )


def int8_paged_decode_attention_plain(q, pool_kq, pool_ks, pool_vq, pool_vs,
                                      table, pos):
    """Plain PyTorch version of the block-table kernel (same arguments as
    ``int8_paged_decode_attention``): each slot's logical view gathered
    through its table (``paged_gather_kmajor``), laid out K-major, then
    the dense read's plain version with the same watermarks."""
    ck = paged_gather_kmajor(pool_kq, table).transpose(1, 2)  # [B, K, M', Dh]
    cv = paged_gather_kmajor(pool_vq, table).transpose(1, 2)
    cks = paged_gather_kmajor(pool_ks, table).transpose(1, 2)  # [B, K, M']
    cvs = paged_gather_kmajor(pool_vs, table).transpose(1, 2)
    return int8_decode_attention_plain(q, ck, cks, cv, cvs, pos)


def _check_paged(q, pool_kq, pool_ks, pool_vq, pool_vs, table, pos) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode attention is one token per slot, got q {tuple(q.shape)}")
    b, _, h, dh = q.shape
    if pool_kq.dim() != 4 or pool_kq.shape[3] != dh:
        raise ValueError(f"want paged pool [NB, K, bs, Dh], got {tuple(pool_kq.shape)}")
    nb, n_kv, bs = pool_kq.shape[:3]
    if (pool_vq.shape != pool_kq.shape or pool_ks.shape != (nb, n_kv, bs)
            or pool_vs.shape != (nb, n_kv, bs)):
        raise ValueError("payloads must be [NB, K, bs, Dh] and scales [NB, K, bs]")
    if h % n_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({n_kv})")
    if pool_kq.dtype != torch.int8 or pool_vq.dtype != torch.int8:
        raise ValueError("payloads must be int8")
    if pool_ks.dtype != torch.float32 or pool_vs.dtype != torch.float32:
        raise ValueError("scales must be float32")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if table.dim() != 2 or table.shape[0] != b or table.dtype != torch.int32:
        raise ValueError("table must be int32 [B, nblk]")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError("pos must be int32 [B]")
    if len({t.device for t in (q, pool_kq, pool_ks, pool_vq, pool_vs, table, pos)}) != 1:
        raise ValueError("all operands must be on one device")


def int8_paged_decode_attention(q, pool_kq, pool_ks, pool_vq, pool_vs, table, pos):
    """q [B, 1, H, Dh] against the int8 PAGED pool — K-major-per-block
    payloads ``pool_kq``/``pool_vq`` [NB, K, bs, Dh] with f32 scales [NB,
    K, bs] — read through the per-slot block tables ``table`` [B, nblk]
    (int32) at watermarks ``pos`` [B] (int32; positions [0, pos[b]]
    readable) → [B, 1, H, Dh] in q's dtype. Only the ceil((pos+1)/bs)
    table entries a slot needs are read, and no gathered view is
    materialised. CUDA tensors launch ``csrc/kvattn_paged.cu``, split as
    ``_split_plan`` says (``int8_paged_decode_attention.launches`` counts
    each launch); CPU
    tensors run ``int8_paged_decode_attention_plain``."""
    _check_paged(q, pool_kq, pool_ks, pool_vq, pool_vs, table, pos)
    if q.device.type == "cpu":
        return int8_paged_decode_attention_plain(
            q, pool_kq, pool_ks, pool_vq, pool_vs, table, pos
        )
    if q.device.type != "cuda":
        raise ValueError(f"int8 paged attention runs on cuda or cpu, not {q.device}")
    b, _, h, dh = q.shape
    nb, n_kv, bs = pool_kq.shape[:3]
    nblk = table.shape[1]
    if not paged_kernel_applicable(dh, bs, h // n_kv) or nblk < 1:
        raise ValueError(
            f"the CUDA kernel does not take head_dim={dh}, block_size={bs}, "
            f"H/K={h // n_kv}, nblk={nblk} (see paged_kernel_applicable)"
        )
    ops = (q, pool_kq, pool_ks, pool_vq, pool_vs, table, pos)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the int8 paged kernel needs contiguous operands")
    if pool_kq.data_ptr() % 16 or pool_vq.data_ptr() % 16:
        raise ValueError("the int8 payloads must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = _lib_paged().tk_kvattn_paged
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        span, n_split, ws, cnt, _keep = _split_args(q, b * n_kv, h // n_kv, dh,
                                                    nblk * bs, bs, stream)
        rc = fn(
            *(t.data_ptr() for t in ops), out.data_ptr(), ws, cnt, _DTYPES[q.dtype],
            b, n_kv, h // n_kv, nb, bs, nblk, dh, span, n_split,
            float(1.0 / np.sqrt(dh)), stream,
        )
    _native.check(rc, "kvattn_paged")
    int8_paged_decode_attention.launches += 1
    return out


int8_paged_decode_attention.launches = 0


def _check_local(what: str, q, pool, kv_dim: int, shard, slots_split: bool) -> None:
    """A sharded read's operands must be the rank's own: q's H/tp heads, the
    pool's K/tp kv heads on dim ``kv_dim`` and, where the slots split over
    data, B/data slots; allocated at those local shapes (contiguous), never
    as views into a whole pool."""
    cfg = shard.cfg
    h, k = cfg.n_heads // shard.tp, cfg.n_kv_heads // shard.tp
    if q.shape[2] != h or pool.shape[kv_dim] != k:
        raise ValueError(f"{what}: this rank holds {h} q heads and {k} kv heads "
                         f"(tp={shard.tp}), got q {tuple(q.shape)}, pool {tuple(pool.shape)}")
    if slots_split and q.shape[0] != pool.shape[0]:
        raise ValueError(f"{what}: q has {q.shape[0]} slots, the pool {pool.shape[0]}")


def int8_decode_attention_dynlen_sharded(q, ck_q, ck_s, cv_q, cv_s, pos, shard):
    """K4 on a serving mesh (``shard``: the rank's
    ``models.generate.ServingShard``): each rank reads its B/data slots'
    K/tp kv heads of the K-major pool with its H/tp q heads. Attention is
    head-local and slot-local, so no collective runs; the launch counts on
    ``int8_decode_attention_dynlen.launches`` as any other."""
    _check_local("int8_decode_attention_dynlen_sharded", q, ck_q, 1, shard, True)
    return int8_decode_attention_dynlen(q, ck_q, ck_s, cv_q, cv_s, pos)


def int8_paged_decode_attention_sharded(q, pool_kq, pool_ks, pool_vq, pool_vs, table,
                                        pos, shard):
    """K5 on a serving mesh: each rank reads its K/tp kv heads of the paged
    pool (blocks replicated over data) through the replicated tables. No
    collective runs; the launch counts on
    ``int8_paged_decode_attention.launches``."""
    _check_local("int8_paged_decode_attention_sharded", q, pool_kq, 1, shard, False)
    return int8_paged_decode_attention(q, pool_kq, pool_ks, pool_vq, pool_vs, table, pos)


def _lib_paged():
    lib = _native.load("kvattn_paged")
    fn = lib.tk_kvattn_paged
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q, kq, ks, vq, vs, table, pos, out, ws, counter; dtype, b, n_kv,
        # rep, nb, bs, nblk, dh, span, n_split; 1/sqrt(dh); stream.
        fn.argtypes = [p] * 10 + [i] * 10 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.tk_kvattn_paged_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.tk_kvattn_paged_attrs.restype = ctypes.c_int
    return lib


def paged_attrs(dtype: torch.dtype = torch.bfloat16, rep: int = 2) -> dict:
    """The compiled resources of K5's kernel for (dtype, rep), as
    ``dynlen_attrs``. Builds the library if needed; needs CUDA."""
    return _attrs(_lib_paged().tk_kvattn_paged_attrs, dtype, rep, "kvattn_paged attrs")

"""Causal flash attention, forward and backward: port of
``torchkafka_tpu/ops/flash.py``.

Three hand-written CUDA kernels, each behind a wrapper that counts its
launches:

- ``flash_fwd_bhsd`` → ``csrc/flash_fwd.cu`` (replaces the Pallas
  ``_flash_kernel``): O and the per-row lse;
- ``flash_dq_bhsd`` → ``csrc/flash_bwd.cu`` (replaces ``_dq_kernel``): dQ;
- ``flash_dkv_bhsd`` → ``csrc/flash_bwd.cu`` (replaces ``_dkv_kernel``):
  dK and dV, summed over the q heads of each kv head inside the kernel.

Each wrapper picks one of two kernels by one fixed rule, ``_route``, the
same in both directions: bf16 with D a multiple of 16 (up to 128) runs the
tensor-core kernel (``flash_fwd_tc_kernel``, ``flash_dq_tc_kernel``,
``flash_dkv_tc_kernel``: mma.sync over swizzled bf16 tiles), f32 or any
other D the CUDA-core kernel (``flash_fwd_kernel``, ``flash_dq_kernel``,
``flash_dkv_kernel``). ``launches`` counts every launch, ``tc_launches``
the tensor-core ones.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version beside it (``flash_fwd_plain``,
``flash_dq_plain``, ``flash_dkv_plain``), which the tests hold against the
JAX package and which the on-card smoke check holds the kernel against.
There is no fallback from kernel to plain, or from one kernel to the
other, on the card. ``flash_attention_sharded`` runs the same wrappers on
each rank's local rows and heads of a batch- and head-sharded mesh.

Layout: the public ``flash_attention`` takes ``[B, S, H, D]`` (``mha``'s
layout) and runs the kernels over ``[B·H, S, D]``; K < H kv heads (GQA) are
served by the kernels' kv row map, never by repeating them. It is a
``torch.autograd.Function``: the forward saves ``(q, k, v, o, lse)``, which
is O(S·D), and the backward computes ``delta = rowsum(dO∘O)`` in f32 as
plain tensor code (the JAX package leaves it to XLA outside any kernel),
then runs dQ and dK/dV.
"""

from __future__ import annotations

import ctypes
import math

import torch

from torchkafka_tpu_torch.ops import _native

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_D_MAX = 256  # both directions; the CUDA-core backward takes 32-row tiles past 128
_D_MAX_TC = 128  # the tensor-core kernels: a 16 x D f32 accumulator a warp


def _kv_rows(bh: int, n_q_heads: int, n_kv_heads: int, device) -> torch.Tensor:
    """q row ``b·H + h`` → kv row ``b·K + h // (H/K)``."""
    r = torch.arange(bh, device=device)
    rep = n_q_heads // n_kv_heads
    return (r // n_q_heads) * n_kv_heads + (r % n_q_heads) // rep


def _allowed(sq: int, sk: int, causal: bool, q_offset: int, k_offset: int,
             device) -> torch.Tensor:
    """[1, Sq, Sk] bool: which (q row, key) pairs attend."""
    if not causal:
        return torch.ones((1, sq, sk), dtype=torch.bool, device=device)
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = k_offset + torch.arange(sk, device=device)
    return (q_pos[:, None] >= k_pos[None, :])[None]


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
    allowed = _allowed(sq, sk, causal, q_offset, k_offset, q.device)
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


def _route(dtype: torch.dtype, d: int) -> str:
    """Which kernel a CUDA launch takes, forward and backward alike, by
    rule: "tc" (tensor cores, bf16 products) for bf16 with D a multiple of
    16 and D <= 128, "simt" (f32 FMAs on the CUDA cores) for f32, for D
    not a multiple of 16, and for bf16 with 128 < D <= 256. ``_check``
    refuses D > 256 before a route is taken."""
    tc = dtype == torch.bfloat16 and d % 16 == 0 and d <= _D_MAX_TC
    return "tc" if tc else "simt"


def _launch_fwd(q, k, v, route: str, *, causal: bool = True, q_offset: int = 0,
                k_offset: int = 0, n_q_heads: int = 1, n_kv_heads: int = 1):
    """Launch the ``route`` forward kernel on contiguous CUDA q/k/v and
    return (o, lse); counts nothing."""
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    fn = _lib().tk_flash_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], int(route == "tc"), bh, sq,
            k.shape[1], d, n_q_heads, n_kv_heads, int(q_offset),
            int(k_offset), int(bool(causal)), 1.0 / math.sqrt(d), stream,
        )
    _native.check(rc, f"flash_fwd ({route})")
    return o, lse


def flash_fwd_bhsd(
    q, k, v, *, causal: bool = True, q_offset: int = 0, k_offset: int = 0,
    n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """q [B·H, Sq, D], k/v [B·K, Sk, D] → (o [B·H, Sq, D], lse [B·H, Sq, 1]).

    CUDA tensors launch the ``csrc/flash_fwd.cu`` kernel that
    ``_route`` picks (``flash_fwd_bhsd.launches`` counts each launch,
    ``.tc_launches`` the tensor-core ones); CPU tensors run
    ``flash_fwd_plain``."""
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
    route = _route(q.dtype, q.shape[2])
    o, lse = _launch_fwd(
        q, k, v, route, causal=causal, q_offset=q_offset, k_offset=k_offset,
        n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
    )
    flash_fwd_bhsd.launches += 1
    flash_fwd_bhsd.tc_launches += route == "tc"
    return o, lse


flash_fwd_bhsd.launches = 0
flash_fwd_bhsd.tc_launches = 0


def _lib():
    lib = _native.load("flash_fwd")
    if lib.tk_flash_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tk_flash_fwd.argtypes = [p] * 5 + [i] * 11 + [ctypes.c_float, p]
        lib.tk_flash_fwd.restype = ctypes.c_int
        lib.tk_flash_fwd_tc_attrs.argtypes = [i, ctypes.POINTER(i)]
        lib.tk_flash_fwd_tc_attrs.restype = ctypes.c_int
    return lib


def fwd_tc_attrs(d: int) -> dict:
    """The compiled resources of the tensor-core forward kernel that serves
    head dim ``d``: {"regs", "local_bytes", "static_smem", "dynamic_smem"}
    (local bytes > 0 means spills). Builds the library if needed; needs
    CUDA."""
    out = (ctypes.c_int * 4)()
    rc = _lib().tk_flash_fwd_tc_attrs(64 if d <= 64 else 128, out)
    _native.check(rc, "flash_fwd attrs")
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem"), out))


# ----------------------------------------------------------------- backward


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO∘O) in f32, [B·H, Sq, 1]: plain tensor code, as
    the JAX package leaves it to XLA outside its kernels."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def _bwd_probs(q, k, v, do, lse, delta, causal, q_offset, k_offset,
               n_q_heads, n_kv_heads):
    """The plain backward's per-pair tensors, [B·H, Sq, Sk] f32: p from the
    saved lse (a select on the mask: rows with no allowed key have
    lse ≈ -1e30 and exp overflows there) and ds = p∘(dp − delta)·scale."""
    bh, sq, d = q.shape
    idx = _kv_rows(bh, n_q_heads, n_kv_heads, q.device)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k[idx].float()) * scale
    allowed = _allowed(sq, k.shape[1], causal, q_offset, k_offset, q.device)
    p = torch.where(allowed, torch.exp(s - lse.float()), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v[idx].float())
    return p, p * (dp - delta.float()) * scale, idx


def flash_dq_plain(
    q, k, v, do, lse, delta, *, causal: bool = True, q_offset: int = 0,
    k_offset: int = 0, n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """Plain PyTorch version of the dQ kernel: dQ = round(dS, k dtype)·K,
    [B·H, Sq, D] in q's dtype."""
    _, ds, idx = _bwd_probs(q, k, v, do, lse, delta, causal, q_offset,
                            k_offset, n_q_heads, n_kv_heads)
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k[idx].float())
    return dq.to(q.dtype)


def flash_dkv_plain(
    q, k, v, do, lse, delta, *, causal: bool = True, q_offset: int = 0,
    k_offset: int = 0, n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """Plain PyTorch version of the dK/dV kernel: dV = round(P, dO
    dtype)ᵀ·dO and dK = round(dS, q dtype)ᵀ·Q per q head, summed in f32
    over the H/K q heads of each kv head, [B·K, Sk, D] in k's/v's dtype."""
    p, ds, _ = _bwd_probs(q, k, v, do, lse, delta, causal, q_offset,
                          k_offset, n_q_heads, n_kv_heads)
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    rep = n_q_heads // n_kv_heads
    bk, sk, d = k.shape

    def group_sum(x):  # q rows b·H + kh·rep + r → kv row b·K + kh
        return x.reshape(bk, rep, sk, d).sum(dim=1)

    return group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


def flash_bwd_plain(
    q, k, v, o, lse, do, *, causal: bool = True, q_offset: int = 0,
    k_offset: int = 0, n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """Plain PyTorch version of the whole backward: (q, k, v, o, lse, dO)
    → (dq [B·H, Sq, D], dk, dv [B·K, Sk, D]), through the same delta and
    the same casts as the kernels."""
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
              n_q_heads=n_q_heads, n_kv_heads=n_kv_heads)
    delta = flash_delta(o, do)
    dq = flash_dq_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def _check_bwd(q, k, v, do, lse, delta, n_q_heads, n_kv_heads) -> None:
    _check(q, k, v, n_q_heads, n_kv_heads)
    bh, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (bh, sq, 1) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be f32 [B·H, Sq, 1] on q's device")


def _launch_args(what, tensors, causal, q_offset, k_offset, n_q_heads,
                 n_kv_heads):
    """The route and the C launchers' scalar arguments after the
    kernel-only checks: (route, dtype, Sq, Sk, D, H, K, q_offset, k_offset,
    causal, scale)."""
    q, k = tensors[0], tensors[1]
    d = q.shape[2]
    route = _route(q.dtype, d)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel needs contiguous inputs")
    return (route, _DTYPES[q.dtype], q.shape[1], k.shape[1], d, n_q_heads,
            n_kv_heads, int(q_offset), int(k_offset), int(bool(causal)),
            1.0 / math.sqrt(d))


def flash_dq_bhsd(
    q, k, v, do, lse, delta, *, causal: bool = True, q_offset: int = 0,
    k_offset: int = 0, n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """dQ [B·H, Sq, D]. CUDA tensors launch the kernel ``_route``
    picks (``flash_dq_bhsd.launches`` counts each launch, ``.tc_launches``
    the tensor-core ones); CPU tensors run ``flash_dq_plain``."""
    _check_bwd(q, k, v, do, lse, delta, n_q_heads, n_kv_heads)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
              n_q_heads=n_q_heads, n_kv_heads=n_kv_heads)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_dq runs on cuda or cpu, not {q.device}")
    route, dtype, *args = _launch_args("flash_dq", (q, k, v, do, lse, delta),
                                       causal, q_offset, k_offset, n_q_heads,
                                       n_kv_heads)
    dq = torch.empty_like(q)
    lib = _bwd_lib()
    fn = lib.tk_flash_dq_tc if route == "tc" else lib.tk_flash_dq
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dtype,
                q.shape[0], *args, stream)
    _native.check(rc, f"flash_dq ({route})")
    flash_dq_bhsd.launches += 1
    flash_dq_bhsd.tc_launches += route == "tc"
    return dq


flash_dq_bhsd.launches = 0
flash_dq_bhsd.tc_launches = 0


def flash_dkv_bhsd(
    q, k, v, do, lse, delta, *, causal: bool = True, q_offset: int = 0,
    k_offset: int = 0, n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """(dK, dV), each [B·K, Sk, D], summed over the q heads of each kv
    head. CUDA tensors launch the kernel ``_route`` picks
    (``flash_dkv_bhsd.launches`` counts each launch, ``.tc_launches`` the
    tensor-core ones); CPU tensors run ``flash_dkv_plain``."""
    _check_bwd(q, k, v, do, lse, delta, n_q_heads, n_kv_heads)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
              n_q_heads=n_q_heads, n_kv_heads=n_kv_heads)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_dkv runs on cuda or cpu, not {q.device}")
    route, dtype, *args = _launch_args("flash_dkv", (q, k, v, do, lse, delta),
                                       causal, q_offset, k_offset, n_q_heads,
                                       n_kv_heads)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _bwd_lib()
    fn = lib.tk_flash_dkv_tc if route == "tc" else lib.tk_flash_dkv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dtype, k.shape[0], *args, stream)
    _native.check(rc, f"flash_dkv ({route})")
    flash_dkv_bhsd.launches += 1
    flash_dkv_bhsd.tc_launches += route == "tc"
    return dk, dv


flash_dkv_bhsd.launches = 0
flash_dkv_bhsd.tc_launches = 0


def flash_bwd_bhsd(
    q, k, v, o, lse, do, *, causal: bool = True, q_offset: int = 0,
    k_offset: int = 0, n_q_heads: int = 1, n_kv_heads: int = 1,
):
    """The flash backward over [B·H, S, D]: delta, then dQ and dK/dV →
    (dq [B·H, Sq, D], dk, dv [B·K, Sk, D]). On CUDA tensors both kernels
    launch; on CPU tensors their plain versions run."""
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
              n_q_heads=n_q_heads, n_kv_heads=n_kv_heads)
    delta = flash_delta(o, do)
    dq = flash_dq_bhsd(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_dkv_bhsd(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def _bwd_lib():
    lib = _native.load("flash_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if lib.tk_flash_dq.argtypes is None:
        for fn in (lib.tk_flash_dq, lib.tk_flash_dq_tc):
            fn.argtypes = [p] * 7 + [i] * 10 + [f, p]
            fn.restype = ctypes.c_int
        for fn in (lib.tk_flash_dkv, lib.tk_flash_dkv_tc):
            fn.argtypes = [p] * 8 + [i] * 10 + [f, p]
            fn.restype = ctypes.c_int
        lib.tk_flash_bwd_tc_attrs.argtypes = [i, i, ctypes.POINTER(i)]
        lib.tk_flash_bwd_tc_attrs.restype = ctypes.c_int
    return lib


def bwd_tc_attrs(which: str, d: int) -> dict:
    """The compiled resources of the tensor-core kernel that serves head
    dim ``d``: ``which`` "dq" or "dkv" → {"regs", "local_bytes",
    "static_smem", "dynamic_smem"} (local bytes > 0 means spills). Builds
    the library if needed; needs CUDA."""
    out = (ctypes.c_int * 4)()
    rc = _bwd_lib().tk_flash_bwd_tc_attrs({"dq": 0, "dkv": 1}[which],
                                           64 if d <= 64 else 128, out)
    _native.check(rc, f"flash_bwd attrs {which}")
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem"), out))


# ------------------------------------------------------------------ public


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] → contiguous [B·H, S, D] (at B=1 a reshape alone can
    return a strided view)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bhsd(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """Forward on the flash forward kernel, backward on dQ and dK/dV. The
    saved tensors are (q, k, v, o, lse) in the kernels' layout: O(S·D),
    never an [S, S] tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        b, _, h, _ = q.shape
        n_kv = k.shape[2]
        qb, kb, vb = _to_bhsd(q), _to_bhsd(k), _to_bhsd(v)
        kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
                  n_q_heads=h, n_kv_heads=n_kv)
        o, lse = flash_fwd_bhsd(qb, kb, vb, **kw)
        ctx.save_for_backward(qb, kb, vb, o, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return _from_bhsd(o, b, h), lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        qb, kb, vb, o, lse = ctx.saved_tensors
        b, _, h, _ = g.shape
        # g arrives as a transposed view of [B, S, H, D]; the kernels take
        # contiguous [B·H, S, D].
        dq, dk, dv = flash_bwd_bhsd(qb, kb, vb, o, lse, _to_bhsd(g), **ctx.kw)
        n_kv = ctx.kw["n_kv_heads"]
        return (_from_bhsd(dq, b, h), _from_bhsd(dk, b, n_kv),
                _from_bhsd(dv, b, n_kv), None, None, None)


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
    """Fused attention, differentiable with O(S·D) memory. q: [B, S, H, D];
    k, v: [B, S, K, D] with K dividing H → [B, S, H, D] (and lse
    [B·H, S, 1] f32 with ``return_lse``). Gradients come back in each
    input's layout: dK/dV as [B, S, K, D], summed over the q heads of each
    kv head. Any S is served; the kernels mask the ragged edge."""
    h, n_kv = q.shape[2], k.shape[2]
    if h % n_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({n_kv})")
    out, lse = _FlashAttention.apply(q, k, v, causal, q_offset, k_offset)
    return (out, lse) if return_lse else out


def flash_attention_sharded(q, k, v, mesh, causal: bool = True):
    """Flash attention over a {data, fsdp, tp} mesh: port of the JAX
    package's ``flash_attention_sharded``.

    Batch- and head-parallel attention needs no communication: each rank's
    rows attend over their own full sequences, and each tp rank's q heads
    and kv heads (split over tp alike, so the GQA group ratio holds per
    shard) attend by themselves. So each rank calls ``flash_attention`` on
    its local tensors (K1 forward, K2/K3 backward, the CUDA kernels on the
    card) and nothing else; DTensor's op rules never see the kernels.
    Other axes (sp) see the inputs replicated, as the JAX package's do.
    ``q``/``k``/``v``: ``DTensor``s sharded over the batch axes
    (``Shard(0)``) and the heads over tp (``Shard(2)``) → a ``DTensor``
    with q's placements, through ``to_local``/``from_local``, which carry
    gradients in both directions without a copy; or plain tensors holding
    this rank's rows and heads → a plain tensor. Under autograd the result
    is the unsharded call's on each rank's shard. A mesh with a ``pp`` or
    ``ep`` axis above 1 raises ``NotImplementedError`` with its ROADMAP
    queue A title."""
    from torch.distributed.tensor import DTensor

    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    for axis in ("pp", "ep"):
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"flash_attention_sharded over {axis}={sizes[axis]} is not ported "
                "yet (ROADMAP queue A: Pipeline and expert parallelism)")
    if not isinstance(q, DTensor):
        return flash_attention(q, k, v, causal)
    out = flash_attention(q.to_local(), k.to_local(), v.to_local(), causal)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)

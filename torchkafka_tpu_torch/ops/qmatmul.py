"""The weight-only int8 matmul y = x @ (q · scale): port of
``torchkafka_tpu/ops/qmatmul.py``.

``quantized_matmul`` keeps the JAX wrapper's operand checks and its shape
rule, which decides the numerics:

- Shapes the JAX wrapper tiles (K and N divisible by a 128-multiple
  block, the row count by its block) compute ``(x · q in f32) × scale``,
  the scale landing once on the f32 accumulator: a CUDA tensor launches
  a hand-written kernel of ``csrc/qmatmul.cu`` (which replaces the Pallas
  ``_qmm_kernel``), a CPU tensor runs ``quantized_matmul_plain``. Which
  kernel is a fixed rule, ``_route``: bf16 x on the tensor cores
  (``qmm_tc_kernel``, tiles and K splits from ``_qmm_plan``), f32 x and
  unaligned bf16 operands on the CUDA cores. ``quantized_matmul.launches``
  counts every launch, ``.tc_launches`` the tensor-core ones. No path
  falls back from one kernel to another, or from a kernel to the plain
  version.
- Other shapes take the JAX wrapper's own dequant formula
  (``_dequant_matmul``: q·scale in f32, one cast to x's dtype, then the
  matmul), which the JAX package computes in XLA outside any kernel. The
  launch counter shows which branch ran.

The serving path does not call it, as in the JAX package: the model's
weights dequantize through ``models.quant.load_weight`` (the JAX default,
XLA's dequant matmul there), and routing the tick through this kernel
would round differently.
"""

from __future__ import annotations

import ctypes
import math

import torch

from torchkafka_tpu_torch.ops import _native
from torchkafka_tpu_torch.ops.kvattn import _counter

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132  # H100 SXM streaming multiprocessors
_TC_BN, _TC_BK = 128, 64  # the tensor-core kernel's columns a block, k rows a stage
_MAX_SPLIT = 16
# Forces the number of K splits of the tensor-core kernel (clipped to the
# k tiles) in place of ``_qmm_plan``'s; None in every path (the on-card
# smoke check sets it to time forced splits beside the plan).
_forced_split: int | None = None


def _auto_block_mm(d: int) -> int:
    """The JAX wrapper's block pick: the largest of (1024, 512, 256, 128)
    dividing ``d``, else 0."""
    for b in (1024, 512, 256, 128):
        if d % b == 0:
            return b
    return 0


def tiles(m: int, k: int, n: int, *, block_m: int | None = None,
          block_k: int | None = None, block_n: int | None = None) -> bool:
    """The JAX wrapper's shape rule: True where it runs its kernel (the
    port then runs its own, or the plain version on the CPU), False where
    it takes the dequant formula. The block sizes only decide this; they
    do not shape the CUDA grid."""
    bk = _auto_block_mm(k) if block_k is None else block_k
    bn = _auto_block_mm(n) if block_n is None else block_n
    if block_m is not None:
        bm = block_m
    elif m % 8 == 0 and m <= 512:
        bm = m  # decode shapes: a handful of rows, one m-block
    else:
        bm = _auto_block_mm(m)
    return bool(bk and bn and bm and k % bk == 0 and n % bn == 0 and m % bm == 0)


def _route(dtype: torch.dtype, k: int, n: int, aligned: bool = True) -> str:
    """Which kernel a CUDA launch takes, by rule: "tc" (``qmm_tc_kernel``,
    bf16 tensor cores, f32 sums) for bf16 x with K and N multiples of 16
    and x and q at 16-byte-aligned addresses (``aligned``: its 16-byte
    copies); "simt" (the CUDA-core kernels, f32 FMAs) for f32 x (TF32
    would round x, another function) and for any bf16 operand the
    tensor-core kernel does not take."""
    tc = dtype == torch.bfloat16 and k % 16 == 0 and n % 16 == 0 and aligned
    return "tc" if tc else "simt"


def _qmm_plan(m: int, k: int, n: int, *,
              n_split: int | None = None) -> tuple[int, int, int, int]:
    """(BM, BN, BK, n_split) of the tensor-core kernel for x [m, k] @ q
    [k, n]. Decode rows (m <= 64, bound by the weight's bytes): BM is the
    least of 16/32/64 that holds m; prefill rows (bound by operations):
    BM = 128. BN = 128 columns a block, BK = 64 k rows a stage. K is split
    (whole BK tiles, at most 16 splits) only while the output tiles alone
    are fewer blocks than the card's 132 SMs, and a split keeps at least
    64 · BM k rows, so its f32 partial (4 · BM bytes a column) stays a
    sixteenth of the weight bytes it read: more splits cost their partials
    and merge more than they add in parallel reads (``chip_smoke.py``'s
    qmatmul phase times each 8b decode shape at 1, 2, 4, 8 and 16 splits
    beside the plan). ``n_split`` forces the count (clipped to the k
    tiles). The splits are ``_split_rows(k, BK, n_split)`` k rows each,
    the last one shorter."""
    bm = 128 if m > 64 else 16 if m <= 16 else 32 if m <= 32 else 64
    n_tiles = -(-m // bm) * -(-n // _TC_BN)
    k_tiles = -(-k // _TC_BK)
    if n_split is None:
        n_split = min(_MAX_SPLIT, -(-_SMS // n_tiles), k_tiles * _TC_BK // (64 * bm))
    n_split = max(1, min(n_split, k_tiles))
    per = -(-k_tiles // n_split)
    return bm, _TC_BN, _TC_BK, -(-k_tiles // per)


def _split_rows(k: int, bk: int, n_split: int) -> int:
    """k rows of each split but the last: whole BK tiles, (n_split - 1)
    splits of them fall short of K and n_split cover it."""
    return -(-(-(-k // bk)) // n_split) * bk


def quantized_matmul_plain(x2: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x2 [M, K] @ q [K, N] with f32
    sums, the f32 scale [1, N] on the sum, one cast to x2's dtype.

    For bf16 x2 every product is exact in f32, so the contract's f32 sum
    has one faithful value, the exact sum rounded once: it is summed in
    f64 (within 2^-53 of exact) and then rounded. A sequential f32 GEMM
    strays further from it than the kernels do: at K = 14,336 it puts some
    outputs more than a bf16 ulp off the exact sum (``chip_smoke.py``
    counts them). For f32 x2 the products themselves round in f32: an f32
    GEMM."""
    if x2.dtype == torch.bfloat16:
        acc = (x2.double() @ q.double()).float()
    else:
        acc = x2.float() @ q.float()
    return (acc * scale.float()).to(x2.dtype)


def _dequant_matmul(x2, q, scale, dtype):
    # q·scale in f32 then ONE cast (a bf16 scale would round to 8 mantissa
    # bits before the multiply: the load_weight rule, models/quant.py).
    return (x2 @ (q.float() * scale.float()).to(dtype)).to(dtype)


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                     block_m: int | None = None, block_k: int | None = None,
                     block_n: int | None = None) -> torch.Tensor:
    """x [.., K] (bf16/f32) @ int8 q [K, N] with per-column scale → [.., N]
    in x's dtype.

    ``scale`` broadcasts as [1, N] (or [N]): one scale per output channel,
    the layout ``models.quant.quantize`` produces for 2-D weights
    (contract axis 0). Shapes that do not tile (``tiles``) take the dequant
    formula (module docstring). ``block_m``/``block_k``/``block_n`` are the
    JAX wrapper's VMEM tile sizes: they feed that shape rule only and have
    no other effect here."""
    if scale.dim() == 1:
        scale = scale[None, :]
    *lead, k = x.shape
    if q.dim() != 2 or q.shape[0] != k:
        raise ValueError(
            f"q must be [K={k}, N], got {tuple(q.shape)} — quantize() with "
            "contract_axes=(0,) for 2-D weights"
        )
    n = q.shape[1]
    if tuple(scale.shape) != (1, n):
        raise ValueError(
            f"scale must broadcast as [1, N={n}] (one per output channel), "
            f"got {tuple(scale.shape)}"
        )
    m = math.prod(lead) if lead else 1
    x2 = x.reshape(m, k)
    if not tiles(m, k, n, block_m=block_m, block_k=block_k, block_n=block_n):
        return _dequant_matmul(x2, q, scale, x.dtype).reshape(*lead, n)
    scale = scale.float()
    if x.device.type == "cpu":
        return quantized_matmul_plain(x2, q, scale).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the int8 matmul kernel takes float32 or bfloat16 x, got {x.dtype}")
    if q.dtype != torch.int8:
        raise ValueError(f"q must be int8, got {q.dtype}")
    if len({t.device for t in (x2, q, scale)}) != 1:
        raise ValueError("all operands must be on one device")
    x2, q, scale = x2.contiguous(), q.contiguous(), scale.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    route = _route(x.dtype, k, n, x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    _native.check(_launch(route, x2, q, scale, out), f"qmatmul ({route})")
    quantized_matmul.launches += 1
    quantized_matmul.tc_launches += route == "tc"
    return out.reshape(*lead, n)


def _launch(route: str, x2, q, scale, out) -> int:
    """One launch of the ``route`` kernel on contiguous CUDA operands (the
    tensor-core one with ``_qmm_plan``'s tiles and splits) on the current
    stream; returns the C launcher's cudaError_t and counts nothing."""
    (m, k), n = x2.shape, q.shape[1]
    lib = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        if route != "tc":
            vec_ok = int(n % 4 == 0 and q.data_ptr() % 4 == 0)
            return lib.tk_qmatmul(x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                  out.data_ptr(), _DTYPES[x2.dtype], m, k, n, vec_ok, stream)
        bm, bn, bk, n_split = _qmm_plan(m, k, n, n_split=_forced_split)
        ws_ptr = cnt_ptr = 0
        if n_split > 1:
            n_tiles = -(-m // bm) * -(-n // bn)
            ws = torch.empty(n_tiles * n_split * bm * bn, dtype=torch.float32,
                             device=x2.device)
            ws_ptr = ws.data_ptr()
            cnt_ptr = _counter(x2.device, stream, n_tiles).data_ptr()
        return lib.tk_qmatmul_tc(x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), ws_ptr, cnt_ptr, m, k, n, bm,
                                 _split_rows(k, bk, n_split), n_split, stream)


quantized_matmul.launches = 0
quantized_matmul.tc_launches = 0


def tc_attrs(bm: int) -> dict:
    """Registers, local (spill) bytes and shared bytes of the tensor-core
    kernel for ``bm`` rows a block (16, 32, 64 or 128), as compiled."""
    out = (ctypes.c_int * 4)()
    _native.check(_lib().tk_qmatmul_tc_attrs(bm, out), "qmatmul tc attrs")
    return {"registers": out[0], "local_bytes": out[1], "static_smem": out[2],
            "dynamic_smem": out[3]}


def i8_convert_table(device="cuda") -> torch.Tensor:
    """The tensor-core kernel's int8 → bf16 conversion of all 256 bytes:
    [256] bf16, entry b the conversion of byte b read as int8."""
    out = torch.empty(256, dtype=torch.bfloat16, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _native.check(_lib().tk_qmatmul_i8_table(out.data_ptr(), stream), "qmatmul i8 table")
    return out


def _lib():
    lib = _native.load("qmatmul")
    if lib.tk_qmatmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, q, scale, out; dtype, m, k, n, vec_ok; stream.
        lib.tk_qmatmul.argtypes = [p] * 4 + [i] * 5 + [p]
        # x, q, scale, out, ws, counter; m, k, n, bm, ks, n_split; stream.
        lib.tk_qmatmul_tc.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.tk_qmatmul_tc_attrs.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        lib.tk_qmatmul_i8_table.argtypes = [p, p]
        for fn in (lib.tk_qmatmul, lib.tk_qmatmul_tc, lib.tk_qmatmul_tc_attrs,
                   lib.tk_qmatmul_i8_table):
            fn.restype = ctypes.c_int
    return lib

"""The weight-only int8 matmul y = x @ (q · scale): port of
``torchkafka_tpu/ops/qmatmul.py``.

``quantized_matmul`` keeps the JAX wrapper's operand checks and its shape
rule, which decides the numerics:

- Shapes the JAX wrapper tiles (K and N divisible by a 128-multiple
  block, the row count by its block) compute ``(x · q in f32) × scale``,
  the scale landing once on the f32 accumulator: a CUDA tensor launches
  the hand-written kernel ``csrc/qmatmul.cu`` (which replaces the Pallas
  ``_qmm_kernel``; ``quantized_matmul.launches`` counts each launch), a
  CPU tensor runs ``quantized_matmul_plain``.
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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def quantized_matmul_plain(x2: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x2 [M, K] @ q [K, N] in f32
    (exact products), the f32 scale [1, N] on the accumulator, one cast
    to x2's dtype."""
    return ((x2.float() @ q.float()) * scale.float()).to(x2.dtype)


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
    vec_ok = int(n % 4 == 0 and q.data_ptr() % 4 == 0)
    fn = _lib().tk_qmatmul
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                _DTYPES[x.dtype], m, k, n, vec_ok, stream)
    _native.check(rc, "qmatmul")
    quantized_matmul.launches += 1
    return out.reshape(*lead, n)


quantized_matmul.launches = 0


def _lib():
    lib = _native.load("qmatmul")
    fn = lib.tk_qmatmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, q, scale, out; dtype, m, k, n, vec_ok; stream.
        fn.argtypes = [p] * 4 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
    return lib

"""The tensor-core int8 matmul's planner (``ops/qmatmul.py _qmm_plan``,
``_split_rows``) and a plain-torch emulation of the kernel's arithmetic
(int8 -> bf16 by two masks and a subtraction, f32 partials per K split
summed in split order, the scale once) against the JAX package's Pallas kernel in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models.quant import quantize as jax_quantize
from torchkafka_tpu.ops.qmatmul import quantized_matmul as jax_qmm
from torchkafka_tpu_torch.ops.qmatmul import _qmm_plan, _split_rows

SHAPES = {  # (K, N): the 8b weights, then those of tests/test_qmatmul.py
    "w_gate": (4096, 14336), "w_down": (14336, 4096), "lm_head": (4096, 128256),
    "k512_n256": (512, 256), "k1024_n128": (1024, 128), "k300_n200": (300, 200),
}
ROWS = (8, 16, 24, 64, 200, 2048)
BF16_ULP = 2.0 ** -7  # one bf16 ulp of the output, as tests/test_torch_qmatmul.py


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_k_with_whole_tiles(shape, m):
    k, n = SHAPES[shape]
    bm, bn, bk, n_split = _qmm_plan(m, k, n)
    ks = _split_rows(k, bk, n_split)
    assert 1 <= n_split <= 16
    assert ks % bk == 0
    assert (n_split - 1) * ks < k <= n_split * ks  # no empty split, K covered
    assert bn == 128 and bk == 64
    if m <= 64:  # decode rows: the least of 16/32/64 that holds m
        assert bm == min(b for b in (16, 32, 64) if b >= m)
    else:
        assert bm == 128


@pytest.mark.parametrize(
    "shape,m,splits",
    [("w_down", 16, True), ("w_gate", 16, True), ("lm_head", 16, False),
     ("w_gate", 2048, False), ("w_down", 2048, False)],
)
def test_plan_splits_only_short_grids(shape, m, splits):
    """At 16 rows w_down (32 output tiles) and w_gate (112) are fewer
    blocks than the card's 132 SMs: K splits. lm_head's 1,002 tiles and
    the 2048-row tiles fill the card unsplit."""
    k, n = SHAPES[shape]
    assert (_qmm_plan(m, k, n)[3] > 1) == splits


@pytest.mark.parametrize("forced", [1, 2, 3, 16, 100])
def test_forced_split_is_clipped_to_the_k_tiles(forced):
    k, n = SHAPES["k1024_n128"]  # 16 k tiles
    _, _, bk, n_split = _qmm_plan(16, k, n, n_split=forced)
    ks = _split_rows(k, bk, n_split)
    assert n_split == min(forced, 16)
    assert (n_split - 1) * ks < k <= n_split * ks


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _i8_to_bf16_bits(b: np.ndarray) -> np.ndarray:
    """The kernel's conversion (``i8x4_to_bf16``) of bytes b = x & 0xFF:
    the bf16 values 0x4300 | (b & 0x7F) = 128 + (b & 127) and
    0x4300 | (b & 0x80) = 128 or 256, subtracted (one bf16x2 fma there;
    exact, so f32 here gives the same value)."""
    b = b.astype(np.uint16)
    a = _bf16_bits_to_f32(0x4300 | (b & 0x7F))
    c = _bf16_bits_to_f32(0x4300 | (b & 0x80))
    d = (a - c).astype(np.float32)
    assert np.all((d.view(np.uint32) & 0xFFFF) == 0)  # representable in bf16
    return (d.view(np.uint32) >> 16).astype(np.uint16)


def test_int8_to_bf16_is_exact_for_all_256_values():
    b = np.arange(256, dtype=np.uint32)
    got = torch.from_numpy(_i8_to_bf16_bits(b).view(np.int16)).view(torch.bfloat16)
    want = torch.from_numpy(b.astype(np.uint8).view(np.int8).copy())
    assert torch.equal(got.float(), want.float())
    assert torch.equal(want.to(torch.bfloat16).view(torch.int16), got.view(torch.int16))


def _emulate(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
             n_split: int) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain torch: bf16 x times q
    in bf16 (the kernel's conversion), f32 partials over ``_split_rows``
    k rows each, summed in split order, the f32 scale once, one rounding."""
    k, n = q.shape
    bm, _, bk, n_split = _qmm_plan(x.shape[0], k, n, n_split=n_split)
    ks = _split_rows(k, bk, n_split)
    qb = torch.from_numpy(_i8_to_bf16_bits(q.numpy().view(np.uint8)).view(np.int16))
    qb = qb.view(torch.bfloat16).float()
    acc = None
    for s in range(n_split):
        part = x[:, s * ks:(s + 1) * ks].float() @ qb[s * ks:(s + 1) * ks]
        acc = part if acc is None else acc + part
    return (acc * scale).to(x.dtype)


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_split_k_emulation_matches_pallas(n_split):
    rng = np.random.default_rng(n_split)
    k, n, m = 1024, 256, 16
    qt = jax_quantize(jnp.asarray(rng.normal(size=(k, n)), jnp.float32), (0,))
    q, s = np.array(qt.q), np.array(qt.scale)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = np.asarray(jax_qmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s),
                             interpret=True), np.float32)
    assert _qmm_plan(m, k, n, n_split=n_split)[3] == n_split
    got = _emulate(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
                   torch.from_numpy(s), n_split).float().numpy()
    np.testing.assert_array_less(np.abs(got - ref), BF16_ULP * np.abs(ref) + 1e-6)

"""The port's int8 dequant matmul (its plain PyTorch version on the CPU,
which the CUDA kernel is held against on the card) against the JAX
package's Pallas kernel in interpret mode: the cases of
``tests/test_qmatmul.py``, the same seeded inputs through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models.quant import quantize as jax_quantize
from torchkafka_tpu.ops.qmatmul import quantized_matmul as jax_qmm
from torchkafka_tpu_torch.ops import quantized_matmul
from torchkafka_tpu_torch.ops.qmatmul import tiles

# f32: only the f32 summation order differs. bf16: one bf16 ulp (2^-8
# relative at round-to-nearest) of the output.
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = 2.0 ** -7


def _weights(rng, k, n):
    w = jnp.asarray(rng.normal(size=(k, n)), jnp.float32)
    qt = jax_quantize(w, (0,))
    return qt, np.array(qt.q), np.array(qt.scale)


def _both(x_np, q_np, s_np, dtype=np.float32, **kw):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ref = jax_qmm(jnp.asarray(x_np, jdt), jnp.asarray(q_np), jnp.asarray(s_np),
                  interpret=True, **kw)
    got = quantized_matmul(torch.from_numpy(x_np).to(tdt), torch.from_numpy(q_np),
                           torch.from_numpy(s_np), **kw)
    return np.asarray(ref, np.float32), got


@pytest.mark.parametrize("case", [
    "f32_16x512", "leading_dims_2x8x512", "1d_scale", "multi_k_blocks",
    "non_tiling_fallback",
])
def test_matches_pallas_f32(case):
    rng = np.random.default_rng(0)
    k, n, lead, kw = 512, 256, (16,), {}
    if case == "leading_dims_2x8x512":
        lead = (2, 8)
    elif case == "multi_k_blocks":
        k, n, lead, kw = 1024, 128, (8,), {"block_k": 256}
    elif case == "non_tiling_fallback":
        k, n, lead = 300, 200, (5,)
    _, q, s = _weights(rng, k, n)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    if case == "1d_scale":
        s = s[0]
    ref, got = _both(x, q, s, **kw)
    assert got.shape == (*lead, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **F32)
    assert tiles(int(np.prod(lead)), k, n, **kw) == (case != "non_tiling_fallback")


@pytest.mark.parametrize("rows", [8, 128])
def test_matches_pallas_bf16_within_one_ulp(rows):
    rng = np.random.default_rng(1)
    _, q, s = _weights(rng, 512, 256)
    x = rng.normal(size=(rows, 512)).astype(np.float32)
    ref, got = _both(x, q, s, dtype="bf16")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_less(np.abs(got - ref), BF16_ULP * np.abs(ref) + 1e-6)


def test_bf16_scale_dequantizes_in_f32_on_the_fallback():
    """Non-tiling shape with a bf16 scale: still q·scale in f32, one cast."""
    rng = np.random.default_rng(2)
    _, q, s = _weights(rng, 300, 200)
    x = rng.normal(size=(5, 300)).astype(np.float32)
    s_bf16 = jnp.asarray(s, jnp.bfloat16)
    ref = jax_qmm(jnp.asarray(x), jnp.asarray(q), s_bf16, interpret=True)
    got = quantized_matmul(torch.from_numpy(x), torch.from_numpy(q),
                           torch.from_numpy(s).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_bf16_scale_casts_to_f32_on_the_tiled_path():
    rng = np.random.default_rng(3)
    _, q, s = _weights(rng, 512, 256)
    x = rng.normal(size=(16, 512)).astype(np.float32)
    s_bf16 = jnp.asarray(s, jnp.bfloat16)
    ref = jax_qmm(jnp.asarray(x), jnp.asarray(q), s_bf16, interpret=True)
    got = quantized_matmul(torch.from_numpy(x), torch.from_numpy(q),
                           torch.from_numpy(np.asarray(s_bf16, np.float32)).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_mismatched_q_raises():
    rng = np.random.default_rng(4)
    _, q, s = _weights(rng, 512, 256)
    x = torch.zeros((8, 256))  # K=256 != 512
    with pytest.raises(ValueError, match=r"q must be \[K"):
        quantized_matmul(x, torch.from_numpy(q), torch.from_numpy(s))


def test_mismatched_scale_raises():
    rng = np.random.default_rng(5)
    _, q, s = _weights(rng, 512, 256)
    x = torch.zeros((8, 512))
    with pytest.raises(ValueError, match="scale must broadcast"):
        quantized_matmul(x, torch.from_numpy(q), torch.from_numpy(s[:, :128]))


def test_cpu_calls_leave_the_launch_count_alone():
    rng = np.random.default_rng(6)
    _, q, s = _weights(rng, 512, 256)
    before = quantized_matmul.launches
    quantized_matmul(torch.zeros((16, 512)), torch.from_numpy(q), torch.from_numpy(s))
    quantized_matmul(torch.zeros((5, 512)), torch.from_numpy(q), torch.from_numpy(s))
    assert quantized_matmul.launches == before


@pytest.mark.parametrize("m,k,n,want", [
    (16, 4096, 14336, True),     # 8b decode rows, w_gate
    (16, 14336, 4096, True),     # w_down
    (16, 4096, 128256, True),    # lm_head (N = 501 · 256)
    (2048, 4096, 14336, True),   # 16 × 128 prefill rows
    (600, 512, 256, False),      # > 512 rows and no 128-multiple block
    (16, 4096, 1000, False),     # N has no 128-multiple block
])
def test_shape_rule(m, k, n, want):
    assert tiles(m, k, n) is want

"""The port's fused blocked cross-entropy against the JAX package's at f32:
value, dx and dW, with S not a multiple of the block, auto and explicit
blocks, a partial mask, and the dense oracle on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.ops import xent as jx
from torchkafka_tpu_torch.ops import xent as px

B, S, D, V = 4, 48, 32, 97  # V prime and S not a block multiple on purpose
ATOL = 1e-6  # f32 sums over D and V in another order


@pytest.fixture
def inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    t = rng.integers(0, V, size=(B, S)).astype(np.int32)
    m = rng.integers(0, 2, size=(B, S)).astype(np.float32)
    return x, w, t, m


def _jax(fn, inputs, *args):
    x, w, t, m = (jnp.asarray(a) for a in inputs)
    return jax.value_and_grad(lambda x, w: fn(x, w, t, m, *args), argnums=(0, 1))(x, w)


def _port(fn, inputs, *args):
    x, w, t, m = (torch.from_numpy(a) for a in inputs)
    x.requires_grad_(True)
    w.requires_grad_(True)
    val = fn(x, w, t, m, *args)
    val.backward()
    return val.item(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("block", [16, 32, 48, None])
def test_fused_matches_jax(inputs, block):
    jval, (jdx, jdw) = _jax(jx.fused_softmax_xent, inputs, block, jnp.float32)
    val, dx, dw = _port(px.fused_softmax_xent, inputs, block, torch.float32)
    assert abs(val - float(jval)) < ATOL
    np.testing.assert_allclose(dx, np.asarray(jdx), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw, np.asarray(jdw), atol=ATOL, rtol=1e-5)


def test_dense_matches_jax(inputs):
    jval, (jdx, jdw) = _jax(jx.dense_softmax_xent, inputs, jnp.float32)
    val, dx, dw = _port(px.dense_softmax_xent, inputs, torch.float32)
    assert abs(val - float(jval)) < ATOL
    np.testing.assert_allclose(dx, np.asarray(jdx), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw, np.asarray(jdw), atol=ATOL, rtol=1e-5)


def test_bf16_compute_matches_jax(inputs):
    """bf16 operands, f32 products and sums: the same rounding points."""
    jval, (jdx, jdw) = _jax(jx.fused_softmax_xent, inputs, 16, jnp.bfloat16)
    val, dx, dw = _port(px.fused_softmax_xent, inputs, 16, torch.bfloat16)
    assert abs(val - float(jval)) < 1e-5
    np.testing.assert_allclose(dx, np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(dw, np.asarray(jdw), atol=1e-5)


def test_upstream_gradient_scales(inputs):
    x, w, t, m = (torch.from_numpy(a) for a in inputs)
    grads = []
    for scale in (1.0, 3.0):
        xx = x.clone().requires_grad_(True)
        (scale * px.fused_softmax_xent(xx, w, t, m, 16, torch.float32)).backward()
        grads.append(xx.grad)
    torch.testing.assert_close(grads[1], 3 * grads[0], rtol=1e-5, atol=0)


def test_all_masked_is_finite(inputs):
    x, w, t, _ = (torch.from_numpy(a) for a in inputs)
    x.requires_grad_(True)
    val = px.fused_softmax_xent(x, w, t, torch.zeros(B, S), 16, torch.float32)
    val.backward()
    assert val.item() == 0.0 and torch.isfinite(x.grad).all()
    assert x.grad.abs().max().item() == 0.0


def test_bad_block_raises_and_auto_block_matches(inputs):
    x, w, t, m = (torch.from_numpy(a) for a in inputs)
    for bad in (0, -16):
        with pytest.raises(ValueError, match="block_size"):
            px.fused_softmax_xent(x, w, t, m, bad, torch.float32)
    for args in ((8, 512, 32_000), (1, 16, 32), (64, 16_384, 128_000), (4, 48, 97)):
        assert px.auto_block_size(*args) == jx.auto_block_size(*args)

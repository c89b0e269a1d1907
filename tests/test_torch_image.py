"""The port's image path against the JAX package, on the CPU.

- ``tests/test_image.py`` re-rooted onto the port's copy of
  ``transform/image.py`` and its native PNG decoder (every case).
- ResNet-50 ``forward`` at f32 from the JAX package's parameters (HWIO →
  OIHW at load), width 8, on an even (32) and an odd (35) image size: the
  odd size makes every stride-2 "SAME" padding asymmetric. Logits within
  1e-5 of their largest magnitude.
- ``preprocess`` against ``jax.image.resize(..., "bilinear")``, upsampling
  (64 → 224, scenario 4's resize) and downsampling (antialiased), within
  1e-5 relative to the largest normalized value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu_torch as ptk
from _torch_fleet_common import load_rerooted
from torchkafka_tpu.models import resnet as jr
from torchkafka_tpu_torch.models import resnet as pr


@pytest.fixture
def broker():
    """The port's broker for the re-rooted cases (conftest's is JAX's)."""
    return ptk.InMemoryBroker()


_ref = load_rerooted("test_image")
TestPngRoundtrip = _ref.TestPngRoundtrip
TestPngDrops = _ref.TestPngDrops
TestPngProcessor = _ref.TestPngProcessor

TOL = 1e-5


@pytest.fixture(scope="module")
def resnets():
    """One JAX ResNet-50 (width 8, 10 classes) and its port copy."""
    jcfg = jr.ResNetConfig(num_classes=10, width=8, dtype=jnp.float32)
    pcfg = pr.ResNetConfig(num_classes=10, width=8, dtype=torch.float32)
    jparams = jax.jit(jr.init_params, static_argnums=1)(jax.random.key(0), jcfg)
    params = pr.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, pcfg, params


def test_params_from_numpy_layout(resnets):
    jcfg, jparams, pcfg, params = resnets
    assert params["stem"]["conv"].shape == (8, 3, 7, 7)  # HWIO [7, 7, 3, 8] → OIHW
    assert params["stage1"][0]["conv2"].shape == (128, 128, 3, 3)
    assert "proj" in params["stage2"][0] and "proj" not in params["stage2"][1]
    assert pr.count_params(params) == jr.count_params(jparams)
    shape = pr.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), shape) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), params)


@pytest.mark.parametrize("size", [32, 35])
def test_forward_matches_jax(resnets, size):
    jcfg, jparams, pcfg, params = resnets
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jr.forward, static_argnums=2)(jparams, jnp.asarray(x), jcfg))
    got = pr.forward(params, torch.from_numpy(x), pcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * np.abs(want).max(), rtol=0)


def test_same_padding_is_asymmetric():
    """XLA's "SAME": the extra row/column of padding goes high."""
    assert pr._same_pads(35, 3, 2) == (1, 1)
    assert pr._same_pads(32, 3, 2) == (0, 1)
    assert pr._same_pads(32, 7, 2) == (2, 3)
    assert pr._same_pads(35, 1, 2) == (0, 0)
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    assert pr._pad_same(x, 3, 2).shape == (1, 1, 5, 5)
    assert pr._pad_same(x, 3, 2)[0, 0, 0, 0] == 0.0  # low side unpadded: x[0, 0]


@pytest.mark.parametrize("h,out", [(64, 224), (64, 24), (37, 16)],
                         ids=["up_64_224", "down_64_24", "down_37_16"])
def test_preprocess_matches_jax_resize(h, out):
    raw = np.random.default_rng(h + out).integers(0, 256, (2, h, h, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(jr.preprocess, static_argnums=1)(jnp.asarray(raw), out))
    got = pr.preprocess(torch.from_numpy(raw), out)
    assert got.shape == (2, out, out, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * np.abs(want).max(), rtol=0)


def test_bf16_forward_tracks_f32(resnets):
    """bf16 compute rounds each convolution's output before the f32 batch
    norm (the JAX model rounds after it): the logits stay close."""
    _, _, pcfg, params = resnets
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32))
    f32 = pr.forward(params, x, pcfg)
    bf16 = pr.forward(params, x, pr.ResNetConfig(num_classes=10, width=8))
    rel = float((bf16 - f32).abs().max() / f32.abs().max())
    assert torch.isfinite(bf16).all() and rel < 0.1, rel

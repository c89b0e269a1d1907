"""Sampling in the port against the JAX package at f32: ``filter_logits``,
``sample_logits`` (one key over [B, V]), the server's per-slot
``_pick_slots`` (keys [B, 2] folded with each row's token index), and the
lockstep ``generate`` token for token from the same parameters and keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models import generate as jg
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.serve import _pick_slots as jax_pick_slots
from torchkafka_tpu_torch.models import generate as pg
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import _pick_slots
from torchkafka_tpu_torch.utils import prng

VOCAB = 64
KNOBS = [
    (None, None), (1, None), (5, None), (63, None),
    (None, 0.1), (None, 0.5), (None, 0.9),
    (8, 0.7), (3, 0.99), (64, 1.0),
]


def _logits(seed, shape=(16, VOCAB), scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("top_k,top_p", KNOBS)
def test_filter_logits_matches_jax(top_k, top_p):
    logits = _logits(0)
    want = np.asarray(jg.filter_logits(jnp.asarray(logits), temperature=0.7,
                                       top_k=top_k, top_p=top_p))
    got = pg.filter_logits(torch.from_numpy(logits), temperature=0.7,
                           top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


@pytest.mark.parametrize("top_k,top_p", KNOBS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_logits_matches_jax(seed, top_k, top_p):
    """One key over the whole [B, V] array."""
    logits = _logits(seed + 10)
    want = np.asarray(jg.sample_logits(jnp.asarray(logits), jax.random.key(seed),
                                       temperature=0.9, top_k=top_k, top_p=top_p))
    got = pg.sample_logits(torch.from_numpy(logits), prng.key(seed),
                           temperature=0.9, top_k=top_k, top_p=top_p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, None, None), (1.0, None, None), (0.9, 16, None), (0.9, 16, 0.95),
    (2.0, None, 0.5), (5.0, 1, None),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_pick_slots_matches_jax(seed, temperature, top_k, top_p):
    """Row b draws with fold_in(record_key_b, idx_b), whatever the other
    rows hold."""
    rng = np.random.default_rng(seed)
    logits = _logits(seed + 20, shape=(8, VOCAB))
    key_data = rng.integers(0, 2**32, (8, 2), dtype=np.uint32)
    idx = rng.integers(0, 40, (8,), dtype=np.int32)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    want = np.asarray(jax_pick_slots(jnp.asarray(logits), jnp.asarray(key_data),
                                     jnp.asarray(idx), **kw))
    got = _pick_slots(torch.from_numpy(logits),
                      torch.from_numpy(key_data.astype(np.int64)),
                      torch.from_numpy(idx), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pick_slots_rows_are_independent():
    """A row's draw does not depend on its slot: permuting the rows
    permutes the tokens."""
    logits = torch.from_numpy(_logits(5, shape=(6, VOCAB)))
    keys = torch.from_numpy(
        np.random.default_rng(5).integers(0, 2**32, (6, 2)).astype(np.int64)
    )
    idx = torch.arange(6, dtype=torch.int32)
    kw = dict(temperature=1.0, top_k=None, top_p=None)
    base = _pick_slots(logits, keys, idx, **kw)
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    np.testing.assert_array_equal(
        _pick_slots(logits[perm], keys[perm], idx[perm], **kw).numpy(),
        base[perm].numpy(),
    )


SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=16)
B, P, MAX_NEW = 3, 8, 6


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(4), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    prompt = np.random.default_rng(1).integers(0, VOCAB, (B, P), dtype=np.int32)
    return jcfg, jparams, pcfg, params, prompt


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("top_k,top_p", [(None, None), (8, None), (None, 0.9), (8, 0.9)])
def test_generate_matches_jax(model, seed, top_k, top_p):
    jcfg, jparams, pcfg, params, prompt = model
    kw = dict(temperature=1.0, top_k=top_k, top_p=top_p)
    want = np.asarray(jg.generate(jparams, jcfg, jnp.asarray(prompt), MAX_NEW,
                                  rng=jax.random.key(seed), **kw))
    got = pg.generate(params, pcfg, torch.from_numpy(prompt), MAX_NEW,
                      rng=prng.key(seed), **kw)
    assert got.shape == (B, MAX_NEW) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_greedy_and_top_k1(model):
    """Greedy equals JAX's greedy, and top_k=1 at any temperature is greedy."""
    jcfg, jparams, pcfg, params, prompt = model
    want = np.asarray(jg.generate(jparams, jcfg, jnp.asarray(prompt), MAX_NEW))
    greedy = pg.generate(params, pcfg, torch.from_numpy(prompt), MAX_NEW)
    k1 = pg.generate(params, pcfg, torch.from_numpy(prompt), MAX_NEW,
                     temperature=5.0, top_k=1, rng=prng.key(9))
    np.testing.assert_array_equal(greedy.numpy(), want)
    np.testing.assert_array_equal(k1.numpy(), want)


def test_generate_default_rng_is_key_zero(model):
    _, _, pcfg, params, prompt = model
    a = pg.generate(params, pcfg, torch.from_numpy(prompt), MAX_NEW, temperature=1.0)
    b = pg.generate(params, pcfg, torch.from_numpy(prompt), MAX_NEW, temperature=1.0,
                    rng=prng.key(0))
    np.testing.assert_array_equal(a.numpy(), b.numpy())

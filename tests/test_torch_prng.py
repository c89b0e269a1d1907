"""The port's threefry keys and draws (``utils.prng``) against ``jax.random``:
key data, ``fold_in``, ``split``, raw bits and uniforms bit for bit; the
Gumbels within 2 ulp (at the scale of max(|g|, 1): the outer log's error
is absolute where g is near 0); categorical draws equal."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu.source.records import Record as JaxRecord
from torchkafka_tpu_torch.utils import prng

SEEDS = [0, 1, 11, 12345, 2**31 - 1]
DATA = [0, 1, 7, 0x7FFFFFFF, 2**32 - 1]
SHAPES = [(5,), (64,), (3, 7), (4, 33), (2, 3, 5)]


def _jkd(k):
    return np.asarray(jax.random.key_data(k), np.uint32)


def _ulps(a: np.ndarray, b: np.ndarray) -> float:
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1).astype(np.float32)
    return float((np.abs(a.astype(np.float64) - b) / np.spacing(scale)).max())


def test_jax_threefry_is_partitionable():
    """The port copies the partitionable scheme; a JAX whose default
    changes must fail here, not pass the comparisons below by accident."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS + [-1, -7])
def test_key_data(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(), _jkd(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", DATA)
def test_fold_in(seed, data):
    want = _jkd(jax.random.fold_in(jax.random.key(seed), data))
    np.testing.assert_array_equal(prng.fold_in(prng.key(seed), data).numpy(), want)
    assert prng.fold_in_host(prng.key(seed).tolist(), data) == tuple(int(w) for w in want)


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_fold_in_is_vmapped(seed):
    """[B, 2] keys with [B] data: ``vmap(jax.random.fold_in)``, data given
    as int32 (wrapping mod 2**32 like JAX's uint32 cast)."""
    data = np.array([0, 1, 5, 0x7FFFFFFF, -1, -2**31], np.int32)
    jkeys = jax.random.split(jax.random.key(seed), len(data))
    want = _jkd(jax.vmap(jax.random.fold_in)(jkeys, jnp.asarray(data.astype(np.uint32))))
    keys = torch.from_numpy(_jkd(jkeys).astype(np.int64))
    np.testing.assert_array_equal(prng.fold_in(keys, torch.from_numpy(data)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 16])
def test_split(seed, num):
    want = _jkd(jax.random.split(jax.random.key(seed), num))
    np.testing.assert_array_equal(prng.split(prng.key(seed), num).numpy(), want)


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_and_uniform(seed, shape):
    k = jax.random.key(seed)
    bits = prng.random_bits(prng.key(seed), shape)
    assert bits.shape == shape
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jax.random.bits(k, shape)))
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32,
                                         minval=np.finfo(np.float32).tiny))
    got = prng.uniform(prng.key(seed), shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_batched_random_bits_are_per_key():
    """[B, 2] keys draw ``shape`` each, as ``vmap(jax.random.bits)``."""
    jkeys = jax.random.split(jax.random.key(3), 4)
    want = np.asarray(jax.vmap(lambda kk: jax.random.bits(kk, (37,)))(jkeys))
    keys = torch.from_numpy(_jkd(jkeys).astype(np.int64))
    np.testing.assert_array_equal(prng.random_bits(keys, (37,)).numpy(), want)


@pytest.mark.parametrize("seed", [0, 11, 99])
@pytest.mark.parametrize("shape", [(4096,), (3, 4096), (16, 1000)])
def test_gumbel_within_two_ulp(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), shape))
    got = prng.gumbel(prng.key(seed), shape).numpy()
    assert np.isfinite(got).all()
    assert _ulps(got, want) <= 2.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_categorical_one_key_over_rows(seed):
    """One key covers [B, V]: the flat index b*V + v enters the counts."""
    logits = np.random.default_rng(seed).normal(size=(8, 300)).astype(np.float32) * 2
    want = np.asarray(jax.random.categorical(jax.random.key(seed), jnp.asarray(logits)))
    got = prng.categorical(prng.key(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 5])
def test_categorical_256_keyed_draws(seed):
    """256 rows, each with its own key (the server's per-slot draw): every
    sampled index equals JAX's."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(256, 97)) * 3).astype(np.float32)
    logits[rng.random(logits.shape) < 0.3] = -np.inf  # filtered entries
    jkeys = jax.random.split(jax.random.key(seed), 256)
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(logits)))
    keys = torch.from_numpy(_jkd(jkeys).astype(np.int64))
    got = prng.categorical(keys, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


class _Base:
    """Just enough of the JAX server for its ``_record_key_data``."""

    def __init__(self, seed):
        self._rng = jax.random.key(seed)


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("topic,partition,offset", [
    ("prompts", 0, 0), ("prompts", 3, 17), ("t", 1, 0x7FFFFFFF),
    ("a-much-longer-topic-name", 2**31 - 1, 2**33 + 5),
])
def test_record_key_chain_matches_the_jax_server(seed, topic, partition, offset):
    want = JaxServer._record_key_data(
        _Base(seed), JaxRecord(topic, partition, offset, None, b"", 0)
    )
    k = prng.key(seed)
    for d in (zlib.crc32(topic.encode()) & 0x7FFFFFFF, partition & 0x7FFFFFFF,
              offset & 0x7FFFFFFF):
        k = prng.fold_in(k, d)
    np.testing.assert_array_equal(k.numpy(), want)

"""The sub-byte wire codec: the port's ``ops.bitpack.unpack_bits`` against
the JAX package's on rows packed by ``native.pack_bits``, for every width
1..16, and ``fixed_width(wire_bits=15)`` through both packages'
``KafkaStream``s: equal packed batches, equal unpacked tokens, equal
commits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from torchkafka_tpu import native as jnative
from torchkafka_tpu.ops.bitpack import unpack_bits as jax_unpack
from torchkafka_tpu_torch import native as pnative
from torchkafka_tpu_torch.ops.bitpack import unpack_bits


@pytest.mark.parametrize("seq", [7, 32])
@pytest.mark.parametrize("bits", list(range(1, 17)))
def test_unpack_matches_jax(bits, seq):
    rng = np.random.default_rng(bits * 100 + seq)
    rows = rng.integers(0, 1 << bits, (5, seq), dtype=np.int64).astype(np.int32)
    rows[0] = (1 << bits) - 1  # every bit set: the mask's edge
    packed = jnative.pack_bits(rows, bits)
    np.testing.assert_array_equal(pnative.pack_bits(rows, bits), packed)
    ref = np.asarray(jax_unpack(jnp.asarray(packed), bits, seq))
    got = unpack_bits(torch.from_numpy(packed), bits, seq)
    assert got.dtype == torch.int32 and got.shape == (5, seq)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), rows)


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("bits", [0, 17])
def test_bad_bits_error_matches(bits):
    packed = np.zeros((1, 4), np.uint8)
    assert (_error(lambda: unpack_bits(torch.from_numpy(packed), bits, 2))
            == _error(lambda: jax_unpack(jnp.asarray(packed), bits, 2)))


def test_bad_width_error_matches():
    packed = np.zeros((2, 5), np.uint8)  # packed_width(4, 15) is 8
    msg = _error(lambda: unpack_bits(torch.from_numpy(packed), 15, 4))
    assert msg == _error(lambda: jax_unpack(jnp.asarray(packed), 15, 4))
    assert "packed_width(4, 15) = 8" in msg


def test_fixed_width_wire15_stream_matches_jax():
    seq, n, parts = 12, 40, 2
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 1 << 15, (n, seq), dtype=np.int32)
    out = {}
    for name, pkg in (("jax", tk), ("port", ptk)):
        broker = pkg.InMemoryBroker()
        broker.create_topic("w", partitions=parts)
        for i in range(n):
            broker.produce("w", rows[i].tobytes(), partition=i % parts)
        consumer = pkg.MemoryConsumer(broker, "w", group_id="g")
        kw = {"device": "cpu"} if name == "port" else {}
        batches, tokens = [], []
        with pkg.KafkaStream(consumer, pkg.fixed_width(seq, np.int32, wire_bits=15),
                             batch_size=8, idle_timeout_ms=300, owns_consumer=True,
                             **kw) as stream:
            for batch, token in stream:
                data = np.asarray(batch.data)
                batches.append(data)
                if name == "port":
                    tokens.append(unpack_bits(batch.data, 15, seq).numpy())
                else:
                    tokens.append(np.asarray(jax_unpack(batch.data, 15, seq)))
                token.commit()
        committed = [broker.committed("g", pkg.TopicPartition("w", p)) for p in range(parts)]
        out[name] = (batches, tokens, committed)
    jb, jt, jc = out["jax"]
    pb, pt, pc = out["port"]
    assert pc == jc == [n // parts] * parts
    assert len(pb) == len(jb)
    for a, b in zip(pb, jb):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(pt), np.concatenate(jt))
    assert sorted(map(tuple, np.concatenate(pt))) == sorted(map(tuple, rows))

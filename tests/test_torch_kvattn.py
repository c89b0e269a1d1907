"""The port's fill-bounded int8 decode read (its plain PyTorch version, which
the CUDA kernel is held against on the card) against the JAX package's
Pallas kernel in interpret mode, and the int8 KV groups byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models.quant import quant_kv_groups as jax_quant
from torchkafka_tpu.models.quant import quantize as jax_quantize
from torchkafka_tpu.ops.kvattn import int8_decode_attention_dynlen as jax_dynlen
from torchkafka_tpu_torch.models.quant import quant_kv_groups, quantize
from torchkafka_tpu_torch.ops.kvattn import (
    dynlen_block,
    int8_decode_attention_dynlen,
    kernel_applicable,
)

B, M, K, REP, DH = 4, 32, 2, 2, 16


def _pool(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, K * REP, DH)).astype(np.float32)
    k = (rng.normal(size=(B, M, K, DH)) * 2).astype(np.float32)
    v = (rng.normal(size=(B, M, K, DH)) * 2).astype(np.float32)
    kq, ks = (np.asarray(a) for a in jax_quant(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jax_quant(jnp.asarray(v)))
    # K-major: [B, K, M, Dh] payloads, [B, K, M] scales.
    return q, kq.swapaxes(1, 2), ks.swapaxes(1, 2), vq.swapaxes(1, 2), vs.swapaxes(1, 2)


@pytest.mark.parametrize("block", [8, 16, 32])
def test_matches_pallas_kernel_interpret(block):
    q, kq, ks, vq, vs = (np.ascontiguousarray(a) for a in _pool(0))
    pos = np.asarray([0, 7, 15, 31], np.int32)  # empty-ish, block edges, full
    ref = jax_dynlen(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs, pos)),
                     block=block, interpret=True)
    got = int8_decode_attention_dynlen(
        *(torch.from_numpy(a) for a in (q, kq, ks, vq, vs, pos))
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)


def test_reads_only_up_to_the_watermark():
    """Positions past pos[b] never reach the result: poisoning them with
    huge values changes nothing."""
    q, kq, ks, vq, vs = (torch.from_numpy(np.ascontiguousarray(a)) for a in _pool(1))
    pos = torch.tensor([3, 9, 20, 31], dtype=torch.int32)
    base = int8_decode_attention_dynlen(q, kq, ks, vq, vs, pos)
    ks2, vs2 = ks.clone(), vs.clone()
    for b, p in enumerate(pos.tolist()):
        ks2[b, :, p + 1:] = 1e6
        vs2[b, :, p + 1:] = 1e6
    again = int8_decode_attention_dynlen(q, kq, ks2, vq, vs2, pos)
    torch.testing.assert_close(again, base, atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(3, 5, 16), (2, 7, 4, 128)])
def test_quant_kv_groups_byte_equal(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.01, 10)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero group takes the 1e-12 floor
    x.reshape(-1)[5] = 2.5 * np.abs(x).max() / 127  # exercise ties at .5
    jq, js = (np.asarray(a) for a in jax_quant(jnp.asarray(x)))
    pq, ps = quant_kv_groups(torch.from_numpy(x))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), jq)
    np.testing.assert_array_equal(ps.numpy(), js)


def test_quantize_weights_byte_equal():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(2, 24, 3, 8)).astype(np.float32)
    for axes in ((1,), (1, 2)):
        j = jax_quantize(jnp.asarray(w), axes)
        p = quantize(torch.from_numpy(w), axes)
        np.testing.assert_array_equal(p.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(p.scale.numpy(), np.asarray(j.scale))


def test_round_half_to_even():
    """jnp.round and torch.round both round .5 to the even neighbour."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    np.testing.assert_array_equal(torch.round(x).numpy(), np.asarray(jnp.round(jnp.asarray(x.numpy()))))


def test_kernel_shapes_and_blocks():
    assert kernel_applicable(128, 192, 2) and kernel_applicable(64, 7, 8)
    assert not kernel_applicable(96 + 8, 64) and not kernel_applicable(256, 64)
    assert not kernel_applicable(128, 64, 3)
    assert [dynlen_block(m) for m in (2048, 192, 40, 7)] == [512, 64, 8, 0]


def test_wrapper_refuses_bad_operands():
    q, kq, ks, vq, vs = (torch.from_numpy(np.ascontiguousarray(a)) for a in _pool(2))
    pos = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError):
        int8_decode_attention_dynlen(q, kq, ks, vq, vs, pos.long())
    with pytest.raises(ValueError):
        int8_decode_attention_dynlen(q, kq.float(), ks, vq, vs, pos)
    with pytest.raises(ValueError):
        int8_decode_attention_dynlen(q.repeat(1, 2, 1, 1), kq, ks, vq, vs, pos)

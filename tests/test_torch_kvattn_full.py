"""The port's full-pool int8 decode reads (the plain PyTorch versions of the
K-major and M-major kernels, which the CUDA kernel is held against on the
card) against the JAX package's Pallas kernels in interpret mode, at
``tests/test_ops.py``'s sizes: prefix masks, masks with holes and an
all-false row, in f32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models.quant import quant_kv_groups as jax_quant
from torchkafka_tpu.ops.kvattn import int8_decode_attention as jax_mmajor
from torchkafka_tpu.ops.kvattn import int8_decode_attention_kmajor as jax_kmajor
from torchkafka_tpu_torch.ops.kvattn import (
    int8_decode_attention,
    int8_decode_attention_dynlen,
    int8_decode_attention_kmajor,
    int8_decode_attention_kmajor_plain,
    int8_decode_attention_mmajor_plain,
)

B, M, K, REP, DH = 4, 24, 2, 2, 16
# f32: reduction order only (the JAX tests' 2e-5). bf16: p·v_scale and the
# output round to bf16 in both packages, at another point of the sum.
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _pool(seed):
    """M-major int8 pool [B, M, K, Dh] / [B, M, K] from seeded f32 k/v,
    quantized by the JAX package's own groups."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, K * REP, DH)).astype(np.float32)
    k = (rng.normal(size=(B, M, K, DH)) * 2).astype(np.float32)
    v = (rng.normal(size=(B, M, K, DH)) * 2).astype(np.float32)
    kq, ks = (np.array(a) for a in jax_quant(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jax_quant(jnp.asarray(v)))
    return q, kq, ks, vq, vs


def _masks():
    rng = np.random.default_rng(11)
    prefix = np.arange(M)[None, :] <= np.asarray([5, 12, 23, 0])[:, None]
    holes = rng.random((B, M)) < 0.6
    holes[2] = False  # one all-false row: the uniform average over all M
    return {"prefix": prefix, "holes": holes}


def _kmajor(*arrs):
    return [np.ascontiguousarray(np.swapaxes(a, 1, 2)) for a in arrs]


def _as(dtype, q):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(q, jdt), torch.from_numpy(q).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["prefix", "holes"])
def test_mmajor_matches_pallas_interpret(dtype, mask):
    q, kq, ks, vq, vs = _pool(0)
    valid = _masks()[mask]
    jq, tq = _as(dtype, q)
    ref = jax_mmajor(jq, *(jnp.asarray(a) for a in (kq, ks, vq, vs, valid)),
                     interpret=True)
    got = int8_decode_attention(tq, *(torch.from_numpy(a) for a in (kq, ks, vq, vs, valid)))
    assert got.dtype == tq.dtype and got.shape == (B, 1, K * REP, DH)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("slot_block", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["prefix", "holes"])
def test_kmajor_matches_pallas_interpret(slot_block, dtype, mask):
    q, kq, ks, vq, vs = _pool(1)
    kq, ks, vq, vs = _kmajor(kq, ks, vq, vs)
    valid = _masks()[mask]
    jq, tq = _as(dtype, q)
    ref = jax_kmajor(jq, *(jnp.asarray(a) for a in (kq, ks, vq, vs, valid)),
                     slot_block=slot_block, interpret=True)
    got = int8_decode_attention_kmajor(
        tq, *(torch.from_numpy(a) for a in (kq, ks, vq, vs, valid)),
        slot_block=slot_block,
    )
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **TOL[dtype])


def test_all_false_row_is_the_uniform_average():
    """A row with no readable position averages every position's dequantized
    value (softmax over M equal -1e30 scores), in both layouts."""
    q, kq, ks, vq, vs = _pool(2)
    valid = np.zeros((B, M), bool)
    got = int8_decode_attention(*(torch.from_numpy(a) for a in (q, kq, ks, vq, vs, valid)))
    mean_v = (vq.astype(np.float32) * vs[..., None]).mean(axis=1)  # [B, K, Dh]
    want = np.repeat(mean_v[:, :, None, :], REP, axis=2).reshape(B, 1, K * REP, DH)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    kmaj = int8_decode_attention_kmajor(
        *(torch.from_numpy(a) for a in [q, *_kmajor(kq, ks, vq, vs), valid])
    )
    np.testing.assert_allclose(kmaj.numpy(), got.numpy(), atol=1e-6, rtol=1e-6)


def test_kmajor_plain_equals_dynlen_plain_on_prefix_masks():
    """On prefix masks the full-pool K-major read and the fill-bounded read
    agree (f32: they differ only in where the softmax normalises)."""
    q, kq, ks, vq, vs = _pool(3)
    t = [torch.from_numpy(a) for a in [q, *_kmajor(kq, ks, vq, vs)]]
    pos = torch.tensor([0, 7, 15, 23], dtype=torch.int32)
    valid = torch.arange(M)[None, :] <= pos[:, None]
    full = int8_decode_attention_kmajor_plain(*t, valid)
    dyn = int8_decode_attention_dynlen(*t, pos)
    torch.testing.assert_close(full, dyn, atol=1e-6, rtol=1e-6)
    mmaj = int8_decode_attention_mmajor_plain(
        *(torch.from_numpy(a) for a in (q, kq, ks, vq, vs)), valid
    )
    torch.testing.assert_close(mmaj, full, atol=0, rtol=0)


def test_slot_block_must_divide():
    q = torch.zeros((3, 1, 4, DH))
    c = torch.zeros((3, K, 8, DH), dtype=torch.int8)
    s = torch.zeros((3, K, 8))
    valid = torch.ones((3, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="must divide"):
        int8_decode_attention_kmajor(q, c, s, c, s, valid, slot_block=2)
    # A divisor, or None, is accepted.
    assert int8_decode_attention_kmajor(q, c, s, c, s, valid, slot_block=3).shape == q.shape


def test_cpu_calls_leave_the_launch_counts_alone():
    q, kq, ks, vq, vs = _pool(4)
    valid = _masks()["holes"]
    before = (int8_decode_attention.launches, int8_decode_attention_kmajor.launches)
    int8_decode_attention(*(torch.from_numpy(a) for a in (q, kq, ks, vq, vs, valid)))
    int8_decode_attention_kmajor(
        *(torch.from_numpy(a) for a in [q, *_kmajor(kq, ks, vq, vs), valid])
    )
    assert (int8_decode_attention.launches, int8_decode_attention_kmajor.launches) == before


@pytest.mark.parametrize("bad", ["mask_dtype", "mask_shape", "scale_dtype"])
def test_operand_checks(bad):
    q, kq, ks, vq, vs = (torch.from_numpy(a) for a in _pool(5))
    valid = torch.ones((B, M), dtype=torch.bool)
    if bad == "mask_dtype":
        valid = valid.int()
    elif bad == "mask_shape":
        valid = valid[:, :-1]
    else:
        ks = ks.double()
    with pytest.raises(ValueError):
        int8_decode_attention(q, kq, ks, vq, vs, valid)

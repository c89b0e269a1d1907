"""The port's flash-attention forward (its plain PyTorch version, which the
CUDA kernel is held against on the card) against the JAX package's Pallas
kernel in interpret mode and its dense ``mha``, at f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.ops.attention import mha as jax_mha
from torchkafka_tpu.ops.flash import _flash_fwd_bhsd as jax_fwd_bhsd
from torchkafka_tpu.ops.flash import flash_attention as jax_flash
from torchkafka_tpu_torch.ops.attention import mha as port_mha
from torchkafka_tpu_torch.ops.flash import flash_attention, flash_fwd_bhsd

ATOL = 2e-5  # f32 sums in another order than the interpreted kernel


def _qkv(seed, b, s, h, k, d):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, k, k)
    )


def _t(x):
    return torch.from_numpy(np.array(x))


def test_matches_pallas_kernel_interpret():
    q, k, v = _qkv(0, 2, 128, 4, 2, 32)
    ref_o = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 True, None, None, True))
    got_o, got_lse = flash_attention(_t(q), _t(k), _t(v), True, return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), ref_o, atol=ATOL, rtol=ATOL)
    # lse against the kernel's own output, through its [B·H, S, D] wrapper.
    to_bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, 128, 32)  # noqa: E731
    _, ref_lse = jax_fwd_bhsd(
        to_bhsd(q), to_bhsd(k), to_bhsd(v), causal=True, block_q=128,
        block_k=128, interpret=True, n_q_heads=4, n_kv_heads=2,
    )
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(ref_lse), atol=ATOL, rtol=ATOL)


def test_untileable_length_matches_mha_route():
    """S=40 tiles no Pallas block, so the JAX package routes it to ``mha``;
    the port serves any S through the same function."""
    q, k, v = _qkv(1, 2, 40, 4, 2, 16)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = flash_attention(_t(q), _t(k), _t(v), True).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    kk, vv = (np.repeat(x, 2, axis=2) for x in (k, v))
    dense = port_mha(_t(q), _t(kk), _t(vv), causal=True).numpy()
    np.testing.assert_allclose(dense, ref, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("q_offset,k_offset", [(32, 0), (0, 32), (16, 48)])
def test_offsets_and_fully_masked_rows(q_offset, k_offset):
    """Non-zero ring offsets. Rows with an allowed key match ``mha``; rows
    with none give o = 0 and lse ≈ -1e30, as the Pallas kernel does where
    its causal block skip drops every k-block of the row."""
    b, h, kh, s, d = 1, 2, 1, 64, 16
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(-1, s, d) for x in _qkv(2, b, s, h, kh, d))
    o, lse = flash_fwd_bhsd(
        _t(q), _t(k), _t(v), causal=True, q_offset=q_offset,
        k_offset=k_offset, n_q_heads=h, n_kv_heads=kh,
    )
    ref_o, ref_lse = jax_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=32, block_k=32, interpret=True, q_offset=q_offset,
        k_offset=k_offset, n_q_heads=h, n_kv_heads=kh,
    )
    q_pos = q_offset + np.arange(s)
    has_key = q_pos >= k_offset
    rows = np.nonzero(has_key)[0]
    masked = np.nonzero(~has_key)[0]
    # mha over [1, S, B·H, D]: each (batch, head) row as a head.
    as_heads = lambda x: jnp.asarray(x)[None].transpose(0, 2, 1, 3)  # noqa: E731
    dense = np.asarray(jax_mha(
        as_heads(q), as_heads(np.repeat(k, h // kh, axis=0)),
        as_heads(np.repeat(v, h // kh, axis=0)),
        causal=True, q_offset=q_offset, k_offset=k_offset,
    )).transpose(0, 2, 1, 3)[0]  # back to [B·H, S, D]
    np.testing.assert_allclose(o.numpy()[:, rows], dense[:, rows], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(o.numpy()[:, rows], np.asarray(ref_o)[:, rows], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        lse.numpy()[:, rows], np.asarray(ref_lse)[:, rows], atol=ATOL, rtol=ATOL
    )
    if masked.size:
        # The Pallas kernel zeroes such rows only where their whole block
        # is skipped; 32-row blocks at these offsets skip every one.
        assert np.all(o.numpy()[:, masked] == 0.0)
        assert np.all(np.asarray(ref_o)[:, masked] == 0.0)
        assert np.all(lse.numpy()[:, masked] < -1e29)
        assert np.all(np.asarray(ref_lse)[:, masked] < -1e29)


@pytest.mark.parametrize("b", [1, 3])
def test_kernel_layout_is_contiguous(b):
    """The kernel takes contiguous [B·H, S, D]; the layout change must give
    that at every batch size (a bare reshape gives a strided view at B=1)."""
    from torchkafka_tpu_torch.ops.flash import _from_bhsd, _to_bhsd

    x = torch.randn(b, 5, 4, 8)
    y = _to_bhsd(x)
    assert y.is_contiguous() and y.shape == (b * 4, 5, 8)
    torch.testing.assert_close(_from_bhsd(y, b, 4), x, atol=0, rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError):
        flash_fwd_bhsd(q, torch.zeros(4, 8, 16, dtype=torch.float64),
                       torch.zeros(4, 8, 16, dtype=torch.float64))
    with pytest.raises(ValueError):  # 3 q heads over 2 kv heads
        flash_fwd_bhsd(q, torch.zeros(2, 8, 16), torch.zeros(2, 8, 16),
                       n_q_heads=3, n_kv_heads=2)


# bf16 at the head dims of the tensor-core route: the port's forward (the
# plain version the wrapper runs on the CPU, which the tensor-core kernel is
# held against on the card) against the Pallas kernel in interpret mode on
# the same bf16 inputs. o is compared relative to its largest |value|: p is
# rounded to bf16 against different running maxima (one softmax over all
# keys here, one per 64-key block there) and o is rounded to bf16 at the
# end, about one bf16 ulp (2^-8 relative) at the top of the range. lse is
# f32 from the same products, summed in another order.
BF16_O_REL = 1e-2
LSE_ATOL = 1e-5


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _to_jax(t):
    """A bf16 tensor as a bf16 JAX array with the same values."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize(
    "d,h,k,s,causal,q_offset,k_offset",
    [
        (16, 1, 1, 128, True, 0, 0),
        (16, 4, 1, 256, False, 0, 0),
        (16, 2, 2, 128, True, 64, 0),
        (64, 1, 1, 256, True, 0, 0),
        (64, 2, 1, 128, False, 0, 0),
        (64, 4, 1, 128, True, 0, 0),  # rep 4, the 8b model's ratio
        (64, 8, 2, 128, True, 0, 64),  # rows before the first key
        (128, 2, 2, 128, True, 0, 0),
        (128, 4, 2, 256, True, 0, 0),  # rep 2, the 1b model's ratio
        (128, 4, 1, 128, False, 0, 0),
        (128, 8, 2, 128, True, 64, 0),
        (128, 2, 1, 256, True, 32, 96),
    ],
    ids=["d16_rep1", "d16_rep4_full", "d16_q_offset64", "d64_rep1_s256",
         "d64_rep2_full", "d64_rep4", "d64_rep4_k_offset64", "d128_rep1",
         "d128_rep2_s256", "d128_rep4_full", "d128_rep4_q_offset64",
         "d128_rep2_offsets"],
)
def test_bf16_fwd_matches_pallas(d, h, k, s, causal, q_offset, k_offset):
    rng = np.random.default_rng(d + h + k + s + q_offset + k_offset)
    q = _bf16(rng.normal(size=(h, s, d)).astype(np.float32))
    kk, v = (_bf16(rng.normal(size=(k, s, d)).astype(np.float32)) for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset, n_q_heads=h,
              n_kv_heads=k)
    o, lse = flash_fwd_bhsd(q, kk, v, **kw)
    ref_o, ref_lse = jax_fwd_bhsd(_to_jax(q), _to_jax(kk), _to_jax(v), block_q=64,
                                  block_k=64, interpret=True, **kw)
    ref_o = np.asarray(ref_o, dtype=np.float32)
    assert o.dtype == torch.bfloat16 and o.shape == ref_o.shape
    got = o.float().numpy()
    assert np.isfinite(got).all() and np.isfinite(lse.numpy()).all()
    assert np.abs(got - ref_o).max() <= BF16_O_REL * np.abs(ref_o).max()
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=LSE_ATOL, rtol=0)
    if causal and k_offset > q_offset:
        # 64-row blocks whose rows see no key are skipped whole by the
        # Pallas kernel: o = 0 and lse ≈ -1e30 on both sides.
        rows = slice(0, k_offset - q_offset)
        assert np.all(got[:, rows] == 0.0) and np.all(ref_o[:, rows] == 0.0)
        assert np.all(lse.numpy()[:, rows] < -1e29)

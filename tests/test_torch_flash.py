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

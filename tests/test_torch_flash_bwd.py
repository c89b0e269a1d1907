"""The port's flash-attention backward (its plain PyTorch version, which
the CUDA kernels are held against on the card) against the JAX package's
Pallas backward in interpret mode, at f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.ops.flash import _flash_bwd_bhsd as jax_bwd_bhsd
from torchkafka_tpu.ops.flash import flash_attention as jax_flash
from torchkafka_tpu_torch.ops import flash

ATOL = 5e-5  # dq/dk/dv: f32 sums in another order than the interpreted kernels


def _qkv(seed, b, s, h, k, d):
    rng = np.random.default_rng(seed)
    q, kk, v = (rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, k, k))
    g = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return q, kk, v, g


def _jax_grads(q, k, v, g, causal, block):
    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal, block, block, True) * g)

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, g, causal):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal)
    (out * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize(
    "b,s,h,k,d,causal,block",
    [
        (2, 256, 4, 4, 32, True, 64),  # MHA, 64-row blocks: 4×4 block grid
        (2, 256, 4, 4, 32, False, 64),
        (2, 128, 4, 2, 32, True, None),  # GQA: dK/dV summed over 2 q heads
        (1, 128, 8, 2, 16, True, 32),  # GQA with rep 4
        (2, 100, 4, 2, 16, True, None),  # untileable: the JAX side's dense vjp
    ],
    ids=["mha_causal", "mha_full", "gqa", "gqa_rep4", "untileable_s100"],
)
def test_grads_match_jax(b, s, h, k, d, causal, block):
    q, kk, v, g = _qkv(s + h, b, s, h, k, d)
    ref = _jax_grads(q, kk, v, g, causal, block)
    got = _port_grads(q, kk, v, g, causal)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=ATOL, rtol=ATOL, err_msg=name)


@pytest.mark.parametrize("q_offset,k_offset", [(64, 0), (0, 64), (32, 96)])
def test_bwd_plain_matches_pallas_at_offsets(q_offset, k_offset):
    """Non-zero offsets, where whole blocks are skipped and (k_offset >
    q_offset) some rows have no allowed key. Both backwards read the same
    (o, lse) — the port's forward, whose masked rows have o = 0 and
    lse ≈ -1e30 — and select p on the mask, so they agree everywhere,
    masked rows included (dq = 0 there)."""
    bh, s, d = 4, 128, 16
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(4))
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset)
    o, lse = flash.flash_fwd_bhsd(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    got = flash.flash_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), o, lse,
                                torch.from_numpy(do), **kw)
    ref = jax_bwd_bhsd(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(o.numpy()),
                       jnp.asarray(lse.numpy()), jnp.asarray(do), block_q=32,
                       block_k=32, interpret=True, **kw)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, rtol=ATOL,
                                   err_msg=name)
    masked = q_offset + np.arange(s) < k_offset
    assert np.all(got[0].numpy()[:, masked] == 0.0)


def test_wrappers_compose_the_plain_backward():
    """On CPU tensors the kernel wrappers run the plain versions: the
    composed backward equals ``flash_bwd_plain`` exactly, dK/dV in the kv
    layout."""
    q, k, v, do = (torch.randn(n, 64, 16, generator=torch.Generator().manual_seed(n))
                   for n in (8, 4, 4, 8))
    kw = dict(causal=True, n_q_heads=4, n_kv_heads=2)
    o, lse = flash.flash_fwd_bhsd(q, k, v, **kw)
    got = flash.flash_bwd_bhsd(q, k, v, o, lse, do, **kw)
    ref = flash.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    assert [tuple(t.shape) for t in got] == [(8, 64, 16), (4, 64, 16), (4, 64, 16)]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=0, rtol=0)


def test_saved_tensors_are_linear_in_s():
    """The autograd graph keeps (q, k, v, o, lse): no tensor with an
    [S, S] trailing face is saved (mirrors the JAX package's
    ``test_no_quadratic_residual``)."""
    s = 256
    q, k, v, _ = _qkv(0, 1, s, 4, 2, 16)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = flash.flash_attention(tq, tk, tv, True)
    assert shapes and all(not (len(sh) >= 2 and sh[-1] == s and sh[-2] == s)
                          for sh in shapes), shapes
    out.sum().backward()
    assert tk.grad.shape == (1, s, 2, 16)


def test_bwd_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(4, 8, 16)
    lse = torch.zeros(4, 8, 1)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_dq_bhsd(q, q, q, q, lse.double(), lse)
    with pytest.raises(ValueError, match="dO"):
        flash.flash_dkv_bhsd(q, q, q, torch.zeros(4, 8, 8), lse, lse)

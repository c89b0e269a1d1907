"""The port's flash-attention backward (its plain PyTorch version, which
the CUDA kernels are held against on the card) against the JAX package's
Pallas backward in interpret mode, at f32 and at bf16 (the dtype of the
tensor-core kernels)."""

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


# bf16: the dtype the tensor-core kernels take. Relative to the largest
# |reference value|: the Pallas backward writes dK/dV per q head rounded to
# bf16 and the test sums those partials, where the port sums the heads in
# f32 and rounds once; with the p and ds roundings that is a few bf16 ulps
# (2^-8 each) at the top of the range.
BF16_REL = 2e-2


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _to_jax(t):
    """A bf16 tensor as a bf16 JAX array with the same values."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _assert_rel(got, ref, name):
    ref = np.asarray(ref, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    assert err <= BF16_REL * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize(
    "d,h,k,causal,q_offset,k_offset",
    [
        (64, 1, 1, True, 0, 0),
        (64, 2, 1, True, 0, 0),
        (64, 4, 1, False, 0, 0),
        (64, 8, 1, True, 0, 0),  # rep 8
        (128, 2, 2, False, 0, 0),
        (128, 4, 2, True, 0, 0),
        (128, 4, 1, True, 0, 0),  # rep 4, the 8b model's ratio
        (128, 8, 1, False, 0, 0),
        (64, 4, 2, True, 0, 64),  # rows before the first key: dq = 0
        (128, 2, 1, True, 32, 96),
    ],
    ids=["d64_rep1", "d64_rep2", "d64_rep4_full", "d64_rep8", "d128_rep1_full",
         "d128_rep2", "d128_rep4", "d128_rep8_full", "d64_k_offset64",
         "d128_offsets"],
)
def test_bf16_bwd_matches_pallas(d, h, k, causal, q_offset, k_offset):
    """The port's bf16 backward (the plain versions the wrappers run on the
    CPU, which the tensor-core kernels are held against on the card)
    against the Pallas backward in interpret mode on the same bf16 inputs
    and the same (o, lse). The Pallas dK/dV come per q head: they are
    group-summed in f32 here."""
    s = 128
    rng = np.random.default_rng(d + h + k)
    q, do = (_bf16(rng.normal(size=(h, s, d)).astype(np.float32)) for _ in range(2))
    kk, v = (_bf16(rng.normal(size=(k, s, d)).astype(np.float32)) for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset, n_q_heads=h,
              n_kv_heads=k)
    o, lse = flash.flash_fwd_bhsd(q, kk, v, **kw)
    got = flash.flash_bwd_bhsd(q, kk, v, o, lse, do, **kw)
    rdq, rdk, rdv = jax_bwd_bhsd(
        _to_jax(q), _to_jax(kk), _to_jax(v), _to_jax(o), jnp.asarray(lse.numpy()),
        _to_jax(do), block_q=64, block_k=64, interpret=True, **kw)
    rep = h // k

    def group_sum(x):  # per-q-head partials → kv heads, in f32
        return np.asarray(x, dtype=np.float32).reshape(k, rep, s, d).sum(axis=1)

    _assert_rel(got[0], rdq, "dq")
    _assert_rel(got[1], group_sum(rdk), "dk")
    _assert_rel(got[2], group_sum(rdv), "dv")
    if k_offset > q_offset:
        assert np.all(got[0].float().numpy()[:, : k_offset - q_offset] == 0.0)


@pytest.mark.parametrize("s,causal", [(100, True), (72, False)],
                         ids=["s100_causal", "s72_full"])
def test_bf16_grads_match_jax_at_ragged_s(s, causal):
    """A ragged S through the public ``flash_attention`` in bf16: the JAX
    side takes its dense VJP there (no block divides S), the port its
    masked backward."""
    q, kk, v, g = _qkv(s, 1, s, 4, 2, 64)
    jq, jk, jv, jg = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, kk, v, g))

    def loss(q, k, v):
        out = jax_flash(q, k, v, causal, None, None, True)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_bf16(x).requires_grad_(True) for x in (q, kk, v))
    out = flash.flash_attention(tq, tk, tv, causal)
    (out.float() * _bf16(g).float()).sum().backward()
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        _assert_rel(t.grad, r, name)


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bwd_plain_matches_pallas_past_d128(d, dtype):
    """Head dims past 128, which the CUDA-core backward serves with 32-row
    tiles: the plain backward against the Pallas backward in interpret
    mode at a small S, GQA rep 2, on the same inputs and (o, lse)."""
    h, k, s = 4, 2, 64
    rng = np.random.default_rng(d)
    mk = (lambda x: torch.from_numpy(x)) if dtype == "f32" else _bf16
    q, do = (mk(rng.normal(size=(h, s, d)).astype(np.float32)) for _ in range(2))
    kk, v = (mk(rng.normal(size=(k, s, d)).astype(np.float32)) for _ in range(2))
    kw = dict(causal=True, n_q_heads=h, n_kv_heads=k)
    o, lse = flash.flash_fwd_bhsd(q, kk, v, **kw)
    got = flash.flash_bwd_bhsd(q, kk, v, o, lse, do, **kw)
    tj = _to_jax if dtype == "bf16" else (lambda t: jnp.asarray(t.numpy()))
    rdq, rdk, rdv = jax_bwd_bhsd(
        tj(q), tj(kk), tj(v), tj(o), jnp.asarray(lse.numpy()), tj(do),
        block_q=32, block_k=32, interpret=True, **kw)

    def group_sum(x):  # per-q-head partials → kv heads, in f32
        return np.asarray(x, dtype=np.float32).reshape(k, h // k, s, d).sum(axis=1)

    for name, a, r in zip(("dq", "dk", "dv"), got, (rdq, group_sum(rdk), group_sum(rdv))):
        if dtype == "f32":
            assert a.dtype == torch.float32 and np.isfinite(a.numpy()).all(), name
            np.testing.assert_allclose(a.numpy(), r, atol=ATOL, rtol=ATOL, err_msg=name)
        else:
            _assert_rel(a, r, name)

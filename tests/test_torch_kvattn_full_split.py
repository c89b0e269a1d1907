"""The full-pool masked int8 decode reads (K7 K-major, K8 M-major) on the
split-K body of ``csrc/kvattn_split.cuh`` in its mask mode, checked on the
CPU through the numpy model of the kernel (``_model_one`` of
``tests/test_torch_kvattn_split.py`` with a mask):

- the model against the port's plain versions on both layouts: prefix
  masks, masks with holes, an all-false row, a row whose only readable
  position is the pool's last, one span of 192 (three tiles) and forced
  spans of 64 (three spans of one tile), a ragged pool of 200, rep 1-8,
  f32 and bf16;
- why the first tile is found by its index: the watermark mode's
  m == -1e30 rule wipes an all-false row's sums tile by tile;
- on prefix masks the mask mode equals the watermark mode (K4's model);
- the plain versions against the Pallas kernels in interpret mode at a
  ragged pool;
- CPU tensors launch nothing and make no counter buffer; other devices
  are refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kvattn_split import TOL, _bf16, _model_one, _quant_pool, model_dense
from torchkafka_tpu.ops import kvattn as jk
from torchkafka_tpu_torch.ops import kvattn as pk

N_KV, DH = 2, 32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _masks(rng, b, m):
    """[b, m] bool, one pattern a row: a prefix, every position, holes, all
    false, only the last position, sparse holes (repeated past six rows)."""
    pats = [np.arange(m) <= 5, np.ones(m, bool), rng.random(m) < 0.6, np.zeros(m, bool),
            np.arange(m) == m - 1, rng.random(m) < 0.05]
    return np.stack([pats[i % len(pats)] for i in range(b)])


def _case(seed, m, rep, b=6):
    """q [b, 1, K*rep, DH] f32; a K-major int8 pool [b, K, m, DH] with f32
    scales [b, K, m]; masks [b, m]."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, N_KV * rep, DH)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (b, N_KV, m, DH), dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 0.021, (b, N_KV, m)).astype(np.float32) for _ in range(2))
    return q, kq, ks, vq, vs, _masks(rng, b, m)


def _mmajor(*arrs):
    return [np.ascontiguousarray(np.swapaxes(a, 1, 2)) for a in arrs]


def model_full(q, kq, ks, vq, vs, valid, bf16, span=None, kmajor=True, sentinel=False):
    """The kernel's full read: q [B, 1, H, dh]; a K-major ([B, K, M, dh],
    scales [B, K, M]) or M-major ([B, M, K, dh], [B, M, K]) pool; valid
    [B, M]; ``span`` the override. Returns (out [B, 1, H, dh] f32, live
    spans [B])."""
    b, _, h, dh = q.shape
    n_kv, m = (kq.shape[1], kq.shape[2]) if kmajor else (kq.shape[2], kq.shape[1])
    rep = h // n_kv
    span, _ = pk._split_plan(m, span=span, max_split=pk._MAX_SPLIT_FULL)
    out = np.zeros((b, n_kv, rep, dh), np.float32)
    live = np.zeros(b, int)
    for i in range(b):
        for kh in range(n_kv):
            rows = (lambda a: a[i, kh]) if kmajor else (lambda a: a[i, :, kh])
            out[i, kh], live[i] = _model_one(
                q[i, 0, kh * rep:(kh + 1) * rep], rows(kq), rows(ks), rows(vq), rows(vs),
                m, span, bf16, valid=valid[i], sentinel=sentinel)
    out = _bf16(out) if bf16 else out
    return out.reshape(b, 1, h, dh), live


def _plain(q, kq, ks, vq, vs, valid, bf16, kmajor=True):
    tq = _t(q).to(torch.bfloat16 if bf16 else torch.float32)
    fn = pk.int8_decode_attention_kmajor_plain if kmajor else pk.int8_decode_attention_mmajor_plain
    return fn(tq, *(_t(a) for a in (kq, ks, vq, vs, valid))).float().numpy()


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("span", [None, 64], ids=["planner", "L64"])
@pytest.mark.parametrize("m", [192, 200])
def test_model_full_matches_plain(m, span, bf16, rep):
    """Pools of 192 (the planner's one span of three tiles; forced: three
    spans of one tile) and a ragged 200 (one span; forced: three spans of
    64 and one of 8), every mask pattern, both layouts: every span live."""
    q, kq, ks, vq, vs, valid = _case(100 * rep + m, m, rep)
    q = _bf16(q) if bf16 else q
    want_spans = -(-m // (span or m))
    got, live = model_full(q, kq, ks, vq, vs, valid, bf16, span=span)
    np.testing.assert_array_equal(live, want_spans)
    np.testing.assert_allclose(got, _plain(q, kq, ks, vq, vs, valid, bf16), **TOL[bf16])
    mm = _mmajor(kq, ks, vq, vs)
    got_m, _ = model_full(q, *mm, valid, bf16, span=span, kmajor=False)
    np.testing.assert_array_equal(got_m, got)  # the row map changes no value
    np.testing.assert_allclose(got_m, _plain(q, *mm, valid, bf16, kmajor=False), **TOL[bf16])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_first_tile_is_found_by_its_index(bf16):
    """One span of 192 positions, three tiles. The watermark mode's rule
    (alpha = 0 while m == -1e30) zeroes an all-false row's sums at every
    tile, which leaves the mean of the last tile's 64 positions, not of
    all 192; the mask mode's rule (alpha = 0 on tile 0 only) keeps them.
    Rows with a readable position come out the same under both rules."""
    m = 192
    q, kq, ks, vq, vs, valid = _case(7, m, 2)
    q = _bf16(q) if bf16 else q
    assert pk._split_plan(m, max_split=pk._MAX_SPLIT_FULL) == (m, 1)
    good, _ = model_full(q, kq, ks, vq, vs, valid, bf16)
    bad, _ = model_full(q, kq, ks, vq, vs, valid, bf16, sentinel=True)
    ref = _plain(q, kq, ks, vq, vs, valid, bf16)
    np.testing.assert_allclose(good, ref, **TOL[bf16])
    dq = vq.astype(np.float32) * vs[..., None]  # [B, K, M, dh]
    tail = np.repeat(dq[3, :, 128:].mean(axis=1)[:, None], 2, axis=1).reshape(1, -1, DH)
    np.testing.assert_allclose(bad[3], tail, atol=2.0**-6 if bf16 else 1e-5, rtol=0)
    assert np.abs(bad[3] - ref[3]).max() > 10 * TOL[bf16]["atol"]
    others = np.arange(len(valid)) != 3
    np.testing.assert_array_equal(bad[others], good[others])


@pytest.mark.parametrize("span", [None, 64], ids=["planner", "L64"])
@pytest.mark.parametrize("m", [192, 300])
def test_masked_model_equals_watermark_model_on_prefix_masks(m, span):
    """At the same span, the mask mode on a prefix mask is the watermark
    mode: the masked positions add p = 0 and the spans past the watermark
    weigh e^(-1e30 - M) = 0 in the merge. numpy may sum the extra zero
    terms in another order, so f32 rounding apart, not bitwise."""
    q, kq, ks, vq, vs, _ = _case(m, m, 2)
    pos = np.asarray([0, 63, 64, 65, m // 2, m - 1], np.int32)
    valid = np.arange(m)[None, :] <= pos[:, None]
    L, n = pk._split_plan(m, span=span, max_split=pk._MAX_SPLIT_FULL)
    full, live = model_full(q, kq, ks, vq, vs, valid, False, span=L)
    np.testing.assert_array_equal(live, n)
    wm, wm_live = model_dense(q, kq, ks, vq, vs, pos, False, span=L)
    assert (wm_live <= n).all() and wm_live.min() == 1
    np.testing.assert_allclose(full, wm, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("span", [None, 64], ids=["planner", "L64"])
def test_all_false_row_averages_every_position(span):
    """The all-false row weighs all M positions alike: its output is the
    mean of the dequantised V rows over the whole pool."""
    m = 192
    q, kq, ks, vq, vs, valid = _case(9, m, 4)
    got, _ = model_full(q, kq, ks, vq, vs, valid, False, span=span)
    mean = (vq[3].astype(np.float32) * vs[3][..., None]).mean(axis=1)  # [K, dh]
    np.testing.assert_allclose(got[3, 0], np.repeat(mean, 4, axis=0), atol=1e-5, rtol=1e-5)


def test_full_plan_at_the_measured_pools():
    """Full reads split into at most 8 spans (all live), the fill-bounded
    reads into at most 16: 2048 positions are 8 spans of 256 against 16 of
    128; a 192 pool is one span for both; forced spans of 64 split 192 into
    three."""
    assert pk._split_plan(2048, max_split=pk._MAX_SPLIT_FULL) == (256, 8)
    assert pk._split_plan(2048) == (128, 16)
    assert pk._split_plan(192, max_split=pk._MAX_SPLIT_FULL) == (192, 1)
    assert pk._split_plan(4096, max_split=pk._MAX_SPLIT_FULL) == (512, 8)
    assert pk._split_plan(192, span=64, max_split=pk._MAX_SPLIT_FULL) == (64, 3)


@pytest.mark.parametrize("kmajor", [True, False], ids=["kmajor", "mmajor"])
@pytest.mark.parametrize("rep", [4, 8])
def test_plain_full_matches_pallas_on_a_ragged_pool(rep, kmajor):
    """The plain versions against the Pallas kernels in interpret mode at a
    200-position pool, every mask pattern (f32)."""
    rng = np.random.default_rng(rep * 10 + kmajor)
    b, m = 6, 200
    q = rng.normal(size=(b, 1, N_KV * rep, DH)).astype(np.float32)
    kq, ks = _quant_pool(rng, (b, m, N_KV, DH))  # K-major
    vq, vs = _quant_pool(rng, (b, m, N_KV, DH))
    valid = _masks(rng, b, m)
    pool = (kq, ks, vq, vs) if kmajor else _mmajor(kq, ks, vq, vs)
    if kmajor:
        ref = jk.int8_decode_attention_kmajor(*(jnp.asarray(a) for a in (q, *pool, valid)),
                                              interpret=True)
        got = pk.int8_decode_attention_kmajor(*(_t(a) for a in (q, *pool, valid)))
    else:
        ref = jk.int8_decode_attention(*(jnp.asarray(a) for a in (q, *pool, valid)),
                                       interpret=True)
        got = pk.int8_decode_attention(*(_t(a) for a in (q, *pool, valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("kmajor", [True, False], ids=["kmajor", "mmajor"])
def test_cpu_full_read_launches_nothing(kmajor):
    q, kq, ks, vq, vs, valid = _case(3, 200, 2)
    pool = (kq, ks, vq, vs) if kmajor else _mmajor(kq, ks, vq, vs)
    fn = pk.int8_decode_attention_kmajor if kmajor else pk.int8_decode_attention
    before, counters = fn.launches, dict(pk._counters)
    out = fn(*(_t(a) for a in (q, *pool, valid)))
    assert out.device.type == "cpu"
    assert fn.launches == before
    assert pk._counters == counters


@pytest.mark.parametrize("kmajor", [True, False], ids=["kmajor", "mmajor"])
def test_full_read_refuses_other_devices(kmajor):
    """Only CPU tensors take the plain version; tensors elsewhere than on
    a CUDA card are refused before any launch."""
    q, kq, ks, vq, vs, valid = _case(4, 64, 2)
    pool = (kq, ks, vq, vs) if kmajor else _mmajor(kq, ks, vq, vs)
    fn = pk.int8_decode_attention_kmajor if kmajor else pk.int8_decode_attention
    before = fn.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(*(_t(a).to("meta") for a in (q, *pool, valid)))
    assert fn.launches == before

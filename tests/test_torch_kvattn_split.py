"""The split-K schedule of the fill-bounded int8 decode reads (K4 dense, K5
paged; ``csrc/kvattn_split.cuh``), checked on the CPU:

- ``_split_plan``: the spans cover the pool with the least count, are whole
  blocks where a block fits, and the override forces one span;
- a numpy model of the kernel's split-and-merge (spans from ``_split_plan``,
  64-position tiles, an online softmax per span, p * v_scale rounded to q's
  dtype against the span's running max, the merge of the live spans in
  split order), held against the port's plain versions (its mask mode,
  the full-pool reads K7/K8: ``tests/test_torch_kvattn_full_split.py``);
- the plain versions against the JAX package's Pallas kernels in interpret
  mode at the schedule's edge cases (rep 4 and 8, ragged pools, watermarks
  at span edges, small blocks);
- CPU tensors launch nothing and make no counter buffer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models.quant import quant_kv_groups as jax_quant
from torchkafka_tpu.ops import kvattn as jk
from torchkafka_tpu_torch.ops import kvattn as pk

TILE = 64  # positions a kernel tile
NEG = np.float32(-1e30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ planner


@pytest.mark.parametrize("m_len,bs", [
    (1, 1), (192, 1), (200, 1), (2048, 1), (8192, 1), (100_000, 1),
    (192, 16), (200, 16), (2048, 16), (192, 48), (200, 48), (4096, 48),
    (256, 256), (2048, 256), (1, 256),
])
def test_split_plan_covers_the_pool_with_the_least_spans(m_len, bs):
    span, n = pk._split_plan(m_len, bs)
    assert span >= 1 and n >= 1
    assert n * span >= m_len > (n - 1) * span  # covers, and n is the least
    assert n <= 16  # longer pools widen the span, not the grid
    assert (n == 1) == (m_len <= 256)  # up to four tiles: one span
    if bs <= span:
        assert span % bs == 0  # whole blocks: a span reads its entries once
    one, n1 = pk._split_plan(m_len, bs, span=m_len)  # the override: one span
    assert n1 == 1 and one >= m_len and one % min(bs, one) == 0
    if m_len <= 64 * 64:  # spans of 64 up to the merge's 64 spans
        forced, nf = pk._split_plan(m_len, bs, span=64)
        assert nf * forced >= m_len > (nf - 1) * forced


def test_split_plan_at_the_serving_shapes():
    """The serving pools of 192 positions run as one span; 2048 as 16 spans
    of 128; forced spans of 64 split 192 into 3; blocks of 48 give spans of
    two blocks; more spans than the kernel's merge takes are refused."""
    assert pk._split_plan(192) == (192, 1)
    assert pk._split_plan(192, 16) == (192, 1)
    assert pk._split_plan(2048) == (128, 16)
    assert pk._split_plan(4096, 16) == (256, 16)
    assert pk._split_plan(192, span=64) == (64, 3)
    assert pk._split_plan(384, 48) == (96, 4)
    with pytest.raises(ValueError):
        pk._split_plan(0)
    with pytest.raises(ValueError):
        pk._split_plan(8192, span=64)


# ------------------------------------------------------- the kernel's model


def _bf16(x):
    """f32 -> bf16 (round to nearest even) -> f32, as __float2bfloat16_rn."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _model_one(q, k, ks, v, vs, n_pos, span, bf16, valid=None, sentinel=False):
    """One (slot, kv head) as the kernel computes it. q [rep, dh] f32 (values
    of q's dtype); k/v [n, dh] int8 and ks/vs [n] f32 in logical order.
    ``valid`` [n_pos] bool selects the mask mode (K7/K8): all n_pos
    positions are visited, every span is live, a masked position scores
    exactly -1e30, and alpha is 0 on a span's first tile by its index.
    The watermark mode (K4/K5) finds the first tile by m == -1e30 instead;
    ``sentinel`` applies that rule in the mask mode too (the rule the
    body had before the mask mode). Returns (out [rep, dh] f32 before the
    output rounding, live spans)."""
    rnd = _bf16 if bf16 else (lambda x: x)
    inv = np.float32(1.0 / np.sqrt(q.shape[1]))
    parts = []
    for start in range(0, n_pos, span):
        end = min(start + span, n_pos)
        m = np.full(q.shape[0], NEG, np.float32)
        l = np.zeros(q.shape[0], np.float32)
        acc = np.zeros(q.shape, np.float32)
        for i, t0 in enumerate(range(start, end, TILE)):
            t1 = min(t0 + TILE, end)
            s = (q @ k[t0:t1].astype(np.float32).T) * ks[t0:t1] * inv
            if valid is not None:
                s = np.where(valid[t0:t1], s, NEG).astype(np.float32)
            m_new = np.maximum(m, s.max(axis=1))
            first = m == NEG if valid is None or sentinel else np.full(m.shape, i == 0)
            alpha = np.where(first, 0, np.where(m == m_new, 1, np.exp(m - m_new)))
            alpha = alpha.astype(np.float32)
            p = np.exp(s - m_new[:, None])
            pw = rnd((p * vs[t0:t1]).astype(np.float32))
            l = l * alpha + p.sum(axis=1)
            acc = acc * alpha[:, None] + pw @ v[t0:t1].astype(np.float32)
            m = m_new
        parts.append((m, l, acc))
    if len(parts) == 1:
        return acc / l[:, None], 1
    mx = np.max([p[0] for p in parts], axis=0)
    num = np.zeros(q.shape, np.float32)
    den = np.zeros(q.shape[0], np.float32)
    for m, l, acc in parts:  # split order
        e = np.exp(m - mx)
        num += e[:, None] * acc
        den += e * l
    return num / den[:, None], len(parts)


def model_dense(q, kq, ks, vq, vs, pos, bf16, span=None):
    """The kernel over a dense K-major pool: q [B, 1, H, dh]; kq/vq
    [B, K, M, dh]; ks/vs [B, K, M]; ``span`` the override. Returns (out
    [B, 1, H, dh] f32, live spans [B])."""
    b, _, h, dh = q.shape
    n_kv, m = kq.shape[1], kq.shape[2]
    rep = h // n_kv
    span, _ = pk._split_plan(m, 1, span=span)
    out = np.zeros((b, n_kv, rep, dh), np.float32)
    live = np.zeros(b, int)
    for i in range(b):
        n_pos = min(max(int(pos[i]), 0), m - 1) + 1
        for kh in range(n_kv):
            out[i, kh], live[i] = _model_one(
                q[i, 0, kh * rep:(kh + 1) * rep], kq[i, kh], ks[i, kh], vq[i, kh],
                vs[i, kh], n_pos, span, bf16)
    out = _bf16(out) if bf16 else out
    return out.reshape(b, 1, h, dh), live


def model_paged(q, pkq, pks, pvq, pvs, table, pos, bf16):
    """The kernel over a paged pool [NB, K, bs, dh] through ``table``
    [B, nblk]: each slot's rows looked up position by position (entries
    clamped into the pool), then the dense model's spans of whole
    blocks."""
    nb, n_kv, bs, dh = pkq.shape
    b, nblk = table.shape
    rep = q.shape[2] // n_kv
    span, _ = pk._split_plan(nblk * bs, bs)
    out = np.zeros((b, n_kv, rep, dh), np.float32)
    for i in range(b):
        n_pos = min(max(int(pos[i]), 0), nblk * bs - 1) + 1
        blk = np.clip(table[i, np.arange(n_pos) // bs], 0, nb - 1)
        off = np.arange(n_pos) % bs
        for kh in range(n_kv):
            out[i, kh], _ = _model_one(
                q[i, 0, kh * rep:(kh + 1) * rep], pkq[blk, kh, off], pks[blk, kh, off],
                pvq[blk, kh, off], pvs[blk, kh, off], n_pos, span, bf16)
    out = _bf16(out) if bf16 else out
    return out.reshape(b, 1, q.shape[2], dh)


def _dense_case(seed, m, rep, pos, n_kv=2, dh=32):
    rng = np.random.default_rng(seed)
    b = len(pos)
    q = rng.normal(size=(b, 1, n_kv * rep, dh)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (b, n_kv, m, dh), dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 0.021, (b, n_kv, m)).astype(np.float32) for _ in range(2))
    return q, kq, ks, vq, vs, np.asarray(pos, np.int32)


# Tolerances against the plain version. f32: the same math, the f32 sums
# in another order (tiles, spans, the merge). bf16: each span rounds
# p * v_scale to bf16 against its own running max where the plain version
# rounds against the whole prefix's max, which moves the f32 result by far
# less than a bf16 step, and the output is rounded to bf16 once: the two
# may land one bf16 step apart, 2^-6 for the |out| < 4 these inputs give.
TOL = {False: dict(atol=1e-5, rtol=1e-5), True: dict(atol=2.0**-6, rtol=0)}


def _plain_dense(q, kq, ks, vq, vs, pos, bf16):
    tq = _t(q).to(torch.bfloat16 if bf16 else torch.float32)
    return pk.int8_decode_attention_plain(tq, _t(kq), _t(ks), _t(vq), _t(vs),
                                          _t(pos)).float().numpy()


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_model_dense_matches_plain(bf16, rep):
    """Watermarks at 0, L-1, L, L+1 and M-1 of a 300-position pool (spans of
    64: one, one, two, two and five live spans)."""
    q, kq, ks, vq, vs, pos = _dense_case(rep, 300, rep, [0, 63, 64, 65, 299])
    if bf16:
        q = _bf16(q)
    got, live = model_dense(q, kq, ks, vq, vs, pos, bf16)
    np.testing.assert_array_equal(live, [1, 1, 2, 2, 5])
    ref = _plain_dense(q, kq, ks, vq, vs, pos, bf16)
    np.testing.assert_allclose(got, ref, **TOL[bf16])


@pytest.mark.parametrize("span,live", [(None, [1, 1, 1, 1]), (64, [1, 2, 3, 4]),
                                       (300, [1, 1, 1, 1])], ids=["planner", "L64", "one"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_model_spans_of_a_short_pool_match_plain(bf16, span, live):
    """A 200-position pool: the planner's one span, its tiles chained by the
    online softmax; the override's spans of 64 (what the on-card check
    forces to run the merge at a serving pool); one span of the pool."""
    q, kq, ks, vq, vs, pos = _dense_case(11, 200, 2, [0, 64, 130, 199])
    q = _bf16(q) if bf16 else q
    got, n_live = model_dense(q, kq, ks, vq, vs, pos, bf16, span=span)
    np.testing.assert_array_equal(n_live, live)
    np.testing.assert_allclose(got, _plain_dense(q, kq, ks, vq, vs, pos, bf16),
                               **TOL[bf16])


def test_model_spans_past_the_watermark_contribute_nothing():
    """Poisoning every position past each slot's watermark leaves the
    model's result bit-identical: dead spans are never read."""
    q, kq, ks, vq, vs, pos = _dense_case(5, 300, 2, [0, 63, 64, 65, 230])
    base, _ = model_dense(q, kq, ks, vq, vs, pos, True)
    ks2, vs2 = ks.copy(), vs.copy()
    for i, p in enumerate(pos):
        ks2[i, :, p + 1:] = 1e6
        vs2[i, :, p + 1:] = 1e6
    again, _ = model_dense(q, kq, ks2, vq, vs2, pos, True)
    np.testing.assert_array_equal(again, base)


def _paged_case(seed, bs, nblk, rep, pos, n_kv=2, dh=32):
    rng = np.random.default_rng(seed)
    b = len(pos)
    nb = b * nblk + 3  # + a sink and garbage blocks
    q = rng.normal(size=(b, 1, n_kv * rep, dh)).astype(np.float32)
    pkq, pvq = (rng.integers(-127, 128, (nb, n_kv, bs, dh), dtype=np.int8) for _ in range(2))
    pks, pvs = (rng.uniform(1e-3, 0.021, (nb, n_kv, bs)).astype(np.float32) for _ in range(2))
    table = rng.permutation(np.arange(1, nb))[:b * nblk].reshape(b, nblk).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    live = np.arange(nblk)[None, :] <= (pos // bs)[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    table[0, -1] = nb + 5  # past the live range and outside [0, NB): clamped, never read
    return q, pkq, pks, pvq, pvs, table, pos


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_model_paged_matches_plain(bf16, rep):
    """Blocks of 48 (spans of two blocks, 96 positions) over a 384-position
    view: watermarks at 0, L-1, L, L+1 and the view's last."""
    q, pkq, pks, pvq, pvs, table, pos = _paged_case(20 + rep, 48, 8, rep,
                                                    [0, 95, 96, 97, 383])
    q = _bf16(q) if bf16 else q
    got = model_paged(q, pkq, pks, pvq, pvs, table, pos, bf16)
    tq = _t(q).to(torch.bfloat16 if bf16 else torch.float32)
    clamped = np.clip(table, 0, pkq.shape[0] - 1)  # the plain gather indexes the whole table
    ref = pk.int8_paged_decode_attention_plain(
        tq, *(_t(a) for a in (pkq, pks, pvq, pvs, clamped, pos))).float().numpy()
    np.testing.assert_allclose(got, ref, **TOL[bf16])


@pytest.mark.parametrize("bs", [16, 256])
def test_model_paged_block_sizes(bs):
    """Spans of four blocks of 16, and spans inside one block of 256."""
    nblk = 512 // bs + 1
    q, pkq, pks, pvq, pvs, table, pos = _paged_case(bs, bs, nblk, 2,
                                                    [0, 63, 64, 65, nblk * bs - 1])
    got = model_paged(q, pkq, pks, pvq, pvs, table, pos, False)
    clamped = np.clip(table, 0, pkq.shape[0] - 1)
    ref = pk.int8_paged_decode_attention_plain(
        *(_t(a) for a in (q, pkq, pks, pvq, pvs, clamped, pos))).numpy()
    np.testing.assert_allclose(got, ref, **TOL[False])


# -------------------------------------- plain versions against the Pallas kernels


def _quant_pool(rng, shape):
    """[B, M, K, dh] f32 -> K-major int8 [B, K, M, dh] and f32 [B, K, M],
    quantised as the JAX package quantises its pool."""
    x = (rng.normal(size=shape) * 2).astype(np.float32)
    qv, sc = (np.asarray(a) for a in jax_quant(jnp.asarray(x)))
    return qv.swapaxes(1, 2).copy(), sc.swapaxes(1, 2).copy()


@pytest.mark.parametrize("m,block", [(130, 10), (200, 8)])
@pytest.mark.parametrize("rep", [4, 8])
def test_plain_dense_matches_pallas_at_span_edges(rep, m, block):
    rng = np.random.default_rng(rep * 1000 + m)
    k_n, dh = 2, 32
    q = rng.normal(size=(4, 1, k_n * rep, dh)).astype(np.float32)
    kq, ks = _quant_pool(rng, (4, m, k_n, dh))
    vq, vs = _quant_pool(rng, (4, m, k_n, dh))
    pos = np.asarray([0, 63, 64, m - 1], np.int32)  # span edges and the pool's last
    ref = jk.int8_decode_attention_dynlen(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs, pos)),
                                          block=block, interpret=True)
    got = pk.int8_decode_attention_dynlen(*(_t(a) for a in (q, kq, ks, vq, vs, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("rep", [4, 8])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_plain_paged_matches_pallas_at_span_edges(bs, rep):
    rng = np.random.default_rng(bs * 10 + rep)
    k_n, dh, nblk = 2, 32, 160 // bs
    nb = 4 * nblk + 2
    q = rng.normal(size=(4, 1, k_n * rep, dh)).astype(np.float32)
    pools = []
    for _ in range(2):
        qv, sc = _quant_pool(rng, (nb, bs, k_n, dh))
        pools += [qv, sc]
    table = rng.permutation(np.arange(1, nb))[:4 * nblk].reshape(4, nblk).astype(np.int32)
    pos = np.asarray([63, 64, 65, nblk * bs - 1], np.int32)
    table = np.where(np.arange(nblk)[None, :] <= (pos // bs)[:, None], table, 0)
    table = table.astype(np.int32)
    ref = jk.int8_paged_decode_attention(*(jnp.asarray(a) for a in (q, *pools, table, pos)),
                                         interpret=True)
    got = pk.int8_paged_decode_attention(*(_t(a) for a in (q, *pools, table, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)


# ---------------------------------------------------- CPU tensors launch nothing


def test_cpu_dense_read_launches_nothing():
    q, kq, ks, vq, vs, pos = _dense_case(3, 200, 2, [0, 199])
    before, counters = pk.int8_decode_attention_dynlen.launches, dict(pk._counters)
    out = pk.int8_decode_attention_dynlen(*(_t(a) for a in (q, kq, ks, vq, vs, pos)))
    assert out.device.type == "cpu"
    assert pk.int8_decode_attention_dynlen.launches == before
    assert pk._counters == counters


def test_cpu_paged_read_launches_nothing():
    q, pkq, pks, pvq, pvs, table, pos = _paged_case(4, 16, 4, 2, [0, 63])
    table = np.clip(table, 0, pkq.shape[0] - 1)
    before, counters = pk.int8_paged_decode_attention.launches, dict(pk._counters)
    out = pk.int8_paged_decode_attention(*(_t(a) for a in (q, pkq, pks, pvq, pvs, table,
                                                           pos)))
    assert out.device.type == "cpu"
    assert pk.int8_paged_decode_attention.launches == before
    assert pk._counters == counters

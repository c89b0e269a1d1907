"""The paged pool's operators in the port against the JAX package's: the
gathers and scatters of both layouts and ``block_table_attention(_q8)``
exactly at f32, and the block-table read ``int8_paged_decode_attention``
(its plain version, which the CUDA kernel is held against on the card)
against the JAX wrapper's Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models.quant import quant_kv_groups as jax_quant
from torchkafka_tpu.ops import kvattn as jk
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.ops import kvattn as pk

K, DH, NB, NBLK = 2, 16, 12, 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _table():
    """Slots 0 and 1 share block 3 (a cached prefix), block 0 is the sink,
    blocks 9-11 are garbage no table references."""
    return np.asarray([[3, 1, 2, 4], [3, 5, 6, 7], [8, 2, 1, 5], [4, 6, 3, 8]],
                      np.int32)


@pytest.mark.parametrize("kmajor", [False, True], ids=["plain", "kmajor"])
def test_gather_matches_jax(kmajor):
    rng = np.random.default_rng(0)
    shape = (NB, K, 4, DH) if kmajor else (NB, 4, K, DH)
    pool = rng.normal(size=shape).astype(np.float32)
    jf, pf = ((jk.paged_gather_kmajor, pk.paged_gather_kmajor) if kmajor
              else (jk.paged_gather, pk.paged_gather))
    ref = np.asarray(jf(jnp.asarray(pool), jnp.asarray(_table())))
    got = pf(_t(pool), _t(_table())).numpy()
    assert got.shape == ref.shape == (4, NBLK * 4, K, DH)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kmajor", [False, True], ids=["plain", "kmajor"])
def test_scatter_matches_jax(kmajor):
    """Two query rows per slot at distinct logical positions (block
    edges and mid-block), written through the tables; the port writes in
    place and returns the pool."""
    rng = np.random.default_rng(1)
    bs = 4
    shape = (NB, K, bs, DH) if kmajor else (NB, bs, K, DH)
    pool = rng.normal(size=shape).astype(np.float32)
    table = np.asarray([[3, 1, 2, 4], [9, 5, 6, 7], [8, 2, 1, 5], [4, 6, 10, 8]],
                       np.int32)  # no block is written by two rows
    positions = np.asarray([[4, 7], [0, 15], [8, 9], [10, 3]], np.int32)
    values = rng.normal(size=(4, 2, K, DH)).astype(np.float32)
    jf, pf = ((jk.paged_scatter_kmajor, pk.paged_scatter_kmajor) if kmajor
              else (jk.paged_scatter, pk.paged_scatter))
    ref = np.asarray(jf(jnp.asarray(pool), jnp.asarray(table),
                        jnp.asarray(positions), jnp.asarray(values)))
    dst = _t(pool).clone()
    out = pf(dst, _t(table), _t(positions), _t(values))
    assert out is dst
    np.testing.assert_array_equal(dst.numpy(), ref)
    assert not np.array_equal(ref, pool)


@pytest.fixture(scope="module")
def layer():
    shape = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=K,
                 d_ff=64, max_seq_len=32)
    jcfg = jt.TransformerConfig(**shape, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**shape, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(3), jcfg)
    params = pt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), pcfg,
                                  device="cpu")
    jlayer = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"])
    return jcfg, jlayer, pcfg, pt.layer_at(params["layers"], 1)


@pytest.mark.parametrize("int8", [False, True], ids=["compute", "q8"])
def test_block_table_attention_matches_jax(layer, int8):
    """A chunk-shaped batch: slot 1's rows attend over positions its own
    earlier rows write in the same call (write-before-attend)."""
    jcfg, jlayer, pcfg, player = layer
    rng = np.random.default_rng(2)
    bs, S, dh = 4, 3, pcfg.head_dim
    table = _table()
    positions = np.asarray([[5, 6, 7], [8, 9, 10], [0, 1, 2], [13, 14, 15]], np.int32)
    x = rng.normal(size=(4, S, 32)).astype(np.float32)
    q = rng.normal(size=(4, S, 4, dh)).astype(np.float32)
    kn, vn = (rng.normal(size=(4, S, K, dh)).astype(np.float32) for _ in range(2))
    jargs = [jnp.asarray(a) for a in (x, q, kn, vn)]
    if int8:
        raw = [rng.normal(size=(NB, bs, K, dh)).astype(np.float32) for _ in range(2)]
        pools = []
        for r in raw:
            qv, sc = (np.asarray(a) for a in jax_quant(jnp.asarray(r)))
            pools += [qv.swapaxes(1, 2).copy(), sc.swapaxes(1, 2).copy()]
        jf, pf = jk.block_table_attention_q8, pk.block_table_attention_q8
    else:
        pools = [rng.normal(size=(NB, bs, K, dh)).astype(np.float32) for _ in range(2)]
        jf, pf = jk.block_table_attention, pk.block_table_attention
    ref = jf(*jargs, *(jnp.asarray(p) for p in pools), jnp.asarray(table),
             jnp.asarray(positions), jlayer, jcfg)
    ppools = [_t(p).clone() for p in pools]
    got = pf(*(_t(a) for a in (x, q, kn, vn)), *ppools, _t(table), _t(positions),
             player, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[0]), atol=1e-5, rtol=1e-5)
    for p, r in zip(ppools, ref[1:]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def _paged_inputs(bs, rep, seed):
    rng = np.random.default_rng(seed)
    B, H = 4, K * rep
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    pools = []
    for _ in range(2):
        raw = (rng.normal(size=(NB, bs, K, DH)) * 2).astype(np.float32)
        qv, sc = (np.asarray(a) for a in jax_quant(jnp.asarray(raw)))
        pools += [qv.swapaxes(1, 2).copy(), sc.swapaxes(1, 2).copy()]
    # Watermarks: the first position, a block's last, mid-block, the view's
    # last. Entries past a slot's watermark block point at the sink.
    pos = np.asarray([0, bs - 1, bs + bs // 2, NBLK * bs - 1], np.int32)
    table = _table()
    table = np.where(np.arange(NBLK)[None, :] <= (pos // bs)[:, None], table, 0)
    return q, pools, table.astype(np.int32), pos


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_int8_paged_decode_matches_pallas_interpret(bs, rep):
    q, pools, table, pos = _paged_inputs(bs, rep, seed=bs * 10 + rep)
    ref = jk.int8_paged_decode_attention(
        *(jnp.asarray(a) for a in (q, *pools, table, pos)), interpret=True
    )
    got = pk.int8_paged_decode_attention(*(_t(a) for a in (q, *pools, table, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)


def test_paged_read_touches_only_live_entries():
    """Poisoning every position a slot may not read — the unreferenced
    garbage blocks, the sink, and the tail of each slot's last block past
    its watermark — leaves the result bit-identical."""
    q, pools, table, pos = _paged_inputs(8, 2, seed=7)
    args = [_t(a) for a in (q, *pools, table, pos)]
    base = pk.int8_paged_decode_attention(*args)
    ks, vs = args[2].clone(), args[4].clone()
    live = np.zeros((NB, 8), bool)
    for b in range(4):
        for p in range(int(pos[b]) + 1):
            live[table[b, p // 8], p % 8] = True
    dead = torch.from_numpy(~live)[:, None, :].expand(-1, K, -1)
    ks[dead] = 1e6
    vs[dead] = 1e6
    again = pk.int8_paged_decode_attention(args[0], args[1], ks, args[3], vs,
                                           *args[5:])
    torch.testing.assert_close(again, base, atol=0, rtol=0)


def test_paged_kernel_applicable():
    assert pk.paged_kernel_applicable(128, 16, 2)
    assert pk.paged_kernel_applicable(64, 1, 8) and pk.paged_kernel_applicable(16, 256)
    assert not pk.paged_kernel_applicable(136, 16)  # > 128
    assert not pk.paged_kernel_applicable(72, 16)  # not a multiple of 16
    assert not pk.paged_kernel_applicable(128, 0)
    assert not pk.paged_kernel_applicable(128, 16, 3)


def test_wrapper_refuses_bad_operands():
    q, pools, table, pos = (_paged_inputs(4, 2, seed=1))
    args = [_t(a) for a in (q, *pools, table, pos)]
    bad = [
        (5, args[5].long()),  # table not int32
        (6, args[6].long()),  # pos not int32
        (1, args[1].float()),  # payload not int8
        (2, args[2].double()),  # scale not f32
        (0, args[0].repeat(1, 2, 1, 1)),  # two query tokens
        (5, args[5][:2]),  # table rows != B
    ]
    for i, t in bad:
        with pytest.raises(ValueError):
            pk.int8_paged_decode_attention(*args[:i], t, *args[i + 1:])

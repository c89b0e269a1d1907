"""The decode roofline: ``serve.decode_tick_bytes`` against the JAX
package's byte accounting, and ``StreamingGenerator.decode_roofline``
re-rooted from ``tests/test_serve.py`` (its accounting and its ``_pos``
restore) onto the port's dense and paged pools, on the CPU (eager windows
on the host's clock, as the JAX server's off the TPU); plus
``tests/test_timing.py``'s two-point slope cases re-rooted onto
``utils/timing.py``. The CUDA graph windows run on the card
(``chip_smoke.py`` phase ``harness``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models.quant import quantize_params as jax_quantize
from torchkafka_tpu.serve import decode_tick_bytes as jax_tick_bytes
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import (
    H100_PEAK_HBM_GBS,
    StreamingGenerator,
    decode_tick_bytes,
)
from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator
from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
from torchkafka_tpu_torch.utils.timing import two_point_slope

P, MAX_NEW, VOCAB = 8, 8, 64
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)
POOLS = {
    "dense": {},
    "dense_int8": {"kv_dtype": "int8", "kv_kernel": True},
    "paged": {"kv_pages": {"block_size": 4, "num_blocks": 16}},
    "paged_int8": {"kv_pages": {"block_size": 4, "num_blocks": 16},
                   "kv_dtype": "int8", "kv_kernel": True},
}


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, pcfg, pt.params_from_numpy(tree, pcfg, device="cpu")


@pytest.mark.parametrize("quantized", [False, True], ids=["f32_params", "int8_params"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16_pool", "int8_pool"])
def test_decode_tick_bytes_matches_jax(model, kv_int8, quantized):
    _, jparams, _, _ = model
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.bfloat16)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.bfloat16)
    if quantized:
        jparams = jax_quantize(jparams, jcfg)
    params = pt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), pcfg,
                                  device="cpu")
    for batch, max_len in ((2, P + MAX_NEW), (16, 192)):
        ref = jax_tick_bytes(jparams, jcfg, batch, max_len, kv_int8=kv_int8)
        got = decode_tick_bytes(params, pcfg, batch, max_len, kv_int8=kv_int8)
        assert tuple(int(x) for x in ref) == got


def _server(pcfg, params, group, cls=StreamingGenerator, **kw):
    broker = InMemoryBroker()
    broker.create_topic("p", partitions=2)
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, VOCAB, (4, P), dtype=np.int32)
    for i in range(4):
        broker.produce("p", prompts[i].tobytes(), partition=i % 2)
    consumer = MemoryConsumer(broker, "p", group_id=group)
    return cls(consumer, params, pcfg, slots=2, prompt_len=P, max_new=MAX_NEW,
               device="cpu", **kw), consumer


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_decode_roofline_accounting(model, pool):
    """The roofline measures the real tick and reports self-consistent
    byte/bandwidth accounting with the JAX package's keys; the server
    still serves afterwards."""
    _, _, pcfg, params = model
    server, consumer = _server(pcfg, params, "g", **POOLS[pool])
    server.warmup()
    r = server.decode_roofline(iters=2, windows=2)
    for key in ("slope_ok", "fill", "measured_fill_frac", "dispatch_overhead_ms",
                "weight_bytes", "kv_pool_bytes", "kv_read_bytes", "weight_bytes_g",
                "kv_pool_bytes_g", "peak_hbm_gbs", "roofline_tok_s", "device_tick_ms",
                "device_tok_s", "achieved_hbm_gbs", "hbm_roofline_pct"):
        assert key in r, key
    assert r["timer"] == "host" and r["peak_hbm_gbs"] == H100_PEAK_HBM_GBS
    assert r["fill"] == "mid"
    # A degenerate slope is FLAGGED (numeric fields None), never floored.
    if r["slope_ok"]:
        assert r["device_tick_ms"] >= 0
        if r["device_tick_ms"] > 1e-3:
            assert r["device_tok_s"] == pytest.approx(
                2 / (r["device_tick_ms"] / 1e3), rel=0.01)
    else:
        assert r["device_tick_ms"] is None and r["hbm_roofline_pct"] is None
    w, kv = decode_tick_bytes(params, pcfg, 2, P + MAX_NEW,
                              kv_int8=POOLS[pool].get("kv_dtype") == "int8")
    assert (r["weight_bytes"], r["kv_pool_bytes"]) == (w, kv)
    # The fill-bounded reads scale the KV bytes by the measured fill: the
    # mid fill pins 12 = P + MAX_NEW // 2; a 4-tick block advances it to
    # the done latch's 14 = P + MAX_NEW - 2, so the live lengths are 13,
    # 14, 15, 15 of 16.
    assert r["measured_fill_frac"] == pytest.approx(14.25 / 16, abs=1e-3)
    kernel = POOLS[pool].get("kv_kernel") is True
    assert r["kv_read_bytes"] == (round(kv * 14.25 / 16) if kernel else kv)
    total = r["weight_bytes"] + r["kv_read_bytes"]
    assert r["roofline_tok_s"] == pytest.approx(
        2 * r["peak_hbm_gbs"] * 1e9 / total, rel=0.01)
    assert sum(r["probe_launches"].values()) == 0  # the CPU runs no kernel
    assert len(list(server.run(max_records=4))) == 4
    consumer.close()


@pytest.mark.parametrize("pool", ["dense", "paged_int8"])
def test_decode_roofline_restores_pos(model, pool):
    """The 'mid' probe overwrites the positions for its windows: it must
    restore them, and the server must then serve exactly as one never
    probed."""
    _, _, pcfg, params = model
    server, consumer = _server(pcfg, params, "grp", **POOLS[pool])
    server.warmup()
    before = server._pos.clone()
    server.decode_roofline(iters=1, windows=1)
    assert torch.equal(server._pos, before)
    got = {(r.partition, r.offset): t for r, t in server.run(max_records=4)}
    consumer.close()
    plain, c2 = _server(pcfg, params, "grp", **POOLS[pool])
    plain.warmup()
    ref = {(r.partition, r.offset): t for r, t in plain.run(max_records=4)}
    c2.close()
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


def test_decode_roofline_live_fill_and_bad_fill(model):
    _, _, pcfg, params = model
    server, consumer = _server(pcfg, params, "gl")
    server.warmup()
    r = server.decode_roofline(iters=1, windows=1, fill="live")
    # Idle slots sit at position 0 and advance one a tick: mean (1+2+3+4)/4.
    assert r["fill"] == "live"
    assert r["measured_fill_frac"] == pytest.approx(2.5 / 16, abs=1e-3)
    with pytest.raises(ValueError, match="fill must be 'mid' or 'live'"):
        server.decode_roofline(fill="bogus")
    consumer.close()


def test_spec_server_inherits_decode_roofline(model):
    """As in the JAX package, the speculative server inherits the probe:
    it times live rounds with target-only byte accounting, and serves
    afterwards."""
    _, _, pcfg, params = model
    server, consumer = _server(pcfg, params, "gs", cls=SpecStreamingGenerator, k=2)
    server.warmup()
    before = server._pos.clone()
    r = server.decode_roofline(iters=1, windows=1)
    assert torch.equal(server._pos, before)
    assert r["weight_bytes"] == decode_tick_bytes(params, pcfg, 2, server._max_len)[0]
    assert len(list(server.run(max_records=4))) == 4
    consumer.close()


# tests/test_timing.py, re-rooted onto the port's utils/timing.py.
class TestTwoPointSlope:
    def test_cancels_constant_overhead(self):
        per_iter, overhead, ok = two_point_slope(
            0.09 + 0.005 * 8, 0.09 + 0.005 * 40, 8, 40
        )
        assert ok
        assert per_iter == pytest.approx(0.005)
        assert overhead == pytest.approx(0.09)

    def test_degenerate_slope_flagged(self):
        per_iter, _overhead, ok = two_point_slope(0.2, 0.15, 8, 40)
        assert not ok
        assert per_iter == 1e-9

    def test_bad_chain_lengths_rejected(self):
        with pytest.raises(ValueError, match="k_long"):
            two_point_slope(0.1, 0.2, 8, 8)

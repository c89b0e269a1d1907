"""The port's host-RAM KV tier against the JAX package's.

- ``test_tier.py``'s host-tier and radix-times-tier property cases
  (``TestHostTier``, ``TestTieredRadixProperty``) run over the port: the
  module's source is loaded with the package name re-rooted onto
  ``torchkafka_tpu_torch`` and the two classes are collected here.
- Tiered serving at f32 against the JAX package's tiered server on the
  same broker content, at a tenant count where the HBM-only radix tree
  thrashes: tokens, committed watermarks and the tier counters
  (demotions, promotions, hits, occupancy bytes) equal, greedy, sampled,
  on the int8 pool and through a disk-spill tier; and the port's tiered
  run equal to its own HBM-only run, with more prefix hits and fewer
  prefill tokens.
- The server's tier I/O: a block's payload read to the host and written
  into a fresh block is bitwise the original on every pool (f32, bf16,
  int8 payloads and f32 scales).
"""

import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch.kvcache import HostTier, TierConfig
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.utils import prng

_REF = pathlib.Path(__file__).with_name("test_tier.py")
_mod = types.ModuleType("_port_tier")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
exec(compile(_REF.read_text().replace("torchkafka_tpu", "torchkafka_tpu_torch"),
             str(_REF), "exec"), _mod.__dict__)
assert _mod.tk is ptk and _mod.HostTier is HostTier

TestHostTier = _mod.TestHostTier
TestTieredRadixProperty = _mod.TestTieredRadixProperty

P, MAX_NEW, VOCAB, BS = 8, 8, 64, 4
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)
PKG = {"jax": (tk, JaxServer), "port": (ptk, StreamingGenerator)}
TIER = {"capacity_bytes": 1 << 20}


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    return {"jax": (jcfg, jparams), "port": (pcfg, params)}


def _kw(pkg: str, kw: dict) -> dict:
    kw = dict(kw)
    if "rng" in kw:
        kw["rng"] = (jax.random.key if pkg == "jax" else prng.key)(kw["rng"])
    if pkg == "jax":
        if kw.get("kv_dtype") == "int8":
            kw["kv_kernel"] = False
    else:
        if kw.get("kv_dtype") == "int8":
            kw["kv_kernel"] = True  # decode-only ticks through K5's wrapper
        kw["device"] = "cpu"
    return kw


def _serve(pkg, model, prompts, **kw):
    """``test_tier.py``'s thrashing run: 2 slots over a 9-block pool, one
    partition, keys by tenant. Returns tokens by offset, the committed
    watermark, the prefix-cache summary and the server."""
    mod, Server = PKG[pkg]
    cfg, params = model[pkg]
    broker = mod.InMemoryBroker()
    broker.create_topic("p", partitions=1)
    for i in range(prompts.shape[0]):
        broker.produce("p", prompts[i].tobytes(), partition=0, key=str(i % 8).encode())
    consumer = mod.MemoryConsumer(broker, "p", group_id="g")
    server = Server(consumer, params, cfg, slots=2, prompt_len=P, max_new=MAX_NEW,
                    commit_every=4, kv_pages={"block_size": BS, "num_blocks": 9},
                    **_kw(pkg, kw))
    out = {rec.offset: np.asarray(toks).tolist()
           for rec, toks in server.run(max_records=prompts.shape[0])}
    committed = broker.committed("g", mod.TopicPartition("p", 0))
    consumer.close()
    return out, committed, server.metrics.cache_summary(), server


CASES = {
    "greedy": (2, {}),
    "sampled": (9, {"temperature": 0.8, "top_k": 8, "rng": 5}),
    "int8": (4, {"kv_dtype": "int8"}),
    "disk-spill": (6, {"spill": True}),
}


def _tier_kw(kw, tmp_path, pkg):
    kw = dict(kw)
    if kw.pop("spill", False):
        d = tmp_path / f"spill-{pkg}"
        d.mkdir()
        return {**kw, "kv_tier": {"capacity_bytes": 0, "spill_dir": str(d)}}
    return {**kw, "kv_tier": TIER}


@pytest.mark.parametrize("case", list(CASES))
def test_tiered_serving_matches_jax_and_hbm_only(model, tmp_path, case):
    seed, kw = CASES[case]
    prompts = _mod._thrash_prompts(seed=seed)
    ref, ref_wm, ref_cache, ref_server = _serve("jax", model, prompts,
                                                **_tier_kw(kw, tmp_path, "jax"))
    got, wm, cache, server = _serve("port", model, prompts,
                                    **_tier_kw(kw, tmp_path, "port"))
    base, base_wm, base_cache, _ = _serve("port", model, prompts,
                                          **{k: v for k, v in kw.items() if k != "spill"})
    assert len(got) == prompts.shape[0]
    assert got == ref and wm == ref_wm
    assert cache == ref_cache  # hits, prefill tokens, evictions, tier counters
    assert got == base and wm == base_wm
    assert cache["tier"]["demotions"] > 0 and cache["tier"]["promotions"] > 0
    assert cache["tier"]["hits"] == cache["tier"]["promotions"]
    assert cache["hits"] > base_cache["hits"]
    assert cache["prefill_tokens"] < base_cache["prefill_tokens"]
    assert base_cache["tier"]["demotions"] == 0
    if case == "disk-spill":
        assert server._kv_tier.spills > 0 and server._kv_tier.spill_loads > 0
        assert (server._kv_tier.spills, server._kv_tier.spill_loads) == (
            ref_server._kv_tier.spills, ref_server._kv_tier.spill_loads)


def test_tier_metrics_on_exposition(model):
    _, _, _, server = _serve("port", model, _mod._thrash_prompts(seed=2), kv_tier=TIER)
    text = server.metrics.render_prometheus()
    for family in ("radix_demotions_total", "radix_promotions_total",
                   "tier_hits_total", "tier_occupancy_bytes"):
        assert f"torchkafka_serve_{family}" in text, family
    assert "radix_demotions_total 0\n" not in text


def _port_server(model, **kw):
    cfg, params = model["port"]
    broker = ptk.InMemoryBroker()
    broker.create_topic("p", partitions=1)
    consumer = ptk.MemoryConsumer(broker, "p", group_id="g")
    return StreamingGenerator(consumer, params, cfg, slots=2, prompt_len=P,
                              max_new=MAX_NEW, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    {}, {"kv_dtype": "int8"}, {"dtype": torch.bfloat16},
], ids=["f32", "int8", "bf16"])
def test_tier_block_round_trip_is_bitwise(model, kw):
    """Each pool's slice at one block, read to the host and written into
    another block, is that block's bytes exactly; the host copy shares no
    memory with the pool."""
    kw = dict(kw)
    if "dtype" in kw:
        cfg = pt.TransformerConfig(**SHAPE, dtype=kw.pop("dtype"),
                                   param_dtype=torch.float32)
        m = {"port": (cfg, model["port"][1])}
    else:
        m = model
    server = _port_server(m, kv_pages={"block_size": BS, "num_blocks": 9},
                          kv_tier=TIER, **kw)
    g = torch.Generator().manual_seed(3)
    for p in server._pools:
        if p.dtype == torch.int8:
            p.copy_(torch.randint(-128, 128, p.shape, generator=g, dtype=torch.int8))
        else:
            p.copy_(torch.randn(p.shape, generator=g).to(p.dtype))
    assert len(server._pools) == (4 if kw.get("kv_dtype") else 2)
    payload = server._tier_read_block(3)
    before = [p[:, 3].clone() for p in server._pools]
    for p in server._pools:
        p[:, 3] = 0  # the host copy must not follow the pool
    server._tier_write_block(5, payload)
    for p, b in zip(server._pools, before):
        assert torch.equal(p[:, 5].view(torch.uint8), b.view(torch.uint8))
    assert sum(a.nbytes for a in payload) == sum(b.numel() * b.element_size()
                                                for b in before)


def test_kv_tier_needs_pages(model):
    """As in JAX: the tier tiers the paged radix cache."""
    with pytest.raises(ValueError, match="kv_tier requires kv_pages"):
        _port_server(model, kv_tier=TIER)
    with pytest.raises(ValueError, match="kv_tier requires kv_pages"):
        _port_server(model, kv_tier=TierConfig(capacity_bytes=1))


def test_tier_config_takes_a_dict_or_a_config(model):
    for tier in (TIER, TierConfig(**TIER)):
        server = _port_server(model, kv_pages={"block_size": BS, "num_blocks": 9},
                              kv_tier=tier)
        assert isinstance(server._kv_tier, HostTier)
        assert server._kv_tier.config.capacity_bytes == TIER["capacity_bytes"]


def test_fallback_to_dense_drops_the_tier(model):
    """A pool too small for one slot falls back to the dense pool, with no
    tier, as in JAX."""
    server = _port_server(model, kv_pages={"block_size": BS, "num_blocks": 3},
                          kv_tier=TIER)
    assert server._kv_pages is None and server._kv_tier is None
    assert server.metrics.summary()["prefix_cache"]["fallbacks"] == 1

"""The port's speculative server (``serve_spec.py``) against the JAX
package's.

- ``test_serve_spec.py`` runs over the port: the module's source is
  loaded with the package name re-rooted onto ``torchkafka_tpu_torch``
  and its classes are collected here (token exactness against the plain
  server, EOS, rounds per sync 1 and 3, the perfect and the deeper
  self-draft, chaos commit parity and survivability, validation, stats
  before serving), without the mesh case (meshes are not ported). Its
  JAX spellings are bound to the port's: the key is a seeded
  ``torch.Generator``, ``init_params`` draws on the CPU, ``jnp.float32``
  is ``torch.float32``, and both servers run on the CPU.
- Differentials at f32 from JAX's ``init_params`` through
  ``params_from_numpy``, one seeded broker content through both
  speculative servers, each traced under a manual clock: tokens,
  committed offsets, ``spec_stats()``, the prefix-cache counters and the
  trace event list equal to the JAX package's on the dense pool (the
  self-draft with an EOS, the perfect draft), the legacy paged pool and
  the chunked paged pool; a draft hot-swapped in the middle of a run;
  and the host-RAM tier over a thrashing tenant stream (also equal to the
  port's HBM-only speculative run). Each JAX run is made once per module.
- ``swap_draft_params``: JAX's structural ``ValueError``s, and a death at
  ``draft_swap_pre_apply`` leaves the incumbent draft bound.
"""

import dataclasses
import functools
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
from torchkafka_tpu.serve_spec import SpecStreamingGenerator as JaxSpec
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.resilience import crashpoint
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator

_REF = pathlib.Path(__file__).with_name("test_serve_spec.py")
_mod = types.ModuleType("_port_serve_spec")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
_JAX_IMPORTS = "import jax\nimport jax.numpy as jnp\n"
_src = _REF.read_text()
assert _src.count(_JAX_IMPORTS) == 1
_mod.jax = types.SimpleNamespace(
    random=types.SimpleNamespace(key=lambda seed: torch.Generator().manual_seed(seed)),
)
_mod.jnp = types.SimpleNamespace(float32=torch.float32)
exec(compile(_src.replace(_JAX_IMPORTS, "").replace("torchkafka_tpu", "torchkafka_tpu_torch"),
             str(_REF), "exec"), _mod.__dict__)
assert _mod.tk is ptk and _mod.SpecStreamingGenerator is SpecStreamingGenerator
_mod.init_params = lambda gen, cfg: pt.init_params(gen, cfg, device="cpu")
_mod.StreamingGenerator = functools.partial(StreamingGenerator, device="cpu")
_mod.SpecStreamingGenerator = functools.partial(SpecStreamingGenerator, device="cpu")

model = _mod.model  # the collected classes' fixture: (cfg, params) on the CPU
TestSpecTokenExactness = _mod.TestSpecTokenExactness
TestSpecCommitExactness = _mod.TestSpecCommitExactness


class TestSpecValidation(_mod.TestSpecValidation):
    test_mesh_spec_token_exact = None  # meshes are not ported


P, MAX_NEW, VOCAB, BS, SLOTS, N = 8, 8, 64, 4, 4, 10
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)
PKG = {"jax": (tk, JaxSpec), "port": (ptk, SpecStreamingGenerator)}


def _pages(chunk, num_blocks=48):
    return {"block_size": BS, "num_blocks": num_blocks, "prefill_chunk": chunk}


def _jax_and_port(shape, seed):
    jcfg = jt.TransformerConfig(**shape, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**shape, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    return {"jax": (jcfg, jparams), "port": (pcfg, params)}


@pytest.fixture(scope="module")
def pkgs():
    return _jax_and_port(SHAPE, 0)


@pytest.fixture(scope="module")
def new_draft():
    """A second 1-layer draft with the self-draft's structure."""
    return _jax_and_port(dict(SHAPE, n_layers=1), 7)


def _prompts(n=N, seed=7):
    prompts = np.random.default_rng(seed).integers(0, VOCAB, (n, P), dtype=np.int32)
    prompts[:, :5] = np.arange(5, dtype=np.int32)  # one shared radix block
    return prompts


def _tracer(mod):
    """A tracer on a manual clock that steps 1 ms at every reading."""
    mc = mod.ManualClock()

    def clock():
        mc.advance(0.001)
        return mc.now()

    return mod.RecordTracer(mod.ObsConfig(clock=clock))


def _serve(pkg, pkgs, prompts, *, perfect=False, swap=None, slots=SLOTS, parts=2,
           cls=None, **kw):
    """One traced serve of ``prompts`` (keyed by tenant i % 8) through
    ``pkg``'s speculative server (``cls``: another server class).
    ``perfect``: the target as its own draft; ``swap``: {pkg: (draft
    cfg, draft params)} hot-swapped in once the second completion is
    out."""
    mod, Server = PKG[pkg]
    cfg, params = pkgs[pkg]
    broker = mod.InMemoryBroker()
    broker.create_topic("p", partitions=parts)
    for i in range(prompts.shape[0]):
        broker.produce("p", prompts[i].tobytes(), partition=i % parts,
                       key=str(i % 8).encode())
    consumer = mod.MemoryConsumer(broker, "p", group_id="g")
    if perfect:
        kw.update(draft_params=params, draft_cfg=cfg)
    if pkg == "port":
        kw["device"] = "cpu"
    tracer = _tracer(mod)
    server = (cls or Server)(consumer, params, cfg, slots=slots, prompt_len=P,
                             max_new=MAX_NEW, commit_every=4, tracer=tracer, **kw)
    got = {}
    for rec, toks in server.run(max_records=prompts.shape[0]):
        got[(rec.partition, rec.offset)] = np.asarray(toks).tolist()
        if swap is not None and len(got) == 2:
            dcfg, dparams = swap[pkg]
            server.swap_draft_params(dparams, dcfg)
    consumer.close()
    return {
        "tokens": got,
        "committed": [broker.committed("g", mod.TopicPartition("p", p)) or 0
                      for p in range(parts)],
        "stats": server.spec_stats() if hasattr(server, "spec_stats") else None,
        "cache": server.metrics.cache_summary(),
        "events": [e.to_json() for e in tracer.events],
        "server": server,
    }


MODES = {
    "dense-eos": dict(k=3, eos_id=14),  # 14 ends some records mid-round
    "dense-perfect": dict(k=2, perfect=True),
    "paged-legacy": dict(k=2, kv_pages=_pages(0)),
    "paged-chunked": dict(k=2, kv_pages=_pages(5)),
}


@pytest.fixture(scope="module")
def jax_runs(pkgs, new_draft):
    """The JAX speculative server's runs, each made once per module."""
    cache: dict = {}

    def get(mode, prompts=None, **kw):
        key = (mode, repr(sorted(kw.items())))
        if key not in cache:
            if mode == "swap":
                kw["swap"] = {"jax": new_draft["jax"]}
            cache[key] = _serve("jax", pkgs, _prompts() if prompts is None else prompts,
                                **kw)
        return cache[key]

    return get


def _same(got, ref):
    assert got["tokens"] == ref["tokens"]
    assert got["committed"] == ref["committed"]
    assert got["stats"] == ref["stats"]
    assert got["cache"] == ref["cache"]
    assert got["events"] == ref["events"]


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_server_matches_jax(pkgs, jax_runs, mode):
    kw = MODES[mode]
    ref = jax_runs(mode, **kw)
    got = _serve("port", pkgs, _prompts(), **kw)
    _same(got, ref)
    assert len(got["tokens"]) == N and got["stats"]["proposed"] > 0
    plain = _serve("port", pkgs, _prompts(), cls=StreamingGenerator,
                   eos_id=kw.get("eos_id"))
    assert got["tokens"] == plain["tokens"]  # the draft sets only the speed
    assert got["committed"] == plain["committed"]
    if kw.get("perfect"):
        assert got["stats"]["acceptance"] == 1.0
    if "kv_pages" in kw:
        assert got["cache"]["hits"] > 0
    if mode == "dense-eos":
        assert any(len(t) < MAX_NEW for t in got["tokens"].values())
    if mode == "paged-chunked":
        assert got["server"].metrics.chunk_ticks.count > 0


def test_draft_hot_swap_mid_run_matches_jax(pkgs, jax_runs, new_draft):
    """The draft swapped between two tick blocks: the tokens stay the
    target's, and the counters follow JAX's swapped run."""
    ref = jax_runs("swap", k=2)
    got = _serve("port", pkgs, _prompts(), k=2, swap={"port": new_draft["port"]})
    _same(got, ref)
    assert got["server"]._draft_params["embed"] is new_draft["port"][1]["embed"]
    plain = _serve("port", pkgs, _prompts(), cls=StreamingGenerator)
    assert got["tokens"] == plain["tokens"]


def _thrash_prompts(tenants=8, rounds=3, seed=3):
    t = np.random.default_rng(seed).integers(0, VOCAB, (tenants, P), dtype=np.int32)
    return np.stack([t[i % tenants] for i in range(tenants * rounds)])


def test_tiered_spec_matches_jax_and_hbm_only(pkgs, jax_runs):
    """``test_tier.py``'s thrashing stream (8 tenants revisited three
    times, 2 slots, one spare block): the tier's payload carries both
    models' pools, and a promoted block reads as the re-prefill it
    replaces."""
    kw = dict(k=2, slots=2, parts=1, kv_pages=_pages(None, 11),
              kv_tier={"capacity_bytes": 1 << 20})
    prompts = _thrash_prompts()
    ref = jax_runs("tier", prompts=prompts, **kw)
    got = _serve("port", pkgs, prompts, **kw)
    _same(got, ref)
    base = _serve("port", pkgs, prompts, **{**kw, "kv_tier": None})
    assert got["tokens"] == base["tokens"] and got["committed"] == base["committed"]
    tier = got["cache"]["tier"]
    assert tier["demotions"] > 0 and tier["hits"] == tier["promotions"] > 0
    assert got["cache"]["prefill_tokens"] < base["cache"]["prefill_tokens"]
    payload = got["server"]._tier_read_block(1)
    assert len(payload) == 4  # target k, v and draft k, v


def _spec_server(pkgs, **kw):
    cfg, params = pkgs["port"]
    broker = ptk.InMemoryBroker()
    broker.create_topic("p", partitions=1)
    return SpecStreamingGenerator(
        ptk.MemoryConsumer(broker, "p", group_id="g"), params, cfg, slots=2,
        prompt_len=P, max_new=MAX_NEW, device="cpu", **kw,
    )


def test_swap_draft_params_validates_like_jax(pkgs, new_draft):
    server = _spec_server(pkgs)
    jserver = JaxSpec(object(), *reversed(pkgs["jax"]), slots=2, prompt_len=P,
                      max_new=MAX_NEW)
    dcfg, dparams = new_draft["port"]
    jdcfg, jdparams = new_draft["jax"]
    for srv, params, cfg in ((server, dparams, dcfg), (jserver, jdparams, jdcfg)):
        with pytest.raises(ValueError, match="structurally identical"):
            srv.swap_draft_params(params, dataclasses.replace(cfg, n_layers=2))
        with pytest.raises(ValueError, match="structurally identical"):
            srv.swap_draft_params(params, dataclasses.replace(cfg, d_model=64, n_heads=4))
        with pytest.raises(ValueError, match="tree structure mismatch"):
            srv.swap_draft_params({k: v for k, v in params.items() if k != "ln_f"})
        with pytest.raises(ValueError, match="tree structure mismatch"):
            srv.swap_draft_params(dict(params, layers={
                k: v for k, v in params["layers"].items() if k != "wq"}))
    server.swap_draft_params(dparams, dcfg)
    assert server._draft_params["layers"]["wq"] is dparams["layers"]["wq"]
    assert server._draft_layers[0]["wq"].shape == dparams["layers"]["wq"].shape[1:]


def test_swap_death_before_apply_keeps_the_incumbent(pkgs, new_draft):
    server = _spec_server(pkgs)
    before = server._draft_params
    crashpoint.arm("draft_swap_pre_apply", mode="raise")
    try:
        with pytest.raises(crashpoint.CrashPointInjected):
            server.swap_draft_params(new_draft["port"][1])
    finally:
        crashpoint.disarm()
    assert server._draft_params is before


def test_spec_pools_and_counters(pkgs):
    """Dense: target and draft pools hold P + max_new + k positions; paged:
    four block pools under one table; the counters start at zero and the
    default draft is the first half of the target's layers, as views."""
    cfg, params = pkgs["port"]
    dense = _spec_server(pkgs, k=3)
    assert [tuple(c.shape) for c in dense._caches] == [
        (2, 2, P + MAX_NEW + 3, 1, 16)] * 2 + [(1, 2, P + MAX_NEW + 3, 1, 16)] * 2
    assert dense._draft_cfg.n_layers == 1
    assert dense._draft_params["layers"]["wq"].data_ptr() == params["layers"]["wq"].data_ptr()
    assert dense.spec_stats() == {"rounds": 0, "proposed": 0, "accepted": 0,
                                  "acceptance": None, "k": 3, "draft_layers": 1}
    paged = _spec_server(pkgs, k=3, kv_pages=_pages(None, 16))
    assert [tuple(p.shape) for p in paged._pools] == [
        (2, 16, BS, 1, 16)] * 2 + [(1, 16, BS, 1, 16)] * 2
    assert paged._blocks_per_slot == -(-(P + MAX_NEW + 3) // BS)


def test_mesh_serves_on_a_one_process_mesh(pkgs):
    """``mesh=`` on a one-rank mesh in this process (the one-process group
    ``make_mesh`` starts): both models are laid out through their
    ``ServingShard``s, and the completions, commits and counters equal
    the mesh-less speculative server's (the 8-rank meshes are
    tests/test_torch_serve_mesh.py's)."""
    from torchkafka_tpu_torch.parallel import multihost

    def serve(**kw):
        cfg, params = pkgs["port"]
        broker = ptk.InMemoryBroker()
        broker.create_topic("p", partitions=1)
        prompts = np.random.default_rng(3).integers(0, VOCAB, (4, P), dtype=np.int32)
        for row in prompts:
            broker.produce("p", row.tobytes())
        consumer = ptk.MemoryConsumer(broker, "p", group_id="g")
        server = SpecStreamingGenerator(consumer, params, cfg, slots=2, prompt_len=P,
                                        max_new=MAX_NEW, k=2, device="cpu", **kw)
        out = [(rec.offset, toks.tolist()) for rec, toks in server.run(max_records=4)]
        server.close()
        return out, broker.committed("g", ptk.TopicPartition("p", 0)), server.spec_stats()

    started = not torch.distributed.is_initialized()
    try:
        got = serve(mesh=ptk.make_mesh({"data": 1}, device="cpu"))
    finally:
        if started:
            multihost.shutdown()
    assert got == serve() and got[1] == 4


def test_weight_rebinds_drop_the_captured_block(pkgs, new_draft):
    """A captured tick block reads the weights it was captured over: a
    draft swap and a target swap both drop it, so the next block on the
    card captures anew. On the CPU the serving loop runs the eager block
    and captures nothing."""
    server = _spec_server(pkgs)
    server.warmup()
    active = torch.zeros((2,), dtype=torch.bool)
    assert server._serve_block(active) is not None
    assert server._block_graph is None
    server._block_graph = "captured"
    dcfg, dparams = new_draft["port"]
    server.swap_draft_params(dparams, dcfg)
    assert server._block_graph is None
    server._block_graph = "captured"
    server.swap_params(pkgs["port"][1], version=2)
    assert server._block_graph is None

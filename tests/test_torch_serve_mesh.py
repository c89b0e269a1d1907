"""The port's sharded serving (``mesh=`` on ``generate``, the server, the
speculative server, disaggregated prefill and the distill trainer;
harness scenario 20) against the JAX package at f32.

One gloo group of 8 processes runs every case once
(tests/_torch_serve_mesh_cases.py, mode ``serve_mesh``); the JAX
references compile in threads while the ranks run. Parameters are the JAX
``init_params`` at the JAX tests' tiny configs, through
``params_from_numpy``. The JAX side runs the same mesh where the JAX
package's own tier-1 test runs that mesh (``generate`` and the dense
servers of ``tests/test_generate.py``/``tests/test_serve.py``) and its
mesh-less server elsewhere (the paged, speculative and disaggregated mesh
cases, whose mesh-exactness the JAX package's slow tests hold). Tokens are
held exact, committed offsets equal; on every rank each completion is
yielded once, in the same order, and only the root commits or sends.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
from torchkafka_tpu.models import generate as jg
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchkafka_tpu.serve import StreamingGenerator as JServer
from torchkafka_tpu.serve_spec import SpecStreamingGenerator as JSpec
from torchkafka_tpu_torch.models import generate as pg
from torchkafka_tpu_torch.models import transformer as pt

from tests.test_torch_pod import diagnose, read, spawn_pod, wait_all

NPROC = 8
P, MAX_NEW, VOCAB, BS = 8, 8, 64, 4
PAGES = {"block_size": BS, "num_blocks": 40}
# tests/test_generate.py TestMeshShardedGenerate's config, and the mesh
# model of tests/test_serve.py / test_kvcache.py / test_disagg.py.
GEN_CFG = dict(vocab_size=96, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96,
               max_seq_len=64)
MESH_CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=64,
                max_seq_len=P + MAX_NEW)
MOE_CFG = dict(MESH_CFG, n_experts=4)
ALL = list(range(NPROC))
SAMPLED = {"temperature": 0.9, "top_k": 16}

# name → (fn, axes, ranks, cfg, params key, prompts key, extra)
CASES = {
    "gen_data4_tp2": ("generate", {"data": 4, "tp": 2}, ALL, GEN_CFG, "gen", "gen_prompt", {}),
    "gen_data2_fsdp2_tp2": ("generate", {"data": 2, "fsdp": 2, "tp": 2}, ALL, GEN_CFG, "gen",
                            "gen_prompt", {}),
    "gen_int8_data2_fsdp2_tp2": ("generate", {"data": 2, "fsdp": 2, "tp": 2}, ALL, GEN_CFG,
                                 "gen", "gen_prompt", {"quantized": True}),
    "serve_data2_fsdp2_tp2": ("serve", {"data": 2, "fsdp": 2, "tp": 2}, ALL, MESH_CFG, "mesh",
                              "serve_prompts", {"slots": 4, "commit_every": 1}),
    "serve_data4_tp2": ("serve", {"data": 4, "tp": 2}, ALL, MESH_CFG, "mesh", "serve_prompts",
                        {"slots": 4, "commit_every": 1}),
    "serve_int8_data2_tp2_fsdp2": ("serve", {"data": 2, "tp": 2, "fsdp": 2}, ALL, MESH_CFG,
                                   "mesh", "serve_prompts",
                                   {"slots": 4, "commit_every": 1, "kw": {"kv_dtype": "int8"}}),
    "moe_data2_ep2_tp2": ("serve", {"data": 2, "ep": 2, "tp": 2}, ALL, MOE_CFG, "moe",
                          "moe_prompts", {"slots": 2, "commit_every": 1}),
    "paged_int8_data2_tp2": ("serve", {"data": 2, "tp": 2}, [4, 5, 6, 7], MESH_CFG, "mesh",
                             "paged_prompts",
                             {"slots": 4, "commit_every": 4,
                              "kw": {"kv_dtype": "int8", "kv_kernel": True,
                                     "kv_pages": PAGES}}),
    "scenario20_data2_tp2": ("scenario20", {"data": 2, "tp": 2}, [0, 1, 2, 3], None, None,
                             None, {}),
    "paged_tp2_greedy": ("serve", {"tp": 2}, [4, 5], MESH_CFG, "mesh", "paged10",
                         {"slots": 4, "commit_every": 4, "kw": {"kv_pages": PAGES}}),
    "paged_tp2_sampled": ("serve", {"tp": 2}, [4, 5], MESH_CFG, "mesh", "paged10",
                          {"slots": 4, "commit_every": 4,
                           "kw": {"kv_pages": PAGES, "rng": 11, **SAMPLED}}),
    "spec_data2": ("spec", {"data": 2}, [6, 7], MESH_CFG, "mesh", "spec_prompts",
                   {"slots": 4, "commit_every": 4, "kw": {"k": 2}}),
    "disagg_tp2": ("disagg", {"tp": 2}, [4, 5], MESH_CFG, "mesh", "disagg_prompts",
                   {"pages": PAGES}),
    "distill_data2": ("distill", {"data": 2}, [6, 7], MESH_CFG, "mesh", None,
                      {"frames": "frames", "frame_ends": "frame_ends"}),
}
SERVERS = [n for n, c in CASES.items() if c[0] in ("serve", "spec", "disagg")]


def _jcfg(cfg: dict):
    return jt.TransformerConfig(**cfg, dtype=jnp.float32, param_dtype=jnp.float32)


def _np_tree(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree) -> dict:
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _prompts(n, seed=7, shared=0):
    prompts = np.random.default_rng(seed).integers(0, VOCAB, (n, P), dtype=np.int32)
    if shared:
        prompts[:, :shared] = np.arange(shared, dtype=np.int32)
    return prompts


def _frames():
    from torchkafka_tpu.distill import encode_completion

    rng = np.random.default_rng(5)
    out = []
    for i in range(12):
        prompt = rng.integers(0, VOCAB, P, dtype=np.int32)
        toks = rng.integers(0, VOCAB, MAX_NEW, dtype=np.int32)
        out.append(encode_completion(prompt, toks, tenant=f"t{i % 3}".encode(),
                                     model_version=0))
    return out


def _jax_generate(axes, params, prompt, quantized):
    cfg = _jcfg(GEN_CFG)
    if quantized:
        from torchkafka_tpu.models.quant import quantize_params

        params = quantize_params(params, cfg)
    mesh = _mesh(axes)
    sharded = jax.device_put(params, jg.serving_shardings(cfg, mesh, params))
    return np.asarray(jax.jit(lambda p, t: jg.generate(p, cfg, t, 6, mesh=mesh))(
        sharded, jnp.asarray(prompt)))


def _jax_serve(cls, cfg, params, prompts, axes, slots, commit_every, **kw):
    broker = tk.InMemoryBroker()
    broker.create_topic("p", partitions=2)
    for i in range(prompts.shape[0]):
        broker.produce("p", prompts[i].tobytes(), partition=i % 2)
    consumer = tk.MemoryConsumer(broker, "p", group_id="g")
    mesh = None if axes is None else _mesh(axes)
    server = cls(consumer, params, cfg, slots=slots, prompt_len=P, max_new=MAX_NEW,
                 commit_every=commit_every, mesh=mesh, **kw)
    out = [(f"{rec.partition}:{rec.offset}", np.asarray(toks).tolist())
           for rec, toks in server.run(max_records=prompts.shape[0])]
    server.close()
    committed = {str(p): broker.committed("g", tk.TopicPartition("p", p)) for p in (0, 1)}
    consumer.close()
    return {"tokens": dict(out), "committed": committed}


def _jax_disagg(cfg, params, prompts):
    import test_disagg as jd

    out, committed, dgen, pgen = jd._disagg(cfg, params, prompts)
    return {"tokens": {f"{p}:{o}": np.asarray(t).tolist() for (p, o), t in out.items()},
            "committed": {str(p): c for p, c in committed.items()},
            "adopted": dgen.metrics.adopted_slots.count}


def _jax_distill(cfg, params, frames):
    from torchkafka_tpu.distill import DistillTrainer

    broker = tk.InMemoryBroker()
    broker.create_topic("d", partitions=1)
    for f in frames:
        broker.produce("d", f)
    consumer = tk.MemoryConsumer(broker, "d", group_id="tr")
    trainer = DistillTrainer(consumer, params, cfg, seq_len=P + MAX_NEW, batch_size=4,
                             draft_layers=1, learning_rate=5e-3)
    report = trainer.run(idle_timeout_ms=200)
    consumer.close()
    return report


def _jax_scenario20():
    from torchkafka_tpu.harness.scenarios import scenario_20

    return scenario_20("tiny")


def _write(outdir, group: str, arrays: dict) -> None:
    """One group of the ranks' inputs (``_torch_serve_mesh_cases._Inputs``),
    renamed into place when whole."""
    tmp = outdir / f"serve_mesh_in_{group}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, outdir / f"serve_mesh_in_{group}.npz")


def _jax_references(outdir) -> dict:
    """Writes the ranks' inputs to ``outdir`` (the prompts and distill
    frames, then each JAX parameter tree as it is built) and runs every JAX
    reference in threads, each as soon as its parameters exist."""
    inputs = {
        "gen_prompt": np.random.default_rng(1).integers(0, 96, (4, 8)).astype(np.int32),
        "serve_prompts": _prompts(10),
        "moe_prompts": _prompts(6),
        "paged_prompts": _prompts(8, shared=5),
        "paged10": _prompts(10, shared=5),
        "spec_prompts": _prompts(8, shared=5),
        "disagg_prompts": _prompts(8, shared=5),
    }
    frames = _frames()
    _write(outdir, "inputs", dict(inputs, frames=np.frombuffer(b"".join(frames), np.uint8),
                                  frame_ends=np.cumsum([0] + [len(f) for f in frames])))
    jcfg, jmoe = _jcfg(MESH_CFG), _jcfg(MOE_CFG)
    sampled = dict(SAMPLED, rng=jax.random.key(11))
    d2f2t2 = {"data": 2, "fsdp": 2, "tp": 2}
    with ThreadPoolExecutor(4) as pool:
        # Scenario 20, the longest, builds its own model.
        jobs = {"scenario20_data2_tp2": pool.submit(_jax_scenario20)}
        jp = jt.init_params(jax.random.key(0), _jcfg(GEN_CFG))
        _write(outdir, "gen", _flat(_np_tree(jp)))
        gp = inputs["gen_prompt"]
        jobs.update({
            "gen_int8_data2_fsdp2_tp2": pool.submit(_jax_generate, d2f2t2, jp, gp, True),
            "gen_data4_tp2": pool.submit(_jax_generate, {"data": 4, "tp": 2}, jp, gp, False),
            "gen_data2_fsdp2_tp2": pool.submit(_jax_generate, d2f2t2, jp, gp, False),
        })
        mp = jt.init_params(jax.random.key(0), jcfg)
        _write(outdir, "mesh", _flat(_np_tree(mp)))
        jobs.update({
            "distill_data2": pool.submit(_jax_distill, jcfg, mp, frames),
            "serve_data2_fsdp2_tp2": pool.submit(_jax_serve, JServer, jcfg, mp,
                                                 inputs["serve_prompts"], d2f2t2, 4, 1),
            "serve_data4_tp2": pool.submit(_jax_serve, JServer, jcfg, mp,
                                           inputs["serve_prompts"], {"data": 4, "tp": 2}, 4, 1),
            "serve_int8_data2_tp2_fsdp2": pool.submit(
                _jax_serve, JServer, jcfg, mp, inputs["serve_prompts"],
                {"data": 2, "tp": 2, "fsdp": 2}, 4, 1, kv_dtype="int8"),
        })
        moe = jt.init_params(jax.random.key(2), jmoe)
        _write(outdir, "moe", _flat(_np_tree(moe)))
        jobs.update({
            "moe_data2_ep2_tp2": pool.submit(_jax_serve, JServer, jmoe, moe,
                                             inputs["moe_prompts"], {"data": 2, "ep": 2,
                                                                     "tp": 2}, 2, 1),
            "paged_int8_data2_tp2": pool.submit(_jax_serve, JServer, jcfg, mp,
                                                inputs["paged_prompts"], None, 4, 4,
                                                kv_dtype="int8"),
            "paged_tp2_greedy": pool.submit(_jax_serve, JServer, jcfg, mp, inputs["paged10"],
                                            None, 4, 4),
            "paged_tp2_sampled": pool.submit(_jax_serve, JServer, jcfg, mp, inputs["paged10"],
                                             None, 4, 4, **sampled),
            "spec_data2": pool.submit(_jax_serve, JSpec, jcfg, mp, inputs["spec_prompts"],
                                      None, 4, 4, k=2),
            "disagg_tp2": pool.submit(_jax_disagg, jcfg, mp, inputs["disagg_prompts"]),
        })
        return {n: j.result() for n, j in jobs.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("serve_mesh")
    cases = []
    for name, (fn, axes, ranks, cfg, pkey, prompts, extra) in CASES.items():
        c = {"name": name, "fn": fn, "axes": axes, "ranks": ranks, "cfg": cfg,
             "params": pkey, "prompts": prompts, "max_new": 6, **extra}
        if ranks == ALL:
            c["ranks"] = None
        cases.append(c)
    (outdir / "serve_mesh_cases.json").write_text(json.dumps(cases))
    # The ranks start (and wait for their inputs) while JAX builds them.
    procs = spawn_pod(NPROC, str(outdir), "serve_mesh")
    try:
        refs = _jax_references(outdir)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    codes = wait_all(procs, str(outdir), timeout_s=400)
    assert codes == [0] * NPROC, diagnose(procs, str(outdir))
    infos = [read(str(outdir), "serve_mesh", pid) for pid in range(NPROC)]
    return {"refs": refs, "infos": infos}


def _ranks_of(name):
    ranks = CASES[name][2]
    return ranks


def _results(run, name):
    """[(global rank, result)] of the ranks that ran case ``name``."""
    return [(r, run["infos"][r][name]) for r in _ranks_of(name)]


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[0] == "generate"])
def test_generate_tokens_equal_jax(run, name):
    """Every rank returns the whole [B, 6]: JAX's mesh generate's (int8:
    on the quantized tree)."""
    want = run["refs"][name]
    for r, res in _results(run, name):
        np.testing.assert_array_equal(np.asarray(res["tokens"]), want, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", SERVERS)
def test_server_tokens_and_commits_equal_jax(run, name):
    """The root's completions equal JAX's token for token at f32, and its
    committed offsets JAX's; every other rank yields the same completions
    in the same order, each once, and commits nothing."""
    want = run["refs"][name]
    results = _results(run, name)
    root_yields = results[0][1]["yields"]
    keys = [k for k, _ in root_yields]
    assert len(keys) == len(set(keys)) == len(want["tokens"])
    assert dict(root_yields) == want["tokens"]
    assert results[0][1]["committed"] == want["committed"]
    for r, res in results[1:]:
        assert res["yields"] == root_yields, f"rank {r}"
        assert res["committed"] is None


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[0] in ("serve", "spec")])
def test_only_the_root_sends_outputs(run, name):
    """Every rank's server was handed an output producer; only the root's
    sent anything, one record a completion."""
    results = _results(run, name)
    assert results[0][1]["sent"] == len(results[0][1]["yields"])
    assert all(res["sent"] == 0 for _, res in results[1:])


def test_int8_pool_holds_local_shards(run):
    """The int8 pool on {"data": 2, "tp": 2, "fsdp": 2}: K-major payloads
    [L, B/data, K/tp, M, Dh] and scales [L, B/data, K/tp, M] allocated at
    the rank's shape (K4's operands), the backend recording the mesh."""
    for _, res in _results(run, "serve_int8_data2_tp2_fsdp2"):
        assert res["pool_shapes"] == [[2, 2, 1, 16, 16], [2, 2, 1, 16]] * 2
        kb = res["kv_backend"]
        assert kb["kernel"] and kb["data"] == 2 and kb["tp"] == 2


def test_decode_roofline_refuses_a_tick_with_collectives(run):
    """Under tp (and fsdp, ep) a tick runs gloo collectives, which a CUDA
    graph cannot capture: ``decode_roofline`` raises, saying why."""
    for name in ("serve_data4_tp2", "paged_tp2_greedy", "moe_data2_ep2_tp2"):
        for _, res in _results(run, name):
            assert "runs collectives" in res["roofline"], res["roofline"]


def test_experts_split_over_ep(run):
    """ep-sharded MoE: a rank holds E/ep experts, each one's d_ff over tp."""
    for _, res in _results(run, "moe_data2_ep2_tp2"):
        assert res["w_gate"] == [2, 2, 32, 32]


def test_paged_int8_kernel_on_the_mesh(run):
    """Paged int8 through the block-table read on {"data": 2, "tp": 2}:
    blocks replicated over data ([L, NB, K/tp, bs, Dh]), the backend says
    so, the radix cache hits, and the tokens are the int8-dense
    single-process server's (test_server_tokens_and_commits_equal_jax)."""
    for _, res in _results(run, "paged_int8_data2_tp2"):
        assert res["pool_shapes"] == [[2, 40, 1, BS, 16], [2, 40, 1, BS]] * 2
        kb = res["kv_backend"]
        assert kb["layout"] == "paged" and kb["kernel_engaged"] == 1
        assert (kb["data"], kb["tp"]) == (2, 2)
        assert res["cache_hits"] > 0


def test_spec_counters_sum_over_data(run):
    """The speculative server on {"data": 2}: every rank reports the
    summed proposals and acceptances (one collective)."""
    results = _results(run, "spec_data2")
    stats = [res["spec"] for _, res in results]
    assert stats[0] == stats[1] and stats[0]["proposed"] > 0


def test_disagg_adopts_every_handoff(run):
    """Disaggregated prefill on {"tp": 2}: the handoffs carry every kv head
    (gathered over tp) and each adoption scatters this rank's back; every
    slot adopted, the decode side prefilled nothing, JAX's count."""
    want = run["refs"]["disagg_tp2"]
    for _, res in _results(run, "disagg_tp2"):
        assert res["adopted"] == want["adopted"] == 8
        assert res["decode_prefill_tokens"] == 0 and res["published"] == 8


def test_distill_trainer_matches_jax(run):
    """The distill trainer on {"data": 2} (the mesh train step, each rank
    its half of the root's batches) against JAX's over the same corpus."""
    want = run["refs"]["distill_data2"]
    for _, res in _results(run, "distill_data2"):
        got = res["report"]
        assert {k: v for k, v in got.items() if k != "loss"} == {
            k: v for k, v in want.items() if k != "loss"}
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_scenario_20_summary_equals_jax(run):
    """Harness scenario 20 on the four ranks of a {"data": 2, "tp": 2}
    mesh: the root's summary equals the JAX package's apart from its
    timings and the kernel fields of its backend (the port's "auto" read
    runs on CUDA only); the other ranks report nothing."""
    want = dict(run["refs"]["scenario20_data2_tp2"])
    results = _results(run, "scenario20_data2_tp2")
    got = dict(results[0][1]["summary"])
    for s in (got, want):
        for k in ("elapsed_s", "records_per_s", "model_scale"):
            s.pop(k)
        kb = s.pop("kv_backend")
        s["backend"] = {k: kb[k] for k in ("layout", "kv_dtype", "chunked", "data", "tp")}
    assert got == want
    assert got["coverage_complete"] and got["committed_complete"]
    assert all(res["summary"] is None for _, res in results[1:])


# ----------------------------------------------------- refusals, no ranks


class _FakeMesh:
    def __init__(self, axes: dict) -> None:
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.zeros(tuple(axes.values()))


@pytest.mark.parametrize("axes,batch,match", [
    ({"data": 2, "tp": 4}, None, "n_kv_heads"),
    ({"data": 8}, 6, "slots"),
    ({"sp": 2}, None, "must not carry an sp axis"),
    ({"fsdp": 5}, None, "d_model"),
], ids=["tp_heads", "data_slots", "sp", "fsdp"])
def test_check_serving_mesh_raises_as_jax(axes, batch, match):
    """``check_serving_mesh``'s errors, word for word the JAX package's."""
    cfg = pt.TransformerConfig(**GEN_CFG)
    with pytest.raises(ValueError, match=match) as got:
        pg.check_serving_mesh(cfg, _FakeMesh(axes), batch=batch)

    class JMesh:
        shape = axes

    with pytest.raises(ValueError) as want:
        jg.check_serving_mesh(_jcfg(GEN_CFG), JMesh(), batch=batch)
    assert str(got.value) == str(want.value)


def test_pp_serving_mesh_is_not_ported():
    """Layer-sharded serving (a pp axis) raises ``NotImplementedError``
    naming the ROADMAP queue A title."""
    with pytest.raises(NotImplementedError, match="Sharded serving"):
        pg.ServingShard(pt.TransformerConfig(**GEN_CFG), _FakeMesh({"pp": 2}))


def test_placement_records_give_local_shapes():
    """The placement records split the JAX package's dims: dense pools
    slots over data and kv heads over tp, paged pools kv heads only."""
    mesh = _FakeMesh({"data": 2, "tp": 2})
    assert pg.kv_sharding(mesh).local_shape((2, 4, 16, 2, 8)) == (2, 2, 16, 1, 8)
    assert pg.kv_kmajor_sharding(mesh).local_shape((2, 4, 2, 16, 8)) == (2, 2, 1, 16, 8)
    assert pg.kv_kmajor_scale_sharding(mesh).local_shape((2, 4, 2, 16)) == (2, 2, 1, 16)
    assert pg.paged_pool_sharding(mesh).local_shape((2, 40, 4, 2, 8)) == (2, 40, 4, 1, 8)
    assert pg.paged_pool_kmajor_sharding(mesh).local_shape((2, 40, 2, 4, 8)) == (2, 40, 1, 4, 8)
    assert pg.slot_sharding(mesh, 2).local_shape((4, 8)) == (2, 8)


def test_serving_shardings_are_the_training_layouts():
    """``serving_shardings`` places a plain tree as the train step's
    ``param_specs`` do, and an int8 tree's scales unsplit on their
    contraction axes (``quantize_specs``)."""
    from torch.distributed.tensor import Replicate, Shard

    from torchkafka_tpu_torch.models.quant import QTensor, quantize_params

    cfg = pt.TransformerConfig(**GEN_CFG, dtype=torch.float32)
    mesh = _FakeMesh({"data": 2, "fsdp": 2, "tp": 2})
    params = pt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    plain = pg.serving_shardings(cfg, mesh, params)
    assert plain == pt.shardings_for_mesh(mesh, pt.param_specs(cfg))
    quant = pg.serving_shardings(cfg, mesh, quantize_params(params, cfg))
    wq = quant["layers"]["wq"]  # [L, D, H, Dh]: D over fsdp, H over tp; scales D unsplit
    assert isinstance(wq, QTensor)
    assert wq.q == [Replicate(), Shard(1), Shard(2)]
    assert wq.scale == [Replicate(), Replicate(), Shard(2)]

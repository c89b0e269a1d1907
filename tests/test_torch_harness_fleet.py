"""The port's in-process fleet scenarios (10-16 and 22 of
``torchkafka_tpu_torch.harness``) against the JAX package's, on the CPU at
tiny size.

- ``tests/test_harness.py``'s cases for scenarios 10, 11, 12, 13, 14, 15,
  16 and 22 run over the port: the module's source is loaded with the
  package name re-rooted onto ``torchkafka_tpu_torch`` and its
  ``run_scenario`` bound to the port's with ``device="cpu"`` (one run of
  a scenario serves every case that reads it).
- Differentials at f32 from the JAX harness's own tiny parameters
  (``params_from_numpy``): scenarios 10, 12, 13, 14 and 22 give the JAX
  scenario's tokens for every record, its committed offsets on every
  partition and its deterministic summary keys (coverage, drains, prefix
  hits, chunk counters, kills and journal counters, the autoscaler's
  decisions and digest). Both packages' member counters start at 0 for
  each run, so range assignment splits the partitions the same way.
- Without a GPU and without ``device``, every ported fleet scenario
  raises before it builds anything; the CLI runs scenario 14 with
  ``--prefill-chunk`` and ``--device cpu`` without loading JAX.
"""

import itertools
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from _torch_fleet_common import load_rerooted
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu.harness import run_scenario as jax_run
from torchkafka_tpu_torch.harness import PORTED, run_scenario
from torchkafka_tpu_torch.harness import scenarios as pscen

IN_PROCESS = (10, 11, 12, 13, 14, 15, 16, 22, 25)
_RUNS: dict = {}


def _cpu_run(num, size="tiny", **kw):
    """The port's ``run_scenario`` on the CPU, one run per argument set."""
    key = (num, size, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = run_scenario(num, size, device="cpu", **kw)
    return _RUNS[key]


_h = load_rerooted("test_harness")
_h.run_scenario = _cpu_run
test_scenario_10_fleet_smoke = _h.test_scenario_10_fleet_smoke
test_scenario_11_chaos_soak_smoke = _h.test_scenario_11_chaos_soak_smoke
test_scenario_12_prefix_cache_smoke = _h.test_scenario_12_prefix_cache_smoke
test_scenario_13_warm_failover_smoke = _h.test_scenario_13_warm_failover_smoke
test_scenario_14_chunked_prefill_storm = _h.test_scenario_14_chunked_prefill_storm
test_scenario_15_slo_observability = _h.test_scenario_15_slo_observability
test_scenario_16_traffic_observatory = _h.test_scenario_16_traffic_observatory
test_scenario_22_autoscaled_step_storm = _h.test_scenario_22_autoscaled_step_storm
test_prefill_chunk_flag_scoping = _h.test_prefill_chunk_flag_scoping


def test_scenario_10_runs_and_reports():
    """``test_harness.py``'s generic case, for the one fleet scenario it
    lists."""
    out = _cpu_run(10)
    assert out["records"] > 0
    assert out["records_per_s"] > 0
    assert out["commit_failures"] == 0
    assert out["commit"]["count"] > 0
    assert out["dropped"] == 0


def test_in_process_scenarios_are_ported():
    assert set(IN_PROCESS) <= set(PORTED)


@pytest.mark.parametrize("num", IN_PROCESS)
def test_fleet_scenario_needs_a_device(num, monkeypatch):
    """No device named and no CUDA: the scenario raises before it builds a
    model or a broker."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(ptk, "InMemoryBroker", lambda *a, **k: built.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(num, "tiny")
    assert not built


def test_cli_scenario_14_without_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['harness', '--scenario', '14', '--size', 'tiny', "
        "'--prefill-chunk', '8', '--device', 'cpu']\n"
        "runpy.run_module('torchkafka_tpu_torch.harness', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'torchkafka_tpu'))\n"
        "print('JAX_MODULES', bad, file=sys.stderr)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300,
                          cwd=str(pathlib.Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["scenario"] == "14:chunked-prefill-storm" and out["prefill_chunk"] == 8
    assert out["coverage_complete"] and out["max_decode_stall_ticks"] == 0
    assert "JAX_MODULES []" in proc.stderr


# ----------------------------------------------- differential: tokens, commits


TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)


@pytest.fixture()
def same_params(monkeypatch):
    """The port's tiny serving model made from the JAX harness's own tiny
    parameters (``init_params(jax.random.key(0), cfg)``)."""
    from torchkafka_tpu.models.transformer import TransformerConfig as JCfg
    from torchkafka_tpu.models.transformer import init_params as jinit
    from torchkafka_tpu_torch.models import transformer as pt

    def model(size, model_scale, prompt_len, max_new, quantized=None, device=None):
        assert size == "tiny" and model_scale is None and quantized is None
        seq = prompt_len + max_new
        jparams = jinit(jax.random.key(0), JCfg(**TINY, max_seq_len=seq, dtype=jnp.float32))
        cfg = pt.TransformerConfig(**TINY, max_seq_len=seq, dtype=torch.float32)
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        return cfg, pt.params_from_numpy(tree, cfg, device=device), "default"

    monkeypatch.setattr(pscen, "_serving_model", model)


def _spy(monkeypatch):
    """Record, in both packages, every broker a scenario makes, every
    fleet serve's completions in order (replica, partition, offset,
    tokens) and every plain server's completions by record; restart each
    package's member-id counter."""
    import torchkafka_tpu.fleet.fleet as jfleet
    import torchkafka_tpu.serve as jserve
    import torchkafka_tpu.source.memory as jmemory
    import torchkafka_tpu_torch.fleet.fleet as pfleet
    import torchkafka_tpu_torch.serve as pserve
    import torchkafka_tpu_torch.source.memory as pmemory

    seen = {}
    for name, pkg, fleet_mod, serve_mod, memory in (
            ("jax", tk, jfleet, jserve, jmemory), ("port", ptk, pfleet, pserve, pmemory)):
        rec = seen[name] = {"brokers": [], "fleets": [], "server": {}}

        class Broker(pkg.InMemoryBroker):
            def __init__(self, *a, _rec=rec, **k):
                super().__init__(*a, **k)
                _rec["brokers"].append(self)

        def serve(self, *a, _rec=rec, _orig=fleet_mod.ServingFleet.serve, **k):
            done = []
            _rec["fleets"].append(done)
            for rid, r, toks in _orig(self, *a, **k):
                done.append((rid, r.partition, r.offset, np.asarray(toks).tolist()))
                yield rid, r, toks

        class Server(serve_mod.StreamingGenerator):
            def run(self, *a, _rec=rec, **k):
                for r, toks in super().run(*a, **k):
                    _rec["server"][(r.partition, r.offset)] = np.asarray(toks).tolist()
                    yield r, toks

        monkeypatch.setattr(pkg, "InMemoryBroker", Broker)
        monkeypatch.setattr(fleet_mod.ServingFleet, "serve", serve)
        monkeypatch.setattr(serve_mod, "StreamingGenerator", Server)
        monkeypatch.setattr(memory, "_member_counter", itertools.count())
    return seen


# (topic, consumer groups) of each scenario, and the result keys that do
# not depend on the host's clock. Scenario 10's token buckets run on the
# real clock, so where its drain splits the stream is not compared: its
# tokens are compared by record over both fleets.
GROUPS = {10: ("t10", ("s10",)), 12: ("t12", ("s12",)), 13: ("t13", ("ref13", "s13")),
          14: ("t14", ("s14",)), 22: ("t22", ("s22",))}
CLOCKED = {"elapsed_s", "records_per_s", "wall_s"}
KEYS_10 = ("scenario", "replicas", "records", "drained_states", "drains",
           "coverage_complete", "zero_replayed_after_drain", "commit_failures", "dropped")


def _committed(pkg, brokers, topic, groups):
    return [[b.committed(g, pkg.TopicPartition(topic, p)) for g in groups
             for p in range(b.partitions_for(topic))] for b in brokers]


@pytest.mark.parametrize("num", sorted(GROUPS))
def test_scenario_matches_jax(num, monkeypatch, same_params):
    seen = _spy(monkeypatch)
    ref = jax_run(num, "tiny")
    for m in ("torchkafka_tpu.source.memory", "torchkafka_tpu_torch.source.memory"):
        monkeypatch.setattr(sys.modules[m], "_member_counter", itertools.count())
    got = run_scenario(num, "tiny", device="cpu")
    keys = KEYS_10 if num == 10 else sorted(set(ref) - CLOCKED)
    assert set(got) >= set(keys)
    for key in keys:
        assert got[key] == ref[key], key
    j, p = seen["jax"], seen["port"]
    if num == 14:
        assert p["server"] == j["server"] and len(p["server"]) == 16
    elif num == 10:
        def by_record(fleets):
            return {(part, off): toks for done in fleets for _rid, part, off, toks in done}

        assert by_record(p["fleets"]) == by_record(j["fleets"])
        assert len(by_record(p["fleets"])) == 24
    else:
        assert p["fleets"] == j["fleets"] and all(p["fleets"])
    topic, groups = GROUPS[num]
    want = _committed(tk, j["brokers"], topic, groups)
    assert _committed(ptk, p["brokers"], topic, groups) == want
    assert any(off for row in want for off in row)

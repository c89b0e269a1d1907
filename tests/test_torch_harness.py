"""The port's harness (``torchkafka_tpu_torch.harness``) against the JAX
package's, on the CPU at tiny size: ``tests/test_harness.py``'s cases for
scenarios 1, 2, 5, 6, 7 and 9 re-rooted onto the port (the fleet
scenarios' are in ``test_torch_harness_fleet.py`` and
``test_torch_harness_distill.py``), scenarios 5 and 7
giving the JAX harness's tokens and committed offsets at f32 from the
same parameters, ``run_scenario``'s flag scoping raising JAX's errors,
every scenario ported, and the CLI printing one JSON line without loading
JAX."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu.harness import run_scenario as jax_run
from torchkafka_tpu_torch.harness import PORTED, SCENARIOS, run_scenario
from torchkafka_tpu_torch.harness import scenarios as pscen

CPU = {"device": "cpu"}
_RUNS: dict = {}


def _port(num: int) -> dict:
    """One port run of scenario ``num`` at tiny size, shared by the cases
    that read it."""
    if num not in _RUNS:
        _RUNS[num] = run_scenario(num, "tiny", **CPU)
    return _RUNS[num]


@pytest.mark.parametrize("num", [1, 2, 5, 6, 7, 9])
def test_scenario_runs_and_reports(num):
    out = _port(num)
    assert out["records"] > 0
    assert out["records_per_s"] > 0
    assert out["commit_failures"] == 0
    assert out["commit"]["count"] > 0
    assert out["dropped"] == 0


def test_scenario_5_token_accounting():
    out = _port(5)
    assert out["generated_tokens"] == out["records"] * 8
    assert "device_prefill_ms" not in out  # the device split is the card's


def test_scenario_9_buckets_and_efficiency():
    out = _port(9)
    assert 0 < out["bucket_efficiency"] < 1  # bucketing beat pad-to-max
    assert set(out["rows_per_width"]) <= {16, 32, 64}
    assert sum(out["rows_per_width"].values()) == out["records"]
    assert out["mesh"] == {"data": 1}
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_scenario_7_reports_serving_keys():
    out = _port(7)
    assert out["scenario"] == "7:continuous-serve"
    assert out["committed"] == out["records"] == 24
    assert out["eos_mode"] == "on" and out["ticks_per_sync"] == 4
    assert out["decode_ticks"] > 0
    assert "hbm_roofline_pct" not in out  # the roofline runs at a model scale on CUDA


def test_bad_size_rejected():
    with pytest.raises(ValueError):
        run_scenario(1, "huge")


def test_scenario_7_spec_smoke():
    out = run_scenario(7, "tiny", spec=True, spec_k=2, **CPU)
    assert out["scenario"] == "7:continuous-serve+spec"
    assert out["records"] > 0
    assert out["committed"] == out["records"]
    assert out["commit_failures"] == 0
    st = out["spec"]
    assert st["k"] == 2
    assert st["proposed"] > 0
    assert 0 <= st["accepted"] <= st["proposed"]
    assert st["acceptance"] is not None


def test_scenario_7_sampled_serving():
    out = run_scenario(7, "tiny", temperature=0.8, top_k=8, top_p=0.95, **CPU)
    assert out["records"] > 0
    assert out["commit_failures"] == 0
    assert out["sampling"] == {"temperature": 0.8, "top_k": 8, "top_p": 0.95}


FLAG_ERRORS = {
    "spec_on_5": (5, dict(spec=True)),
    "spec_kv_int8": (7, dict(spec=True, kv_int8=True)),
    "sampling_on_5": (5, dict(temperature=0.5)),
    "spec_sampled": (7, dict(spec=True, top_k=4)),
    "prefill_chunk_on_12": (12, dict(prefill_chunk=8)),
    "serve_eos_tiny": (7, dict(serve_eos=True)),
    "quantized_tiny": (7, dict(quantized=True)),
    "kv_int8_on_5": (5, dict(kv_int8=True)),
    "model_scale_on_1": (1, dict(model_scale="1b")),
    "bad_size": (1, dict(size="huge")),
}


@pytest.mark.parametrize("case", sorted(FLAG_ERRORS))
def test_flag_scoping_matches_jax(case):
    """The JAX harness's ValueErrors, message for message, raised before
    any device is resolved or any model is built."""
    num, kw = FLAG_ERRORS[case]
    size = kw.pop("size", "tiny")
    with pytest.raises(ValueError) as ref:
        jax_run(num, size, **kw)
    with pytest.raises(ValueError) as got:
        run_scenario(num, size, **kw)
    assert str(got.value) == str(ref.value)


def test_every_scenario_is_ported():
    """All 25 of the JAX package's scenarios run in the port (20, the
    sharded paged fleet, since the sharded serving slice)."""
    assert sorted(SCENARIOS) == list(range(1, 26))
    assert PORTED == tuple(range(1, 26))


def test_device_rule_without_cuda(monkeypatch):
    """No device named and no CUDA: the harness raises instead of running
    on the CPU under a device's name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(1, "tiny")
    from torchkafka_tpu_torch.harness.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--scenario", "6"])


def test_cli_one_json_line_without_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['harness', '--scenario', '1', '--size', 'tiny', '--device', 'cpu']\n"
        "runpy.run_module('torchkafka_tpu_torch.harness', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'torchkafka_tpu'))\n"
        "print('JAX_MODULES', bad, file=sys.stderr)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(__import__("pathlib").Path(__file__)
                                               .resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["scenario"] == "1:single-process" and out["records"] == 512
    assert "JAX_MODULES []" in proc.stderr


# ----------------------------------------------- differential: tokens, commits


TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)


def _spy(monkeypatch):
    """Record every broker the scenarios make and, through the servers'
    ``run``, every completion (record identity → tokens), in both
    packages."""
    seen = {"jax": {"brokers": [], "done": {}, "gen": []},
            "port": {"brokers": [], "done": {}, "gen": []}}
    import torchkafka_tpu.serve as jserve
    import torchkafka_tpu_torch.serve as pserve

    for name, pkg, serve in (("jax", tk, jserve), ("port", ptk, pserve)):
        rec = seen[name]

        class Broker(pkg.InMemoryBroker):
            def __init__(self, *a, _rec=rec, **k):
                super().__init__(*a, **k)
                _rec["brokers"].append(self)

        class Server(serve.StreamingGenerator):
            def run(self, *a, _rec=rec, **k):
                for r, toks in super().run(*a, **k):
                    _rec["done"][(r.partition, r.offset)] = np.asarray(toks).copy()
                    yield r, toks

        monkeypatch.setattr(pkg, "InMemoryBroker", Broker)
        monkeypatch.setattr(serve, "StreamingGenerator", Server)
    return seen


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


def _committed(broker, pkg, topic, group):
    return [broker.committed(group, pkg.TopicPartition(topic, p))
            for p in range(broker.partitions_for(topic))]


def _jax_tiny(seq: int):
    from torchkafka_tpu.models.transformer import TransformerConfig as JCfg
    from torchkafka_tpu.models.transformer import init_params as jinit

    jcfg = JCfg(**TINY, max_seq_len=seq, dtype=jnp.float32)
    return jcfg, jinit(jax.random.key(0), jcfg)


def test_scenario_7_tokens_and_commits_match_jax(monkeypatch, same_params):
    seen = _spy(monkeypatch)
    ref = jax_run(7, "tiny")
    got = run_scenario(7, "tiny", **CPU)
    for key in ("records", "generated_tokens", "truncated_by_eos", "committed",
                "eos_mode", "ticks_per_sync", "slots", "commit_failures", "dropped"):
        assert got[key] == ref[key], key
    j, p = seen["jax"], seen["port"]
    assert sorted(p["done"]) == sorted(j["done"]) and len(p["done"]) == 24
    for key, toks in j["done"].items():
        np.testing.assert_array_equal(p["done"][key], toks, err_msg=str(key))
    assert (_committed(p["brokers"][-1], ptk, "t7", "s7")
            == _committed(j["brokers"][-1], tk, "t7", "s7") == [12, 12])


def test_scenario_5_tokens_and_commits_match_jax(monkeypatch, same_params):
    """The port's scenario 5 generates, batch by batch, the tokens the JAX
    package's ``generate`` gives the same prompts, and both scenarios
    commit the same offsets."""
    from torchkafka_tpu.models.generate import generate as jax_generate
    import torchkafka_tpu_torch.models.generate as pgen

    seen = _spy(monkeypatch)
    calls = []
    orig = pgen.generate

    def generate(params, cfg, prompt, max_new, **kw):
        out = orig(params, cfg, prompt, max_new, **kw)
        calls.append((prompt.cpu().numpy(), out.cpu().numpy()))
        return out

    monkeypatch.setattr(pgen, "generate", generate)
    ref = jax_run(5, "tiny")
    got = run_scenario(5, "tiny", **CPU)
    for key in ("records", "generated_tokens", "batches", "commit_failures", "dropped"):
        assert got[key] == ref[key], key
    prompts = np.concatenate([pr for pr, _ in calls[1:]])  # calls[0]: the warm-up
    toks = np.concatenate([out for _, out in calls[1:]])
    assert prompts.shape == (64, 16)
    jcfg, jparams = _jax_tiny(24)
    want = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(prompts), 8))
    np.testing.assert_array_equal(toks, want)
    assert (_committed(seen["port"]["brokers"][-1], ptk, "t5", "s5")
            == _committed(seen["jax"]["brokers"][-1], tk, "t5", "s5") == [32, 32])

"""The port's autoscaling loop (``fleet/autoscale.py``, a copy),
``ServingFleet.scale_to`` and the process supervisor's ``scale`` against
the JAX package's.

- ``test_autoscale.py`` runs over the port: the module's source is loaded
  with the package name re-rooted onto ``torchkafka_tpu_torch`` and its
  policy-validation, controller-unit, in-process ``scale_to`` and
  scale-during-rebalance classes are collected here (the last over stub
  worker processes and a real broker membership), the fleets on the CPU;
  so is ``SupervisorAutoscaler`` closing the loop on a real-process
  ``ProcessFleet`` of port workers serving on the CPU (every wait
  bounded at 60 s).
- Differential at f32: a ``FleetAutoscaler`` over a decode fleet, driven
  by a ``WorkloadGenerator`` step load under one manual clock, scales up
  and back down; the completion order, trace events, committed offsets,
  the controller's summary and decision digest equal the JAX package's,
  and a second port run replays byte for byte.
- Differential at f32: ``test_autoscale.py``'s per-role loop (decode
  replicas adopting from a ``PrefillPool``, both roles autoscaled): the
  completion order, trace events, committed offsets, decision digest,
  adopted slots and warm pool drains equal the JAX package's.
"""

import pytest

import test_autoscale as ja
from _torch_fleet_common import MOD, jax_and_port, load_rerooted, sub
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu_torch.fleet import drill
from torchkafka_tpu_torch.models import transformer as pt

_mod = load_rerooted("test_autoscale", replace=[
    ("    import jax\n    import jax.numpy as jnp\n\n", ""),
    ("        TransformerConfig, init_params,\n", "        TransformerConfig,\n"),
    # The per-role loop's prefill pool and the real-process supervisor
    # run on the CPU; every wait bounded at 60 s.
    ("        prompt_len=P, max_new=MAX_NEW, kv_pages=pages, commit_every=2,\n",
     "        prompt_len=P, max_new=MAX_NEW, kv_pages=pages, commit_every=2,\n"
     '        gen_kwargs={"device": "cpu"},\n'),
    ('            heartbeat_interval_s=0.2, respawn=True, group="g",\n        )',
     '            heartbeat_interval_s=0.2, respawn=True, group="g",\n'
     '            device="cpu",\n        )'),
    ("timeout_s=300", "timeout_s=60"),
    ("timeout_s=120", "timeout_s=60"),
    ("deadline = time.monotonic() + 240", "deadline = time.monotonic() + 60"),
    ("deadline = time.monotonic() + 120", "deadline = time.monotonic() + 60"),
])
_mod.init_params = lambda gen, cfg: pt.init_params(gen, cfg, device="cpu")

model = _mod.model
stub_fleet = _mod.stub_fleet
TestPolicyValidation = _mod.TestPolicyValidation
TestControllerUnits = _mod.TestControllerUnits
TestServingFleetScaleTo = _mod.TestServingFleetScaleTo
TestScaleDuringRebalanceRace = _mod.TestScaleDuringRebalanceRace


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one intra-op thread
    each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_supervisor_autoscaler_scales_real_processes(tmp_path):
    _mod.TestAutoscaledLoop().test_supervisor_autoscaler_scales_real_processes(tmp_path)


P, MAX_NEW, VOCAB = _mod.P, _mod.MAX_NEW, _mod.VOCAB


def _autoscaled_run(pkg, model):
    """``test_autoscale.py``'s loop with the decode role only: the port's
    one copy, ``fleet/drill.py``'s ``autoscaled_run``, over ``pkg``'s
    modules."""
    cfg, params = model
    return drill.autoscaled_run(
        cfg, params, prompt_len=P, max_new=MAX_NEW,
        modules=(MOD[pkg], sub(pkg, "workload"), sub(pkg, "fleet")),
        gen_kwargs={"device": "cpu"} if pkg == "port" else None)


@pytest.fixture(scope="module")
def pkgs():
    return jax_and_port(dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2,
                             n_kv_heads=1, d_ff=64, max_seq_len=P + MAX_NEW))


def test_autoscaled_loop_matches_jax_and_replays(pkgs):
    got = _autoscaled_run("port", pkgs["port"])
    assert _autoscaled_run("jax", pkgs["jax"]) == got
    assert _autoscaled_run("port", pkgs["port"]) == got
    by_reason = got["ctrl"]["by_reason"]
    assert by_reason.get("decode/up/queue", 0) >= 1
    assert by_reason.get("decode/down/idle", 0) >= 1
    assert got["joins"] >= 2
    assert got["committed"] == got["ends"]
    assert {(p, o) for _r, p, o, _t in got["order"]} == {
        (p, o) for p in range(4) for o in range(got["ends"][p])}


def _per_role(out: dict) -> dict:
    return {**{k: out[k] for k in ("order", "committed", "digest", "adopted",
                                   "pool_drained", "ctrl")},
            "events": [e.to_json() for e in out["events"]]}


def test_per_role_loop_with_prefill_pool_matches_jax(pkgs):
    got = _per_role(_mod._autoscaled_run(*pkgs["port"]))
    assert got == _per_role(ja._autoscaled_run(*pkgs["jax"]))
    by_reason = got["ctrl"]["by_reason"]
    assert by_reason.get("decode/up/queue", 0) >= 1
    assert by_reason.get("prefill/up/queue", 0) >= 1
    assert got["adopted"] > 0

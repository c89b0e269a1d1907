"""The port's autoscaling loop (``fleet/autoscale.py``, a copy) and
``ServingFleet.scale_to`` against the JAX package's.

- ``test_autoscale.py`` runs over the port: the module's source is loaded
  with the package name re-rooted onto ``torchkafka_tpu_torch`` (without
  its process-fleet imports: the supervisor is not ported) and its
  policy-validation, controller-unit and in-process ``scale_to`` classes
  are collected here, the fleets on the CPU. ``SupervisorAutoscaler``'s
  cases wait for the process fleet (ROADMAP queue A).
- Differential at f32: a ``FleetAutoscaler`` over a decode fleet, driven
  by a ``WorkloadGenerator`` step load under one manual clock, scales up
  and back down; the completion order, trace events, committed offsets,
  the controller's summary and decision digest equal the JAX package's,
  and a second port run replays byte for byte.
"""

import pytest

from _torch_fleet_common import MOD, jax_and_port, load_rerooted, sub
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu_torch.fleet import drill
from torchkafka_tpu_torch.models import transformer as pt

_mod = load_rerooted("test_autoscale", drop=(
    "from torchkafka_tpu.fleet.supervisor import",
), replace=[
    ("    ProcessFleet,\n", ""),
    ("    sweep_expired,\n", ""),
    ("    import jax\n    import jax.numpy as jnp\n\n", ""),
    ("        TransformerConfig, init_params,\n", "        TransformerConfig,\n"),
])
_mod.init_params = lambda gen, cfg: pt.init_params(gen, cfg, device="cpu")

model = _mod.model
TestPolicyValidation = _mod.TestPolicyValidation
TestControllerUnits = _mod.TestControllerUnits
TestServingFleetScaleTo = _mod.TestServingFleetScaleTo

P, MAX_NEW, VOCAB = _mod.P, _mod.MAX_NEW, _mod.VOCAB


def _autoscaled_run(pkg, model):
    """``test_autoscale.py``'s per-role loop with the decode role only
    (disaggregated prefill is not ported): the port's one copy,
    ``fleet/drill.py``'s ``autoscaled_run``, over ``pkg``'s modules."""
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

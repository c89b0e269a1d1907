"""The port's workload generator (``workload/``, a copy) driving the
port's fleet, against the JAX package's.

- ``test_workload.py`` runs over the port: the module's source is loaded
  with the package name re-rooted onto ``torchkafka_tpu_torch`` and its
  classes are collected here (the seeded schedule and its distribution
  contracts, per-record output budgets on the dense and paged pools, the
  burn-rate overload's ``should_defer`` and the storm that defers batch
  work but completes everything), the fleets and servers on the CPU. Its
  full-stack same-seed replay runs below against the JAX package's.
- Differential at f32: the same full-stack run (paged fleet, budgets
  from the ``max_new`` header, a burn-rate monitor, a scheduled replica
  kill and broker outage, all under one manual clock) through both
  packages gives the same schedule digest, completion order, trace
  events, committed offsets and report counters.
"""

import pytest

import test_workload as jax_workload
from _torch_fleet_common import jax_and_port, load_rerooted
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture

_mod = load_rerooted("test_workload")

model = _mod.model
TestSchedule = _mod.TestSchedule
TestOutputBudget = _mod.TestOutputBudget
TestOverload = _mod.TestOverload

REPORT_KEYS = ("kills_fired", "kills_skipped", "all_arrived", "unique_served",
               "duplicates", "arrived")  # not "rounds": idle rounds run on the host clock


def _comparable(run) -> dict:
    report = run["report"]
    return {
        "digest": run["digest"],
        "order": run["order"],
        "committed": run["committed"],
        "produced": run["produced"],
        "events": [e.to_json() for e in run["events"]],
        "report": {k: report.get(k) for k in REPORT_KEYS},
    }


def test_full_stack_replay_matches_jax():
    shape = dict(vocab_size=_mod.VOCAB, d_model=32, n_layers=2, n_heads=2,
                 n_kv_heads=1, d_ff=64, max_seq_len=_mod.P + _mod.MAX_NEW)
    pk = jax_and_port(shape)
    got = _comparable(_mod._full_stack_run(*pk["port"]))
    ref = _comparable(jax_workload._full_stack_run(*pk["jax"]))
    assert got == ref
    assert _comparable(_mod._full_stack_run(*pk["port"])) == got  # replays
    assert len(got["report"]["kills_fired"]) == 1
    assert {(p, o) for _r, p, o, _t in got["order"]} == got["produced"]


@pytest.mark.parametrize("seed", [0, 3])
def test_schedule_digest_matches_jax(seed):
    from torchkafka_tpu import workload as jw
    from torchkafka_tpu_torch import workload as pw

    def digest(mod):
        cfg = mod.WorkloadConfig(tenants=5, total_records=40, seed=seed,
                                 chaos=mod.ChaosSchedule(replica_kills=((0.01, 1),)))
        gen = mod.WorkloadGenerator(cfg, prompt_len=8, max_new=4, vocab_size=64)
        return gen.schedule_digest(), [
            (e.t_s, e.seq, e.tenant, e.lane, e.suffix_len, e.out_len,
             e.prompt.tolist())
            for e in gen.schedule()
        ]

    assert digest(pw) == digest(jw)

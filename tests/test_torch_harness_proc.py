"""The port's process-fleet scenarios 17, 18 and 21 (the SIGKILL storm,
the exactly-once storm and the killed prefill worker of
``torchkafka_tpu_torch.harness``) on the CPU at tiny size.

- ``tests/test_harness.py``'s cases for them run over the port: the
  module's source is loaded with the package name re-rooted onto
  ``torchkafka_tpu_torch`` and its ``run_scenario`` bound to the port's
  with ``device="cpu"``. The workers are real ``python -m
  torchkafka_tpu_torch.fleet.proc`` processes on one intra-op thread
  each; the in-process reference serves on the weights they build
  (``fleet.proc.build_model``).
- Without a GPU and without ``device``, each of the six process
  scenarios raises before it spawns a worker or builds a model; the CLI
  runs scenario 17 with ``--device cpu`` without loading JAX.

Scenarios 19, 23 and 24 are in ``test_torch_harness_durable.py`` (two
files, so that the suite's parallel workers take them apart).
"""

import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from _torch_fleet_common import load_rerooted
from _torch_fleet_common import one_thread_workers  # noqa: F401 - autouse fixture
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu_torch.fleet import supervisor
from torchkafka_tpu_torch.fleet import proc
from torchkafka_tpu_torch.harness import PORTED, run_scenario

PROCESS = (17, 18, 19, 21, 23, 24)


def _cpu_run(num, size="tiny", **kw):
    return run_scenario(num, size, device="cpu", **kw)


_h = load_rerooted("test_harness")
_h.run_scenario = _cpu_run
test_scenario_17_process_fleet_kill_storm = _h.test_scenario_17_process_fleet_kill_storm
test_scenario_18_exactly_once_kill_storm = _h.test_scenario_18_exactly_once_kill_storm
test_scenario_21_disaggregated_prefill_kill_storm = (
    _h.test_scenario_21_disaggregated_prefill_kill_storm)


def test_process_scenarios_are_ported():
    assert set(PROCESS) <= set(PORTED)


@pytest.mark.parametrize("num", PROCESS)
def test_process_scenario_needs_a_device(num, monkeypatch):
    """No device named and no CUDA: the scenario raises at once, before it
    builds a model or spawns a worker (a spawned worker would sit out the
    fleet's readiness wait)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    monkeypatch.setattr(supervisor.ProcessFleet, "__init__",
                        lambda *a, **k: made.append("fleet"))
    monkeypatch.setattr(proc, "build_model", lambda *a, **k: made.append("model"))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(num, "tiny")
    assert time.perf_counter() - t0 < 1.0
    assert not made


def test_cli_scenario_17_without_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['harness', '--scenario', '17', '--size', 'tiny', "
        "'--device', 'cpu']\n"
        "runpy.run_module('torchkafka_tpu_torch.harness', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'torchkafka_tpu'))\n"
        "print('JAX_MODULES', bad, file=sys.stderr)\n"
    )
    proc_ = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=300,
                           cwd=str(pathlib.Path(__file__).resolve().parent.parent))
    assert proc_.returncode == 0, proc_.stderr
    lines = [ln for ln in proc_.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["scenario"] == "17:process-fleet-kill-storm"
    assert out["zero_lost"] and out["identical_to_no_kill"] and out["duplicates_within_bound"]
    assert sorted(out["exit_codes"].values()) == [-9, 0]
    assert "JAX_MODULES []" in proc_.stderr


class _IdleServer:
    """A server with no free slot: whatever the replica polls stays queued."""

    slots = 2
    pending_admissions = 0

    def __init__(self):
        self.fetched = []

    def free_slots(self):
        return 0

    def note_fetched(self, records):
        self.fetched.extend(records)

    def admit_records(self, records):
        raise AssertionError("nothing is admitted without a free slot")

    def step(self):
        return []

    def note_partitions_revoked(self, tps):
        pass


@pytest.mark.parametrize("drop_refetched", [False, True])
def test_survivor_queues_a_refetched_record_once(drop_refetched):
    """Scenario 17's duplicate bound at full size: a peer's death hands a
    survivor new partitions, and the eager rebalance fetches the partition
    it kept again from its committed offset. The reference's replica
    queues those records a second time (each is then served twice); the
    process worker's (``drop_refetched``) keeps one copy of each."""
    import torchkafka_tpu_torch as ptk
    from torchkafka_tpu_torch.fleet.metrics import FleetMetrics
    from torchkafka_tpu_torch.fleet.qos import AdmissionQueue, QoSConfig, TenantBuckets
    from torchkafka_tpu_torch.fleet.replica import Replica

    broker = ptk.InMemoryBroker()
    broker.create_topic("t", partitions=2)
    for i in range(8):
        broker.produce("t", b"p%d" % i, partition=i % 2)
    a = ptk.MemoryConsumer(broker, "t", group_id="g", member_id="a")
    b = ptk.MemoryConsumer(broker, "t", group_id="g", member_id="b")
    qos, metrics = QoSConfig(), FleetMetrics()
    rep = Replica(0, _IdleServer(), a, AdmissionQueue(qos, TenantBuckets(qos), metrics),
                  qos, metrics, drop_refetched=drop_refetched)
    rep.pump()
    assert [tp.partition for tp in a.assignment()] == [0] and rep.queue.depth() == 4
    b.close()  # the peer leaves: "a" takes partition 1 and refetches 0
    rep.pump()
    queued = [(tp.partition, off) for tp, off in rep.queue.queued()]
    assert len(queued) == 8 and set(queued) == {(i % 2, i // 2) for i in range(8)}
    assert rep.queue.depth() == (8 if drop_refetched else 12)

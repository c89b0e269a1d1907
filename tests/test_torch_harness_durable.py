"""The port's durability scenarios 19, 23 and 24 (the broker crashed and
recovered from its write-ahead log, the quorum cell's leader killed, the
rolling hot-swap with a canary rollback, of
``torchkafka_tpu_torch.harness``) on the CPU at tiny size:
``tests/test_harness.py``'s cases for them, re-rooted onto the port with
``run_scenario(..., device="cpu")``, over real worker processes on one
intra-op thread each (``test_torch_harness_proc.py`` has 17, 18 and 21).
"""

from _torch_fleet_common import load_rerooted
from _torch_fleet_common import one_thread_workers  # noqa: F401 - autouse fixture
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu_torch.harness import run_scenario


def _cpu_run(num, size="tiny", **kw):
    return run_scenario(num, size, device="cpu", **kw)


_h = load_rerooted("test_harness")
_h.run_scenario = _cpu_run
test_scenario_19_broker_crash_recovery = _h.test_scenario_19_broker_crash_recovery
test_scenario_23_quorum_leader_failover = _h.test_scenario_23_quorum_leader_failover
test_scenario_24_rolling_hot_swap = _h.test_scenario_24_rolling_hot_swap

"""Benchmark harness: port of ``torchkafka_tpu/harness``.

The JAX package's scenarios over the port, each returning a metrics dict:
the ingest scenarios 1, 2 and 6, the serving scenarios 5 and 7 (with the
decode roofline timed from a CUDA graph of the tick block), PNG →
ResNet-50 inference (4), streaming DLRM training (8), the bucketed
training scenario 9, the in-process fleets 10-16, 22 and 25, and the
process fleets 17, 18, 19, 21, 23 and 24 (worker processes over the
socket broker: SIGKILL storms, exactly-once output, a broker recovered
from its write-ahead log, a killed prefill worker, a quorum cell's leader
failover, a rolling hot-swap), the data-parallel training scenario 3 and
the sharded paged serving fleet 20 (both over the launched ranks).

Run: ``python -m torchkafka_tpu_torch.harness --scenario N [--size tiny|full]
[--device cpu]`` (CUDA unless ``--device`` names another device).
"""

from torchkafka_tpu_torch.harness.scenarios import PORTED, SCENARIOS, run_scenario

__all__ = ["PORTED", "SCENARIOS", "run_scenario"]

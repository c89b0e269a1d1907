"""Benchmark harness: port of ``torchkafka_tpu/harness``.

The JAX package's scenarios over the port, each returning a metrics dict:
the ingest scenarios 1, 2 and 6, the serving scenarios 5 and 7 (with the
decode roofline timed from a CUDA graph of the tick block) and the
bucketed training scenario 9. Every other scenario number raises
``NotImplementedError`` naming its ROADMAP queue A item.

Run: ``python -m torchkafka_tpu_torch.harness --scenario N [--size tiny|full]
[--device cpu]`` (CUDA unless ``--device`` names another device).
"""

from torchkafka_tpu_torch.harness.scenarios import PORTED, SCENARIOS, run_scenario

__all__ = ["PORTED", "SCENARIOS", "run_scenario"]

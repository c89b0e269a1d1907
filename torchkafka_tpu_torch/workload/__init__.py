"""Deterministic multi-tenant load generation (torchkafka_tpu_torch/workload).

Copy of ``torchkafka_tpu/workload/__init__.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

The "traffic survived" half of the observability story: a seeded,
injectable-clock workload generator — Zipf tenants with keyed partition
pinning, Poisson burst arrivals, heavy-tailed prompt/output lengths,
mixed QoS lanes, scheduled mid-run chaos — that drives the FULL serving
stack (fleet + QoS + paged/chunked KV cache + resilience + journal +
tracer) and replays byte-identically at the same seed. See
``generator.py`` for the draw-stream contract and ``obs/burn.py`` for
the burn-rate engine its traffic is measured against.
"""

from torchkafka_tpu_torch.workload.generator import (
    ArrivalEvent,
    ChaosSchedule,
    WorkloadConfig,
    WorkloadGenerator,
    diurnal_load,
    header_max_new,
    hot_set_shift_at,
    rate_multiplier_at,
    step_load,
    zipf_weights,
)

__all__ = [
    "ArrivalEvent",
    "ChaosSchedule",
    "WorkloadConfig",
    "WorkloadGenerator",
    "diurnal_load",
    "header_max_new",
    "hot_set_shift_at",
    "rate_multiplier_at",
    "step_load",
    "zipf_weights",
]

"""Serving fleet: partitioned multi-replica serving with QoS admission,
replica failover, graceful drain, elastic membership, autoscaling and the
rolling hot-swap (see fleet/fleet.py for the design).

Port of ``torchkafka_tpu/fleet``'s in-process part. The real-process
fleet (``ProcessFleet``, ``sweep_expired``) and disaggregated prefill
(``PrefillPool``/``Router``/``Worker``, ``encode_handoff``/
``decode_handoff``) are not ported yet (ROADMAP queue A: process fleet
and disaggregated prefill). ``SupervisorAutoscaler`` is duck-typed on
that supervisor and is exported for it.
"""

from torchkafka_tpu_torch.fleet.autoscale import (
    AutoscaleController,
    FleetAutoscaler,
    RolePolicy,
    RoleSignals,
    ScaleDecision,
    SupervisorAutoscaler,
)
from torchkafka_tpu_torch.fleet.fleet import ReplicaChaos, ServingFleet
from torchkafka_tpu_torch.fleet.metrics import FleetMetrics
from torchkafka_tpu_torch.fleet.qos import (
    BATCH,
    INTERACTIVE,
    AdmissionQueue,
    QoSConfig,
    TenantBuckets,
    TokenBucket,
    default_lane,
    default_tenant,
)
from torchkafka_tpu_torch.fleet.replica import Replica
from torchkafka_tpu_torch.fleet.rollout import (
    BrokerRolloutDriver,
    InProcessRolloutDriver,
    RolloutController,
    RolloutWorker,
)

__all__ = [
    "AdmissionQueue",
    "AutoscaleController",
    "BATCH",
    "BrokerRolloutDriver",
    "FleetAutoscaler",
    "FleetMetrics",
    "INTERACTIVE",
    "InProcessRolloutDriver",
    "QoSConfig",
    "Replica",
    "ReplicaChaos",
    "RolePolicy",
    "RoleSignals",
    "RolloutController",
    "RolloutWorker",
    "ScaleDecision",
    "ServingFleet",
    "SupervisorAutoscaler",
    "TenantBuckets",
    "TokenBucket",
    "default_lane",
    "default_tenant",
]

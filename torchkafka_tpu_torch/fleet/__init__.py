"""Serving fleet: partitioned multi-replica serving with QoS admission,
replica failover, and graceful drain (see fleet/fleet.py for the design).
``ProcessFleet`` (fleet/supervisor.py) is the REAL-PROCESS deployment of
the same group: one OS process per replica over the socket broker, with
heartbeat leases, zombie fencing, and cross-process warm failover.

Port of ``torchkafka_tpu/fleet``: the same exports, the worker processes
and disaggregated prefill on the port's server.
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
from torchkafka_tpu_torch.fleet.prefill import (
    PrefillPool,
    PrefillRouter,
    PrefillWorker,
    decode_handoff,
    encode_handoff,
)
from torchkafka_tpu_torch.fleet.rollout import (
    BrokerRolloutDriver,
    InProcessRolloutDriver,
    RolloutController,
    RolloutWorker,
)
from torchkafka_tpu_torch.fleet.supervisor import ProcessFleet, sweep_expired
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

__all__ = [
    "AdmissionQueue",
    "AutoscaleController",
    "BATCH",
    "BrokerRolloutDriver",
    "InProcessRolloutDriver",
    "RolloutController",
    "RolloutWorker",
    "FleetAutoscaler",
    "FleetMetrics",
    "INTERACTIVE",
    "PrefillPool",
    "PrefillRouter",
    "PrefillWorker",
    "ProcessFleet",
    "QoSConfig",
    "RolePolicy",
    "RoleSignals",
    "ScaleDecision",
    "SupervisorAutoscaler",
    "decode_handoff",
    "encode_handoff",
    "Replica",
    "ReplicaChaos",
    "ServingFleet",
    "sweep_expired",
    "TenantBuckets",
    "TokenBucket",
    "default_lane",
    "default_tenant",
]

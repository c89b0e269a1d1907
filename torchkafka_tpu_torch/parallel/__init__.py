"""Parallelism layer: process meshes, placements, multi-process wiring."""

from torchkafka_tpu_torch.parallel.mesh import (
    batch_sharding,
    global_batch,
    make_mesh,
    process_count,
    process_index,
)
from torchkafka_tpu_torch.parallel.multihost import (
    BarrierWatchdog,
    initialize,
    pod_consumer,
    pod_partitions,
)

__all__ = [
    "BarrierWatchdog",
    "batch_sharding",
    "global_batch",
    "initialize",
    "make_mesh",
    "pod_consumer",
    "pod_partitions",
    "process_count",
    "process_index",
]

"""Mesh-aligned partition assignment.

Copy of ``torchkafka_tpu/source/assignment.py``, imports re-rooted.

The reference shards consumption by letting the Kafka group protocol spread
partitions across DataLoader worker processes (/root/reference/src/kafka_dataset.py:208-233).
On a TPU pod the data-parallel topology is *static* — one ingest process per
host, ``jax.process_count()`` hosts — so the TPU-native design uses manual,
deterministic assignment aligned to the mesh's data axis instead: no
rebalance churn, no generation races, and every host knows exactly which
partitions feed its shard of the global batch. Group-managed mode remains
available for elasticity (MemoryConsumer/KafkaConsumer both support it).
"""

from __future__ import annotations

from torchkafka_tpu_torch.source.records import TopicPartition


def partitions_for_process(
    topic: str,
    num_partitions: int,
    process_index: int,
    process_count: int,
) -> list[TopicPartition]:
    """Strided partition assignment: process i owns partitions {p : p % N == i}.

    Strided (not range) so that adding partitions to a topic spreads new load
    evenly across hosts without remapping existing ones.
    """
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range [0, {process_count})")
    return [
        TopicPartition(topic, p)
        for p in range(num_partitions)
        if p % process_count == process_index
    ]


def local_batch_size(global_batch_size: int, process_count: int, process_index: int | None = None) -> int:
    """Per-host share of a global batch; requires even divisibility because
    XLA needs identical static shapes on every host."""
    if global_batch_size % process_count != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {process_count} processes"
        )
    return global_batch_size // process_count

"""Source layer: transports implementing the Consumer/Producer protocols."""

from torchkafka_tpu_torch.source.assignment import local_batch_size, partitions_for_process
from torchkafka_tpu_torch.source.chaos import ChaosConsumer, ChaosProducer
from torchkafka_tpu_torch.source.consumer import Consumer, seek_to_timestamp
from torchkafka_tpu_torch.source.kafka import (
    HAVE_KAFKA_PYTHON,
    KafkaConsumer,
    KafkaProducer,
    KafkaTransactionalProducer,
)
from torchkafka_tpu_torch.source.cluster import BrokerCell
from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
from torchkafka_tpu_torch.source.netbroker import (
    BrokerClient,
    BrokerServer,
    ChaosTransport,
    WireFaults,
)
from torchkafka_tpu_torch.source.replication import (
    FollowerReplica,
    ReplicationConfig,
    Replicator,
)
from torchkafka_tpu_torch.source.wal import WriteAheadLog
from torchkafka_tpu_torch.source.producer import (
    MemoryProducer,
    Producer,
    RecordMetadata,
    TransactionalProducer,
    dead_letter_to_topic,
)
from torchkafka_tpu_torch.source.records import Record, TopicPartition

__all__ = [
    "BrokerCell",
    "BrokerClient",
    "BrokerServer",
    "ChaosConsumer",
    "ChaosProducer",
    "ChaosTransport",
    "Consumer",
    "HAVE_KAFKA_PYTHON",
    "InMemoryBroker",
    "KafkaConsumer",
    "KafkaProducer",
    "KafkaTransactionalProducer",
    "MemoryConsumer",
    "MemoryProducer",
    "Producer",
    "TransactionalProducer",
    "RecordMetadata",
    "FollowerReplica",
    "ReplicationConfig",
    "Replicator",
    "dead_letter_to_topic",
    "seek_to_timestamp",
    "Record",
    "TopicPartition",
    "WireFaults",
    "WriteAheadLog",
    "local_batch_size",
    "partitions_for_process",
]

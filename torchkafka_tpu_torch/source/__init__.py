"""Kafka-semantics transports: records, the consumer protocol, the in-memory
broker, and the producers that write records back."""

from torchkafka_tpu_torch.source.producer import (
    MemoryProducer,
    Producer,
    RecordMetadata,
    TransactionalProducer,
    dead_letter_to_topic,
)

__all__ = [
    "MemoryProducer",
    "Producer",
    "RecordMetadata",
    "TransactionalProducer",
    "dead_letter_to_topic",
]

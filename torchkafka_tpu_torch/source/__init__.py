"""Kafka-semantics transports: records, the consumer protocol, the in-memory broker."""

"""Pipeline layer: the user-facing streaming loop."""

from torchkafka_tpu_torch.pipeline.stream import KafkaStream, stream

__all__ = ["KafkaStream", "stream"]

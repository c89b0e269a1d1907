"""Transform layer: per-record / per-chunk processors and fixed-shape batching."""

from torchkafka_tpu_torch.transform.batcher import Batch, Batcher
from torchkafka_tpu_torch.transform.bucket import BucketBatcher
from torchkafka_tpu_torch.transform.processor import (
    Processor,
    chunk_of,
    chunked,
    compose,
    fixed_width,
    is_chunked,
    json_field,
    json_tokens,
    raw_bytes,
)

__all__ = [
    "Batch",
    "Batcher",
    "BucketBatcher",
    "Processor",
    "chunk_of",
    "chunked",
    "compose",
    "fixed_width",
    "is_chunked",
    "json_field",
    "json_tokens",
    "raw_bytes",
]

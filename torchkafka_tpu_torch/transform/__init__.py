"""Transform layer: per-record / per-chunk processors and fixed-shape batching."""

from torchkafka_tpu_torch.transform.batcher import Batch, Batcher
from torchkafka_tpu_torch.transform.bucket import BucketBatcher
from torchkafka_tpu_torch.transform.image import encode_png_rgb, png_images
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
    "encode_png_rgb",
    "fixed_width",
    "is_chunked",
    "json_field",
    "json_tokens",
    "png_images",
    "raw_bytes",
]

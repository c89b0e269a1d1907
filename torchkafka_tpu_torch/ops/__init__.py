"""Attention operators, the int8 matmul and their hand-written CUDA kernels."""

from torchkafka_tpu_torch.ops.attention import mha
from torchkafka_tpu_torch.ops.flash import flash_attention
from torchkafka_tpu_torch.ops.qmatmul import quantized_matmul

__all__ = ["flash_attention", "mha", "quantized_matmul"]

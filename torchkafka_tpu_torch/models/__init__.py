"""The models: the flagship decoder (config, parameters, prefill, decode
math, speculative decoding), the DLRM recommender and ResNet-50.

As in the JAX package, the ``generate`` FUNCTION is not re-exported here:
binding it at package level would shadow the ``models.generate``
submodule."""

from torchkafka_tpu_torch.models.recsys import DLRMConfig, make_dlrm_train_step
from torchkafka_tpu_torch.models.spec_decode import (
    SpecStats,
    speculative_generate,
    truncated_draft,
)
from torchkafka_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    make_train_step,
)

__all__ = [
    "DLRMConfig",
    "SpecStats",
    "Transformer",
    "TransformerConfig",
    "make_dlrm_train_step",
    "make_train_step",
    "speculative_generate",
    "truncated_draft",
]

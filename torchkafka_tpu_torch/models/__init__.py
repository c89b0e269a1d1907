"""The flagship decoder: config, parameters, prefill, decode math and
speculative decoding.

As in the JAX package, the ``generate`` FUNCTION is not re-exported here:
binding it at package level would shadow the ``models.generate``
submodule."""

from torchkafka_tpu_torch.models.spec_decode import (
    SpecStats,
    speculative_generate,
    truncated_draft,
)

__all__ = ["SpecStats", "speculative_generate", "truncated_draft"]

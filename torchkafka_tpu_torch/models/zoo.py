"""Named model scales for the flagship decoder: port of
``torchkafka_tpu/models/zoo.py``.

| scale | params | layout                              | serving dtype |
|-------|--------|-------------------------------------|---------------|
| 45m   | ~45M   | 512 × 4L, 8 heads (package default) | bf16          |
| 1b    | ~1.26B | 2048 × 24L, 16 q / 8 kv heads       | bf16 (2.5 GB) |
| 8b    | ~8.0B  | 4096 × 32L, 32 q / 8 kv heads,      | int8 (8.0 GB) |
|       |        | d_ff 14336, vocab 128256 (Llama-3)  |               |

``random_serving_params`` gives benchmark weights at the model's true
byte footprint, drawn directly on the device: the distribution does not
matter for serving measurements, only the bytes and the shapes.
"""

from __future__ import annotations

import torch

from torchkafka_tpu_torch.models.transformer import TransformerConfig, init_params


def zoo_config(scale: str, *, max_seq_len: int = 512) -> TransformerConfig:
    """A named model scale (the JAX package's shapes, torch dtypes)."""
    if scale == "45m":
        return TransformerConfig(
            max_seq_len=max_seq_len, param_dtype=torch.bfloat16
        )
    if scale == "1b":
        return TransformerConfig(
            vocab_size=32_000, d_model=2048, n_layers=24, n_heads=16,
            n_kv_heads=8, d_ff=5632, max_seq_len=max_seq_len,
            dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        )
    if scale == "8b":
        return TransformerConfig(
            vocab_size=128_256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq_len=max_seq_len,
            dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        )
    raise ValueError(f"unknown scale {scale!r} (want 45m | 1b | 8b)")


def random_serving_params(
    generator: torch.Generator, cfg: TransformerConfig, *,
    quantized: bool = False, device=None,
) -> dict:
    """Serving-shaped benchmark weights: ``init_params`` drawn on the
    device from ``generator`` in ``cfg.param_dtype`` (bf16 for the zoo's
    1b/8b, so the tree materialises at 2 bytes per parameter)."""
    if quantized:
        raise NotImplementedError(
            "random int8 serving weights are not ported yet (ROADMAP "
            "Queue A, serving follow-up 10)"
        )
    return init_params(generator, cfg, device)

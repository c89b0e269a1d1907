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
matter for serving measurements, only the bytes and the shapes. With
``quantized=True`` the weights are int8 ``QTensor``s drawn uniform in
[-127, 127] with per-output-channel scales chosen so the dequantized
magnitude matches the scaled-normal init (std 1/√fan_in); peak memory is
the int8 footprint itself, which is how the 8b scale serves (8.0 GB of
int8 weights and scales). The tree has the JAX package's structure,
shapes, dtypes and scale values; the int8 draws come from a
``torch.Generator`` and so differ from JAX's threefry draws. MoE configs
raise ``ValueError`` there, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from torchkafka_tpu_torch.models.quant import _LAYER_AXES, QTensor, quantized_nbytes
from torchkafka_tpu_torch.models.transformer import TransformerConfig, init_params
from torchkafka_tpu_torch.utils.devices import resolve_device

# Device bytes of a parameter tree (QTensor leaves count q + scale).
params_nbytes = quantized_nbytes

# Uniform over [-127, 127] has std 127/√3; scale = 1/(that · √fan_in) gives
# dequantized std 1/√fan_in, the init the trained path uses.
_UNIFORM_INT8_STD = 127.0 / math.sqrt(3.0)


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


def _rand_q(generator: torch.Generator, shape: tuple[int, ...],
            contract_axes: tuple[int, ...], device) -> QTensor:
    """Benchmark-weight QTensor drawn directly in int8 on ``device`` (no
    f32 transient), with the constant scale 1/(127/√3 · √fan_in) shaped
    with 1 on the contraction axes."""
    q = torch.randint(-127, 128, shape, generator=generator, dtype=torch.int8,
                      device=device)
    fan_in = math.prod(shape[ax] for ax in contract_axes)
    scale_shape = tuple(1 if ax in contract_axes else s for ax, s in enumerate(shape))
    scale = torch.full(
        scale_shape, 1.0 / (_UNIFORM_INT8_STD * math.sqrt(fan_in)),
        dtype=torch.float32, device=device,
    )
    return QTensor(q=q, scale=scale)


def random_serving_params(
    generator: torch.Generator, cfg: TransformerConfig, *,
    quantized: bool = False, device=None,
) -> dict:
    """Serving-shaped benchmark weights drawn on the device from
    ``generator`` (which must live there).

    quantized=False → ``init_params`` in ``cfg.param_dtype`` (bf16 for the
    zoo's 1b/8b, so the tree materialises at 2 bytes per parameter).
    quantized=True → int8 QTensors for ``embed``, ``lm_head`` and the
    seven layer weights, f32 ones for ``ln1``, ``ln2`` and ``ln_f`` (see
    the module docstring); dense configs only."""
    if not quantized:
        return init_params(generator, cfg, device)
    if cfg.is_moe:
        raise ValueError(
            "random_serving_params(quantized=True) covers the dense zoo "
            "scales; quantize a real MoE checkpoint via quantize_params"
        )
    dev = resolve_device(device)
    dm, dff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, k_, dh, v = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size
    shapes = {
        "wq": (nl, dm, h, dh), "wk": (nl, dm, k_, dh), "wv": (nl, dm, k_, dh),
        "wo": (nl, h, dh, dm),
        "w_gate": (nl, dm, dff), "w_up": (nl, dm, dff), "w_down": (nl, dff, dm),
    }
    embed = _rand_q(generator, (v, dm), (1,), dev)
    lm_head = _rand_q(generator, (dm, v), (0,), dev)
    layers: dict = {
        "ln1": torch.ones((nl, dm), dtype=torch.float32, device=dev),
        "ln2": torch.ones((nl, dm), dtype=torch.float32, device=dev),
    }
    for name, shape in shapes.items():
        layers[name] = _rand_q(generator, shape, _LAYER_AXES[name], dev)
    return {
        "embed": embed,
        "layers": layers,
        "ln_f": torch.ones((dm,), dtype=torch.float32, device=dev),
        "lm_head": lm_head,
    }

"""ResNet-50 inference: port of ``torchkafka_tpu/models/resnet.py``.

The JAX model runs NHWC activations over HWIO weights; this one keeps
the NHWC interface (``forward`` takes [B, H, W, 3] images, ``preprocess``
returns them) and runs the convolutions through
``torch.nn.functional.conv2d`` on NCHW views. The permuted view of an
NHWC tensor is already laid out ``channels_last``, the layout cuDNN's
tensor-core convolutions want on the card. Conv weights are stored OIHW;
``params_from_numpy`` converts the JAX package's HWIO trees at load.

Where the JAX model's semantics need care:

- ``"SAME"`` padding is asymmetric in JAX (low = total // 2, high = the
  rest), for the stride-2 convolutions and the 3×3 stride-2 max pool
  (padded with -inf). PyTorch's symmetric ``padding=`` would shift every
  stride-2 window by one pixel, so each call pads explicitly
  (``_same_pads``).
- Rounding order: JAX convolves compute-dtype operands into an f32
  result, applies the folded batch norm in f32 and casts once. Here the
  convolution's result is in the compute dtype before the f32 batch norm:
  at f32 the two are the same computation; at bf16 the port rounds each
  convolution's output once more (an extra bf16 rounding per layer).
- TF32: an f32 forward runs its convolutions and the classifier product
  with TF32 off (``_exact_f32``), whatever the process's flags say.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.tree import tree_leaves

# Bottleneck stage layout for ResNet-50: (blocks, mid_channels, stride).
_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32


def init_params(generator: torch.Generator, cfg: ResNetConfig = ResNetConfig(),
                device=None) -> dict:
    """He-normal conv weights (OIHW), identity folded batch norms, the
    classifier at std 1/√fan_in; drawn on ``device`` from ``generator``.
    The tree is the JAX package's, conv weights transposed to OIHW."""
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def conv(kh, kw, cin, cout):
        w = torch.randn((cout, cin, kh, kw), generator=generator, dtype=pd, device=dev)
        return w.mul_(math.sqrt(2.0 / (kh * kw * cin)))

    def bn(c):
        return {"scale": torch.ones((c,), dtype=pd, device=dev),
                "shift": torch.zeros((c,), dtype=pd, device=dev)}

    params: dict = {"stem": {"conv": conv(7, 7, 3, cfg.width), "bn": bn(cfg.width)}}
    cin = cfg.width
    for s, (blocks, mid, _stride) in enumerate(_STAGES):
        stage = []
        cout = mid * 4
        for b in range(blocks):
            blk = {"conv1": conv(1, 1, cin, mid), "bn1": bn(mid),
                   "conv2": conv(3, 3, mid, mid), "bn2": bn(mid),
                   "conv3": conv(1, 1, mid, cout), "bn3": bn(cout)}
            if b == 0:
                blk["proj"] = conv(1, 1, cin, cout)
                blk["bn_proj"] = bn(cout)
            stage.append(blk)
            cin = cout
        params[f"stage{s}"] = stage
    fc_w = torch.randn((cin, cfg.num_classes), generator=generator, dtype=pd, device=dev)
    params["fc"] = {"w": fc_w.div_(math.sqrt(cin)),
                    "b": torch.zeros((cfg.num_classes,), dtype=pd, device=dev)}
    return params


def params_from_numpy(tree: Any, device=None) -> Any:
    """The JAX package's ResNet tree as numpy arrays → the port's on
    ``device``: every 4-d (conv) weight HWIO → OIHW, the rest copied."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        arr = np.array(node)
        if arr.ndim == 4:
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        return torch.from_numpy(arr).to(dev)

    return walk(tree)


@contextlib.contextmanager
def _exact_f32(dtype):
    """TF32 off for cuDNN and cuBLAS while an f32 forward runs (restored
    after); nothing changes for a low-precision compute dtype."""
    if dtype != torch.float32:
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"``: out = ceil(size / stride), the total padding
    split low = total // 2, high = the rest."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """x [B, C, H, W] padded for a k×k window at ``stride`` under "SAME"."""
    top, bottom = _same_pads(x.shape[2], k, stride)
    left, right = _same_pads(x.shape[3], k, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, dtype) -> torch.Tensor:
    k = w.shape[-1]
    return F.conv2d(_pad_same(x.to(dtype), k, stride), w.to(dtype), stride=stride)


def _bn(x: torch.Tensor, bn: Mapping, dtype) -> torch.Tensor:
    scale = bn["scale"].float()[None, :, None, None]
    shift = bn["shift"].float()[None, :, None, None]
    return (x.float() * scale + shift).to(dtype)


def _bottleneck(x, blk, stride, dtype):
    out = torch.relu(_bn(_conv(x, blk["conv1"], 1, dtype), blk["bn1"], dtype))
    out = torch.relu(_bn(_conv(out, blk["conv2"], stride, dtype), blk["bn2"], dtype))
    out = _bn(_conv(out, blk["conv3"], 1, dtype), blk["bn3"], dtype)
    if "proj" in blk:
        x = _bn(_conv(x, blk["proj"], stride, dtype), blk["bn_proj"], dtype)
    return torch.relu(out + x)


def forward(params: dict, images: torch.Tensor, cfg: ResNetConfig = ResNetConfig()) -> torch.Tensor:
    """images: [B, H, W, 3] float (already normalized) → logits [B, classes] f32."""
    dt = cfg.dtype
    with _exact_f32(dt):
        x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        x = torch.relu(_bn(_conv(x, params["stem"]["conv"], 2, dt), params["stem"]["bn"], dt))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for s, (blocks, _mid, stride) in enumerate(_STAGES):
            for b in range(blocks):
                x = _bottleneck(x, params[f"stage{s}"][b], stride if b == 0 else 1, dt)
        x = x.float().mean(dim=(2, 3))
        return x @ params["fc"]["w"].float() + params["fc"]["b"].float()


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def preprocess(raw_uint8: torch.Tensor, out_size: int = 224) -> torch.Tensor:
    """[B, h, w, 3] uint8 frames → [B, out, out, 3] f32: scaled to [0, 1],
    resized bilinearly (half-pixel centres, antialiased when shrinking,
    as ``jax.image.resize(..., "bilinear")``) and normalized."""
    x = raw_uint8.float() / 255.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(out_size, out_size),
                      mode="bilinear", align_corners=False, antialias=True)
    x = x.permute(0, 2, 3, 1)
    mean = torch.tensor(_MEAN, device=x.device)
    std = torch.tensor(_STD, device=x.device)
    return (x - mean) / std


def count_params(params: dict) -> int:
    return int(sum(t.numel() for t in tree_leaves(params)))

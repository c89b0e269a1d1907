"""The part of ``jax.random`` that the package uses, in torch integer and
f32 ops: threefry2x32 keys as JAX derives them under
``jax_threefry_partitionable=True`` (its default), ``fold_in``, ``split``,
raw bits, uniforms, Gumbels and the categorical draw.

A key is its raw key data: an int64 tensor ``[..., 2]`` holding two
32-bit words. The words are carried in int64 and masked to 32 bits after
every add and shift (``torch.uint32`` lacks shifts and adds on some
backends). Leading dims batch the keys, as ``jax.vmap`` would: ``fold_in``
of ``[B, 2]`` keys and ``[B]`` data is ``vmap(jax.random.fold_in)``, and
``random_bits`` of ``[B, 2]`` keys draws ``shape`` per key. Every op stays
on the key's device with static shapes and no host sync.

What the functions compute, bit for bit against ``jax.random``:

- ``fold_in(key, d)`` = threefry2x32(key, (0, d));
- ``split(key, n)[i]`` = threefry2x32(key, (0, i));
- ``random_bits(key, shape)`` = out0 ^ out1 of threefry2x32(key, (hi, lo)),
  (hi, lo) the 64-bit flat index of each element of ``shape``;
- ``uniform`` = max(tiny, bitcast((bits >> 9) | 0x3F800000) - 1 + tiny);
- ``gumbel`` = -log(-log(uniform)) (the logs are torch's: within a few
  ulp of XLA's);
- ``categorical(key, logits)`` = argmax(gumbel + logits) over the last axis.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on 32-bit words held in int64 tensors or
    Python ints (broadcasting) → (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s data, int64 [2]: [seed >> 32, seed &
    0xFFFFFFFF], so ``key(0) == [0, 0]``. A negative seed is an int32's two's
    complement with a zero high word, as JAX gives without 64-bit mode."""
    seed = int(seed)
    hi = 0 if seed < 0 else (seed >> 32) & _MASK
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def fold_in_host(key_words, data: int) -> tuple[int, int]:
    """``fold_in`` of one key given as two Python ints, in Python ints: the
    host-side derivation of a record key, with no tensor work."""
    return threefry2x32(int(key_words[0]), int(key_words[1]), 0, int(data) & _MASK)


def _words(data, like: torch.Tensor):
    if isinstance(data, torch.Tensor):
        return data.to(device=like.device, dtype=torch.int64) & _MASK
    return int(data) & _MASK


def fold_in(key_: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2], data an int or an integer
    tensor broadcastable to [...] (taken mod 2**32, as JAX's uint32 cast)
    → [..., 2]."""
    y0, y1 = threefry2x32(key_[..., 0], key_[..., 1], 0, _words(data, key_))
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key_: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys [..., 2] → [..., num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key_.device)
    y0, y1 = threefry2x32(key_[..., 0, None], key_[..., 1, None], 0, i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key_: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): keys [..., 2] → [..., *shape] int64
    holding uint32 values, counted over the flat index of ``shape``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=key_.device)
    y0, y1 = threefry2x32(
        key_[..., 0, None], key_[..., 1, None], i >> 32, i & _MASK
    )
    return (y0 ^ y1).reshape(*key_.shape[:-1], *shape)


def uniform(key_: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)``,
    the draw under ``gumbel``: f32 in [tiny, 1)."""
    bits = random_bits(key_, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min((mant - 1.0) + _TINY, _TINY)


def gumbel(key_: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"), f32. Both logs run in f64 and
    the result rounds to f32 once, so the CPU and CUDA paths, whose f32
    ``log`` round apart, give the same f32 values; within 2 ulp of XLA's
    f32 evaluation, at the scale of max(|g|, 1)."""
    return (-torch.log(-torch.log(uniform(key_, shape).double()))).float()


def categorical(key_: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``. ``key_`` [*kb, 2]
    batches the draw over the leading ``kb`` dims of ``logits``: one key
    [2] draws Gumbels over all of ``logits`` (flat index across rows), keys
    [B, 2] draw row b of [B, V] logits with key b. → int64 indices."""
    g = gumbel(key_, logits.shape[key_.dim() - 1:])
    return torch.argmax(g + logits, dim=-1)

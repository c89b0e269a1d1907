"""Device-side unpack for the sub-byte wire codec (``native.pack_bits``):
port of ``torchkafka_tpu/ops/bitpack.py``.

The host packs rows of ``bits``-bit values into a dense little-endian bit
stream (one C call per chunk, ``fixed_width(wire_bits=)``); this op
unpacks them on the tensor's own device with three gathers of a 3-byte
window, a shift and a mask. It is a plain integer op in both packages
(no kernel): on the card PyTorch's elementwise kernels run it.

Layout contract (shared with ``native.pack_bits``/``packed_width``): value
i of a row occupies bit positions [i·bits, (i+1)·bits) of the row's
little-endian bit stream. The window's tail indices are clipped to the
buffer; a clipped (duplicated) byte only ever contributes bit positions
the final mask discards, so no row padding is needed.
"""

from __future__ import annotations

import torch

from torchkafka_tpu_torch.native import packed_width


def unpack_bits(packed: torch.Tensor, bits: int, seq: int) -> torch.Tensor:
    """[..., W] uint8 → [..., seq] int32 (W = ``packed_width(seq, bits)``),
    on ``packed``'s device (a NumPy array, as JAX's op takes one, unpacks
    on the CPU)."""
    packed = torch.as_tensor(packed)
    if not 1 <= bits <= 16:
        raise ValueError("bits must be in [1, 16]")
    w = packed.shape[-1]
    expect = packed_width(seq, bits)
    if w != expect:
        raise ValueError(
            f"packed width {w} != packed_width({seq}, {bits}) = {expect}"
        )
    start = torch.arange(seq, dtype=torch.int64, device=packed.device) * bits
    byte0 = start >> 3
    shift = (start & 7).to(torch.int32)
    b = packed.to(torch.int32)
    last = w - 1
    b0 = b.index_select(-1, byte0)
    b1 = b.index_select(-1, torch.clamp(byte0 + 1, max=last))
    b2 = b.index_select(-1, torch.clamp(byte0 + 2, max=last))
    window = b0 | (b1 << 8) | (b2 << 16)
    return (window >> shift) & ((1 << bits) - 1)

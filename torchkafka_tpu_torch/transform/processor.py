"""The user-extension point: per-record transforms.

Copy of ``torchkafka_tpu/transform/processor.py``, imports re-rooted; its
one ``jax.tree_util`` use is the port's own ``utils.tree``. Fixed shapes
matter here as they do for XLA: the batcher stacks rows into preallocated
buffers.

Capability parity with the reference's single extension hook,
``KafkaDataset._process(record) -> data | None``
(/root/reference/src/kafka_dataset.py:173-186): a processor maps one record to
a pytree of fixed-shape NumPy arrays, or None to drop the record
(/root/reference/src/kafka_dataset.py:161-162, README.md:59 — the drop
contract). The TPU-facing difference is explicit in the type: outputs must be
*fixed-shape* arrays, because XLA compiles static shapes; ragged data must be
padded/truncated here, at the record level, where the user knows the domain.

Processors are plain callables — no subclassing required (though the compat
layer's KafkaDataset._process maps straight onto this).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Optional

import numpy as np

from torchkafka_tpu_torch.source.records import Record
from torchkafka_tpu_torch.utils.tree import tree_map

# A processor maps a record to a pytree of np.ndarray (all leaves fixed-shape
# across records) or None to drop the record.
Processor = Callable[[Record], Optional[Any]]


def chunked(fn: Callable) -> Callable:
    """Mark ``fn(records: list[Record]) -> (stacked_pytree, keep_mask|None)``
    as a chunk processor: the stream hands it a whole poll chunk and it
    returns [K, ...]-stacked arrays (plus an optional boolean keep mask,
    False = drop — the vectorized form of the reference's None-drop contract).

    This is the throughput path: one Python call per poll chunk instead of
    per record, with decode work done as single NumPy (or native) ops.
    """
    fn.chunked = True  # type: ignore[attr-defined]
    return fn


def is_chunked(fn: Callable) -> bool:
    return bool(getattr(fn, "chunked", False))


def fixed_width(
    seq_len: int, dtype=np.int32, pad_value: int = 0, wire_dtype=None,
    wire_bits: int | None = None,
) -> Callable:
    """Chunk processor for fixed-width binary records: each record value is
    ``seq_len`` items of ``dtype`` (the BASELINE token-stream shape). Exact-
    width chunks decode with one join + one frombuffer (two memcpy-scale ops
    for the whole chunk); ragged stragglers fall back to a per-record
    pad/truncate. Uses the native C++ decoder when built (torchkafka_tpu_torch.native).

    ``wire_dtype``: optional narrower dtype the decoded rows are cast to
    before leaving the host — the batch travels host→device in this dtype.
    Host↔device bandwidth is the scarce resource on an ingest pipeline
    (HBM/PCIe/ICI all beat it); token ids under 65536 in ``uint16`` halve
    the wire bytes and gather into embeddings on-device without widening.
    The cast asserts the values fit (overflow would corrupt ids silently).

    ``wire_bits``: go below byte granularity — rows pack into a dense
    little-endian bit stream (native.pack_bits, one C call per chunk) and
    travel as uint8[packed_width]; the consumer unpacks ON DEVICE with
    ``ops.bitpack.unpack_bits(batch, wire_bits, seq_len)`` (three gathers
    + shift + mask, fused into the embedding lookup). A 15-bit vocabulary
    rides the wire at 15/16 of uint16. Exclusive with ``wire_dtype``;
    requires non-negative values < 2^wire_bits (checked per chunk).
    """
    if wire_bits is not None:
        # The packed rows need ops/bitpack.py's device-side unpack.
        raise NotImplementedError(
            "wire_bits= is not ported yet (ROADMAP Queue A, slice 2 "
            "deferred: ops/bitpack.py)"
        )
    if wire_bits is not None and wire_dtype is not None:
        raise ValueError("wire_bits and wire_dtype are exclusive")
    if wire_bits is not None and not 1 <= wire_bits <= 16:
        raise ValueError("wire_bits must be in [1, 16]")
    if wire_bits is not None and not np.issubdtype(np.dtype(dtype), np.integer):
        # The range guard below cannot see fractional parts — a float 3.7
        # passes [0, 2^bits) and then truncates silently in the pack.
        raise ValueError("wire_bits requires an integer record dtype")
    if wire_bits is not None and not 0 <= pad_value < (1 << wire_bits):
        # A short record padded with an out-of-range value would trip the
        # per-chunk range guard with an error blaming the RECORDS; catch
        # the misconfiguration where it lives, at construction.
        raise ValueError(
            f"pad_value {pad_value} outside [0, 2^{wire_bits}) — padded "
            "rows could not be bit-packed"
        )

    @chunked
    def process(records: list[Record]):
        from torchkafka_tpu_torch import native

        rows = native.gather_rows([r.value for r in records], seq_len, dtype, pad_value)
        if wire_bits is not None:
            if rows.size and (rows.min() < 0 or rows.max() >= 1 << wire_bits):
                raise ValueError(
                    f"record values outside [0, 2^{wire_bits}) — bit "
                    "packing would corrupt them"
                )
            return native.pack_bits(rows, wire_bits), None
        if wire_dtype is not None:
            info = np.iinfo(wire_dtype)
            if rows.size and (rows.min() < info.min or rows.max() > info.max):
                raise ValueError(
                    f"record values outside {np.dtype(wire_dtype).name} range "
                    f"[{info.min}, {info.max}] — narrowing would corrupt them"
                )
            rows = rows.astype(wire_dtype)
        return rows, None

    return process


def json_tokens(
    field: str, seq_len: int, pad_id: int = 0
) -> Callable:
    """Chunk processor: flat-JSON records → int32[seq_len] token rows via the
    native C++ field scanner (one C call per poll chunk; utf-8-byte
    tokenization, the same stand-in tokenizer as ``json_field``'s default —
    but raw bytes, escape sequences are not decoded). Records whose field is
    missing/invalid are dropped (keep mask), the vectorized form of the
    reference's None-drop (/root/reference/src/kafka_dataset.py:161-162).

    Use ``chunk_of(json_field(...))`` instead when you need full JSON
    semantics (escape decoding, nested objects, custom tokenizers).
    """

    @chunked
    def process(records: list[Record]):
        from torchkafka_tpu_torch import native

        tokens, keep = native.json_tokens_scan(
            [r.value for r in records], field, seq_len, pad_id
        )
        mask = keep.astype(bool)
        if mask.all():
            return tokens, None
        if not mask.any():
            return None, mask
        return tokens[mask], mask

    return process


def chunk_of(per_record: Processor) -> Callable:
    """Lift a per-record processor into a chunk processor (convenience — no
    speedup, but lets one code path serve both)."""

    @chunked
    def process(records: list[Record]):
        elements = [per_record(r) for r in records]
        keep = np.array([e is not None for e in elements], dtype=bool)
        kept = [e for e in elements if e is not None]
        if not kept:
            return None, keep
        stacked = tree_map(lambda *xs: np.stack(xs), *kept)
        return stacked, keep

    return process


def raw_bytes(length: int, dtype=np.uint8, pad_value: int = 0) -> Processor:
    """Record value -> fixed-length byte vector (truncate/zero-pad)."""

    def process(record: Record):
        buf = np.frombuffer(record.value[:length], dtype=np.uint8)
        if buf.shape[0] < length:
            buf = np.concatenate(
                [buf, np.full(length - buf.shape[0], pad_value, dtype=np.uint8)]
            )
        return buf.astype(dtype, copy=False)

    return process


def json_field(
    field: str,
    seq_len: int,
    tokenizer: Callable[[str], list[int]] | None = None,
    pad_id: int = 0,
    drop_invalid: bool = True,
) -> Processor:
    """JSON record -> int32 token ids of fixed ``seq_len`` (BASELINE config 2
    shape: JSON records -> tokenized int32 batches).

    Invalid JSON / missing field -> None (record dropped) when
    ``drop_invalid``, else raises. Default tokenizer is bytes-of-utf8 — a
    stand-in with the right shape; swap in a real tokenizer callable.
    """
    tok = tokenizer if tokenizer is not None else (lambda s: list(s.encode("utf-8")))

    def process(record: Record):
        try:
            obj = json.loads(record.value)
            text = obj[field]
            if not isinstance(text, str):
                raise TypeError(f"field {field!r} is {type(text).__name__}, not str")
            ids = tok(text)
        except (json.JSONDecodeError, KeyError, UnicodeDecodeError, TypeError,
                AttributeError, IndexError):
            # One malformed record (non-object root, wrong-typed field,
            # tokenizer blowup) must drop, not kill the whole pipeline.
            if drop_invalid:
                return None
            raise
        ids = ids[:seq_len]
        out = np.full(seq_len, pad_id, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    return process


def compose(*fns: Callable) -> Processor:
    """Chain callables left-to-right; None short-circuits (drop)."""

    def process(record: Record):
        x: Any = record
        for f in fns:
            x = f(x)
            if x is None:
                return None
        return x

    return process

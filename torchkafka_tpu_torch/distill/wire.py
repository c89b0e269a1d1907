"""Framed wire format for the distill topic — committed completions only.

Copy of ``torchkafka_tpu/distill/wire.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

One frame = one COMMITTED completion: the prompt ids the serving fleet
admitted, the tokens its target model actually committed (exactly-once
replicas stage the frame inside the same transaction as the output and
the offset, so no divergent-canary or zombie output ever reaches the
corpus), the tenant key, and the model version that produced it. Same
no-pickle discipline as ``source/checkpoint_wire.py``: a magic, a
length-prefixed JSON header, raw little-endian int32 payload bytes, and
a CRC over the payload so a torn frame is REJECTED, never trained on.

Layout::

    b"DSTL" | u32 header_len (BE) | JSON header | prompt int32 | tokens int32

Header fields: ``v`` (wire version), ``mv`` (model version that served
it), ``tenant`` (record key, latin-1 round-trip — arbitrary bytes
survive), ``np``/``nt`` (prompt/token counts), ``crc`` (crc32 of the
concatenated payload bytes).

``distill_processor`` adapts frames to the EXISTING training plane: a
per-record KafkaStream processor returning ``{"tokens": [S] int32,
"mask": [S] int32}`` — prompt ++ committed tokens left-aligned into a
fixed training width (static shapes; the stream's batcher stacks them),
mask 1 over real positions. Malformed frames return ``None`` (the
stream's documented DROP signal): the corpus is at-least-once, so a
torn record costs one sample, not the trainer.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from torchkafka_tpu_torch.errors import DistillWireError

MAGIC = b"DSTL"
WIRE_VERSION = 1
_LEN = struct.Struct(">I")
# JSON headers are small; anything past this is a corrupt length field,
# not a real header — bound it so a torn frame can't ask for gigabytes.
_MAX_HEADER = 1 << 16


def encode_completion(
    prompt, tokens, *, tenant: bytes | None, model_version: int
) -> bytes:
    """Frame one committed completion. ``tenant`` is the raw record key
    (``None`` → empty); prompt/tokens are int32 id sequences."""
    p = np.ascontiguousarray(np.asarray(prompt, np.int32))
    t = np.ascontiguousarray(np.asarray(tokens, np.int32))
    if p.ndim != 1 or t.ndim != 1:
        raise DistillWireError("prompt/tokens must be 1-D id sequences")
    payload = p.tobytes() + t.tobytes()
    header = json.dumps(
        {
            "v": WIRE_VERSION,
            "mv": int(model_version),
            "tenant": (tenant or b"").decode("latin-1"),
            "np": int(p.shape[0]),
            "nt": int(t.shape[0]),
            "crc": zlib.crc32(payload) & 0xFFFFFFFF,
        },
        separators=(",", ":"),
    ).encode("utf-8")
    return MAGIC + _LEN.pack(len(header)) + header + payload


def decode_completion(buf: bytes) -> dict:
    """Parse + validate one frame → dict(prompt, tokens, tenant,
    model_version). Raises :class:`DistillWireError` on anything torn."""
    if not isinstance(buf, (bytes, bytearray, memoryview)):
        raise DistillWireError("frame must be bytes")
    buf = bytes(buf)
    if len(buf) < len(MAGIC) + _LEN.size or buf[: len(MAGIC)] != MAGIC:
        raise DistillWireError("bad distill frame magic")
    (hlen,) = _LEN.unpack_from(buf, len(MAGIC))
    if hlen > _MAX_HEADER:
        raise DistillWireError(f"header length {hlen} exceeds bound")
    start = len(MAGIC) + _LEN.size
    if len(buf) < start + hlen:
        raise DistillWireError("truncated distill header")
    try:
        header = json.loads(buf[start : start + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise DistillWireError(f"undecodable distill header: {exc}") from exc
    if not isinstance(header, dict) or header.get("v") != WIRE_VERSION:
        raise DistillWireError("unknown distill wire version")
    try:
        n_p, n_t = int(header["np"]), int(header["nt"])
        crc = int(header["crc"])
        mv = int(header["mv"])
        tenant = str(header["tenant"]).encode("latin-1")
    except (KeyError, TypeError, ValueError) as exc:
        raise DistillWireError(f"malformed distill header: {exc}") from exc
    if n_p < 0 or n_t < 0:
        raise DistillWireError("negative sequence length")
    payload = buf[start + hlen :]
    want = 4 * (n_p + n_t)
    if len(payload) != want:
        raise DistillWireError(
            f"payload length {len(payload)} != declared {want}"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise DistillWireError("distill payload CRC mismatch")
    ids = np.frombuffer(payload, dtype=np.int32)
    return {
        "prompt": ids[:n_p].copy(),
        "tokens": ids[n_p:].copy(),
        "tenant": tenant,
        "model_version": mv,
    }


def distill_processor(seq_len: int):
    """Per-record KafkaStream processor: frame → ``{"tokens": [S] int32,
    "mask": [S] int32}`` (prompt ++ committed tokens, left-aligned,
    truncated/zero-padded to ``seq_len``). Malformed frames → ``None``
    (the stream's drop signal) so one torn record never stalls training.
    """
    if seq_len < 2:
        raise ValueError("seq_len must be >= 2 (next-token loss shifts)")

    def process(record) -> dict | None:
        try:
            rec = decode_completion(record.value)
        except DistillWireError:
            return None
        seq = np.concatenate([rec["prompt"], rec["tokens"]])[:seq_len]
        n = seq.shape[0]
        toks = np.zeros(seq_len, np.int32)
        toks[:n] = seq
        mask = np.zeros(seq_len, np.int32)
        mask[:n] = 1
        return {"tokens": toks, "mask": mask}

    return process

"""Checkpoint wire: versioned model weights as CRC'd broker frames.

The rollout plane's data format — the PrefillHandoff wire discipline
(length-prefixed JSON header + raw array bytes, no pickle) applied to
whole checkpoints. A checkpoint version is TWO frame kinds on one topic:

- a MANIFEST frame (magic ``CKMF``): the version id, the kind
  (``serving`` or ``draft`` — ROADMAP item 1's distilled-draft refresh
  rides the same plane), every array's name/dtype/shape in the
  deterministic flatten order, the chunking geometry, a CRC per chunk
  and a CRC over the whole payload;
- N CHUNK frames (magic ``CKCH``): the raw payload split at
  ``chunk_bytes`` boundaries, each self-describing (version, index,
  size) and self-checking (CRC over its own bytes).

Chunking is what makes the torn-frame story testable byte-by-byte: a
truncated or bit-flipped frame — at ANY byte — decodes to
``CheckpointWireError``, never to a crash and never to silently wrong
weights. The fetch path verifies chunk CRCs, assembly completeness, the
payload CRC, and finally dtype/shape against the incumbent tree
(``rebuild_tree``); a replica that rejects keeps serving the incumbent
and a re-published checkpoint converges. Frames are idempotent by
(version, index): a duplicate or re-publish overwrites with identical
bytes, so last-wins assembly is deterministic.

Arrays travel in the tree's flatten order (dict keys sorted, sequence
elements by index) so every process — publisher on one machine, replica
on another — maps name ↔ bytes identically without negotiation.

Port of ``torchkafka_tpu/source/checkpoint_wire.py``. The frame layout,
CRCs and chunking are the JAX package's, so a numpy-only tree encodes to
the same bytes. The port's trees are torch trees: leaves may be CPU or
CUDA tensors (``QTensor`` pairs included), each copied to the host by
``flatten_params``. NumPy has no bfloat16, so a bf16 leaf travels as its
16-bit patterns under the logical dtype ``bfloat16`` in the manifest,
which is what the JAX package writes for its bf16 arrays (the ml_dtypes
name); ``fetch_checkpoint`` returns such an array as a CPU bf16 tensor.
``rebuild_tree`` places each array on its incumbent leaf's device in the
leaf's dtype, so the caller gets a tree it can serve at once.
"""

from __future__ import annotations

import json
import zlib

import numpy as np
import torch

from torchkafka_tpu_torch.errors import CheckpointWireError
from torchkafka_tpu_torch.source.records import TopicPartition

_WIRE_VERSION = 1
_MANIFEST_MAGIC = b"CKMF"
_CHUNK_MAGIC = b"CKCH"
DEFAULT_CHUNK_BYTES = 1 << 18


_BF16 = "bfloat16"


def _host_leaf(node):
    """A leaf as the wire carries it: a numpy array, or a CPU bf16 tensor
    (numpy has no bf16). Tensors are detached and copied to the host."""
    if isinstance(node, torch.Tensor):
        t = node.detach().to("cpu")
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(node)


def _dtype_name(a) -> str:
    """The manifest's dtype name of a host leaf, or of an incumbent leaf:
    numpy's name, ``bfloat16`` for bf16 tensors, and a tensor's numpy
    counterpart's name otherwise."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=a.dtype).numpy().dtype)
    return str(np.asarray(a).dtype)


def _wire_dtype(name: str) -> np.dtype:
    """The numpy dtype a manifest's array is read with: bf16 payloads are
    read as their int16 bit patterns."""
    return np.dtype(np.int16) if name == _BF16 else np.dtype(name)


def _raw_bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):  # bf16: its bit patterns
        return a.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def flatten_params(tree) -> list[tuple[str, object]]:
    """The deterministic tree walk: nested dicts by sorted key, lists and
    tuples (``QTensor`` pairs too) by index, leaves on the host as numpy
    arrays, or CPU bf16 tensors — the single flatten order both ends of
    the wire share. Paths join with ``/`` (key names in the model trees
    never contain it)."""
    flat: list[tuple[str, object]] = []

    def walk(node, path: str) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, f"{path}/{i}" if path else str(i))
        else:
            flat.append((path, _host_leaf(node)))

    walk(tree, "")
    return flat


def rebuild_tree(template, flat: dict):
    """Rebuild a params tree with the SAME structure as ``template`` but
    the wire's arrays as leaves — the incumbent tree is the schema, so a
    checkpoint that drops, adds, reshapes or retypes an array is rejected
    (``CheckpointWireError``) before any weight is touched. A tensor leaf
    of ``template`` comes back as a tensor on that leaf's device in its
    dtype (bf16 bit patterns reinterpreted); a numpy leaf as the wire's
    numpy array. Returns a new tree; ``template`` is only read."""
    used: set[str] = set()

    def walk(node, path: str):
        if isinstance(node, dict):
            return {
                k: walk(node[k], f"{path}/{k}" if path else str(k))
                for k in node
            }
        if isinstance(node, (list, tuple)):
            rebuilt = [
                walk(item, f"{path}/{i}" if path else str(i))
                for i, item in enumerate(node)
            ]
            if hasattr(node, "_fields"):  # a NamedTuple (QTensor)
                return type(node)(*rebuilt)
            return type(node)(rebuilt) if isinstance(node, tuple) else rebuilt
        arr = flat.get(path)
        if arr is None:
            raise CheckpointWireError(
                f"checkpoint is missing array {path!r}"
            )
        want, got = _dtype_name(node), _dtype_name(arr)
        shape = tuple(node.shape) if hasattr(node, "shape") else np.shape(node)
        if tuple(arr.shape) != tuple(shape) or got != want:
            raise CheckpointWireError(
                f"checkpoint array {path!r} is {got}{tuple(arr.shape)}, "
                f"incumbent is {want}{tuple(shape)}"
            )
        used.add(path)
        if not isinstance(node, torch.Tensor):
            return arr
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(node.device, copy=True)

    tree = walk(template, "")
    extra = set(flat) - used
    if extra:
        raise CheckpointWireError(
            f"checkpoint carries arrays the incumbent tree has no slot "
            f"for: {sorted(extra)[:4]}"
        )
    return tree


# ------------------------------------------------------------------ framing


def _frame(magic: bytes, header: dict, payload: bytes = b"") -> bytes:
    hb = json.dumps(header).encode()
    return b"".join((magic, len(hb).to_bytes(4, "big"), hb, payload))


def _open_frame(data: bytes, magic: bytes, what: str) -> tuple[dict, bytes]:
    """Shared validation for both frame kinds: magic, length prefix,
    JSON header, wire version — every malformation (including truncation
    at ANY byte) is ``CheckpointWireError``."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise CheckpointWireError(f"{what} frame is not bytes")
    data = bytes(data)
    if len(data) < 8:
        raise CheckpointWireError(
            f"{what} frame truncated at {len(data)} bytes"
        )
    if data[:4] != magic:
        raise CheckpointWireError(
            f"{what} frame has magic {data[:4]!r}, want {magic!r}"
        )
    hlen = int.from_bytes(data[4:8], "big")
    if len(data) < 8 + hlen:
        raise CheckpointWireError(
            f"{what} frame truncated inside header "
            f"({len(data)} of {8 + hlen} bytes)"
        )
    try:
        header = json.loads(data[8:8 + hlen].decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise CheckpointWireError(
            f"{what} frame header is not JSON: {exc}"
        ) from exc
    if not isinstance(header, dict):
        raise CheckpointWireError(f"{what} frame header is not an object")
    if header.get("v") != _WIRE_VERSION:
        raise CheckpointWireError(
            f"unknown {what} wire version {header.get('v')!r}"
        )
    return header, data[8 + hlen:]


def encode_manifest(
    version: int, kind: str, arrays, chunk_bytes: int,
    chunk_crcs: list[int], payload_crc: int, total_bytes: int,
) -> bytes:
    header = {
        "v": _WIRE_VERSION,
        "version": int(version),
        "kind": kind,
        "arrays": [
            {"name": name, "dtype": _dtype_name(a), "shape": list(a.shape)}
            for name, a in arrays
        ],
        "chunk_bytes": int(chunk_bytes),
        "n_chunks": len(chunk_crcs),
        "chunk_crcs": [int(c) for c in chunk_crcs],
        "payload_crc": int(payload_crc),
        "total_bytes": int(total_bytes),
    }
    return _frame(_MANIFEST_MAGIC, header)


def decode_manifest(data: bytes) -> dict:
    header, rest = _open_frame(data, _MANIFEST_MAGIC, "manifest")
    if rest:
        raise CheckpointWireError(
            f"manifest frame has {len(rest)} trailing bytes"
        )
    try:
        version = int(header["version"])
        kind = str(header["kind"])
        arrays = [
            (str(m["name"]), str(m["dtype"]), tuple(
                int(x) for x in m["shape"]))
            for m in header["arrays"]
        ]
        for _, dt, _shape in arrays:
            _wire_dtype(dt)
        chunk_crcs = [int(c) for c in header["chunk_crcs"]]
        n_chunks = int(header["n_chunks"])
        out = {
            "version": version,
            "kind": kind,
            "arrays": arrays,
            "chunk_bytes": int(header["chunk_bytes"]),
            "n_chunks": n_chunks,
            "chunk_crcs": chunk_crcs,
            "payload_crc": int(header["payload_crc"]),
            "total_bytes": int(header["total_bytes"]),
        }
    except (KeyError, TypeError, ValueError) as exc:
        raise CheckpointWireError(
            f"manifest header malformed: {exc!r}"
        ) from exc
    if len(chunk_crcs) != n_chunks:
        raise CheckpointWireError(
            f"manifest claims {n_chunks} chunks but lists "
            f"{len(chunk_crcs)} CRCs"
        )
    declared = sum(
        _wire_dtype(dt).itemsize * int(np.prod(shape, dtype=np.int64))
        if shape else _wire_dtype(dt).itemsize
        for _, dt, shape in out["arrays"]
    )
    if declared != out["total_bytes"]:
        raise CheckpointWireError(
            f"manifest arrays sum to {declared} bytes, claims "
            f"{out['total_bytes']}"
        )
    return out


def encode_chunk(version: int, idx: int, payload: bytes) -> bytes:
    header = {
        "v": _WIRE_VERSION,
        "version": int(version),
        "idx": int(idx),
        "size": len(payload),
        "crc": zlib.crc32(payload) & 0xFFFFFFFF,
    }
    return _frame(_CHUNK_MAGIC, header, payload)


def decode_chunk(data: bytes) -> tuple[int, int, bytes]:
    """Returns ``(version, idx, payload)`` — size- and CRC-verified."""
    header, payload = _open_frame(data, _CHUNK_MAGIC, "chunk")
    try:
        version = int(header["version"])
        idx = int(header["idx"])
        size = int(header["size"])
        crc = int(header["crc"])
    except (KeyError, TypeError, ValueError) as exc:
        raise CheckpointWireError(f"chunk header malformed: {exc!r}") from exc
    if len(payload) != size:
        raise CheckpointWireError(
            f"chunk {idx} of version {version} truncated "
            f"({len(payload)} of {size} payload bytes)"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CheckpointWireError(
            f"chunk {idx} of version {version} fails CRC"
        )
    return version, idx, payload


# --------------------------------------------------------- publish / fetch


def checkpoint_frames(
    version: int, params, *, kind: str = "serving",
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> list[bytes]:
    """Encode ``params`` as its ordered frame list (manifest first) —
    the unit the publisher produces and the fuzz tests mutilate."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    flat = flatten_params(params)
    payload = b"".join(_raw_bytes(a) for _, a in flat)
    chunks = [
        payload[i:i + chunk_bytes]
        for i in range(0, len(payload), chunk_bytes)
    ] or [b""]
    frames = [encode_manifest(
        version, kind, flat, chunk_bytes,
        [zlib.crc32(c) & 0xFFFFFFFF for c in chunks],
        zlib.crc32(payload) & 0xFFFFFFFF, len(payload),
    )]
    frames.extend(
        encode_chunk(version, i, c) for i, c in enumerate(chunks)
    )
    return frames


def publish_checkpoint(
    broker, topic: str, version: int, params, *, kind: str = "serving",
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> int:
    """Produce a checkpoint version onto ``topic`` (manifest, then every
    chunk, keyed by version so a tail can group frames). Idempotent by
    construction: re-publishing a version appends identical-content
    frames and last-wins assembly converges. Returns frames produced."""
    frames = checkpoint_frames(
        version, params, kind=kind, chunk_bytes=chunk_bytes,
    )
    key = str(int(version)).encode()
    for frame in frames:
        broker.produce(topic, frame, key=key)
    return len(frames)


def fetch_checkpoint(
    broker, topic: str, version: int,
) -> tuple[dict[str, np.ndarray], dict]:
    """Assemble and verify checkpoint ``version`` from ``topic``.

    Last-published manifest for the version wins (a corrupt publish
    followed by a clean re-publish converges); chunks are last-wins by
    index, individually CRC'd, then the assembled payload is CRC'd whole
    before slicing into named arrays. ANY defect — missing manifest,
    missing chunk, torn frame, CRC mismatch, size drift — raises
    ``CheckpointWireError``; the caller keeps the incumbent weights.
    Returns ``(name → array, manifest)``; a bf16 array is a CPU bf16
    tensor, every other a numpy array."""
    version = int(version)
    tp = TopicPartition(topic, 0)
    try:
        end = broker.end_offset(tp)
        records = broker.fetch(tp, 0, end) if end else []
    except Exception as exc:  # noqa: BLE001 - unknown topic, transport
        raise CheckpointWireError(
            f"cannot read checkpoint topic {topic!r}: {exc}"
        ) from exc
    manifest: dict | None = None
    chunks: dict[int, bytes] = {}
    for rec in records:
        value = rec.value or b""
        if value[:4] == _MANIFEST_MAGIC:
            try:
                m = decode_manifest(value)
            except CheckpointWireError:
                continue  # torn manifest: a later re-publish may supersede
            if m["version"] == version:
                manifest = m
                chunks.clear()  # chunks published before this manifest
        elif value[:4] == _CHUNK_MAGIC and manifest is not None:
            try:
                v, idx, payload = decode_chunk(value)
            except CheckpointWireError:
                continue  # torn chunk: assembly fails as missing below
            if v == version:
                chunks[idx] = payload
    if manifest is None:
        raise CheckpointWireError(
            f"no valid manifest for version {version} on {topic!r}"
        )
    missing = [i for i in range(manifest["n_chunks"]) if i not in chunks]
    if missing:
        raise CheckpointWireError(
            f"version {version} is missing chunks {missing[:4]} "
            f"(of {manifest['n_chunks']})"
        )
    for i in range(manifest["n_chunks"]):
        if zlib.crc32(chunks[i]) & 0xFFFFFFFF != manifest["chunk_crcs"][i]:
            raise CheckpointWireError(
                f"version {version} chunk {i} does not match its "
                "manifest CRC"
            )
    payload = b"".join(chunks[i] for i in range(manifest["n_chunks"]))
    if len(payload) != manifest["total_bytes"]:
        raise CheckpointWireError(
            f"version {version} assembled to {len(payload)} bytes, "
            f"manifest claims {manifest['total_bytes']}"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != manifest["payload_crc"]:
        raise CheckpointWireError(
            f"version {version} assembled payload fails CRC"
        )
    flat: dict = {}
    off = 0
    for name, dtn, shape in manifest["arrays"]:
        dt = _wire_dtype(dtn)
        n = (
            dt.itemsize * int(np.prod(shape, dtype=np.int64))
            if shape else dt.itemsize
        )
        try:
            arr = np.frombuffer(
                payload, dtype=dt, count=n // dt.itemsize, offset=off,
            ).reshape(shape).copy()
        except ValueError as exc:
            raise CheckpointWireError(
                f"version {version} array {name!r} unreadable: {exc}"
            ) from exc
        flat[name] = (
            torch.from_numpy(arr).view(torch.bfloat16) if dtn == _BF16 else arr
        )
        off += n
    return flat, manifest

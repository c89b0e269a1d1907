"""Native (C++) hot-path decoders, with pure-NumPy fallbacks.

Copy of ``torchkafka_tpu/native/`` (``_decode.cpp`` byte for byte, and
the decoders below), with the port's own loader:

- ``_decode.cpp`` compiles with g++ at FIRST USE, not at import, into
  ``torchkafka_tpu_torch/_build/`` (gitignored) under a name keyed by a
  hash of the source, the flags and the Python headers, and loads as a
  CPython extension; no pip/pybind11 involved;
- the compiler writes to a per-process temporary name and the result is
  renamed into place, so concurrent processes (test workers) never see a
  half-written library and never race on one temporary file; the build
  runs under ``utils.buildlock.build_lock``, so processes that load at
  once build once;
- without a toolchain the pure-Python fallbacks below serve identical
  semantics (the reference's NumPy path, differential-tested), so the
  native path stays a throughput lever, not a dependency.

Public surface:
- ``available()`` — True when the extension built and loaded.
- ``gather_rows(values, width, dtype, pad)`` — list[bytes] → [n, width] array.
- ``json_tokens_scan(values, field, seq_len, pad_id)`` — list[bytes] →
  (int32 [n, seq_len], keep uint8 [n]); minimal flat-JSON string-field scan,
  utf-8-byte tokenization (raw bytes — escape sequences are not decoded).
- ``decode_png_rgb(values, height, width)`` — list[bytes] of 8-bit RGB PNGs
  → (uint8 [n, h, w, 3], keep uint8 [n]); real zlib inflate + all five
  scanline filters; keep=0 (zeroed row) for anything structurally invalid
  or with mismatched dimensions. Chunk CRCs are not verified (Kafka already
  checksums the payload; corruption fails structurally → drop).
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

from torchkafka_tpu_torch.utils.buildlock import build_lock

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "_decode.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_tried = False
# The loaded extension once ``_lib()`` has run, else None. Setting it to
# None forces the NumPy fallbacks, as ``native._native = None`` does in the
# JAX package (the differential tests' switch).
_native = None


def _target() -> Path:
    include = sysconfig.get_paths()["include"]
    key = _SRC.read_bytes() + " ".join((*_FLAGS, include)).encode()
    h = hashlib.sha256(key).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _BUILD / f"_tk_native-{h}{suffix}"


def _build(out: Path) -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    include = sysconfig.get_paths()["include"]
    cmd = ["g++", *_FLAGS, f"-I{include}", str(_SRC), "-o", str(tmp), "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: concurrent loaders see a whole file
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        detail = getattr(e, "stderr", b"")
        logger.warning(
            "native decoder build failed (falling back to NumPy): %s %s",
            e, detail.decode() if isinstance(detail, bytes) else detail,
        )
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _lib():
    """The loaded extension module, or None (no toolchain): built and
    loaded once per process, on first use."""
    global _native, _tried
    if _tried:
        return _native
    with _lock:
        if not _tried:
            out = _target()
            if not out.exists():
                # One build across processes loading at once; a process
                # that waited finds the library built.
                with build_lock(_BUILD):
                    if not out.exists():
                        _build(out)
            if out.exists():
                try:
                    spec = importlib.util.spec_from_file_location("_tk_native", out)
                    mod = importlib.util.module_from_spec(spec)
                    spec.loader.exec_module(mod)
                    _native = mod
                except (ImportError, OSError) as e:
                    logger.warning(
                        "native decoder load failed (falling back to NumPy): %s", e
                    )
            _tried = True
    return _native


def available() -> bool:
    return _lib() is not None


# ------------------------------------------------------------------- gather


def gather_rows(
    values: list[bytes], width: int, dtype=np.uint8, pad: int = 0
) -> np.ndarray:
    """Pack list[bytes] into a [n, width]-items array of ``dtype``
    (truncate/pad each row). One C call for the whole chunk when native."""
    dtype = np.dtype(dtype)
    itemsize = dtype.itemsize
    width_bytes = width * itemsize
    n = len(values)
    out = np.empty((n, width), dtype=dtype)
    if n == 0:
        return out
    pad_pattern = np.asarray([pad]).astype(dtype).tobytes()
    lib = _lib()
    if lib is not None:
        lib.gather_rows(
            values, out.view(np.uint8).reshape(n, width_bytes), pad_pattern
        )
        return out
    # Fallback: join-based bulk decode (still C-speed via bytes.join).
    exact = all(len(v) == width_bytes for v in values)
    if exact:
        return np.frombuffer(b"".join(values), dtype=dtype).reshape(n, width)
    out[:] = np.frombuffer(pad_pattern, dtype=dtype)[0]
    for i, v in enumerate(values):
        take = len(v) - len(v) % itemsize
        row = np.frombuffer(v[: min(take, width_bytes)], dtype=dtype)
        out[i, : row.shape[0]] = row
    return out


# -------------------------------------------------------------- bit packing


def packed_width(seq: int, bits: int) -> int:
    """Bytes per packed row of ``seq`` values at ``bits`` bits each. The
    device-side unpack (ops/bitpack.py) reads a 3-byte window per value
    with tail indices clipped; no extra padding is needed — whenever a
    value's bits spill past the second byte, that third byte necessarily
    exists (the value's own bits occupy it), and a clipped duplicate byte
    only ever contributes bit positions the mask discards."""
    if not 1 <= bits <= 16:
        raise ValueError("bits must be in [1, 16]")
    return (seq * bits + 7) // 8


def pack_bits(rows: np.ndarray, bits: int) -> np.ndarray:
    """[n, s] non-negative ints < 2^bits → [n, packed_width] uint8, packed
    as one little-endian bit stream per row. One C call per chunk when
    native; NumPy packbits fallback with identical layout."""
    n, s = rows.shape
    w = packed_width(s, bits)
    rows16 = np.ascontiguousarray(rows, dtype=np.uint16)
    out = np.empty((n, w), dtype=np.uint8)
    if n == 0:
        return out
    lib = _lib()
    if lib is not None:
        lib.pack_bits(rows16, out, bits, n, s, w)
        return out
    # Fallback: expand each value to its little-endian bits, pad the row's
    # bit stream to w*8, and let packbits do the byte assembly.
    bit_mat = (
        (rows16[:, :, None] >> np.arange(bits, dtype=np.uint16)) & 1
    ).astype(np.uint8).reshape(n, s * bits)
    padded = np.zeros((n, w * 8), dtype=np.uint8)
    padded[:, : s * bits] = bit_mat
    return np.packbits(padded, axis=1, bitorder="little")


# ---------------------------------------------------------------- json scan


def _py_find_string_field(buf: bytes, field: bytes) -> bytes | None:
    """Python mirror of the C++ scanner (same raw-bytes semantics)."""
    needle = b'"' + field + b'"'
    i = buf.find(needle)
    while i != -1:
        j = i + len(needle)
        while j < len(buf) and buf[j : j + 1] in b" \t\n":
            j += 1
        if j < len(buf) and buf[j : j + 1] == b":":
            j += 1
            while j < len(buf) and buf[j : j + 1] in b" \t\n":
                j += 1
            if j >= len(buf) or buf[j : j + 1] != b'"':
                return None  # field exists but is not a string
            j += 1
            start = j
            while j < len(buf):
                if buf[j : j + 1] == b"\\":
                    j += 2
                    continue
                if buf[j : j + 1] == b'"':
                    return buf[start:j]
                j += 1
            return None
        i = buf.find(needle, i + 1)
    return None


def json_tokens_scan(
    values: list[bytes], field: str, seq_len: int, pad_id: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """→ (tokens int32 [n, seq_len], keep uint8 [n]). keep=0 rows are
    pad_id-filled (missing / non-string / unterminated field)."""
    n = len(values)
    tokens = np.empty((n, seq_len), dtype=np.int32)
    keep = np.empty((n,), dtype=np.uint8)
    if n == 0:
        return tokens, keep
    fname = field.encode()
    lib = _lib()
    if lib is not None:
        lib.json_tokens(values, fname, tokens, keep, pad_id)
        return tokens, keep
    for i, v in enumerate(values):
        text = _py_find_string_field(v, fname)
        if text is None:
            keep[i] = 0
            tokens[i] = pad_id
            continue
        keep[i] = 1
        row = np.frombuffer(text[:seq_len], dtype=np.uint8)
        tokens[i, : row.shape[0]] = row
        tokens[i, row.shape[0] :] = pad_id
    return tokens, keep


# ---------------------------------------------------------------- png decode


def _py_defilter_row(filt: int, cur, out, prior, stride: int):
    """Reverse one PNG scanline filter (bpp=3). ``cur`` is the filtered
    bytes (int32 work dtype), ``out`` the row being produced (uint8),
    ``prior`` the previous defiltered row or None."""
    if filt == 0:
        out[:] = cur
    elif filt == 1:  # Sub — per-channel cumulative sum is exactly +left mod 256
        px = cur.reshape(-1, 3)
        out[:] = (np.cumsum(px, axis=0, dtype=np.int64) % 256).astype(
            np.uint8
        ).reshape(-1)
    elif filt == 2:  # Up
        out[:] = cur if prior is None else (cur + prior) % 256
    elif filt == 3:  # Average — sequential in x (left depends on output)
        up = np.zeros(stride, np.int32) if prior is None else prior.astype(np.int32)
        px, upx = cur.reshape(-1, 3), up.reshape(-1, 3)
        o = out.reshape(-1, 3)
        left = np.zeros(3, np.int32)
        for x in range(px.shape[0]):
            left = (px[x] + ((left + upx[x]) >> 1)) % 256
            o[x] = left
    elif filt == 4:  # Paeth — sequential in x
        up = np.zeros(stride, np.int32) if prior is None else prior.astype(np.int32)
        px, upx = cur.reshape(-1, 3), up.reshape(-1, 3)
        o = out.reshape(-1, 3)
        left = np.zeros(3, np.int32)
        ul = np.zeros(3, np.int32)
        for x in range(px.shape[0]):
            p = left + upx[x] - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - upx[x]), np.abs(p - ul)
            pred = np.where(
                (pa <= pb) & (pa <= pc), left, np.where(pb <= pc, upx[x], ul)
            )
            left = (px[x] + pred) % 256
            o[x] = left
            ul = upx[x]
    else:
        raise ValueError(f"unknown PNG filter {filt}")


def _py_decode_one_png(buf: bytes, h: int, w: int) -> np.ndarray | None:
    """Python mirror of the C++ decoder (same accept/reject semantics)."""
    import struct
    import zlib

    if len(buf) < 33 or buf[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos = 8
    idat = bytearray()
    saw_ihdr = False
    while pos + 8 <= len(buf):
        (clen,) = struct.unpack_from(">I", buf, pos)
        ctype = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + clen]
        if pos + 8 + clen + 4 > len(buf):
            return None
        if ctype == b"IHDR":
            if clen != 13:
                return None
            pw, ph = struct.unpack_from(">II", data, 0)
            if (pw, ph) != (w, h) or data[8:13] != b"\x08\x02\x00\x00\x00":
                return None
            saw_ihdr = True
        elif ctype == b"IDAT":
            idat += data
        elif ctype == b"IEND":
            break
        pos += 8 + clen + 4
    if not saw_ihdr or not idat:
        return None
    stride = w * 3
    try:
        raw = zlib.decompress(bytes(idat))
    except zlib.error:
        return None
    if len(raw) != h * (1 + stride):
        return None
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + stride)
    out = np.empty((h, stride), np.uint8)
    prior = None
    for y in range(h):
        if rows[y, 0] > 4:
            return None  # unknown filter byte — drop, same as the C++ path
        _py_defilter_row(
            int(rows[y, 0]), rows[y, 1:].astype(np.int32), out[y], prior, stride
        )
        prior = out[y]
    return out.reshape(h, w, 3)


def decode_png_rgb(
    values: list[bytes], height: int, width: int
) -> tuple[np.ndarray, np.ndarray]:
    """list of 8-bit RGB PNG payloads → (uint8 [n, h, w, 3], keep uint8 [n]).
    Invalid/mismatched records decode to zeros with keep=0 (the vectorized
    None-drop contract). One C call for the whole chunk when native."""
    n = len(values)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    keep = np.empty((n,), dtype=np.uint8)
    if n == 0:
        return out, keep
    lib = _lib()
    if lib is not None:
        lib.decode_png_rgb(values, out, keep, height, width)
        return out, keep
    for i, v in enumerate(values):
        img = _py_decode_one_png(v, height, width)
        if img is None:
            keep[i] = 0
            out[i] = 0
        else:
            keep[i] = 1
            out[i] = img
    return out, keep

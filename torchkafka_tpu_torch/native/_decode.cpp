// _tk_native: C++ hot-path record decoding for torchkafka_tpu.
//
// Net-new capability (the reference is pure Python with no native code —
// SURVEY.md §2 "zero C++/Rust/CUDA components"); this is the host-side
// throughput lever the TPU design calls for: the ingest pipeline's per-chunk
// decode work (byte gathering, JSON field scan + tokenize) done as one C
// call per poll chunk, writing straight into the batcher's NumPy buffers
// with no intermediate joins or per-record Python objects.
//
// Interface contract (kept tiny on purpose):
//   gather_rows(values: list[bytes], out: writable buffer [n, width_bytes],
//               pad: int) -> None
//       Row i = values[i] truncated/zero-padded to width_bytes.
//   json_tokens(values: list[bytes], field: bytes, out: writable int32
//               buffer [n, seq_len], keep: writable uint8 buffer [n],
//               pad_id: int) -> None
//       Minimal flat-JSON scan for "field": "...", tokenised as utf-8 byte
//       values (the same stand-in tokenizer as transform.json_field's
//       default); keep[i]=0 marks a drop (missing/invalid field).
//
// Python-side fallbacks with identical semantics live in
// torchkafka_tpu/native/__init__.py; differential tests enforce equality.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- gather

// Row i = values[i], truncated to whole items of `itemsize` bytes, padded
// to the row width with the `pad_pattern` (one item's byte image) — item-
// level semantics, so e.g. an int32 pad of -1 is a true -1, and a partial
// trailing item in the input is replaced by pad, never half-copied.
PyObject* gather_rows(PyObject*, PyObject* args) {
  PyObject* values;
  Py_buffer out;
  Py_buffer pad;
  if (!PyArg_ParseTuple(args, "O!w*y*", &PyList_Type, &values, &out, &pad)) {
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(values);
  Py_ssize_t itemsize = pad.len;
  auto release = [&]() {
    PyBuffer_Release(&out);
    PyBuffer_Release(&pad);
  };
  if (n == 0) {
    release();
    Py_RETURN_NONE;
  }
  if (itemsize <= 0 || out.len % n != 0 || (out.len / n) % itemsize != 0) {
    release();
    PyErr_SetString(PyExc_ValueError, "out buffer / pad pattern shape mismatch");
    return nullptr;
  }
  Py_ssize_t width = out.len / n;
  auto* dst = static_cast<uint8_t*>(out.buf);
  const auto* pad_bytes = static_cast<const uint8_t*>(pad.buf);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GET_ITEM(values, i);
    char* src;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(item, &src, &len) != 0) {
      release();
      return nullptr;
    }
    Py_ssize_t take = len < width ? len : width;
    take -= take % itemsize;  // whole items only
    std::memcpy(dst, src, static_cast<size_t>(take));
    for (Py_ssize_t off = take; off < width; off += itemsize) {
      std::memcpy(dst + off, pad_bytes, static_cast<size_t>(itemsize));
    }
    dst += width;
  }
  release();
  Py_RETURN_NONE;
}

// ------------------------------------------------------------ json scan

// Find `"field"` (quoted) followed by optional spaces, ':', optional
// spaces, '"', and return [start, end) of the raw string body (first
// unescaped '"'). Returns false when absent or not a string value.
bool find_string_field(const char* buf, Py_ssize_t len, const char* field,
                       Py_ssize_t field_len, const char** out_start,
                       Py_ssize_t* out_len) {
  for (Py_ssize_t i = 0; i + field_len + 2 <= len; ++i) {
    if (buf[i] != '"') continue;
    if (std::memcmp(buf + i + 1, field, static_cast<size_t>(field_len)) != 0)
      continue;
    Py_ssize_t j = i + 1 + field_len;
    if (j >= len || buf[j] != '"') continue;
    ++j;
    while (j < len && (buf[j] == ' ' || buf[j] == '\t' || buf[j] == '\n')) ++j;
    if (j >= len || buf[j] != ':') continue;
    ++j;
    while (j < len && (buf[j] == ' ' || buf[j] == '\t' || buf[j] == '\n')) ++j;
    if (j >= len || buf[j] != '"') return false;  // field exists, not a string
    Py_ssize_t start = ++j;
    while (j < len) {
      if (buf[j] == '\\') {
        j += 2;
        continue;
      }
      if (buf[j] == '"') {
        *out_start = buf + start;
        *out_len = j - start;
        return true;
      }
      ++j;
    }
    return false;  // unterminated
  }
  return false;
}

PyObject* json_tokens(PyObject*, PyObject* args) {
  PyObject* values;
  Py_buffer field;
  Py_buffer out;
  Py_buffer keep;
  int pad_id;
  if (!PyArg_ParseTuple(args, "O!y*w*w*i", &PyList_Type, &values, &field, &out,
                        &keep, &pad_id)) {
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(values);
  auto release = [&]() {
    PyBuffer_Release(&field);
    PyBuffer_Release(&out);
    PyBuffer_Release(&keep);
  };
  if (n == 0) {
    release();
    Py_RETURN_NONE;
  }
  if (static_cast<Py_ssize_t>(keep.len) != n ||
      out.len % (n * static_cast<Py_ssize_t>(sizeof(int32_t))) != 0) {
    release();
    PyErr_SetString(PyExc_ValueError, "out/keep buffer shape mismatch");
    return nullptr;
  }
  Py_ssize_t seq_len = out.len / n / static_cast<Py_ssize_t>(sizeof(int32_t));
  auto* tokens = static_cast<int32_t*>(out.buf);
  auto* keep_flags = static_cast<uint8_t*>(keep.buf);
  const char* fname = static_cast<const char*>(field.buf);
  Py_ssize_t flen = field.len;

  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GET_ITEM(values, i);
    char* src;
    Py_ssize_t len;
    int32_t* row = tokens + i * seq_len;
    if (PyBytes_AsStringAndSize(item, &src, &len) != 0) {
      release();
      return nullptr;
    }
    const char* text;
    Py_ssize_t text_len;
    if (!find_string_field(src, len, fname, flen, &text, &text_len)) {
      keep_flags[i] = 0;
      for (Py_ssize_t t = 0; t < seq_len; ++t) row[t] = pad_id;
      continue;
    }
    keep_flags[i] = 1;
    Py_ssize_t take = text_len < seq_len ? text_len : seq_len;
    for (Py_ssize_t t = 0; t < take; ++t) {
      row[t] = static_cast<int32_t>(static_cast<uint8_t>(text[t]));
    }
    for (Py_ssize_t t = take; t < seq_len; ++t) row[t] = pad_id;
  }
  release();
  Py_RETURN_NONE;
}

// ------------------------------------------------------------- png decode
//
// Minimal-but-real PNG decoder for the image-ingest hot path: 8-bit RGB
// (color type 2), non-interlaced — the shape an image topic's producer
// controls. Full chunk walk, zlib inflate of the concatenated IDAT stream,
// and all five scanline filters reversed (None/Sub/Up/Average/Paeth).
// Chunk CRCs are NOT verified (Kafka already checksums the record payload;
// a corrupt stream fails structurally or in inflate and drops the record
// via keep=0).

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

inline uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

// Decode one PNG into dst[h*w*3]. Scratch vectors are reused across
// records by the caller (no per-record allocations in the chunk loop).
bool decode_one_png(const uint8_t* buf, Py_ssize_t len, Py_ssize_t h,
                    Py_ssize_t w, uint8_t* dst, std::vector<uint8_t>& idat,
                    std::vector<uint8_t>& raw) {
  static const uint8_t kSig[8] = {137, 'P', 'N', 'G', 13, 10, 26, 10};
  if (len < 8 + 25 || std::memcmp(buf, kSig, 8) != 0) return false;
  idat.clear();
  bool saw_ihdr = false;
  Py_ssize_t pos = 8;
  while (pos + 8 <= len) {
    uint32_t clen = be32(buf + pos);
    const uint8_t* ctype = buf + pos + 4;
    const uint8_t* cdata = buf + pos + 8;
    if (pos + 8 + static_cast<Py_ssize_t>(clen) + 4 > len) return false;
    if (std::memcmp(ctype, "IHDR", 4) == 0) {
      if (clen != 13) return false;
      uint32_t pw = be32(cdata), ph = be32(cdata + 4);
      // bitdepth 8, colortype 2 (RGB), compression 0, filter 0, interlace 0
      if (pw != static_cast<uint32_t>(w) || ph != static_cast<uint32_t>(h) ||
          cdata[8] != 8 || cdata[9] != 2 || cdata[10] != 0 ||
          cdata[11] != 0 || cdata[12] != 0) {
        return false;
      }
      saw_ihdr = true;
    } else if (std::memcmp(ctype, "IDAT", 4) == 0) {
      idat.insert(idat.end(), cdata, cdata + clen);
    } else if (std::memcmp(ctype, "IEND", 4) == 0) {
      break;
    }
    pos += 8 + static_cast<Py_ssize_t>(clen) + 4;  // + CRC (unverified)
  }
  if (!saw_ihdr || idat.empty()) return false;

  const size_t stride = static_cast<size_t>(w) * 3;
  const size_t raw_len = static_cast<size_t>(h) * (1 + stride);
  raw.resize(raw_len);
  uLongf out_len = static_cast<uLongf>(raw_len);
  if (uncompress(raw.data(), &out_len, idat.data(),
                 static_cast<uLong>(idat.size())) != Z_OK ||
      out_len != raw_len) {
    return false;
  }

  const uint8_t* prior = nullptr;  // previous DEFILTERED row
  for (Py_ssize_t y = 0; y < h; ++y) {
    const uint8_t* src = raw.data() + static_cast<size_t>(y) * (1 + stride);
    uint8_t filter = src[0];
    const uint8_t* cur = src + 1;
    uint8_t* out = dst + static_cast<size_t>(y) * stride;
    switch (filter) {
      case 0:
        std::memcpy(out, cur, stride);
        break;
      case 1:  // Sub: + left
        for (size_t i = 0; i < 3 && i < stride; ++i) out[i] = cur[i];
        for (size_t i = 3; i < stride; ++i)
          out[i] = static_cast<uint8_t>(cur[i] + out[i - 3]);
        break;
      case 2:  // Up: + above
        if (prior == nullptr) {
          std::memcpy(out, cur, stride);
        } else {
          for (size_t i = 0; i < stride; ++i)
            out[i] = static_cast<uint8_t>(cur[i] + prior[i]);
        }
        break;
      case 3:  // Average: + floor((left + above) / 2)
        for (size_t i = 0; i < stride; ++i) {
          int left = i >= 3 ? out[i - 3] : 0;
          int up = prior ? prior[i] : 0;
          out[i] = static_cast<uint8_t>(cur[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth predictor
        for (size_t i = 0; i < stride; ++i) {
          int left = i >= 3 ? out[i - 3] : 0;
          int up = prior ? prior[i] : 0;
          int ul = (prior && i >= 3) ? prior[i - 3] : 0;
          out[i] = static_cast<uint8_t>(cur[i] + paeth(left, up, ul));
        }
        break;
      default:
        return false;
    }
    prior = out;
  }
  return true;
}

PyObject* decode_png_rgb(PyObject*, PyObject* args) {
  PyObject* values;
  Py_buffer out;
  Py_buffer keep;
  Py_ssize_t h, w;
  if (!PyArg_ParseTuple(args, "O!w*w*nn", &PyList_Type, &values, &out, &keep,
                        &h, &w)) {
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(values);
  auto release = [&]() {
    PyBuffer_Release(&out);
    PyBuffer_Release(&keep);
  };
  if (n == 0) {
    release();
    Py_RETURN_NONE;
  }
  if (static_cast<Py_ssize_t>(keep.len) != n || h <= 0 || w <= 0 ||
      out.len != n * h * w * 3) {
    release();
    PyErr_SetString(PyExc_ValueError, "out/keep buffer shape mismatch");
    return nullptr;
  }
  auto* dst = static_cast<uint8_t*>(out.buf);
  auto* keep_flags = static_cast<uint8_t*>(keep.buf);
  const size_t img = static_cast<size_t>(h) * static_cast<size_t>(w) * 3;
  // Snapshot (ptr, len) under the GIL, then release it for the decode
  // loop — inflate+defilter is milliseconds of pure C work per chunk, and
  // holding the GIL through it would serialize transform threads and stall
  // the poll loop. The values list keeps the bytes objects alive.
  std::vector<std::pair<const uint8_t*, Py_ssize_t>> srcs(
      static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GET_ITEM(values, i);
    char* src;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(item, &src, &len) != 0) {
      release();
      return nullptr;
    }
    srcs[static_cast<size_t>(i)] = {reinterpret_cast<const uint8_t*>(src), len};
  }
  Py_BEGIN_ALLOW_THREADS;
  std::vector<uint8_t> idat, raw;
  for (Py_ssize_t i = 0; i < n; ++i) {
    uint8_t* row = dst + static_cast<size_t>(i) * img;
    const auto& sv = srcs[static_cast<size_t>(i)];
    if (decode_one_png(sv.first, sv.second, h, w, row, idat, raw)) {
      keep_flags[i] = 1;
    } else {
      keep_flags[i] = 0;
      std::memset(row, 0, img);
    }
  }
  Py_END_ALLOW_THREADS;
  release();
  Py_RETURN_NONE;
}

// ------------------------------------------------------------- bit packing
//
// Sub-byte wire codec for bounded-vocab token rows: values < 2^bits pack
// into a little-endian bit stream per row (uint16 in, uint8 out). The
// host packs (here, one C call per chunk); the accelerator unpacks with
// vectorized shifts (ops/bitpack.py) — wire bytes are the ingest
// pipeline's scarce resource, so a 15-bit vocab rides the wire at 15/16
// of uint16.

PyObject* pack_bits(PyObject*, PyObject* args) {
  Py_buffer in;   // uint16, C-contiguous [n, s]
  Py_buffer out;  // uint8, C-contiguous [n, w]
  int bits;
  Py_ssize_t n, s, w;
  if (!PyArg_ParseTuple(args, "y*w*innn", &in, &out, &bits, &n, &s, &w)) {
    return nullptr;
  }
  auto release = [&]() {
    PyBuffer_Release(&in);
    PyBuffer_Release(&out);
  };
  if (bits < 1 || bits > 16 ||
      in.len != n * s * static_cast<Py_ssize_t>(sizeof(uint16_t)) ||
      out.len != n * w || w * 8 < s * bits) {
    release();
    PyErr_SetString(PyExc_ValueError, "pack_bits buffer shape mismatch");
    return nullptr;
  }
  const auto* src = static_cast<const uint16_t*>(in.buf);
  auto* dst = static_cast<uint8_t*>(out.buf);
  const uint32_t mask = (1u << bits) - 1u;
  Py_BEGIN_ALLOW_THREADS;
  for (Py_ssize_t r = 0; r < n; ++r) {
    const uint16_t* row = src + r * s;
    uint8_t* o = dst + r * w;
    std::memset(o, 0, static_cast<size_t>(w));
    uint32_t acc = 0;
    int nbits = 0;
    Py_ssize_t pos = 0;
    for (Py_ssize_t i = 0; i < s; ++i) {
      acc |= (static_cast<uint32_t>(row[i]) & mask) << nbits;
      nbits += bits;
      while (nbits >= 8) {
        o[pos++] = static_cast<uint8_t>(acc & 0xFFu);
        acc >>= 8;
        nbits -= 8;
      }
    }
    if (nbits > 0) o[pos] = static_cast<uint8_t>(acc & 0xFFu);
  }
  Py_END_ALLOW_THREADS;
  release();
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"gather_rows", gather_rows, METH_VARARGS,
     "gather_rows(values, out_buffer, pad): pack bytes rows fixed-width"},
    {"pack_bits", pack_bits, METH_VARARGS,
     "pack_bits(in_u16, out_u8, bits, n, s, w): little-endian bit packing"},
    {"json_tokens", json_tokens, METH_VARARGS,
     "json_tokens(values, field, out_i32, keep_u8, pad_id): scan+tokenize"},
    {"decode_png_rgb", decode_png_rgb, METH_VARARGS,
     "decode_png_rgb(values, out_u8[n,h,w,3], keep_u8, h, w): PNG decode"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_tk_native",
    "C++ hot-path decoders for torchkafka_tpu", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__tk_native() { return PyModule_Create(&module); }

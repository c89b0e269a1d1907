// Int8 decode attention through per-slot block tables over a shared paged
// KV pool, for Hopper (K5).
//
// Replaces: torchkafka_tpu/ops/kvattn.py `_kvattn_paged_kernel` (the
// Pallas TPU read reached through `int8_paged_decode_attention`).
//
// Contract (same as the TPU kernel): one query token per slot,
//   q [B, H, Dh] (bf16 or f32); K-major-per-block pools kq/vq
//   [NB, K, bs, Dh] int8 with f32 scales ks/vs [NB, K, bs]; block tables
//   table [B, nblk] int32 (physical block of each logical block); pos [B]
//   int32 watermarks.
// Slot b reads ONLY table entries j < ceil((pos[b]+1)/bs), positions
// [0, pos[b]] of its logical view of nblk*bs positions (the watermark
// clamped into the view, the tail of the last block masked); logical
// position p is row (p % bs) of kv head k in block table[b, p / bs], a
// table entry outside [0, NB) clamped into the pool. The math is
// kvattn_split.cuh's; no gathered per-slot view is ever written (the
// gathered read copies one per layer per tick).
//
// What bounds it on this card: device memory, (pos+1) * K * 2 * (Dh + 4)
// bytes a slot plus its table entries. At the 1b serving shape (B=16, K=8,
// rep 2, Dh=128, bs 16, a 192-position view) that is about 3.6 MB, 1.1 us
// at 3.35 TB/s. The single-block design this replaces took 0.0213 ms there
// and 0.134 ms at a 2048 view on an NVIDIA H100 80GB HBM3 at 700 W; the
// split-K body takes about 0.012 ms and 0.026 ms on that card. This
// launcher runs it with the table row map. The planner gives
// spans of whole blocks where bs <= L, so a span reads each of its table
// entries from device memory once (each [bs, Dh] run stays contiguous and
// the 16-byte row loads coalesced inside it); the entry of a row comes
// through the L1 cache by the thread that copies the row.

#include "kvattn_split.cuh"

namespace {

template <typename T, int REP>
__global__ void __launch_bounds__(KV_NT)
kvattn_split_kernel_paged(const T* __restrict__ q, const int8_t* __restrict__ kq,
                          const float* __restrict__ ks, const int8_t* __restrict__ vq,
                          const float* __restrict__ vs, const int* __restrict__ table,
                          const int* __restrict__ pos, T* __restrict__ out,
                          float* __restrict__ ws, int* __restrict__ counter, int n_kv,
                          int n_pool, int bs, int nblk, int dh, int span,
                          float inv_sqrt_dh) {
  const int bk = blockIdx.y, b = bk / n_kv;
  const PagedRows rows{table + (size_t)b * nblk, n_pool, n_kv, bk - b * n_kv, bs};
  kvattn_split_body<PagedRows, T, REP>(rows, pos + b, nullptr, nblk * bs, q, kq, ks, vq, vs,
                                       out, ws, counter, span, dh, inv_sqrt_dh);
}

template <typename T, int REP>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* table, const void* pos, void* out,
           void* ws, void* counter, int b, int n_kv, int n_pool, int bs,
           int nblk, int dh, int span, int n_split, float inv_sqrt_dh,
           cudaStream_t stream) {
  if (b * n_kv == 0) return 0;
  const dim3 grid(n_split, b * n_kv);
  kvattn_split_kernel_paged<T, REP><<<grid, KV_NT, 0, stream>>>(
      (const T*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
      (const float*)vs, (const int*)table, (const int*)pos, (T*)out,
      (float*)ws, (int*)counter, n_kv, n_pool, bs, nblk, dh, span,
      inv_sqrt_dh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rep in {1, 2, 4, 8}; dh % 16 == 0 and
// dh <= 128; bs >= 1; nblk >= 1; n_pool >= 1; span >= 1 positions a block;
// 1 <= n_split <= 64 and n_split * span >= nblk * bs. ws holds
// n_split * (2*rep + rep*dh) floats per (slot, kv head) and counter one
// zeroed int per (slot, kv head); both may be null when n_split == 1.
// Returns a cudaError_t (0 = launched).
extern "C" int tk_kvattn_paged(const void* q, const void* kq, const void* ks,
                               const void* vq, const void* vs,
                               const void* table, const void* pos, void* out,
                               void* ws, void* counter, int dtype, int b,
                               int n_kv, int rep, int n_pool, int bs, int nblk,
                               int dh, int span, int n_split,
                               float inv_sqrt_dh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dh < 16 || dh > KV_DH_MAX || dh % 16 || bs < 1 || nblk < 1 ||
      n_pool < 1 || span < 1 || n_split < 1 || n_split > KV_MAX_SPLIT ||
      (long long)n_split * span < (long long)nblk * bs ||
      (n_split > 1 && (ws == nullptr || counter == nullptr)))
    return (int)cudaErrorInvalidValue;
#define TK_KV_CASE(T, R)                                                       \
  if (rep == R)                                                                \
  return launch<T, R>(q, kq, ks, vq, vs, table, pos, out, ws, counter, b,      \
                      n_kv, n_pool, bs, nblk, dh, span, n_split, inv_sqrt_dh, s)
  if (dtype == 0) {
    TK_KV_CASE(float, 1);
    TK_KV_CASE(float, 2);
    TK_KV_CASE(float, 4);
    TK_KV_CASE(float, 8);
  }
  if (dtype == 1) {
    TK_KV_CASE(__nv_bfloat16, 1);
    TK_KV_CASE(__nv_bfloat16, 2);
    TK_KV_CASE(__nv_bfloat16, 4);
    TK_KV_CASE(__nv_bfloat16, 8);
  }
#undef TK_KV_CASE
  return (int)cudaErrorInvalidValue;
}

// The compiled resources of the kernel for (dtype, rep): out[4] = registers,
// local (spill) bytes, static shared bytes, dynamic shared bytes.
extern "C" int tk_kvattn_paged_attrs(int dtype, int rep, int* out) {
#define TK_KV_ATTR(D, T, R)                                                    \
  if (dtype == D && rep == R) return kv_func_attrs(kvattn_split_kernel_paged<T, R>, out)
  TK_KV_ATTR(0, float, 1);
  TK_KV_ATTR(0, float, 2);
  TK_KV_ATTR(0, float, 4);
  TK_KV_ATTR(0, float, 8);
  TK_KV_ATTR(1, __nv_bfloat16, 1);
  TK_KV_ATTR(1, __nv_bfloat16, 2);
  TK_KV_ATTR(1, __nv_bfloat16, 4);
  TK_KV_ATTR(1, __nv_bfloat16, 8);
#undef TK_KV_ATTR
  return (int)cudaErrorInvalidValue;
}

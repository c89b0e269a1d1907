// Fill-bounded int8 decode attention over a dense K-major KV pool, for
// Hopper (K4).
//
// Replaces: torchkafka_tpu/ops/kvattn.py `_kvattn_dynlen_kernel` (the
// Pallas TPU read reached through `int8_decode_attention_dynlen`).
//
// Contract (same as the TPU kernel): one query token per slot,
//   q [B, H, Dh] (bf16 or f32), kq/vq [B, K, M, Dh] int8, ks/vs [B, K, M]
//   f32 per-(position, head) scales, pos [B] int32 watermarks.
// Slot b reads ONLY positions [0, pos[b]] of its rows (the watermark
// clamped into the pool); the math is kvattn_split.cuh's.
//
// What bounds it on this card: device memory, (pos+1) * K * 2 * (Dh + 4)
// bytes a slot. At the 1b serving shape (B=16, K=8, rep 2, Dh=128, pool
// 192) that is about 3.6 MB, 1.1 us at 3.35 TB/s; at a 2048 pool about 7
// us. The single-block design this replaces took 0.0167 ms and 0.0856 ms
// there on an NVIDIA H100 80GB HBM3 at 700 W: 128 blocks on 132 SMs, one
// serial walk over each slot's positions; the split-K body of
// kvattn_split.cuh (spans of L positions in parallel, a merge in the same
// launch) takes about 0.011 ms and 0.025 ms on that card (one span at 192,
// 16 spans of 128 at 2048). This launcher runs it with the dense row map:
// row (b*K + kh)*M + p.

#include "kvattn_split.cuh"

namespace {

template <typename T, int REP>
__global__ void __launch_bounds__(KV_NT)
kvattn_split_kernel_dense(const T* __restrict__ q, const int8_t* __restrict__ kq,
                          const float* __restrict__ ks, const int8_t* __restrict__ vq,
                          const float* __restrict__ vs, const int* __restrict__ pos,
                          T* __restrict__ out, float* __restrict__ ws,
                          int* __restrict__ counter, int n_kv, int m_len, int dh,
                          int span, float inv_sqrt_dh) {
  const int bk = blockIdx.y;
  const DenseRows rows{(size_t)bk * m_len};
  kvattn_split_body<DenseRows, T, REP>(rows, pos + bk / n_kv, nullptr, m_len, q, kq, ks, vq,
                                       vs, out, ws, counter, span, dh, inv_sqrt_dh);
}

template <typename T, int REP>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* pos, void* out, void* ws, void* counter,
           int b, int n_kv, int m_len, int dh, int span, int n_split,
           float inv_sqrt_dh, cudaStream_t stream) {
  if (b * n_kv == 0) return 0;
  const dim3 grid(n_split, b * n_kv);
  kvattn_split_kernel_dense<T, REP><<<grid, KV_NT, 0, stream>>>(
      (const T*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
      (const float*)vs, (const int*)pos, (T*)out, (float*)ws, (int*)counter,
      n_kv, m_len, dh, span, inv_sqrt_dh);
  return (int)cudaGetLastError();
}

__global__ void kvattn_i8_convert_kernel(float* f32_out, __nv_bfloat16* bf16_out) {
  const int x = threadIdx.x;  // 0..255 -> the int8 x - 128
  const uint32_t byte = (uint32_t)(uint8_t)(int8_t)(x - 128);
  float f[4];
  kv_i8x4_to_f(byte * 0x01010101u, f);
  f32_out[x] = f[x & 3];
  bf16_out[x] = __float2bfloat16_rn(f[x & 3]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rep in {1, 2, 4, 8}; dh % 16 == 0 and
// dh <= 128; span >= 1 positions a block; 1 <= n_split <= 64 and
// n_split * span >= m_len. ws holds n_split * (2*rep + rep*dh) floats per
// (slot, kv head) and counter one zeroed int per (slot, kv head); both may
// be null when n_split == 1. Returns a cudaError_t (0 = launched).
extern "C" int tk_kvattn_dynlen(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs,
                                const void* pos, void* out, void* ws,
                                void* counter, int dtype, int b, int n_kv,
                                int rep, int m_len, int dh, int span,
                                int n_split, float inv_sqrt_dh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dh < 16 || dh > KV_DH_MAX || dh % 16 || m_len < 1 || span < 1 ||
      n_split < 1 || n_split > KV_MAX_SPLIT || (long long)n_split * span < m_len ||
      (n_split > 1 && (ws == nullptr || counter == nullptr)))
    return (int)cudaErrorInvalidValue;
#define TK_KV_CASE(T, R)                                                       \
  if (rep == R)                                                                \
  return launch<T, R>(q, kq, ks, vq, vs, pos, out, ws, counter, b, n_kv,       \
                      m_len, dh, span, n_split, inv_sqrt_dh, s)
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
extern "C" int tk_kvattn_dynlen_attrs(int dtype, int rep, int* out) {
#define TK_KV_ATTR(D, T, R)                                                    \
  if (dtype == D && rep == R) return kv_func_attrs(kvattn_split_kernel_dense<T, R>, out)
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

// The kernels' int8 conversion on every int8 value: f32_out[x] and
// bf16_out[x] for the int8 x - 128, x in [0, 256) (device buffers).
extern "C" int tk_kvattn_i8_convert(void* f32_out, void* bf16_out, void* stream) {
  kvattn_i8_convert_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
      (float*)f32_out, (__nv_bfloat16*)bf16_out);
  return (int)cudaGetLastError();
}

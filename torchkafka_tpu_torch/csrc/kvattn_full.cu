// Full-pool int8 decode attention under a readable-position mask, for
// Hopper: one source for the K-major (K7) and the M-major (K8) pool.
//
// Replaces: torchkafka_tpu/ops/kvattn.py `_kvattn_kmajor_kernel` (the v2
// read, K-major pool, reached through `int8_decode_attention_kmajor`) and
// `_kvattn_kernel` (the v1 read, M-major pool, reached through
// `int8_decode_attention`).
//
// Contract (same as the TPU kernels): one query token per slot,
//   q [B, H, Dh] (bf16 or f32); int8 payloads kq/vq and f32 scales ks/vs,
//   K-major  kq/vq [B, K, M, Dh], ks/vs [B, K, M]   (kmajor = 1), or
//   M-major  kq/vq [B, M, K, Dh], ks/vs [B, M, K]   (kmajor = 0);
//   valid [B, M] bool: the positions slot b may read, in any pattern.
// Every position 0..M-1 is read; in f32:
//   s   = (q . float(kq[m])) * ks[m] * (1/sqrt(Dh)),  -1e30 where !valid
//   out = softmax(s) . (round_to_q_dtype(p * vs[m]) . float(vq[m]))
// A masked position gets exactly -1e30: it is not skipped and not -inf, so
// a row whose mask is all false averages all M positions uniformly, as the
// reference softmax does; where any position is valid, masked ones weigh
// exp(-1e30 - max) = 0. Their K and V rows are read all the same (an
// all-false row needs every V row).
//
// What bounds it on this card: device memory, the whole pool,
// B * K * M * 2 * (Dh + 4) bytes plus the mask, q and the output, against
// 3.35 TB/s: 2.0 us at the 8b decode shape (B=16, K=8, rep 4, Dh=128) with
// a 192-position pool, 20.7 us at 2048; ~4 * rep * Dh flops a position.
// The single-block kernel this replaces (one 128-thread block per (slot,
// kv head) walking the whole pool in 128-position tiles) took 0.018 ms and
// 0.105 ms there on an NVIDIA H100 80GB HBM3 at 700 W.
//
// What the design does about it: the split-K body of kvattn_split.cuh in
// its MASKED mode. The grid is (n_split, B*K); block (s, b*K + kh) reads
// span s of one (slot, kv head) for all rep query rows, every span is
// live, and the last span to finish merges in the same launch. K7 uses the
// dense row map, K8 `MMajorRows` (rows K*Dh bytes apart, so the same
// 16-byte cp.async chunks serve both layouts). The mask comes a byte a
// position, each lane loading its own positions' bytes a tile ahead.
//
// Rounding: the reference rounds the NORMALISED softmax(s) * vs to q's
// dtype; this kernel rounds exp(s - m_span) * vs against the span's running
// max and divides by the sum at the end (as the kernel it replaces did, one
// tile's max at a time). In bf16 the two can land one bf16 step apart on
// the output; in f32 only the order of the f32 sums differs. On a prefix
// mask at the same span it gives K4's result bit for bit: masked positions
// add p = 0 to sums they leave unchanged, and all-masked spans enter the
// merge with weight exp(-1e30 - M) = 0.

#include "kvattn_split.cuh"

namespace {

template <bool KMAJOR, typename T, int REP>
__global__ void __launch_bounds__(KV_NT)
kvattn_split_kernel_full(const T* __restrict__ q, const int8_t* __restrict__ kq,
                         const float* __restrict__ ks, const int8_t* __restrict__ vq,
                         const float* __restrict__ vs, const uint8_t* __restrict__ valid,
                         T* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ counter, int n_kv, int m_len, int dh,
                         int span, float inv_sqrt_dh) {
  const int bk = blockIdx.y, b = bk / n_kv;
  const uint8_t* valid_b = valid + (size_t)b * m_len;
  if constexpr (KMAJOR) {
    const DenseRows rows{(size_t)bk * m_len};
    kvattn_split_body<DenseRows, T, REP, true>(rows, nullptr, valid_b, m_len, q, kq, ks, vq,
                                               vs, out, ws, counter, span, dh, inv_sqrt_dh);
  } else {
    const MMajorRows rows{(size_t)b * m_len * n_kv + (bk - b * n_kv), n_kv};
    kvattn_split_body<MMajorRows, T, REP, true>(rows, nullptr, valid_b, m_len, q, kq, ks, vq,
                                                vs, out, ws, counter, span, dh, inv_sqrt_dh);
  }
}

template <typename T, int REP>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* valid, void* out, void* ws, void* counter,
           int b, int n_kv, int m_len, int dh, int span, int n_split, int kmajor,
           float inv_sqrt_dh, cudaStream_t stream) {
  if (b * n_kv == 0) return 0;
  const dim3 grid(n_split, b * n_kv);
  auto kern = kmajor ? kvattn_split_kernel_full<true, T, REP>
                     : kvattn_split_kernel_full<false, T, REP>;
  kern<<<grid, KV_NT, 0, stream>>>(
      (const T*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
      (const float*)vs, (const uint8_t*)valid, (T*)out, (float*)ws, (int*)counter,
      n_kv, m_len, dh, span, inv_sqrt_dh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rep in {1, 2, 4, 8}; dh % 16 == 0 and
// dh <= 128; m_len >= 1; span >= 1 positions a block; 1 <= n_split <= 64
// and n_split * span >= m_len; kmajor: 1 = [B, K, M, Dh] pool,
// 0 = [B, M, K, Dh]. ws holds n_split * (2*rep + rep*dh) floats per (slot,
// kv head) and counter one zeroed int per (slot, kv head); both may be
// null when n_split == 1.
// Returns a cudaError_t (0 = launched).
extern "C" int tk_kvattn_full(const void* q, const void* kq, const void* ks,
                              const void* vq, const void* vs, const void* valid,
                              void* out, void* ws, void* counter, int dtype, int b,
                              int n_kv, int rep, int m_len, int dh, int span,
                              int n_split, int kmajor, float inv_sqrt_dh,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dh < 16 || dh > KV_DH_MAX || dh % 16 || m_len < 1 || span < 1 ||
      n_split < 1 || n_split > KV_MAX_SPLIT || (long long)n_split * span < m_len ||
      (n_split > 1 && (ws == nullptr || counter == nullptr)))
    return (int)cudaErrorInvalidValue;
#define TK_KV_CASE(T, R)                                                       \
  if (rep == R)                                                                \
  return launch<T, R>(q, kq, ks, vq, vs, valid, out, ws, counter, b, n_kv,     \
                      m_len, dh, span, n_split, kmajor, inv_sqrt_dh, s)
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

// The compiled resources of the kernel for (dtype, rep, kmajor): out[4] =
// registers, local (spill) bytes, static shared bytes, dynamic shared bytes.
extern "C" int tk_kvattn_full_attrs(int dtype, int rep, int kmajor, int* out) {
#define TK_KV_ATTR(D, T, R)                                                    \
  if (dtype == D && rep == R)                                                  \
    return kv_func_attrs(kmajor ? kvattn_split_kernel_full<true, T, R>         \
                                : kvattn_split_kernel_full<false, T, R>, out)
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

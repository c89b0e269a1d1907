// Fill-bounded int8 decode attention over a K-major KV pool, for Hopper.
//
// Replaces: torchkafka_tpu/ops/kvattn.py `_kvattn_dynlen_kernel` (the
// Pallas TPU read reached through `int8_decode_attention_dynlen`).
//
// Contract (same as the TPU kernel): one query token per slot,
//   q [B, H, Dh] (bf16 or f32), kq/vq [B, K, M, Dh] int8, ks/vs [B, K, M]
//   f32 per-(position, head) scales, pos [B] int32 watermarks.
// Slot b reads ONLY positions [0, pos[b]] of its rows; under an online
// softmax in f32:
//   s   = (q . float(kq[m])) * ks[m] * (1/sqrt(Dh))
//   p   = exp(s - m_run)
//   acc += round_to_q_dtype(p * vs[m]) . float(vq[m])
//   out = acc / l                                      (in q's dtype)
// The k-scale lands on the scores and the v-scale on the probabilities
// (exact: both are constant along the Dh contraction).
//
// What bounds it on this card: device memory. A slot's read is
// (pos+1) * K * 2 * (Dh + 4) bytes plus q and the output, against
// 3.35 TB/s; the arithmetic is ~4 * rep * Dh flops per position, far below
// the card's rate. What its design does about that: the loop bound is the
// slot's own watermark, read by the block itself, so positions past the
// fill are never fetched (bytes scale with the fill, not the pool size);
// one block per (slot, kv head) keeps all rep = H/K query rows of that head
// together, so every int8 K/V row is read from device memory once for the
// whole group; tiles move as 16-byte coalesced loads into shared memory.
// The TPU kernel's global buffer parity and cross-program prefetch are
// sequential-grid mechanics with no counterpart here: blocks run in
// parallel across the SMs.
//
// Tiles: 128 threads, 128 positions per tile. Thread t scores position t of
// the tile for all rep rows; thread d accumulates output column d.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;       // threads, and positions per tile
constexpr int DH_MAX = 128;
constexpr int KPAD = 16;      // k tile row padding: conflict-free 16-byte reads
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int REP>
__global__ void __launch_bounds__(NT)
kvattn_dynlen_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                     const float* __restrict__ ks,
                     const int8_t* __restrict__ vq,
                     const float* __restrict__ vs,
                     const int* __restrict__ pos, T* __restrict__ out,
                     int n_kv, int m_len, int dh, float inv_sqrt_dh) {
  __shared__ float qs[REP][DH_MAX];
  __shared__ __align__(16) int8_t kt[NT][DH_MAX + KPAD];
  __shared__ __align__(16) int8_t vt[NT][DH_MAX];
  __shared__ float ksc[NT], vsc[NT];
  __shared__ float ps[REP][NT];
  __shared__ float red_max[REP][NT / 32], red_sum[REP][NT / 32];

  const int b = blockIdx.x / n_kv;
  const int kh = blockIdx.x % n_kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The data-dependent loop bound: this slot's watermark (clamped into the
  // pool so a bad watermark can never read outside it).
  const int n_pos = min(max(pos[b], 0), m_len - 1) + 1;
  const size_t row = (size_t)b * n_kv + kh;
  const int8_t* kb = kq + row * m_len * dh;
  const int8_t* vb = vq + row * m_len * dh;
  const float* ksb = ks + row * m_len;
  const float* vsb = vs + row * m_len;
  const size_t q_row0 = ((size_t)b * n_kv + kh) * REP;  // head kh*REP + r

  for (int i = tid; i < REP * dh; i += NT) {
    const int r = i / dh, c = i - r * dh;
    qs[r][c] = to_f(q[(q_row0 + r) * dh + c]);
  }

  float m_run[REP], l_run[REP], acc[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = NEG;
    l_run[r] = 0.f;
    acc[r] = 0.f;
  }
  const int chunks = dh / 16;

  for (int t0 = 0; t0 < n_pos; t0 += NT) {
    const int cnt = min(NT, n_pos - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < cnt * chunks; i += NT) {
      const int r = i / chunks, c = (i - r * chunks) * 16;
      const size_t g = (size_t)(t0 + r) * dh + c;
      *reinterpret_cast<int4*>(&kt[r][c]) = *reinterpret_cast<const int4*>(kb + g);
      *reinterpret_cast<int4*>(&vt[r][c]) = *reinterpret_cast<const int4*>(vb + g);
    }
    if (tid < cnt) {
      ksc[tid] = ksb[t0 + tid];
      vsc[tid] = vsb[t0 + tid];
    }
    __syncthreads();

    const bool valid = tid < cnt;
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r] = 0.f;
    if (valid) {
      for (int c = 0; c < dh; c += 16) {
        const int4 w = *reinterpret_cast<const int4*>(&kt[tid][c]);
        const int8_t* kk = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = (float)kk[e];
#pragma unroll
          for (int r = 0; r < REP; ++r) s[r] = fmaf(qs[r][c + e], kf, s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      s[r] = valid ? (s[r] * ksc[tid]) * inv_sqrt_dh : NEG;
      const float wm = warp_max(s[r]);
      if (lane == 0) red_max[r][warp] = wm;
    }
    __syncthreads();

    float alpha[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float tmax = red_max[r][0];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) tmax = fmaxf(tmax, red_max[r][w]);
      const float m_new = fmaxf(m_run[r], tmax);
      alpha[r] = expf(m_run[r] - m_new);  // first tile: exp(-1e30 - m) = 0
      const float p = valid ? expf(s[r] - m_new) : 0.f;
      ps[r][tid] = valid ? to_f(from_f<T>(p * vsc[tid])) : 0.f;
      const float ws = warp_sum(p);
      if (lane == 0) red_sum[r][warp] = ws;
      m_run[r] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float tsum = red_sum[r][0];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) tsum += red_sum[r][w];
      l_run[r] = l_run[r] * alpha[r] + tsum;
      acc[r] *= alpha[r];
    }
    if (tid < dh) {
      for (int t = 0; t < cnt; ++t) {
        const float vf = (float)vt[t][tid];
#pragma unroll
        for (int r = 0; r < REP; ++r) acc[r] = fmaf(ps[r][t], vf, acc[r]);
      }
    }
  }

  if (tid < dh) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
      out[(q_row0 + r) * dh + tid] = from_f<T>(acc[r] / l_run[r]);
  }
}

template <typename T, int REP>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* pos, void* out, int b, int n_kv,
           int m_len, int dh, float inv_sqrt_dh, cudaStream_t stream) {
  if (b * n_kv == 0) return 0;
  kvattn_dynlen_kernel<T, REP><<<b * n_kv, NT, 0, stream>>>(
      (const T*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
      (const float*)vs, (const int*)pos, (T*)out, n_kv, m_len, dh,
      inv_sqrt_dh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rep in {1, 2, 4, 8}; dh % 16 == 0 and
// dh <= 128. Returns a cudaError_t (0 = launched).
extern "C" int tk_kvattn_dynlen(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs,
                                const void* pos, void* out, int dtype, int b,
                                int n_kv, int rep, int m_len, int dh,
                                float inv_sqrt_dh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dh < 16 || dh > DH_MAX || dh % 16 || m_len < 1)
    return (int)cudaErrorInvalidValue;
#define TK_KV_CASE(T, R)                                                       \
  if (rep == R)                                                                \
  return launch<T, R>(q, kq, ks, vq, vs, pos, out, b, n_kv, m_len, dh,         \
                      inv_sqrt_dh, s)
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

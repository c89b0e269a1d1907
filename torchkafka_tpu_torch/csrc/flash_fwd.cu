// Causal flash-attention forward (FlashAttention-2 recurrence) for Hopper.
//
// Replaces: torchkafka_tpu/ops/flash.py `_flash_kernel` (the Pallas TPU
// forward reached through `_flash_fwd_bhsd` and `flash_attention`).
//
// Contract (same as the TPU kernel): q [BH, Sq, D], k/v [BK, Sk, D], bf16 or
// f32, row-major and contiguous. Each q row attends to the keys with
// q_offset + i >= k_offset + j (causal) under an online softmax kept in f32:
//   s = (q . k) * scale, masked; m, l running max and normaliser;
//   p = exp(s - m) (masked keys give exactly 0);
//   acc += round_to_input_dtype(p) . v;   o = acc / max(l, 1e-30);
//   lse = m + log(max(l, 1e-30)).
// A row with no allowed key gives o = 0 and lse ~ -1e30. GQA: q row b*H + h
// reads kv row b*K + h / (H/K); kv heads are never repeated.
//
// What bounds it on this card: at prefill it is compute bound
// (2 * BH * Sq * Sk * D multiply-adds, about half of them causal-skipped,
// against 989 TFLOP/s of bf16 tensor cores). This first version does its
// inner products as f32 FMAs on the CUDA cores (a 4x4 register micro-tile
// per thread over shared-memory tiles), so it is right rather than fast: the
// tensor-core (wgmma/TMA) version is later work. What its design does about
// the bound: it skips every k-tile that lies wholly after the q-tile's last
// row (the causal block skip), never repeats kv heads in memory, and keeps
// the score tile on chip (O(S*D) device memory, never O(S^2)).
//
// Tiles: one thread block (256 threads) per (b*h, 64-row q tile); k/v tiles
// of 64 rows staged in shared memory as f32 (rows padded to D+1 floats so a
// warp's column reads hit distinct banks). Any Sq/Sk is served: ragged edges
// are masked. The TPU kernel's untileable-S fallback is not needed here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;
constexpr int BKT = 64;
constexpr int NT = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p.astype(v.dtype) before the PV product, as the TPU kernel does.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int d,
                 int n_q_heads, int n_kv_heads, int q_offset, int k_offset,
                 int causal, float scale) {
  constexpr int DPT = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Qs = smem;                // [BQ][ld]
  float* Ks = Qs + BQ * ld;        // [BKT][ld]
  float* Vs = Ks + BKT * ld;       // [BKT][ld]
  float* Ps = Vs + BKT * ld;       // [BQ][BKT + 1]

  const int n_qt = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const int rep = n_q_heads / n_kv_heads;
  const int kvrow = (bh / n_q_heads) * n_kv_heads + (bh % n_q_heads) / rep;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)kvrow * sk * d;
  const T* vb = v + (size_t)kvrow * sk * d;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr + 16 i
  const int tc = tid & 15;  // score columns tc + 16 j, output columns tc + 16 j

  for (int i = tid; i < BQ * d; i += NT) {
    const int r = i / d, c = i - r * d;
    Qs[r * ld + c] = (q0 + r < sq) ? to_f(qb[(size_t)(q0 + r) * d + c]) : 0.f;
  }

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // Causal block skip: k-tile t runs iff its first key is not after the
  // tile's last valid q row.
  int n_kt = (sk + BKT - 1) / BKT;
  if (causal) {
    const int lim = q_offset + min(q0 + BQ, sq) - 1 - k_offset;
    n_kt = lim < 0 ? 0 : min(n_kt, lim / BKT + 1);
  }

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BKT;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BKT * d; i += NT) {
      const int r = i / d, c = i - r * d;
      const bool ok = k0 + r < sk;
      const size_t g = (size_t)(k0 + r) * d + c;
      Ks[r * ld + c] = ok ? to_f(kb[g]) : 0.f;
      Vs[r * ld + c] = ok ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const int qpos = q_offset + q0 + r;
      bool ok[4];
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tc + 16 * j;
        ok[j] = (k0 + kk < sk) && (!causal || qpos >= k_offset + k0 + kk);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        rmax = fmaxf(rmax, s[i][j]);
      }
      // The 16 lanes sharing row r differ only in their low 4 lane bits.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        Ps[r * (BKT + 1) + tc + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BKT; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * (BKT + 1) + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int c = tc + 16 * j;
        if (c < d) {
          const float vv = Vs[kk * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r < sq) {
      const float ll = fmaxf(l[i], 1e-30f);
      const size_t row = (size_t)bh * sq + r;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int c = tc + 16 * j;
        if (c < d) o[row * d + c] = from_f<T>(acc[i][j] / ll);
      }
      if (tc == 0) lse[row] = m[i] + logf(ll);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int sq, int sk, int d, int hq, int hk, int qoff, int koff,
           int causal, float scale, cudaStream_t stream) {
  const int ld = d + 1;
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BKT) * ld + BQ * (BKT + 1));
  auto kern = flash_fwd_kernel<T, DMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)bh * ((sq + BQ - 1) / BQ);
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, sq, sk, d,
      hq, hk, qoff, koff, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int tk_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int bh, int sq,
                            int sk, int d, int n_q_heads, int n_kv_heads,
                            int q_offset, int k_offset, int causal,
                            float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define TK_FLASH_CASE(T, DM)                                                  \
  return launch<T, DM>(q, k, v, o, lse, bh, sq, sk, d, n_q_heads, n_kv_heads, \
                       q_offset, k_offset, causal, scale, s)
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d <= 64) { TK_FLASH_CASE(float, 64); }
    if (d <= 128) { TK_FLASH_CASE(float, 128); }
    TK_FLASH_CASE(float, 256);
  }
  if (dtype == 1) {
    if (d <= 64) { TK_FLASH_CASE(__nv_bfloat16, 64); }
    if (d <= 128) { TK_FLASH_CASE(__nv_bfloat16, 128); }
    TK_FLASH_CASE(__nv_bfloat16, 256);
  }
#undef TK_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// Causal flash-attention backward (FlashAttention-2 recurrence) for Hopper:
// two kernels, dQ (K2) and dK/dV (K3).
//
// Replaces: torchkafka_tpu/ops/flash.py `_dq_kernel` (K2) and `_dkv_kernel`
// (K3), the Pallas TPU backward reached through `_flash_bwd_bhsd` and
// `flash_attention`'s custom VJP.
//
// Contract (the TPU kernels'): q, dO [BH, Sq, D]; k, v [BK, Sk, D]; lse and
// delta = rowsum(dO * O) [BH, Sq] f32; bf16 or f32, row-major, contiguous.
// For each allowed (q row i, key j), with q_offset + i >= k_offset + j when
// causal:
//   s  = (q_i . k_j) * scale
//   p  = exp(s - lse_i)              (a select on the mask, never exp * mask:
//                                     a row with no allowed key has
//                                     lse ~ -1e30 and exp overflows)
//   dp = dO_i . v_j
//   ds = p * (dp - delta_i) * scale
//   dQ_i += round(ds, k dtype) * k_j          (K2)
//   dV_j += round(p, dO dtype) * dO_i          (K3)
//   dK_j += round(ds, q dtype) * q_i           (K3)
// Masked pairs contribute exactly 0. GQA: q row b*H + h reads kv row
// b*K + h / (H/K); kv heads are never repeated.
//
// Schedule (not the TPU's): the TPU grid runs in order on one core and
// carries dQ (or dK/dV) in VMEM scratch across the innermost grid axis. Here
// each thread block owns one output tile and loops over what it needs, so
// nothing carries between blocks:
//   K2: one block per (64-row q tile, b*h); it walks the k tiles that
//       causality allows and writes its dQ tile once.
//   K3: one block per (64-key k tile, kv row b*K + kh); it walks the q tiles
//       that causality allows for each of the rep = H/K q heads that share the
//       kv row, summing their contributions in f32 registers. The GQA group
//       sum therefore happens inside the block: no atomics, no H/K-fold
//       per-head partials in device memory, and a deterministic result. (The
//       TPU kernel writes per-q-head partials in k's dtype and sums them
//       afterwards; the two differ only by rounding.)
//
// What bounds it on this card: at the training shape (S=512, D=128) the
// work is about 6*D (K2) and 8*D (K3) flops per allowed (q, k) pair against
// O(S*D) bytes, so with tensor cores it would be near the balance point.
// This first version does its inner products as f32 FMAs on the CUDA cores
// (a 4x4 register micro-tile per thread over shared-memory tiles), like K1:
// right rather than fast, and far from either bound; the tensor-core
// (wgmma/TMA) version is later work. What its design does about the bound:
// it skips every tile pair that causality rules out, reads each kv row once
// per block instead of once per q head, and keeps the score tiles on chip
// (O(S*D) device memory, never O(S^2)).
//
// Tiles stage in shared memory as f32 with rows padded to D+1 floats, so a
// warp's column reads hit distinct banks. Any Sq/Sk is served: ragged edges
// are masked. D <= 128 (four f32 tiles of 64 x (D+1) plus two score tiles
// must fit in one block's shared memory).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;
constexpr int BKT = 64;
constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x.astype(dtype) ahead of a product, as the TPU kernels do.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows x D tile of src (row stride d) into dst (row stride ld), zero past n.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n, int d, int ld, int rows) {
  for (int i = threadIdx.x; i < rows * d; i += NT) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = (row0 + r < n) ? to_f(src[(size_t)(row0 + r) * d + c]) : 0.f;
  }
}

// K2: dQ for one 64-row q tile of one b*h row.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int sq, int sk, int d, int n_q_heads,
                int n_kv_heads, int q_offset, int k_offset, int causal,
                float scale) {
  constexpr int DPT = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  __shared__ float lse_s[BQ], delta_s[BQ];
  const int ld = d + 1;
  float* Qs = smem;                // [BQ][ld]
  float* dOs = Qs + BQ * ld;       // [BQ][ld]
  float* Ks = dOs + BQ * ld;       // [BKT][ld]
  float* Vs = Ks + BKT * ld;       // [BKT][ld]
  float* dSs = Vs + BKT * ld;      // [BQ][BKT + 1]

  const int n_qt = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const int rep = n_q_heads / n_kv_heads;
  const int kvrow = (bh / n_q_heads) * n_kv_heads + (bh % n_q_heads) / rep;
  const T* kb = k + (size_t)kvrow * sk * d;
  const T* vb = v + (size_t)kvrow * sk * d;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr + 16 i
  const int tc = tid & 15;  // key columns tc + 16 j, output columns tc + 16 j

  load_tile(Qs, q + (size_t)bh * sq * d, q0, sq, d, ld, BQ);
  load_tile(dOs, dout + (size_t)bh * sq * d, q0, sq, d, ld, BQ);
  if (tid < BQ) {
    const bool ok = q0 + tid < sq;
    lse_s[tid] = ok ? lse[(size_t)bh * sq + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[(size_t)bh * sq + q0 + tid] : 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // Causal block skip: k tile t runs iff its first key is not after the
  // tile's last valid q row.
  int n_kt = (sk + BKT - 1) / BKT;
  if (causal) {
    const int lim = q_offset + min(q0 + BQ, sq) - 1 - k_offset;
    n_kt = lim < 0 ? 0 : min(n_kt, lim / BKT + 1);
  }

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BKT;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kb, k0, sk, d, ld, BKT);
    load_tile(Vs, vb, k0, sk, d, ld, BKT);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(tr + 16 * i) * ld + c];
        ov[i] = dOs[(tr + 16 * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tc + 16 * j) * ld + c];
        vv[j] = Vs[(tc + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const int qpos = q_offset + q0 + r;
      const bool row_ok = q0 + r < sq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tc + 16 * j;
        const bool ok = row_ok && (k0 + kk < sk) &&
                        (!causal || qpos >= k_offset + k0 + kk);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[r]) * scale;
        dSs[r * (BKT + 1) + kk] = round_to<T>(ds);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BKT; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(tr + 16 * i) * (BKT + 1) + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int c = tc + 16 * j;
        if (c < d) {
          const float kvv = Ks[kk * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kvv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r < sq) {
      const size_t row = (size_t)bh * sq + r;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int c = tc + 16 * j;
        if (c < d) dq[row * d + c] = from_f<T>(acc[i][j]);
      }
    }
  }
}

// K3: dK and dV for one 64-key tile of one kv row, summed over its q heads.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int d,
                 int n_q_heads, int n_kv_heads, int q_offset, int k_offset,
                 int causal, float scale) {
  constexpr int DPT = DMAX / 16;
  extern __shared__ float smem[];
  __shared__ float lse_s[BQ], delta_s[BQ];
  const int ld = d + 1;
  float* Ks = smem;                // [BKT][ld]
  float* Vs = Ks + BKT * ld;       // [BKT][ld]
  float* Qs = Vs + BKT * ld;       // [BQ][ld]
  float* dOs = Qs + BQ * ld;       // [BQ][ld]
  float* Pt = dOs + BQ * ld;       // [BKT][BQ + 1]: p, key-major
  float* dSt = Pt + BKT * (BQ + 1);  // [BKT][BQ + 1]: ds, key-major

  const int n_kt = (sk + BKT - 1) / BKT;
  const int kvrow = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * BKT;
  const int rep = n_q_heads / n_kv_heads;
  const int b = kvrow / n_kv_heads;
  const int kh = kvrow % n_kv_heads;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // key rows tr + 16 i
  const int tc = tid & 15;  // q columns tc + 16 j, output columns tc + 16 j

  load_tile(Ks, k + (size_t)kvrow * sk * d, k0, sk, d, ld, BKT);
  load_tile(Vs, v + (size_t)kvrow * sk * d, k0, sk, d, ld, BKT);

  float acc_k[4][DPT], acc_v[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // Causal block skip: q tiles wholly before the first q row that can see
  // key k0 contribute nothing.
  const int n_qt = (sq + BQ - 1) / BQ;
  int qt0 = 0;
  if (causal) {
    const int need = k_offset + k0 - q_offset;  // first q index seeing k0
    qt0 = need <= 0 ? 0 : need / BQ;
  }

  for (int hr = 0; hr < rep; ++hr) {
    const int bh = b * n_q_heads + kh * rep + hr;
    const T* qb = q + (size_t)bh * sq * d;
    const T* ob = dout + (size_t)bh * sq * d;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile(Qs, qb, q0, sq, d, ld, BQ);
      load_tile(dOs, ob, q0, sq, d, ld, BQ);
      if (tid < BQ) {
        const bool ok = q0 + tid < sq;
        lse_s[tid] = ok ? lse[(size_t)bh * sq + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[(size_t)bh * sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(tr + 16 * i) * ld + c];
          vv[i] = Vs[(tr + 16 * i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tc + 16 * j) * ld + c];
          ov[j] = dOs[(tc + 16 * j) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = tr + 16 * i;
        const int kpos = k_offset + k0 + kr;
        const bool key_ok = k0 + kr < sk;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tc + 16 * j;
          const bool ok = key_ok && (q0 + qc < sq) &&
                          (!causal || q_offset + q0 + qc >= kpos);
          const float p = ok ? expf(s[i][j] * scale - lse_s[qc]) : 0.f;
          const float ds = p * (dp[i][j] - delta_s[qc]) * scale;
          Pt[kr * (BQ + 1) + qc] = round_to<T>(p);
          dSt[kr * (BQ + 1) + qc] = round_to<T>(ds);
        }
      }
      __syncthreads();

      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(tr + 16 * i) * (BQ + 1) + qq];
          dsv[i] = dSt[(tr + 16 * i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int c = tc + 16 * j;
          if (c < d) {
            const float ovv = dOs[qq * ld + c];
            const float qvv = Qs[qq * ld + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc_v[i][j] = fmaf(pv[i], ovv, acc_v[i][j]);
              acc_k[i][j] = fmaf(dsv[i], qvv, acc_k[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + tr + 16 * i;
    if (r < sk) {
      const size_t row = (size_t)kvrow * sk + r;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int c = tc + 16 * j;
        if (c < d) {
          dk[row * d + c] = from_f<T>(acc_k[i][j]);
          dv[row * d + c] = from_f<T>(acc_v[i][j]);
        }
      }
    }
  }
}

template <typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq,
              int sk, int d, int hq, int hk, int qoff, int koff, int causal,
              float scale, cudaStream_t stream) {
  const int ld = d + 1;
  const size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BKT) * ld + BQ * (BKT + 1));
  auto kern = flash_dq_kernel<T, DMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)bh * ((sq + BQ - 1) / BQ);
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, sq, sk, d, hq, hk, qoff, koff, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bk,
               int sq, int sk, int d, int hq, int hk, int qoff, int koff,
               int causal, float scale, cudaStream_t stream) {
  const int ld = d + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BKT) * ld + 2 * BKT * (BQ + 1));
  auto kern = flash_dkv_kernel<T, DMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)bk * ((sk + BKT - 1) / BKT);
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, sq, sk, d, hq, hk, qoff, koff,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 = launched).
extern "C" int tk_flash_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int dtype, int bh,
                           int sq, int sk, int d, int n_q_heads,
                           int n_kv_heads, int q_offset, int k_offset,
                           int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define TK_DQ_CASE(T, DM)                                                     \
  return launch_dq<T, DM>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,       \
                          n_q_heads, n_kv_heads, q_offset, k_offset, causal,  \
                          scale, s)
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d <= 64) { TK_DQ_CASE(float, 64); }
    TK_DQ_CASE(float, 128);
  }
  if (dtype == 1) {
    if (d <= 64) { TK_DQ_CASE(__nv_bfloat16, 64); }
    TK_DQ_CASE(__nv_bfloat16, 128);
  }
#undef TK_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int tk_flash_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int dtype,
                            int bk, int sq, int sk, int d, int n_q_heads,
                            int n_kv_heads, int q_offset, int k_offset,
                            int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define TK_DKV_CASE(T, DM)                                                    \
  return launch_dkv<T, DM>(q, k, v, dout, lse, delta, dk, dv, bk, sq, sk, d,  \
                           n_q_heads, n_kv_heads, q_offset, k_offset, causal, \
                           scale, s)
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d <= 64) { TK_DKV_CASE(float, 64); }
    TK_DKV_CASE(float, 128);
  }
  if (dtype == 1) {
    if (d <= 64) { TK_DKV_CASE(__nv_bfloat16, 64); }
    TK_DKV_CASE(__nv_bfloat16, 128);
  }
#undef TK_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

// Weight-only int8 matmul, y = (x @ q in f32) * scale, for Hopper.
//
// Replaces: torchkafka_tpu/ops/qmatmul.py `_qmm_kernel` (the Pallas TPU
// kernel reached through `quantized_matmul`).
//
// Contract (same as the TPU kernel): x [M, K] (bf16 or f32, row-major),
// q [K, N] int8 (row-major), scale [N] f32 (one per output column),
// out [M, N] in x's dtype:
//   acc[m, n] = sum_k float(x[m, k]) * float(q[k, n])     (f32, whole K)
//   out[m, n] = round_to_x_dtype(acc[m, n] * scale[n])
// The scale lands ONCE on the f32 accumulator, after the whole K sum, as the
// TPU kernel's `_finish` does; scaling per K chunk would round differently.
// int8 -> f32 is exact, and so is bf16 -> f32, so every product is exact
// and only the f32 summation order differs from the reference.
//
// What bounds it on this card. Decode rows (M <= 64): device memory, the
// int8 weight streamed once (K*N bytes; 58.7 MB for an 8b MLP weight, 17.5
// us at 3.35 TB/s). Prefill rows (M = 2048): arithmetic, 2*M*K*N flops. What
// its design does about that:
//
// - Decode kernel (M <= 64): one block per 32-column panel holds ALL M rows,
//   so every int8 weight byte is read from device memory exactly once.
//   Each thread owns 4 (or 2) adjacent columns and a strided set of k rows;
//   it loads one 32-bit word of q per k row straight into registers (the
//   next chunk's words are in flight while the current chunk computes), and
//   multiplies it against the block's x chunk, staged in shared memory as
//   f32 [k][m] so one 16-byte read feeds 4 rows. The k lanes of a column
//   group are summed by warp shuffles, then warp by warp in a fixed order
//   through shared memory, and the scale is applied once.
// - Tile kernel (M > 64): a plain 128x128 output tile per block, 16-deep k
//   slices of x and q (q converted to f32) in shared memory, 8x8 outputs per
//   thread on the CUDA cores, the next slice prefetched into registers.
//   This is a simple kernel, far from the tensor cores' rate; its time is
//   recorded against the library's and the redesign (wgmma on bf16, which
//   holds int8 exactly) is later work.
//
// Any M, K and N: every load and store is masked at the ragged edges.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ------------------------------------------------------------ decode rows

constexpr int DEC_NT = 256;  // threads
constexpr int DEC_BN = 32;   // output columns per block
constexpr int DEC_BK = 128;  // k rows per staged x chunk

// CPT adjacent int8 columns of row `kk`, starting at column `col`, packed
// into the low bytes of a word (zero where out of range).
template <int CPT>
__device__ __forceinline__ uint32_t load_q(const int8_t* __restrict__ q, int kk,
                                           int col, int k, int n, bool vec) {
  if (kk >= k) return 0u;
  const int8_t* p = q + (size_t)kk * n + col;
  if (vec && col + CPT <= n) {
    if (CPT == 4) return *reinterpret_cast<const uint32_t*>(p);
    return (uint32_t)*reinterpret_cast<const uint16_t*>(p);
  }
  uint32_t w = 0u;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (col + c < n) w |= (uint32_t)(uint8_t)p[c] << (8 * c);
  return w;
}

template <typename T, int MR, int CPT>
__global__ void __launch_bounds__(DEC_NT)
qmm_decode_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, T* __restrict__ out, int m,
                  int k, int n, int vec_ok) {
  constexpr int LPR = DEC_BN / CPT;  // threads per k row (8 or 16)
  constexpr int KL = DEC_NT / LPR;   // k lanes per block (32 or 16)
  constexpr int KPT = DEC_BK / KL;   // k rows per thread per chunk
  constexpr int MP = MR + 4;         // padded x row: 16-byte aligned reads
  __shared__ __align__(16) float xs[DEC_BK][MP];
  __shared__ float red[MR][DEC_BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid % LPR;  // column group within the panel
  const int kl = tid / LPR;  // k lane
  const int n0 = blockIdx.x * DEC_BN;
  const int col = n0 + cl * CPT;
  const bool vec = vec_ok != 0;

  float acc[MR][CPT];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  uint32_t nxt[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) nxt[j] = load_q<CPT>(q, kl + j * KL, col, k, n, vec);

  const int chunks = (k + DEC_BK - 1) / DEC_BK;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * DEC_BK;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < DEC_BK * MR; i += DEC_NT) {
      const int mm = i / DEC_BK, kk = i - mm * DEC_BK;
      float v = 0.f;
      if (mm < m && k0 + kk < k) v = to_f(x[(size_t)mm * k + k0 + kk]);
      xs[kk][mm] = v;
    }
    __syncthreads();
    uint32_t cur[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) cur[j] = nxt[j];
    if (c + 1 < chunks) {
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        nxt[j] = load_q<CPT>(q, k0 + DEC_BK + kl + j * KL, col, k, n, vec);
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = kl + j * KL;
      float qf[CPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) qf[cc] = (float)(int8_t)(cur[j] >> (8 * cc));
#pragma unroll
      for (int mm = 0; mm < MR; mm += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[kk][mm]);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          acc[mm][cc] = fmaf(xv.x, qf[cc], acc[mm][cc]);
          acc[mm + 1][cc] = fmaf(xv.y, qf[cc], acc[mm + 1][cc]);
          acc[mm + 2][cc] = fmaf(xv.z, qf[cc], acc[mm + 2][cc]);
          acc[mm + 3][cc] = fmaf(xv.w, qf[cc], acc[mm + 3][cc]);
        }
      }
    }
  }

  // The k lanes of one column group inside a warp: lanes l, l + LPR, ...
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        acc[i][cc] += __shfl_xor_sync(0xffffffffu, acc[i][cc], off);
  // Then warp by warp, in a fixed order (deterministic sums).
  for (int w = 0; w < DEC_NT / 32; ++w) {
    if (warp == w && lane < LPR) {
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          float* r = &red[i][cl * CPT + cc];
          *r = (w == 0) ? acc[i][cc] : *r + acc[i][cc];
        }
    }
    __syncthreads();
  }
  for (int i = tid; i < MR * DEC_BN; i += DEC_NT) {
    const int mm = i / DEC_BN, j = i - mm * DEC_BN;
    if (mm < m && n0 + j < n)
      out[(size_t)mm * n + n0 + j] = from_f<T>(red[mm][j] * scale[n0 + j]);
  }
}

// ------------------------------------------------------------- tile rows

constexpr int TB_M = 128, TB_N = 128, TB_K = 16, TT = 8;
constexpr int TNT = (TB_M / TT) * (TB_N / TT);  // 256 threads, 16 x 16
constexpr int XPT = TB_M * TB_K / TNT;          // x elements per thread per slice
constexpr int QPT = TB_K * TB_N / TNT;          // q elements per thread per slice

template <typename T>
__global__ void __launch_bounds__(TNT)
qmm_tile_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, T* __restrict__ out, int m,
                int k, int n) {
  __shared__ float xs[TB_K][TB_M + 4];  // [k][m]
  __shared__ float qs[TB_K][TB_N + 4];  // [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % (TB_N / TT), ty = tid / (TB_N / TT);
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * TB_N;

  float xr[XPT], qr[QPT];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * TNT, mm = e / TB_K, kk = e % TB_K;
      const int gm = m0 + mm, gk = k0 + kk;
      xr[i] = (gm < m && gk < k) ? to_f(x[(size_t)gm * k + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int e = tid + i * TNT, kk = e / TB_N, nn = e % TB_N;
      const int gk = k0 + kk, gn = n0 + nn;
      qr[i] = (gk < k && gn < n) ? (float)q[(size_t)gk * n + gn] : 0.f;
    }
  };

  float acc[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < k; k0 += TB_K) {
    __syncthreads();  // the previous slice's readers are done
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * TNT;
      xs[e % TB_K][e / TB_K] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int e = tid + i * TNT;
      qs[e / TB_N][e % TB_N] = qr[i];
    }
    __syncthreads();
    if (k0 + TB_K < k) fetch(k0 + TB_K);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < TB_K; ++kk) {
      float a[TT], b[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i) a[i] = xs[kk][ty + i * (TB_M / TT)];
#pragma unroll
      for (int j = 0; j < TT; ++j) b[j] = qs[kk][tx + j * (TB_N / TT)];
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int gm = m0 + ty + i * (TB_M / TT);
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int gn = n0 + tx + j * (TB_N / TT);
      if (gn < n) out[(size_t)gm * n + gn] = from_f<T>(acc[i][j] * scale[gn]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* out, int m,
           int k, int n, int vec_ok, cudaStream_t s) {
  const T* xp = (const T*)x;
  const int8_t* qp = (const int8_t*)q;
  const float* sp = (const float*)scale;
  T* op = (T*)out;
  if (m <= 64) {
    const dim3 grid((n + DEC_BN - 1) / DEC_BN);
    if (m <= 8)
      qmm_decode_kernel<T, 8, 4><<<grid, DEC_NT, 0, s>>>(xp, qp, sp, op, m, k, n, vec_ok);
    else if (m <= 16)
      qmm_decode_kernel<T, 16, 4><<<grid, DEC_NT, 0, s>>>(xp, qp, sp, op, m, k, n, vec_ok);
    else if (m <= 32)
      qmm_decode_kernel<T, 32, 4><<<grid, DEC_NT, 0, s>>>(xp, qp, sp, op, m, k, n, vec_ok);
    else
      qmm_decode_kernel<T, 64, 2><<<grid, DEC_NT, 0, s>>>(xp, qp, sp, op, m, k, n, vec_ok);
  } else {
    const dim3 grid((n + TB_N - 1) / TB_N, (m + TB_M - 1) / TB_M);
    qmm_tile_kernel<T><<<grid, TNT, 0, s>>>(xp, qp, sp, op, m, k, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec_ok: q's rows may be read as aligned
// 4-byte words (N % 4 == 0 and a 4-byte-aligned q). Returns a cudaError_t
// (0 = launched).
extern "C" int tk_qmatmul(const void* x, const void* q, const void* scale,
                          void* out, int dtype, int m, int k, int n, int vec_ok,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m < 0 || k < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  if (dtype == 0) return launch<float>(x, q, scale, out, m, k, n, vec_ok, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, q, scale, out, m, k, n, vec_ok, s);
  return (int)cudaErrorInvalidValue;
}

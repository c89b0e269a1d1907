// Causal flash-attention backward (FlashAttention-2 recurrence) for Hopper:
// dQ (K2) and dK/dV (K3), each in two versions chosen by a fixed rule
// (ops/flash.py `_route`, never on failure):
//   bf16 with D % 16 == 0, D <= 128
//                          -> flash_dq_tc_kernel / flash_dkv_tc_kernel, on
//                             the tensor cores (the training path);
//   f32, D % 16 != 0, or 128 < D <= 256
//                          -> flash_dq_kernel / flash_dkv_kernel, scalar
//                             f32 FMAs on the CUDA cores.
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
// What bounds it on this card: at the training shape (B=8, S=512, D=128)
// the work is 6*D (K2) and 8*D (K3) flops per allowed (q, k) pair against
// O(S*D) bytes: 13-17 GFLOP over ~20 MB, near the bf16 balance point
// (~295 flops a byte), so the tensor cores are the first limit. The
// CUDA-core version (kept below for f32) reaches ~10-15 TFLOP/s there.
//
// The tensor-core version (bf16, D a multiple of 16 up to 128):
// - Products are `mma.sync.m16n8k16` bf16 -> f32, fed by `ldmatrix`
//   (`.trans` for the operands whose reduction runs along the rows of the
//   tile). mma.sync, not wgmma: its fragment layouts are fixed per warp,
//   so each operand's addressing is one short formula that the plain
//   version checks directly; wgmma (64-row warpgroup tiles, descriptors
//   over the same swizzled tiles) is the next step for these kernels.
// - Operands stay bf16 in shared memory, 64-row tiles whose rows are
//   DMAX (64 or 128) elements; the sixteen-byte chunk c of row r sits at
//   chunk c ^ (r & 7), so the eight rows of every ldmatrix phase and every
//   cp.async row land on distinct banks.
// - Tiles arrive by `cp.async.cg` 16-byte copies (a zero-fill tail for
//   rows past Sq/Sk) in two stages: the next K/V tile (K2) or the next
//   Q/dO/lse/delta tile (K3) loads while the current one is computed.
// - Each of the four warps owns 16 rows of the block's 64: q rows in K2,
//   keys in K3. K3 computes the transposed products S^T = K.Q^T and
//   dP^T = V.dO^T, so P^T and dS^T come out of the accumulator already in
//   the A-operand layout of dV += P^T.dO and dK += dS^T.Q, and are rounded
//   to bf16 in registers with no trip through shared memory; K2 does the
//   same with dS for dQ += dS.K, one 32-key half of its K/V tile at a time
//   so that its scores, dQ and fragment addresses fit in registers with no
//   spill.
// - The mask is applied only on tiles that cross the causal diagonal or a
//   ragged edge; p = exp2(s * scale * log2(e) - lse * log2(e)).
// - dQ (K2) and dK/dV (K3, summed over the rep q heads of the kv head) stay
//   in f32 registers and are written once: no atomics, a deterministic
//   result. Blocks are ordered heaviest causal tile first (K2: last q tile
//   first; K3: first key tile first).
//
// The CUDA-core version stages tiles in shared memory as f32 with rows
// padded to D+1 floats and does its products as a register micro-tile of
// FMAs per thread (TR/16 rows by TR/16 keys). Its tiles are TR = 64 rows
// up to D = 128 and TR = 32 rows above: at D = 256 four 64-row f32 tiles
// alone take 4 * 256 * 257 * 4 = 263,168 bytes, more than a block's
// 232,448, while 32-row tiles take 135,808 (dQ) and 140,032 (dK/dV) bytes.
// Both versions serve any Sq/Sk (ragged edges masked); the tensor-core one
// D <= 128 (a 16 x D f32 accumulator a warp), the CUDA-core one D <= 256.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

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

// K2: dQ for one TR-row q tile of one b*h row.
template <typename T, int DMAX, int TR>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int sq, int sk, int d, int n_q_heads,
                int n_kv_heads, int q_offset, int k_offset, int causal,
                float scale) {
  constexpr int BQ = TR, BKT = TR;  // q rows and keys of a tile
  constexpr int RI = TR / 16;       // rows (and keys) per thread
  constexpr int DPT = DMAX / 16;    // output columns per thread
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

  float acc[RI][DPT];
#pragma unroll
  for (int i = 0; i < RI; ++i)
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

    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RI], ov[RI], kv[RI], vv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(tr + 16 * i) * ld + c];
        ov[i] = dOs[(tr + 16 * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        kv[j] = Ks[(tc + 16 * j) * ld + c];
        vv[j] = Vs[(tc + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = tr + 16 * i;
      const int qpos = q_offset + q0 + r;
      const bool row_ok = q0 + r < sq;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
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
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dSs[(tr + 16 * i) * (BKT + 1) + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int c = tc + 16 * j;
        if (c < d) {
          const float kvv = Ks[kk * ld + c];
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(dsv[i], kvv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
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

// K3: dK and dV for one TR-key tile of one kv row, summed over its q heads.
template <typename T, int DMAX, int TR>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int d,
                 int n_q_heads, int n_kv_heads, int q_offset, int k_offset,
                 int causal, float scale) {
  constexpr int BQ = TR, BKT = TR;
  constexpr int RI = TR / 16;
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

  float acc_k[RI][DPT], acc_v[RI][DPT];
#pragma unroll
  for (int i = 0; i < RI; ++i)
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

      float s[RI][RI], dp[RI][RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float kv[RI], vv[RI], qv[RI], ov[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = Ks[(tr + 16 * i) * ld + c];
          vv[i] = Vs[(tr + 16 * i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          qv[j] = Qs[(tc + 16 * j) * ld + c];
          ov[j] = dOs[(tc + 16 * j) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int kr = tr + 16 * i;
        const int kpos = k_offset + k0 + kr;
        const bool key_ok = k0 + kr < sk;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
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
        float pv[RI], dsv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
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
            for (int i = 0; i < RI; ++i) {
              acc_v[i][j] = fmaf(pv[i], ovv, acc_v[i][j]);
              acc_k[i][j] = fmaf(dsv[i], qvv, acc_k[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
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

template <typename T, int DMAX, int TR>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq,
              int sk, int d, int hq, int hk, int qoff, int koff, int causal,
              float scale, cudaStream_t stream) {
  constexpr int BQ = TR, BKT = TR;
  const int ld = d + 1;
  const size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BKT) * ld + BQ * (BKT + 1));
  auto kern = flash_dq_kernel<T, DMAX, TR>;
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

template <typename T, int DMAX, int TR>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bk,
               int sq, int sk, int d, int hq, int hk, int qoff, int koff,
               int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = TR, BKT = TR;
  const int ld = d + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BKT) * ld + 2 * BKT * (BQ + 1));
  auto kern = flash_dkv_kernel<T, DMAX, TR>;
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

// ------------------------------------------------ tensor-core version (bf16)
//
// The fragment helpers (ldmatrix, mma.sync, cp.async, the swizzle) are in
// flash_tc.cuh, shared with the forward.

// Zeroes a pair of 16 x 8*N accumulator tiles.
template <int N>
__device__ __forceinline__ void zero_tiles(float (&s)[N][4], float (&t)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
}

// Two score-like products over nk 16-deep steps of D: s += A1 . B1^T and
// t += A2 . B2^T, each A the 16 rows at row r0 of a swizzled tile, each B
// the 16*NB rows at address b (a multiple of 8 rows into its tile, so the
// swizzle is unchanged). B's rows are the n dimension and its columns the
// reduction, so plain ldmatrix gives the column-major B fragments.
template <int DMAX, int NB>
__device__ __forceinline__ void scores(float (&s)[2 * NB][4], float (&t)[2 * NB][4],
                                       uint32_t a1, uint32_t b1, uint32_t a2, uint32_t b2,
                                       int r0, int nk, int lane) {
  constexpr int ROWB = DMAX * 2;
  const int la_r = (lane & 7) + ((lane >> 3) & 1) * 8, la_c = lane >> 4;
  const int lb_r = (lane & 7) + (lane >> 4) * 8, lb_c = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < nk) {
      uint32_t a[4], b[4];
      ldsm4(a, a1 + swz(r0 + la_r, 2 * kk + la_c, ROWB));
#pragma unroll
      for (int np = 0; np < NB; ++np) {
        ldsm4(b, b1 + swz(np * 16 + lb_r, 2 * kk + lb_c, ROWB));
        mma16816(s[2 * np], a, b[0], b[1]);
        mma16816(s[2 * np + 1], a, b[2], b[3]);
      }
      ldsm4(a, a2 + swz(r0 + la_r, 2 * kk + la_c, ROWB));
#pragma unroll
      for (int np = 0; np < NB; ++np) {
        ldsm4(b, b2 + swz(np * 16 + lb_r, 2 * kk + lb_c, ROWB));
        mma16816(t[2 * np], a, b[0], b[1]);
        mma16816(t[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int DMAX>
constexpr int dq_tc_smem() { return 6 * TC_ROWS * DMAX * 2; }
template <int DMAX>
constexpr int dkv_tc_smem() { return 6 * TC_ROWS * DMAX * 2 + 2 * 2 * TC_ROWS * 4; }

// K2 on the tensor cores: dQ for one 64-row q tile of one b*h row. Shared
// memory: Q, dO, then two stages of (K, V).
template <int DMAX>
__global__ void __launch_bounds__(TC_NT)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int sq, int sk, int d, int n_q_heads,
                   int n_kv_heads, int q_offset, int k_offset, int causal,
                   float scale) {
  constexpr int TB = TC_ROWS * DMAX * 2;  // bytes of one tile
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_addr(tc_smem), sO = sQ + TB, sKV = sQ + 2 * TB;

  const int n_qt = (sq + TC_ROWS - 1) / TC_ROWS;
  const int n_rows = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / n_rows;  // heaviest causal tiles first
  const int bh = (int)blockIdx.x % n_rows;
  const int q0 = qt * TC_ROWS;
  const int rep = n_q_heads / n_kv_heads;
  const int kvrow = (bh / n_q_heads) * n_kv_heads + (bh % n_q_heads) / rep;
  const bf16* kb = k + (size_t)kvrow * sk * d;
  const bf16* vb = v + (size_t)kvrow * sk * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nk = d >> 4;
  const float sl2 = scale * LOG2E;

  int n_kt = (sk + TC_ROWS - 1) / TC_ROWS;
  if (causal) {
    const int lim = q_offset + min(q0 + TC_ROWS, sq) - 1 - k_offset;
    n_kt = lim < 0 ? 0 : min(n_kt, lim / TC_ROWS + 1);
  }

  // This thread's two q rows, r0 and r0 + 8.
  const int r0 = q0 + warp * 16 + gid;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = r0 + 8 * h < sq;
    lse2[h] = ok ? lse[(size_t)bh * sq + r0 + 8 * h] * LOG2E : 0.f;
    dlt[h] = ok ? delta[(size_t)bh * sq + r0 + 8 * h] : 0.f;
  }

  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (n_kt > 0) {
    tc_load_rows<DMAX>(sQ, q + (size_t)bh * sq * d, q0, sq, d);
    tc_load_rows<DMAX>(sO, dout + (size_t)bh * sq * d, q0, sq, d);
    tc_load_rows<DMAX>(sKV, kb, 0, sk, d);
    tc_load_rows<DMAX>(sKV + TB, vb, 0, sk, d);
  }
  cp_async_commit();

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * TC_ROWS;
    const uint32_t sK = sKV + (t & 1) * 2 * TB, sV = sK + TB;
    if (t + 1 < n_kt) {  // the next K/V tile loads while this one computes
      const uint32_t nK = sKV + ((t + 1) & 1) * 2 * TB;
      tc_load_rows<DMAX>(nK, kb, k0 + TC_ROWS, sk, d);
      tc_load_rows<DMAX>(nK + TB, vb, k0 + TC_ROWS, sk, d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // The tile in two 32-key halves: half the score registers live at once.
    const bool full =
        k0 + TC_ROWS <= sk && (!causal || q_offset + q0 >= k_offset + k0 + TC_ROWS - 1);
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const uint32_t hK = sK + half * 32 * DMAX * 2, hV = sV + half * 32 * DMAX * 2;
      float s[4][4], dp[4][4];
      zero_tiles(s, dp);
      scores<DMAX, 2>(s, dp, sQ, hK, sO, hV, warp * 16, nk, lane);  // S = Q.K^T, dP = dO.V^T

      // dS = P o (dP - delta) * scale; the mask only where a tile crosses
      // the causal diagonal or the ragged key edge.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2f(fmaf(s[j][e], sl2, -lse2[h]));
          if (!full) {
            const int key = k0 + half * 32 + j * 8 + tig * 2 + (e & 1);
            const bool ok = key < sk && (!causal || q_offset + r0 + 8 * h >= k_offset + key);
            p = ok ? p : 0.f;
          }
          s[j][e] = p * (dp[j][e] - dlt[h]) * scale;
        }
      }
      uint32_t da[2][4];
      acc_to_a(da, s);                             // round(dS, k dtype)
      acc_product<DMAX, 2>(acc, da, hK, nk, lane);  // dQ += dS . K
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

  store_rows<DMAX>(dq + (size_t)bh * sq * d, acc, r0, sq, d, tig);
}

// K3 on the tensor cores: dK and dV for one 64-key tile of one kv row,
// summed over its rep q heads. Shared memory: K, V, two stages of (Q, dO),
// then two stages of (lse[64], delta[64]).
template <int DMAX>
__global__ void __launch_bounds__(TC_NT)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int d,
                    int n_q_heads, int n_kv_heads, int q_offset, int k_offset,
                    int causal, float scale) {
  constexpr int TB = TC_ROWS * DMAX * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sK = smem_addr(tc_smem), sV = sK + TB, sQO = sK + 2 * TB;
  const uint32_t sL = sK + 6 * TB;
  const float* lds = reinterpret_cast<const float*>(tc_smem + 6 * TB);

  const int n_kt = (sk + TC_ROWS - 1) / TC_ROWS;
  const int n_rows = gridDim.x / n_kt;
  const int kt = (int)blockIdx.x / n_rows;  // heaviest causal tiles first
  const int kvrow = (int)blockIdx.x % n_rows;
  const int k0 = kt * TC_ROWS;
  const int rep = n_q_heads / n_kv_heads;
  const int b = kvrow / n_kv_heads, kh = kvrow % n_kv_heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nk = d >> 4;
  const float sl2 = scale * LOG2E;

  // Causal block skip: q tiles wholly before the first q row that can see
  // key k0 contribute nothing. Steps t walk (q head, q tile) pairs.
  const int n_qt = (sq + TC_ROWS - 1) / TC_ROWS;
  int qt0 = 0;
  if (causal) {
    const int need = k_offset + k0 - q_offset;  // first q index seeing k0
    qt0 = need <= 0 ? 0 : min(need / TC_ROWS, n_qt);
  }
  const int per_head = n_qt - qt0;
  const int n_t = rep * per_head;

  auto load_q = [&](int t, int st) {
    const int bh = b * n_q_heads + kh * rep + t / per_head;
    const int q0 = (qt0 + t % per_head) * TC_ROWS;
    const uint32_t base = sQO + st * 2 * TB;
    tc_load_rows<DMAX>(base, q + (size_t)bh * sq * d, q0, sq, d);
    tc_load_rows<DMAX>(base + TB, dout + (size_t)bh * sq * d, q0, sq, d);
    const int i = tid & (TC_ROWS - 1);  // threads 0-63: lse[i]; 64-127: delta[i]
    const bool ok = q0 + i < sq;
    const float* src = (tid < TC_ROWS ? lse : delta) + (size_t)bh * sq + (ok ? q0 + i : 0);
    cp_async4(sL + (uint32_t)(st * 2 * TC_ROWS + tid) * 4, src, ok);
  };

  float dka[DMAX / 8][4], dva[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (n_t > 0) {  // K and V once; then the first q tile
    tc_load_rows<DMAX>(sK, k + (size_t)kvrow * sk * d, k0, sk, d);
    tc_load_rows<DMAX>(sV, v + (size_t)kvrow * sk * d, k0, sk, d);
    load_q(0, 0);
  }
  cp_async_commit();

  const int kr = k0 + warp * 16 + gid;  // this thread's keys: kr and kr + 8
  for (int t = 0; t < n_t; ++t) {
    const int st = t & 1;
    const int q0 = (qt0 + t % per_head) * TC_ROWS;
    const uint32_t sQ = sQO + st * 2 * TB, sO = sQ + TB;
    const float* ls = lds + st * 2 * TC_ROWS;  // lse[64], then delta[64]
    if (t + 1 < n_t) load_q(t + 1, st ^ 1);  // the next q tile loads meanwhile
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4], dp[8][4];
    zero_tiles(s, dp);
    scores<DMAX, 4>(s, dp, sK, sQ, sV, sO, warp * 16, nk, lane);  // S^T = K.Q^T, dP^T = V.dO^T

    const bool full = k0 + TC_ROWS <= sk && q0 + TC_ROWS <= sq &&
                      (!causal || q_offset + q0 >= k_offset + k0 + TC_ROWS - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = j * 8 + tig * 2;  // this thread's q columns: qc, qc + 1
      const float2 L = *reinterpret_cast<const float2*>(ls + qc);
      const float2 Dl = *reinterpret_cast<const float2*>(ls + TC_ROWS + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? L.y : L.x, dl = (e & 1) ? Dl.y : Dl.x;
        float p = exp2f(fmaf(s[j][e], sl2, -lq * LOG2E));
        if (!full) {
          const int key = kr + 8 * (e >> 1), row = q0 + qc + (e & 1);
          const bool ok = key < sk && row < sq && (!causal || q_offset + row >= k_offset + key);
          p = ok ? p : 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl) * scale;
        s[j][e] = p;
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    acc_to_a(pa, s);    // round(p, dO dtype), transposed: keys are rows
    acc_to_a(dsa, dp);  // round(ds, q dtype)
    acc_product<DMAX, 4>(dva, pa, sO, nk, lane);   // dV += P^T . dO
    acc_product<DMAX, 4>(dka, dsa, sQ, nk, lane);  // dK += dS^T . Q
    __syncthreads();  // this stage's readers are done before it refills
  }

  store_rows<DMAX>(dk + (size_t)kvrow * sk * d, dka, kr, sk, d, tig);
  store_rows<DMAX>(dv + (size_t)kvrow * sk * d, dva, kr, sk, d, tig);
}

template <int DMAX>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                 int d, int hq, int hk, int qoff, int koff, int causal, float scale,
                 cudaStream_t stream) {
  constexpr int smem = dq_tc_smem<DMAX>();
  auto kern = flash_dq_tc_kernel<DMAX>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)bh * ((sq + TC_ROWS - 1) / TC_ROWS);
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, TC_NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dq, sq, sk, d, hq, hk, qoff, koff, causal, scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int bk, int sq,
                  int sk, int d, int hq, int hk, int qoff, int koff, int causal,
                  float scale, cudaStream_t stream) {
  constexpr int smem = dkv_tc_smem<DMAX>();
  auto kern = flash_dkv_tc_kernel<DMAX>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)bk * ((sk + TC_ROWS - 1) / TC_ROWS);
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, TC_NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, sq, sk, d, hq, hk, qoff, koff, causal,
      scale);
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
#define TK_DQ_CASE(T, DM, TR)                                                 \
  return launch_dq<T, DM, TR>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,   \
                          n_q_heads, n_kv_heads, q_offset, k_offset, causal,  \
                          scale, s)
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d <= 64) { TK_DQ_CASE(float, 64, 64); }
    if (d <= 128) { TK_DQ_CASE(float, 128, 64); }
    TK_DQ_CASE(float, 256, 32);
  }
  if (dtype == 1) {
    if (d <= 64) { TK_DQ_CASE(__nv_bfloat16, 64, 64); }
    if (d <= 128) { TK_DQ_CASE(__nv_bfloat16, 128, 64); }
    TK_DQ_CASE(__nv_bfloat16, 256, 32);
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
#define TK_DKV_CASE(T, DM, TR)                                                \
  return launch_dkv<T, DM, TR>(q, k, v, dout, lse, delta, dk, dv, bk, sq, sk, d,\
                           n_q_heads, n_kv_heads, q_offset, k_offset, causal, \
                           scale, s)
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d <= 64) { TK_DKV_CASE(float, 64, 64); }
    if (d <= 128) { TK_DKV_CASE(float, 128, 64); }
    TK_DKV_CASE(float, 256, 32);
  }
  if (dtype == 1) {
    if (d <= 64) { TK_DKV_CASE(__nv_bfloat16, 64, 64); }
    if (d <= 128) { TK_DKV_CASE(__nv_bfloat16, 128, 64); }
    TK_DKV_CASE(__nv_bfloat16, 256, 32);
  }
#undef TK_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernels: bf16 (dtype 1) with D a multiple of 16 up to 128;
// same arguments as tk_flash_dq / tk_flash_dkv. Each returns a cudaError_t.
extern "C" int tk_flash_dq_tc(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, int dtype, int bh,
                              int sq, int sk, int d, int n_q_heads,
                              int n_kv_heads, int q_offset, int k_offset,
                              int causal, float scale, void* stream) {
  if (dtype != 1 || d < 16 || d > 128 || d % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch_dq_tc<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, n_q_heads,
                            n_kv_heads, q_offset, k_offset, causal, scale, s);
  return launch_dq_tc<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, n_q_heads,
                           n_kv_heads, q_offset, k_offset, causal, scale, s);
}

extern "C" int tk_flash_dkv_tc(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int dtype,
                               int bk, int sq, int sk, int d, int n_q_heads,
                               int n_kv_heads, int q_offset, int k_offset,
                               int causal, float scale, void* stream) {
  if (dtype != 1 || d < 16 || d > 128 || d % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch_dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, bk, sq, sk, d, n_q_heads,
                             n_kv_heads, q_offset, k_offset, causal, scale, s);
  return launch_dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, bk, sq, sk, d, n_q_heads,
                            n_kv_heads, q_offset, k_offset, causal, scale, s);
}

// Resources of a tensor-core kernel as compiled: which 0 = dQ, 1 = dK/dV;
// dmax 64 (D <= 64) or 128. out: registers a thread, local (spill) bytes a
// thread, static and dynamic shared bytes a block.
extern "C" int tk_flash_bwd_tc_attrs(int which, int dmax, int* out) {
  if (which == 0 && dmax == 64) return func_attrs(flash_dq_tc_kernel<64>, dq_tc_smem<64>(), out);
  if (which == 0 && dmax == 128) return func_attrs(flash_dq_tc_kernel<128>, dq_tc_smem<128>(), out);
  if (which == 1 && dmax == 64) return func_attrs(flash_dkv_tc_kernel<64>, dkv_tc_smem<64>(), out);
  if (which == 1 && dmax == 128) return func_attrs(flash_dkv_tc_kernel<128>, dkv_tc_smem<128>(), out);
  return (int)cudaErrorInvalidValue;
}

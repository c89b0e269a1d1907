// Causal flash-attention forward (FlashAttention-2 recurrence) for Hopper,
// in two versions chosen by a fixed rule (ops/flash.py `_route`, never
// on failure):
//   bf16 with D % 16 == 0, D <= 128  -> flash_fwd_tc_kernel, on the tensor
//                                        cores (training, both prefills);
//   f32, D % 16 != 0, or D > 128     -> flash_fwd_kernel, scalar f32 FMAs
//                                        on the CUDA cores.
//
// Replaces: torchkafka_tpu/ops/flash.py `_flash_kernel` (the Pallas TPU
// forward reached through `_flash_fwd_bhsd` and `flash_attention`).
//
// Contract (same as the TPU kernel): q [BH, Sq, D], k/v [BK, Sk, D], bf16 or
// f32, row-major and contiguous. Each q row attends to the keys with
// q_offset + i >= k_offset + j (causal) under an online softmax kept in f32:
//   s = (q . k) * scale, masked; m, l running max and normaliser;
//   p = exp(s - m) (masked keys give exactly 0, by a select on the mask);
//   acc += round_to_input_dtype(p) . v;   o = acc / max(l, 1e-30);
//   lse = m + log(max(l, 1e-30)), natural log (the backward reads it).
// A row with no allowed key gives o = 0 and lse ~ -1e30. GQA: q row b*H + h
// reads kv row b*K + h / (H/K); kv heads are never repeated. Any Sq/Sk is
// served: ragged edges are masked. The TPU kernel's untileable-S fallback
// is not needed here.
//
// What bounds it on this card: 4*D flops per allowed (q, k) pair against
// each of q, k, v, o read or written once. At the 1b prefill (B=16, S=128,
// 16 q / 8 kv heads, D=128) that is 1.08 GFLOP over 25.3 MB, at the
// training shape (B=8, S=512) 8.6 GFLOP over 50.6 MB: 43 and 170 flops a
// byte, under the bf16 balance point (~295), so the bytes are the first
// limit (7.6 and 15.1 us at 3.35 TB/s), the tensor cores close behind at
// the training shape. Both versions skip every k tile wholly after the q
// tile's last row (the causal block skip), read kv heads in place, and keep
// the score tile on chip (O(S*D) device memory, never O(S^2)).
//
// The tensor-core version (bf16, D a multiple of 16 up to 128):
// - One block of four warps per (64-row q tile, b*h); each warp owns 16 q
//   rows. Blocks run heaviest causal tile first (last q tile first).
// - Q is loaded once by cp.async into a swizzled bf16 tile (flash_tc.cuh)
//   and its A fragments stay in registers for the whole k loop.
// - K and V tiles of 64 keys go through a two-stage cp.async ring with a
//   zero-fill tail past Sk: the next tile loads while this one computes.
// - S = Q.K^T by mma.sync.m16n8k16 (bf16 -> f32), K's B fragments by
//   ldmatrix. The softmax runs in base 2, x = s * scale * log2(e), with
//   the running max reduced over the four lanes that share a row and the
//   row sum kept per lane until the end; the mask (a select) is applied
//   only on tiles that cross the causal diagonal or a ragged edge.
// - P is rescaled, rounded to bf16 and packed straight into the A operand
//   of O += P.V (acc_to_a), V's B fragments by ldmatrix.trans: nothing of
//   the score tile goes through shared memory.
// - O (16 x D f32 a warp) stays in registers and is written once; lse
//   goes back to the natural log on the way out. No atomics: the same
//   inputs give the same bits.
// - Registers: at D=128 the O accumulator is 64 a thread, the S tile 32
//   and Q's fragments 32; the kernel needs ~195 and is built for two blocks
//   a SM, which is what its 80 KB of shared memory allows, so it does not
//   spill. Each 64-key tile is one softmax step (32-key halves, as K2
//   takes them, hold fewer registers but ran slower).
// mma.sync, not wgmma: the fragment layouts are the backward's, checked on
// the card; wgmma with TMA, 128-row tiles and packing the H/K q heads of a
// kv head into one block are the next steps.
//
// The CUDA-core version: one block (256 threads) per (b*h, 64-row q tile);
// k/v tiles of 64 rows staged in shared memory as f32 (rows padded to D+1
// floats so a warp's column reads hit distinct banks), inner products as a
// 4x4 register micro-tile of FMAs per thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tc.cuh"

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

// ------------------------------------------------ tensor-core version (bf16)

constexpr float LN2 = 0.6931471805599453f;

// Shared memory: Q, then two stages of (K, V).
template <int DMAX>
constexpr int fwd_tc_smem() { return 5 * TC_ROWS * DMAX * 2; }

// s += Q.K^T over nk 16-deep steps of D for one warp's 16 q rows, whose A
// fragments qa are in registers, against the 16*NB keys at address b of a
// swizzled K tile. K's rows are the n dimension and its columns the
// reduction, so plain ldmatrix gives the column-major B fragments.
template <int DMAX, int NB>
__device__ __forceinline__ void qk_scores(float (&s)[2 * NB][4],
                                          const uint32_t (&qa)[DMAX / 16][4], uint32_t b,
                                          int nk, int lane) {
  constexpr int ROWB = DMAX * 2;
  const int lb_r = (lane & 7) + (lane >> 4) * 8, lb_c = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < nk) {
#pragma unroll
      for (int np = 0; np < NB; ++np) {
        uint32_t f[4];
        ldsm4(f, b + swz(np * 16 + lb_r, 2 * kk + lb_c, ROWB));
        mma16816(s[2 * np], qa[kk], f[0], f[1]);
        mma16816(s[2 * np + 1], qa[kk], f[2], f[3]);
      }
    }
  }
}

// One k tile's online-softmax step for this thread's two q rows, row and
// row + 8 (accumulator elements e < 2 and e >= 2), in base 2: x = s *
// scale * log2(e). m2 is the running max of x, reduced over the four lanes
// of the quad that share the rows; l is this lane's share of the row sum
// (the quad sum is taken once, at the end). On return s holds p, acc and
// l are rescaled. MASK: the tile crosses the causal diagonal or the ragged
// key edge, and masked keys get p = 0 by a select (a row with no allowed
// key so far has m2 = NEG, where exp2(x - m2) would be 1).
template <bool MASK, int DMAX>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m2)[2], float (&l)[2],
                                             float (&acc)[DMAX / 8][4], float sl2, int row,
                                             int key0, int sk, int causal, int shift) {
  uint32_t ok = 0xffffffffu;  // bit 4j + e: key allowed
  float mx[2] = {m2[0], m2[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * sl2;
      if (MASK) {
        const int key = key0 + j * 8 + (e & 1);
        if (!(key < sk && (!causal || row + 8 * (e >> 1) + shift >= key))) {
          ok &= ~(1u << (4 * j + e));
          x = NEG;
        }
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = exp2f(m2[h] - mx[h]);
    m2[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(s[j][e] - mx[e >> 1]);
      if (MASK) p = (ok >> (4 * j + e)) & 1u ? p : 0.f;
      s[j][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    acc[j][0] *= corr[0];
    acc[j][1] *= corr[0];
    acc[j][2] *= corr[1];
    acc[j][3] *= corr[1];
  }
}

// K1 on the tensor cores: o and lse for one 64-row q tile of one b*h row.
// Two blocks a SM, as many as the shared memory allows at D=128 (80 KB a
// block): with no minimum stated, ptxas aims at three and caps the
// registers at 168, which spills; two leave it the ~195 it needs.
template <int DMAX>
__global__ void __launch_bounds__(TC_NT, 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int sq, int sk, int d, int n_q_heads,
                    int n_kv_heads, int q_offset, int k_offset, int causal, float scale) {
  constexpr int TB = TC_ROWS * DMAX * 2;  // bytes of one tile
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_addr(tc_smem), sKV = sQ + TB;

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
  const int r0 = q0 + warp * 16 + gid;  // this thread's q rows: r0 and r0 + 8

  // Causal block skip: k tile t runs iff its first key is not after the
  // tile's last valid q row.
  int n_kt = (sk + TC_ROWS - 1) / TC_ROWS;
  if (causal) {
    const int lim = q_offset + min(q0 + TC_ROWS, sq) - 1 - k_offset;
    n_kt = lim < 0 ? 0 : min(n_kt, lim / TC_ROWS + 1);
  }

  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m2[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  if (n_kt > 0) {
    tc_load_rows<DMAX>(sQ, q + (size_t)bh * sq * d, q0, sq, d);
    cp_async_commit();
    tc_load_rows<DMAX>(sKV, kb, 0, sk, d);
    tc_load_rows<DMAX>(sKV + TB, vb, 0, sk, d);
    cp_async_commit();
    cp_async_wait<1>();  // Q has landed; the first K/V tile may not have
    __syncthreads();
  }

  // Q's A fragments, once: they stay in registers across the k loop.
  uint32_t qa[DMAX / 16][4];
  {
    const int la_r = (lane & 7) + ((lane >> 3) & 1) * 8, la_c = lane >> 4;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      if (kk < nk && n_kt > 0) ldsm4(qa[kk], sQ + swz(warp * 16 + la_r, 2 * kk + la_c, DMAX * 2));
  }

#pragma unroll 1
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

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    qk_scores<DMAX, 4>(s, qa, sK, nk, lane);  // S = Q.K^T

    // Unmasked unless the tile crosses this warp's diagonal or the key edge.
    const bool full = k0 + TC_ROWS <= sk &&
                      (!causal || q_offset + q0 + warp * 16 >= k_offset + k0 + TC_ROWS - 1);
    if (full)
      softmax_tile<false, DMAX>(s, m2, l, acc, sl2, r0, k0 + tig * 2, sk, causal,
                                q_offset - k_offset);
    else
      softmax_tile<true, DMAX>(s, m2, l, acc, sl2, r0, k0 + tig * 2, sk, causal,
                               q_offset - k_offset);
    uint32_t pa[4][4];
    acc_to_a(pa, s);                              // round(p, v dtype)
    acc_product<DMAX, 4>(acc, pa, sV, nk, lane);  // O += P.V
    __syncthreads();  // this stage's readers are done before it refills
  }

  float row_lse[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float ll = fmaxf(l[h], 1e-30f);
    // acc / l as acc * (1 / l) with the hardware reciprocal: within two
    // f32 ulps of the division before the bf16 rounding, and one
    // reciprocal a row instead of an IEEE division per element.
    const float inv = __fdividef(1.f, ll);
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      acc[j][2 * h] *= inv;
      acc[j][2 * h + 1] *= inv;
    }
    // Any allowed key gives l >= 1 (its own p is exp2(0)); none gives the
    // plain version's lse, NEG + log(1e-30) == NEG in f32.
    row_lse[h] = l[h] > 0.f ? (m2[h] + log2f(l[h])) * LN2 : NEG;
  }
  store_rows<DMAX>(o + (size_t)bh * sq * d, acc, r0, sq, d, tig);
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < sq) lse[(size_t)bh * sq + r0 + 8 * h] = row_lse[h];
  }
}

template <int DMAX>
int launch_tc(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
              int sq, int sk, int d, int hq, int hk, int qoff, int koff, int causal,
              float scale, cudaStream_t stream) {
  constexpr int smem = fwd_tc_smem<DMAX>();
  auto kern = flash_fwd_tc_kernel<DMAX>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)bh * ((sq + TC_ROWS - 1) / TC_ROWS);
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, TC_NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, sq, sk, d,
      hq, hk, qoff, koff, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 = the CUDA-core kernel (any
// dtype, D <= 256), 1 = the tensor-core kernel (bf16, D a multiple of 16 up
// to 128). Returns a cudaError_t (0 = launched).
extern "C" int tk_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int route, int bh,
                            int sq, int sk, int d, int n_q_heads, int n_kv_heads,
                            int q_offset, int k_offset, int causal,
                            float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1 || d < 16 || d > 128 || d % 16) return (int)cudaErrorInvalidValue;
    if (d <= 64)
      return launch_tc<64>(q, k, v, o, lse, bh, sq, sk, d, n_q_heads, n_kv_heads, q_offset,
                           k_offset, causal, scale, s);
    return launch_tc<128>(q, k, v, o, lse, bh, sq, sk, d, n_q_heads, n_kv_heads, q_offset,
                          k_offset, causal, scale, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
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

// Resources of the tensor-core kernel as compiled for dmax 64 (D <= 64) or
// 128: registers a thread, local (spill) bytes a thread, static and dynamic
// shared bytes a block.
extern "C" int tk_flash_fwd_tc_attrs(int dmax, int* out) {
  if (dmax == 64) return func_attrs(flash_fwd_tc_kernel<64>, fwd_tc_smem<64>(), out);
  if (dmax == 128) return func_attrs(flash_fwd_tc_kernel<128>, fwd_tc_smem<128>(), out);
  return (int)cudaErrorInvalidValue;
}

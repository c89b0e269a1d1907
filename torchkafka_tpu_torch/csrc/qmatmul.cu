// Weight-only int8 matmul, y = (x @ q in f32) * scale, for Hopper.
//
// Replaces: torchkafka_tpu/ops/qmatmul.py:50 `_qmm_kernel` (the Pallas TPU
// kernel reached through `quantized_matmul`).
//
// Contract (same as the TPU kernel): x [M, K] (bf16 or f32, row-major),
// q [K, N] int8 (row-major), scale [N] f32 (one per output column),
// out [M, N] in x's dtype:
//   acc[m, n] = sum_k float(x[m, k]) * float(q[k, n])     (f32, whole K)
//   out[m, n] = round_to_x_dtype(acc[m, n] * scale[n])
// The scale lands ONCE on the f32 accumulator, after the whole K sum, as the
// TPU kernel's `_finish` does; scaling per K chunk (or per split) would
// round differently. int8 -> f32 and int8 -> bf16 are exact, and so is
// bf16 -> f32, so every product is exact and only the f32 summation order
// differs from the reference.
//
// Two versions, chosen by a fixed rule (ops/qmatmul.py `_route`, never on
// failure):
//   bf16 x, K and N multiples of 16, x and q 16-byte aligned
//       -> qmm_tc_kernel, bf16 tensor cores (mma.sync.m16n8k16, f32 sums);
//   f32 x (TF32 would round x: another function), or any other bf16 shape
//       -> qmm_decode_kernel (M <= 64) / qmm_tile_kernel, f32 FMAs on the
//          CUDA cores (tk_qmatmul, which also takes bf16 x when called
//          directly, for a timing beside the tensor-core kernel).
//
// What bounds it on this card. Decode rows (M <= 64): device memory, the
// int8 weight streamed once (K*N bytes; 58.7 MB for an 8b MLP weight, 17.5
// us at 3.35 TB/s). Prefill rows (M = 2048): operations, 2*M*K*N (240.5
// GFLOP for w_gate, 0.243 ms at the bf16 peak).
//
// The tensor-core version (qmm_tc_kernel):
// - Operands arrive by 16-byte cp.async copies into a ring of STAGES
//   slots: an x tile [BM, 64] bf16 (swizzled rows, rows past M and k past
//   the split zero-filled) and an int8 q tile [64, 128], row-major, as it
//   lies in device memory (the weight is never repacked).
// - mma.sync's B fragment wants pairs of consecutive k for one n, and a
//   row-major int8 tile holds consecutive n. ldmatrix.trans of 16-bit
//   elements (byte pairs along n) over the int8 tile gives each lane the
//   bytes (k 2tig, 2tig + 1) x (n 2g, 2g + 1): the B fragments of two n8
//   tiles at once, one over the even and one over the odd columns of a
//   16-column group. A byte-permute and two masks make the bf16 values
//   128 + (x & 127) and 128 or 256 by x's sign, one bf16x2 subtraction
//   gives two x exactly, in registers: no bf16 copy of the weight in
//   shared memory, one barrier a k tile. The epilogue undoes the
//   interleave: each lane stores four adjacent columns.
// - Products: bf16 x bf16 -> f32 on the tensor cores, chained over 64
//   (decode) or 32 (prefill) k from zero and added to the f32 sum by one
//   rounded add. Warps tile the block 4 across (32 columns each) and WM
//   down (MT 16-row tiles each).
// - Decode rows (bytes): BM is the least of 16/32/64 that holds M and one
//   block covers 128 columns, so x is read once per 128 columns (not per
//   32) and every weight byte once; a ring of four 8 KB weight stages keeps
//   bytes in flight. Where the output tiles alone are too few blocks
//   (ops/qmatmul.py `_qmm_plan`), K is split: grid.z splits of whole
//   64-row k tiles write f32 partials to a workspace, and the last split of
//   an output tile to arrive (a counter per tile, left at 0 by every
//   launch) sums them in split order and applies the scale once, in the
//   same launch: deterministic, whichever split counts last.
// - Prefill rows (operations): 128 x 128 tiles, 8 warps of 64 x 32, three
//   stages; each warp row converts the int8 slices it reads, so a weight
//   byte is converted once per 64 rows of x. mma.sync, not wgmma: wgmma
//   reads B from shared memory, so it needs the bf16 copy this design
//   avoids (or A and B swapped, the weight as A from registers); the next
//   step for this kernel.
// - The epilogue multiplies each f32 sum by scale[n] once, rounds to bf16
//   and stores once.
//
// The CUDA-core version:
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
//
// The CUDA-core kernels take any M, K and N: every load and store is
// masked at the ragged edges.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_tc.cuh"

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

// ------------------------------------------------ tensor-core version (bf16)

constexpr int TQ_BN = 128;           // output columns a block: 4 warps of 32
constexpr int TQ_BK = 64;            // k rows a stage
constexpr int TQ_XROWB = TQ_BK * 2;  // bytes of an x tile row (8 chunks)
constexpr int TQ_QROWB = TQ_BN;      // bytes of an int8 q tile row (8 chunks)

// MT 16-row tiles a warp, WM warps down, 4 across.
template <int MT, int WM, int STAGES>
struct TcCfg {
  static constexpr int BM = 16 * MT * WM;
  static constexpr int NT = 32 * 4 * WM;
  static constexpr int XB = BM * TQ_XROWB;     // one x stage
  static constexpr int QB = TQ_BK * TQ_QROWB;  // one int8 q stage
  static constexpr int SMEM = STAGES * (XB + QB);
  static constexpr int NACC = MT * 16;         // f32 sums a thread
};

// Two int8 as a bf16 pair, exactly: the bytes of w that `sel` picks (a
// __byte_perm selector of the form 0x4?4?) land in the low halves of two
// bf16 lanes whose high byte is 0x43. For a byte b = x & 0xFF the bf16
// bits 0x4300 | (b & 0x7F) are 128 + (b & 0x7F) and 0x4300 | (b & 0x80)
// are 128 or 256 by x's sign: their difference is x, exact in bf16.
__device__ __forceinline__ uint32_t i8x2_to_bf16(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0x43u, sel);
  uint32_t r;  // (p & 0x437F437F) - (p & 0x43804380), as b * -1 + a, both lanes
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(p & 0x43804380u), "r"(0xBF80BF80u), "r"(p & 0x437F437Fu));
  return r;
}

// The tensor cores do not round a running sum to nearest: chaining the
// f32 sum through mma.sync over K = 4096 (256 steps) put sums near zero off
// the one-ulp contract on the card. So each chain is KC 16-deep products
// (4: one k tile; 2 where registers are short) from zero, added to the f32
// sum by one rounded add: over K it then errs less than a sequential f32
// FMA sum.
template <int MT, int WM, int STAGES, int KC>
__global__ void __launch_bounds__(TcCfg<MT, WM, STAGES>::NT, WM == 2 ? 2 : 1)
qmm_tc_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scale, bf16* __restrict__ out,
              float* __restrict__ ws, int* __restrict__ counter, int m, int k,
              int n, int ks) {
  using C = TcCfg<MT, WM, STAGES>;
  extern __shared__ __align__(128) unsigned char tq_smem[];
  __shared__ int last_s;
  const uint32_t s_x = smem_addr(tq_smem), s_q = s_x + STAGES * C::XB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 16*MT rows from wm*16*MT, 32 columns from wn*32
  const int n0 = blockIdx.x * TQ_BN, m0 = blockIdx.y * C::BM;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int kb = split * ks, ke = min(k, kb + ks);
  const int nkt = (ke - kb + TQ_BK - 1) / TQ_BK;

  auto load_stage = [&](int t, int slot) {
    const int k0 = kb + t * TQ_BK;
    const uint32_t dx = s_x + slot * C::XB, dq = s_q + slot * C::QB;
    for (int i = tid; i < C::BM * 8; i += C::NT) {
      const int r = i >> 3, c = i & 7;
      const bool ok = m0 + r < m && k0 + c * 8 < ke;
      cp_async16(dx + swz(r, c, TQ_XROWB), x + (ok ? (size_t)(m0 + r) * k + k0 + c * 8 : 0),
                 ok);
    }
    for (int i = tid; i < TQ_BK * 8; i += C::NT) {
      const int r = i >> 3, c = i & 7;
      const bool ok = k0 + r < ke && n0 + c * 16 < n;
      cp_async16(dq + swz(r, c, TQ_QROWB), q + (ok ? (size_t)(k0 + r) * n + n0 + c * 16 : 0),
                 ok);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nkt) load_stage(t, t);
    cp_async_commit();
  }
  const int a_r = lane & 15, a_c = lane >> 4;                            // ldmatrix (A)
  const int b_r = (lane & 7) + ((lane >> 3) & 1) * 8, b_c = lane >> 4;  // ldmatrix.trans (B)

#pragma unroll 1
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t has landed; the last tile's readers are done
    const int slot = t % STAGES;
    if (t + STAGES - 1 < nkt) load_stage(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();

    // Per KC 16-deep steps: the warp's int8 [16 k, 32 n] slice by one
    // ldmatrix.trans of 16-bit elements (byte pairs along n). Lane (g, tig)
    // gets, per 8 x 8 matrix, the bytes (k 2tig and 2tig + 1) x (n 2g and
    // 2g + 1): the B fragment (two consecutive k, one n) of two n8 tiles,
    // one on the even columns of a 16-column group and one on the odd,
    // converted in registers. Then per 16-row tile its A fragments and,
    // per n8 tile, one chain of KC products added to the f32 sum.
    const uint32_t ax = s_x + slot * C::XB, aq = s_q + slot * C::QB;
#pragma unroll
    for (int k0 = 0; k0 < TQ_BK / 16; k0 += KC) {
      uint32_t bf[KC][4][2];  // [step][n8 tile: 2 * group + odd][b0, b1]
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t f[4];
        ldsm4t(f, aq + swz((k0 + kk) * 16 + b_r, wn * 2 + b_c, TQ_QROWB));
#pragma unroll
        for (int v = 0; v < 4; ++v) {  // f[2 group + (k >= 8)]
          const uint32_t sel = (v & 1) ? 0x4341u : 0x4240u;
          bf[kk][v][0] = i8x2_to_bf16(f[(v >> 1) * 2], sel);
          bf[kk][v][1] = i8x2_to_bf16(f[(v >> 1) * 2 + 1], sel);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[KC][4];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          ldsm4(a[kk], ax + swz((wm * MT + i) * 16 + a_r, 2 * (k0 + kk) + a_c, TQ_XROWB));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) mma16816(t, a[kk], bf[kk][j][0], bf[kk][j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
      }
    }
  }
  cp_async_wait<0>();

  if (n_split > 1) {
    // This split's f32 partial, in the fragment layout: element e of
    // thread tid at e * NT + tid (coalesced), after the block's split-0..
    // partials of the same output tile.
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = ws + (size_t)tile * n_split * C::NACC * C::NT;
    float* mine = part + (size_t)split * C::NACC * C::NT;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[((i * 4 + j) * 4 + e) * C::NT + tid] = acc[i][j][e];
    __syncthreads();  // the block's partial is written; one fence publishes it
    if (tid == 0) {
      __threadfence();
      last_s = atomicAdd(counter + tile, 1) == n_split - 1;
      if (last_s) {
        __threadfence();
        counter[tile] = 0;  // every split has counted: ready for the next launch
      }
    }
    __syncthreads();
    if (!last_s) return;
    // The last split sums every split's partial in split order.
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* p = part + ((i * 4 + j) * 4 + e) * C::NT + tid;
          float v = __ldcg(p);
          for (int sp = 1; sp < n_split; ++sp) v += __ldcg(p + (size_t)sp * C::NACC * C::NT);
          acc[i][j][e] = v;
        }
  }

  // The scale once, one rounding, one store. n8 tile 2 * group + odd holds
  // columns 2 c + odd of the warp's 16-column group, c = 2 tig and 2 tig + 1
  // at rows g and g + 8: four adjacent columns from 4 tig, one 8-byte store.
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int grp = 0; grp < 2; ++grp) {
    const int col = n0 + wn * 32 + grp * 16 + tig * 4;
    if (col >= n) continue;
    const float s0 = scale[col], s1 = scale[col + 1], s2 = scale[col + 2], s3 = scale[col + 3];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = m0 + (wm * MT + i) * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r + 8 * h < m) {
          const float* e0 = acc[i][2 * grp];
          const float* e1 = acc[i][2 * grp + 1];
          *reinterpret_cast<uint2*>(out + (size_t)(r + 8 * h) * n + col) =
              make_uint2(pack_bf16(e0[2 * h] * s0, e1[2 * h] * s1),
                         pack_bf16(e0[2 * h + 1] * s2, e1[2 * h + 1] * s3));
        }
    }
  }
}

template <int MT, int WM, int STAGES, int KC>
int launch_tc(const void* x, const void* q, const void* scale, void* out, void* ws,
              void* counter, int m, int k, int n, int ks, int n_split, cudaStream_t s) {
  using C = TcCfg<MT, WM, STAGES>;
  auto kern = qmm_tc_kernel<MT, WM, STAGES, KC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + TQ_BN - 1) / TQ_BN, (m + C::BM - 1) / C::BM, n_split);
  kern<<<grid, C::NT, C::SMEM, s>>>((const bf16*)x, (const int8_t*)q, (const float*)scale,
                                    (bf16*)out, (float*)ws, (int*)counter, m, k, n, ks);
  return (int)cudaGetLastError();
}

// The tensor-core configurations (BM, MT, WM, STAGES, KC): decode rows
// (one warp row, four stages, chains of 4), prefill rows (two warp rows of
// 64, three stages, chains of 2: chains of 4 spilled at the two blocks an
// SM the launch bounds ask).
#define TQ_CONFIGS(X) X(16, 1, 1, 4, 4) X(32, 2, 1, 4, 4) X(64, 4, 1, 4, 4) X(128, 4, 2, 3, 2)

__global__ void qmm_i8_convert_kernel(uint32_t* out) {
  const uint32_t w = 0x03020100u + 0x04040404u * threadIdx.x;  // bytes 4t .. 4t + 3
  out[2 * threadIdx.x] = i8x2_to_bf16(w, 0x4140u);
  out[2 * threadIdx.x + 1] = i8x2_to_bf16(w, 0x4342u);
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

// The CUDA-core kernels. dtype: 0 = float32, 1 = bfloat16. vec_ok: q's rows
// may be read as aligned 4-byte words (N % 4 == 0 and a 4-byte-aligned q).
// Returns a cudaError_t (0 = launched).
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

// The tensor-core kernel (bf16 x only). bm: 16, 32, 64 or 128 (rows a
// block, ops/qmatmul.py `_qmm_plan`); ks: k rows a split, a multiple of 64
// when n_split > 1, with (n_split - 1) * ks < k <= n_split * ks. ws: f32
// workspace of n_tiles * n_split * bm * 128 floats and counter: n_tiles
// int32 at 0, both unused (may be null) when n_split == 1. Needs K and N
// multiples of 16 and 16-byte-aligned x and q. Returns a cudaError_t.
extern "C" int tk_qmatmul_tc(const void* x, const void* q, const void* scale, void* out,
                             void* ws, void* counter, int m, int k, int n, int bm, int ks,
                             int n_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m < 0 || k < 16 || n < 16 || k % 16 || n % 16 || n_split < 1 || ks < 1 ||
      (long long)(n_split - 1) * ks >= k || (long long)n_split * ks < k)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (ks % TQ_BK || ws == nullptr || counter == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
#define TQ_CASE(BM, MT, WM, ST, KC)                                                  \
  if (bm == BM)                                                                      \
    return launch_tc<MT, WM, ST, KC>(x, q, scale, out, ws, counter, m, k, n, ks, n_split, s);
  TQ_CONFIGS(TQ_CASE)
#undef TQ_CASE
  return (int)cudaErrorInvalidValue;
}

// Registers, local (spill) bytes, static and dynamic shared bytes of the
// tensor-core kernel for rows-a-block bm, into out[0..3].
extern "C" int tk_qmatmul_tc_attrs(int bm, int* out) {
#define TQ_ATTRS(BM, MT, WM, ST, KC) \
  if (bm == BM) return func_attrs(qmm_tc_kernel<MT, WM, ST, KC>, TcCfg<MT, WM, ST>::SMEM, out);
  TQ_CONFIGS(TQ_ATTRS)
#undef TQ_ATTRS
  return (int)cudaErrorInvalidValue;
}

// The kernel's int8 -> bf16 conversion of all 256 bytes: out[b] (bf16) is
// the conversion of the byte b, read as int8.
extern "C" int tk_qmatmul_i8_table(void* out, void* stream) {
  qmm_i8_convert_kernel<<<1, 64, 0, (cudaStream_t)stream>>>((uint32_t*)out);
  return (int)cudaGetLastError();
}

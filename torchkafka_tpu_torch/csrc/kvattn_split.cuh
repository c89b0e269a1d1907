// The split-K body of the int8 decode reads, for Hopper: the fill-bounded
// reads (K4, dense K-major pool: kvattn_dynlen.cu; K5, paged pool through
// block tables: kvattn_paged.cu) and the full-pool masked reads (K7
// K-major, K8 M-major: kvattn_full.cu). Each source is a thin kernel and
// launcher around `kvattn_split_body`, templated on how a logical position
// maps to a pool row (`DenseRows`, `PagedRows`, `MMajorRows`) and on the
// mask mode (MASKED: every position of the pool under a [B, M] bool mask,
// instead of the positions up to a watermark; see kvattn_full.cu).
//
// Contract of the watermark mode (K4, K5): one query token per slot,
// q [B, H, Dh] (bf16 or f32), rep = H/K query rows per kv head, int8 K/V
// rows of Dh bytes with one f32 scale each, pos [B] int32 watermarks.
// Slot b reads ONLY logical positions [0, pos[b]] (the watermark clamped
// into the pool or view):
//   s   = (q . float(k[p])) * ks[p] * (1/sqrt(Dh))
//   p   = exp(s - m)                       m: a running max, in f32
//   acc += round_to_q_dtype(p * vs[p]) . float(v[p])
//   out = acc / l                          (in q's dtype)
//
// What bounds it on this card: device memory at the bytes' rate, and the
// latency of each dependent trip to device memory at the serving shapes.
// A slot reads (pos+1) * K * 2 * (Dh + 4) bytes, 3.6 MB at the 1b decode
// shape (B=16, K=8, rep 2, Dh=128) with a 192-position pool, 1.1 us at
// 3.35 TB/s; the arithmetic is 4 * rep * Dh flops a position. One block
// per (slot, kv head) that walks its positions alone puts 128 blocks on
// 132 SMs, and the slot with the highest watermark sets the time: at a
// 2048 pool 32 serial tiles while a slot at watermark 0 finishes at once.
//
// What the design does about it (flash-decoding):
// - Split-K over positions. The grid is (n_split, B*K); block (s, b*K+kh)
//   reads span s, logical positions [s*L, (s+1)*L), of one (slot, kv head)
//   and keeps all rep query rows of that head, so each int8 row is read
//   from device memory once for the whole group. L and n_split come from
//   the host's planner (ops/kvattn.py `_split_plan`) and the pool or view
//   length alone; the host never reads a watermark. A block whose span
//   starts past pos[b] exits at once, so the work spreads over up to
//   n_split * B * K blocks in proportion to each slot's fill. The planner
//   keeps pools of up to four tiles in one span: a split costs three more
//   dependent round trips (the partial's fence, the counter, the merge's
//   loads), about 3 us under load on an NVIDIA H100 80GB HBM3 at 700 W,
//   more than two or three tiles in parallel save.
// - Loads: the watermark and q first, together; then 64-position tiles,
//   K and V rows as 16-byte cp.async chunks and the scales as 4-byte ones,
//   into shared memory, two stages: a span's first two tiles are requested
//   together, and each later one as soon as a stage is free. (A third
//   stage, a whole 192-position span in flight at once, measured no faster
//   at 192 and slower at 2048, where it costs occupancy.)
// - Arithmetic on the CUDA cores in f32, eight warps. The int8 -> f32
//   conversion is exact and full rate: `__byte_perm` builds 0x4B0000uu from
//   u = x + 128, whose float is 2^23 + u, and one subtract of 2^23 + 128
//   leaves x (the plain (float)x is a quarter-rate I2F). Q.K: each warp
//   scores 8 of the tile's positions, eight lanes a position, one 16-byte
//   chunk of the row a lane, q from shared memory; three shuffles sum a
//   score. Then each lane of a position's eight takes its own (position,
//   row) scores for the exp and the rounding of p * v_scale, so no exp is
//   repeated. P.V: each warp accumulates its own positions, four output
//   columns a lane; the warps' sums are added once a span.
// - One launch merges. A span that is not the slot's only live one writes
//   its partial (m, l, acc[rep, Dh]) in f32 to a workspace; after a
//   barrier one thread publishes it with __threadfence() and counts the
//   span on a per-(slot, kv head) counter; the block that counts last
//   merges the live spans, M = max m_s,
//   out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, and resets the
//   counter to 0 for the next launch. The live count is ceil((pos+1)/L),
//   from pos itself. The merge loads its first partials while it works out
//   the spans' weights. A slot with one live span writes its output
//   directly.
//
// Sum order: every sum has a fixed order (the merge's over the split
// index), so two launches are bitwise equal whichever block merges. It is
// not the single-block kernel's order: each span's p is taken against its
// own running max and rounded to q's dtype there (not against the max of
// the whole prefix), the warps' P.V sums are added at the span's end, and
// the spans' partials are rescaled in the merge. Against the plain
// version that differs by bf16 roundings of p, inside the bf16 tolerance;
// in f32 only by the order of f32 sums.
//
// Included by each source, and each source is its own shared library, so
// the unnamed namespace gives every library its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KV_NW = 8;               // warps
constexpr int KV_NT = 32 * KV_NW;      // threads
constexpr int KV_TILE = 64;            // positions a tile
constexpr int KV_STAGES = 2;           // tiles in flight
constexpr int KV_PW = KV_TILE / KV_NW;  // positions a warp scores, 8
constexpr int KV_IT = KV_PW / 4;       // four at a time, eight lanes each
constexpr int KV_DH_MAX = 128;         // eight 16-byte chunks a row
constexpr int KV_MAX_SPLIT = 64;       // spans a (slot, kv head) at most
constexpr int KV_MB = 8;               // partials a thread loads at once in the merge
constexpr float KV_NEG = -1e30f;

__device__ __forceinline__ float kv_to_f(float x) { return x; }
__device__ __forceinline__ float kv_to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T kv_from_f(float x);
template <> __device__ __forceinline__ float kv_from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 kv_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: p * v_scale enters P.V in q's dtype.
template <typename T> __device__ __forceinline__ float kv_round(float x) {
  return kv_to_f(kv_from_f<T>(x));
}

// Byte k (0..3) of w, a signed int8, as an exact float: u = x + 128 in the
// low byte of 0x4B000000 is the float 2^23 + u.
__device__ __forceinline__ float kv_i8_to_f(uint32_t w_biased, int k) {
  const uint32_t bits = __byte_perm(w_biased, 0x4B000000u, 0x7540u + k);
  return __uint_as_float(bits) - 8388736.0f;
}

// The four int8 of w as exact floats.
__device__ __forceinline__ void kv_i8x4_to_f(uint32_t w, float (&f)[4]) {
  const uint32_t wb = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = kv_i8_to_f(wb, k);
}

__device__ __forceinline__ uint32_t kv_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void kv_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(kv_smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void kv_cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(kv_smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void kv_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every cp.async group but the newest N has landed (this thread's copies).
template <int N>
__device__ __forceinline__ void kv_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Logical position -> pool row of one (slot, kv head), dense K-major pool
// [B, K, M, Dh]: rows of a (slot, head) are consecutive.
struct DenseRows {
  size_t base;  // (b * K + kh) * M
  __device__ __forceinline__ size_t row(int p) const { return base + (size_t)p; }
};

// Position -> pool row of one (slot, kv head), dense M-major pool
// [B, M, K, Dh]: row (b*M + p)*K + kh, rows K*Dh bytes apart (16-byte
// aligned at Dh % 16 == 0, so load_tile's chunks serve it unchanged).
struct MMajorRows {
  size_t base;  // b * M * K + kh
  int n_kv;
  __device__ __forceinline__ size_t row(int p) const { return base + (size_t)p * n_kv; }
};

// Logical position -> pool row through the slot's block table, paged pool
// [NB, K, bs, Dh]; a table entry outside [0, NB) is clamped into the pool.
// Offsets are 64-bit (blk * K * bs * Dh overflows 32 bits on large pools).
struct PagedRows {
  const int* trow;  // table row of the slot
  int n_pool, n_kv, kh, bs;
  __device__ __forceinline__ size_t row(int p) const {
    const int j = p / bs;
    const int blk = min(max(__ldg(trow + j), 0), n_pool - 1);
    return ((size_t)blk * n_kv + kh) * bs + (size_t)(p - j * bs);
  }
};

// One span of one (slot, kv head): grid (n_split, B*K), KV_NT threads.
// kq/vq rows of dh bytes and ks/vs f32 per row, addressed by rows.row(p);
// pos_b the slot's watermark, clamped into the m_view positions of its
// pool or view (MASKED: unused, every position is read, and valid_b, the
// slot's m_view mask bytes, says which score; the watermark mode does not
// read valid_b); q/out [B*K*REP, dh]; ws: the partials, acc [B*K][n_split]
// [REP*dh] then (m, l) [B*K][n_split][2*REP], f32; counter: one int per
// (slot, head), 0 between launches (ws and counter are unused, and may be
// null, when n_split == 1).
template <typename Rows, typename T, int REP, bool MASKED = false>
__device__ __forceinline__ void kvattn_split_body(
    const Rows& rows, const int* __restrict__ pos_b,
    const uint8_t* __restrict__ valid_b, int m_view, const T* __restrict__ q,
    const int8_t* __restrict__ kq, const float* __restrict__ ks, const int8_t* __restrict__ vq,
    const float* __restrict__ vs, T* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counter, int span, int dh, float inv_sqrt_dh) {
  __shared__ __align__(16) int8_t kv_s[KV_STAGES][2][KV_TILE][KV_DH_MAX];  // stage, k/v
  __shared__ __align__(16) float sc_s[KV_STAGES][2][KV_TILE];              // stage, k/v
  __shared__ __align__(16) float4 q_s[REP][4][8];  // q[r][c*16 + j*4 + e]
  __shared__ __align__(16) float p_s[KV_NW][REP][KV_PW];  // a warp's rounded p*vs
  __shared__ float red_m[KV_NW][REP], red_l[KV_NW][REP];
  __shared__ float w_s[KV_MAX_SPLIT][REP];  // the merge's span weights
  __shared__ int last_s;

  const int split = blockIdx.x, bk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_row0 = (size_t)bk * REP;

  // q and the watermark are loaded together, ahead of everything else.
  constexpr int QPT = (REP * KV_DH_MAX + KV_NT - 1) / KV_NT;
  T qv[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * KV_NT;
    if (i < REP * dh) qv[k] = q[q_row0 * dh + i];
  }
  int n_pos = m_view;  // MASKED: the whole pool, every span live
  if constexpr (!MASKED) n_pos = min(max(__ldg(pos_b), 0), m_view - 1) + 1;
  const int start = split * span;
  if (start >= n_pos) return;  // a span past the watermark: nothing to read
  const int end = min(start + span, n_pos);
  const int n_live = (n_pos + span - 1) / span;
  const int chunks = dh >> 4;

  // Tile loads: thread t copies chunk t%8 of rows t/8 + (KV_NT/8)*i of K
  // and V; threads 0..63 the k scales, 64..127 the v scales.
  auto load_tile = [&](int t0, int st) {
    const int c = tid & 7;
#pragma unroll
    for (int i = 0; i < KV_TILE * 8 / KV_NT; ++i) {
      const int r = (tid >> 3) + (KV_NT / 8) * i, p = t0 + r;
      if (p < end && c < chunks) {
        const size_t g = rows.row(p) * dh + c * 16;
        kv_cp16(&kv_s[st][0][r][c * 16], kq + g);
        kv_cp16(&kv_s[st][1][r][c * 16], vq + g);
      }
    }
    if (tid < 2 * KV_TILE) {
      const int r = tid & (KV_TILE - 1), p = t0 + r, which = tid / KV_TILE;
      if (p < end) kv_cp4(&sc_s[st][which][r], (which ? vs : ks) + rows.row(p));
    }
  };
  // One cp.async group a tile: the first KV_STAGES tiles now (empty groups
  // past the span's end keep the count), then tile i + KV_STAGES - 1 into
  // the stage that tile i - 1 frees, so tile i is always group i.
#pragma unroll
  for (int i = 0; i < KV_STAGES; ++i) {
    if (start + i * KV_TILE < end) load_tile(start + i * KV_TILE, i);
    kv_commit();
  }

#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * KV_NT;
    if (i < REP * dh) {
      const int r = i / dh, e = i - r * dh;
      reinterpret_cast<float*>(&q_s[r][(e >> 2) & 3][e >> 4])[e & 3] = kv_to_f(qv[k]);
    }
  }

  constexpr int KV_NH = (KV_IT * REP + 7) / 8;  // p values a lane computes
  float m_run[REP], l_own[KV_NH], acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = KV_NEG;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < KV_NH; ++h) l_own[h] = 0.f;
  const int pg = lane >> 3, c = lane & 7;  // Q.K: position group, chunk
  const bool col_ok = lane * 4 < dh;       // P.V: columns lane*4 .. +3

  // MASKED: bit `it` of the lane's mask word says whether its position
  // t0 + warp*KV_PW + it*4 + pg of the tile at t0 is readable. One byte a
  // position is too narrow and too unaligned for cp.async, so each lane
  // loads its own bytes at the top of the tile, ahead of the barrier and
  // the Q.K products that hide the load. (Loaded a tile ahead, into a
  // register carried across the loop, they spilled 8 bytes at rep 8 on
  // the M-major map.)
  auto mask_bits = [&](int t0) {
    uint32_t bits = 0;
    if constexpr (MASKED) {
#pragma unroll
      for (int it = 0; it < KV_IT; ++it) {
        const int p = t0 + warp * KV_PW + it * 4 + pg;
        if (p < end && __ldg(valid_b + p)) bits |= 1u << it;
      }
    }
    return bits;
  };

  for (int i = 0, t0 = start; t0 < end; ++i, t0 += KV_TILE) {
    const int st = i % KV_STAGES;
    const uint32_t mk = mask_bits(t0);
    if (i == 0) {
      kv_wait<KV_STAGES - 1>();
    } else {
      kv_wait<KV_STAGES - 2>();
    }
    __syncthreads();  // tile i has landed; tile i - 1's readers are done
    if (i > 0) {
      const int tn = t0 + (KV_STAGES - 1) * KV_TILE;
      if (tn < end) load_tile(tn, (i - 1) % KV_STAGES);
      kv_commit();
    }
    const int w0 = warp * KV_PW;       // the warp's first position in the tile
    const bool live = t0 + w0 < end;  // the same in every lane of the warp

    // Q.K: positions w0 + it*4 + pg, chunk c of each row.
    float s[KV_IT][REP];
#pragma unroll
    for (int it = 0; it < KV_IT; ++it)
#pragma unroll
      for (int r = 0; r < REP; ++r) s[it][r] = KV_NEG;
    if (live) {
      float a[KV_IT][REP];
#pragma unroll
      for (int it = 0; it < KV_IT; ++it)
#pragma unroll
        for (int r = 0; r < REP; ++r) a[it][r] = 0.f;
      if (c < chunks) {
        uint4 kk[KV_IT];
#pragma unroll
        for (int it = 0; it < KV_IT; ++it)
          kk[it] = *reinterpret_cast<const uint4*>(&kv_s[st][0][w0 + it * 4 + pg][c * 16]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float kf[KV_IT][4];
#pragma unroll
          for (int it = 0; it < KV_IT; ++it) {
            const uint32_t w = j == 0 ? kk[it].x : j == 1 ? kk[it].y : j == 2 ? kk[it].z : kk[it].w;
            kv_i8x4_to_f(w, kf[it]);
          }
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const float4 qf = q_s[r][j][c];
#pragma unroll
            for (int it = 0; it < KV_IT; ++it) {
              float x = a[it][r];
              x = fmaf(qf.x, kf[it][0], x);
              x = fmaf(qf.y, kf[it][1], x);
              x = fmaf(qf.z, kf[it][2], x);
              x = fmaf(qf.w, kf[it][3], x);
              a[it][r] = x;
            }
          }
        }
      }
#pragma unroll
      for (int it = 0; it < KV_IT; ++it) {
        const int pl = w0 + it * 4 + pg;
        const bool ok = t0 + pl < end;
        const float ksv = sc_s[st][0][pl];
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float x = a[it][r];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          // MASKED: a masked position inside the pool scores exactly
          // -1e30 and still takes part (p = exp(-1e30 - m) below).
          const bool readable = !MASKED || ((mk >> it) & 1u);
          s[it][r] = ok && readable ? (x * ksv) * inv_sqrt_dh : KV_NEG;
        }
      }
    }
    float wmax[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      wmax[r] = s[0][r];
#pragma unroll
      for (int it = 1; it < KV_IT; ++it) wmax[r] = fmaxf(wmax[r], s[it][r]);
      wmax[r] = fmaxf(wmax[r], __shfl_xor_sync(0xffffffffu, wmax[r], 8));
      wmax[r] = fmaxf(wmax[r], __shfl_xor_sync(0xffffffffu, wmax[r], 16));
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r) red_m[warp][r] = wmax[r];
    }
    __syncthreads();

    // The tile's max over the warps and the online rescale (alpha is
    // exactly 0 on the span's first tile and 1 where the max holds). The
    // watermark mode knows the first tile by m_run == -1e30: its live
    // scores are never -1e30. MASKED rows may stay at exactly -1e30 over
    // all-masked tiles, whose p = 1 sums must then carry on, so it asks i.
    float alpha[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float tmax = red_m[0][r];
#pragma unroll
      for (int w = 1; w < KV_NW; ++w) tmax = fmaxf(tmax, red_m[w][r]);
      const float m_new = fmaxf(m_run[r], tmax);
      const bool first = MASKED ? i == 0 : m_run[r] == KV_NEG;
      alpha[r] = first ? 0.f : m_run[r] == m_new ? 1.f : expf(m_run[r] - m_new);
      m_run[r] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= alpha[r];
    }
    // p: lane c of a position group takes scores c and c + 8 of the
    // group's KV_IT * REP, picked by selects, so no exp is repeated.
#pragma unroll
    for (int h = 0; h < KV_NH; ++h) {
      const int idx = c + 8 * h, r = idx % REP, it = idx / REP;
      float x = KV_NEG, mx = m_run[0], al = alpha[0];
#pragma unroll
      for (int i = 0; i < KV_IT; ++i)
#pragma unroll
        for (int rr = 0; rr < REP; ++rr) x = i * REP + rr == idx ? s[i][rr] : x;
#pragma unroll
      for (int rr = 1; rr < REP; ++rr) {
        mx = rr == r ? m_run[rr] : mx;
        al = rr == r ? alpha[rr] : al;
      }
      float p = 0.f;
      if (live && idx < KV_IT * REP) {
        const int pl = w0 + it * 4 + pg;
        const bool ok = t0 + pl < end;
        p = ok ? expf(x - mx) : 0.f;
        p_s[warp][r][it * 4 + pg] = ok ? kv_round<T>(p * sc_s[st][1][pl]) : 0.f;
      }
      l_own[h] = l_own[h] * al + p;
    }
    __syncwarp();

    // P.V over the warp's positions, columns lane*4 .. lane*4+3.
    if (live && col_ok) {
#pragma unroll
      for (int t4 = 0; t4 < KV_PW; t4 += 4) {
        float4 pw[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r)
          pw[r] = *reinterpret_cast<const float4*>(&p_s[warp][r][t4]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vf[4];
          kv_i8x4_to_f(*reinterpret_cast<const uint32_t*>(&kv_s[st][1][w0 + t4 + u][lane * 4]),
                       vf);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const float pr = u == 0 ? pw[r].x : u == 1 ? pw[r].y : u == 2 ? pw[r].z : pw[r].w;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
          }
        }
      }
    }
  }

  // The span's l: each lane holds the sums of its p values; add the
  // lanes' sums of each row over the warp, then the warps.
  float l_part[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float a = 0.f;
#pragma unroll
    for (int h = 0; h < KV_NH; ++h) a += (c + 8 * h) % REP == r ? l_own[h] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    l_part[r] = a;
  }
  __syncthreads();  // every warp is done with the stages
  float* red_acc = reinterpret_cast<float*>(&kv_s[0][0][0][0]);  // [KV_NW][REP][dh]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) red_l[warp][r] = l_part[r];
  }
  if (col_ok) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
      *reinterpret_cast<float4*>(&red_acc[(warp * REP + r) * dh + lane * 4]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  const int nel = REP * dh;
  auto span_acc = [&](int i) {  // the warps' sums, in warp order
    float a = red_acc[i];
#pragma unroll
    for (int w = 1; w < KV_NW; ++w) a += red_acc[w * nel + i];
    return a;
  };
  auto span_l = [&](int r) {
    float a = red_l[0][r];
#pragma unroll
    for (int w = 1; w < KV_NW; ++w) a += red_l[w][r];
    return a;
  };
  if (n_live == 1) {  // the slot's only live span: no merge
    for (int i = tid; i < nel; i += KV_NT) out[q_row0 * dh + i] = kv_from_f<T>(span_acc(i) / span_l(i / dh));
    return;
  }

  const int n_split = gridDim.x;
  float* acc_ws = ws + (size_t)bk * n_split * nel;                   // [n_split][nel]
  float* ml_ws = ws + (size_t)gridDim.y * n_split * nel + (size_t)bk * n_split * 2 * REP;
  for (int i = tid; i < nel; i += KV_NT) acc_ws[(size_t)split * nel + i] = span_acc(i);
  if (tid == 0) {  // m_run is the same in every thread
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      ml_ws[split * 2 * REP + r] = m_run[r];
      ml_ws[split * 2 * REP + REP + r] = span_l(r);
    }
  }
  __syncthreads();  // the block's partial is written; one fence publishes it
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(counter + bk, 1) == n_live - 1;
    if (last_s) {
      __threadfence();
      counter[bk] = 0;  // every live span has counted: ready for the next launch
    }
  }
  __syncthreads();
  if (!last_s) return;

  // The merge. Thread (k, g) sums the float4 group g of acc over the spans
  // k, k + sub, ...; its first KV_MB partials are loaded while warp r
  // weighs the live spans of row r: M = max m_s, w_s = e^(m_s - M),
  // den = sum_s w_s l_s (lane s and s + 32, then a fixed shuffle tree).
  const int groups = nel / 4, sub = KV_NT / groups;
  const int g = tid % groups, k = tid / groups, rg = (g * 4) / dh;
  const float4* acc4 = reinterpret_cast<const float4*>(acc_ws) + g;
  float4 buf[KV_MB];
#pragma unroll
  for (int i = 0; i < KV_MB; ++i) {
    const int sp = k + sub * i;
    if (k < sub && sp < n_live) buf[i] = __ldcg(acc4 + (size_t)sp * groups);
  }
  float* den_s = &red_l[0][0];  // [REP]
  for (int r = warp; r < REP; r += KV_NW) {
    float m2[2], l2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = lane + 32 * h;
      m2[h] = sp < n_live ? __ldcg(ml_ws + sp * 2 * REP + r) : KV_NEG;
      l2[h] = sp < n_live ? __ldcg(ml_ws + sp * 2 * REP + REP + r) : 0.f;
    }
    float mx = fmaxf(m2[0], m2[1]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float den = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = lane + 32 * h;
      const float w = sp < n_live ? expf(m2[h] - mx) : 0.f;
      if (sp < KV_MAX_SPLIT) w_s[sp][r] = w;
      den = fmaf(w, l2[h], den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane == 0) den_s[r] = den;
  }
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(&kv_s[0][0][0][0]);  // [sub][groups]
  if (k < sub) {
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; k + sub * i0 < n_live; i0 += KV_MB) {
#pragma unroll
      for (int i = 0; i < KV_MB; ++i) {
        const int sp = k + sub * (i0 + i);
        if (sp < n_live) {
          const float w = w_s[sp][rg];
          num.x = fmaf(w, buf[i].x, num.x);
          num.y = fmaf(w, buf[i].y, num.y);
          num.z = fmaf(w, buf[i].z, num.z);
          num.w = fmaf(w, buf[i].w, num.w);
        }
      }
#pragma unroll
      for (int i = 0; i < KV_MB; ++i) {
        const int sp = k + sub * (i0 + KV_MB + i);
        if (sp < n_live) buf[i] = __ldcg(acc4 + (size_t)sp * groups);
      }
    }
    part[k * groups + g] = num;
  }
  __syncthreads();
  if (tid < groups) {
    float4 num = part[g];
    for (int kk = 1; kk < sub; ++kk) {
      const float4 a = part[kk * groups + g];
      num.x += a.x;
      num.y += a.y;
      num.z += a.z;
      num.w += a.w;
    }
    const float den = den_s[rg];
    T* o = out + q_row0 * dh + g * 4;
    o[0] = kv_from_f<T>(num.x / den);
    o[1] = kv_from_f<T>(num.y / den);
    o[2] = kv_from_f<T>(num.z / den);
    o[3] = kv_from_f<T>(num.w / den);
  }
}

// The compiled resources of a kernel: registers, local (spill) bytes,
// static and dynamic shared memory.
template <typename K>
int kv_func_attrs(K kern, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kern));
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  return 0;
}

}  // namespace

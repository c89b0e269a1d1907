// Tensor-core building blocks shared by the flash kernels (flash_fwd.cu,
// flash_bwd.cu) and the int8 weight matmul (qmatmul.cu): bf16 tiles of 64 rows in shared memory, the sixteen-byte
// chunk c of row r stored at chunk c ^ (r & 7); filled by cp.async with a
// zero-fill tail, read by ldmatrix into mma.sync.m16n8k16 fragments.
//
// - acc_product: a 16 x D f32 accumulator += an A operand held in
//   registers times the rows of a tile that are the reduction (ldmatrix
//   .trans): P.V in the forward, dQ, dV and dK in the backward.
// - acc_to_a: a probability tile goes from the accumulator straight into
//   the next product's A operand, rounded to bf16 in registers.
// - store_rows: a 16 x D accumulator written once as bf16.
//
// Included by each source, and each source is its own shared library, so
// the unnamed namespace gives every library its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TC_NT = 128;   // four warps, 16 of the 64 tile rows each
constexpr int TC_ROWS = 64;  // rows of every tile: q rows and keys
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of sixteen-byte chunk c of row r in a tile of rowb-byte rows.
__device__ __forceinline__ uint32_t swz(int r, int c, int rowb) {
  return static_cast<uint32_t>(r * rowb + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest N has landed (this thread's copies).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), the lower column in the lower
// half; one instruction, no address taken.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The NS A operands (16 rows x 16 deep each) of a 16 x 16*NS accumulator
// tile c[2*NS][4]: the accumulator's row/column layout is the A layout.
template <int NS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NS][4], const float (&c)[2 * NS][4]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a[s][0] = pack_bf16(c[2 * s][0], c[2 * s][1]);
    a[s][1] = pack_bf16(c[2 * s][2], c[2 * s][3]);
    a[s][2] = pack_bf16(c[2 * s + 1][0], c[2 * s + 1][1]);
    a[s][3] = pack_bf16(c[2 * s + 1][2], c[2 * s + 1][3]);
  }
}

// Rows row0 .. row0+63 of a row-major [n, d] bf16 matrix into a swizzled
// tile of DMAX-element rows (chunks past d are left alone: never read);
// rows past n are zero-filled.
template <int DMAX>
__device__ __forceinline__ void tc_load_rows(uint32_t dst, const bf16* src, int row0,
                                             int n, int d) {
  constexpr int CH = DMAX / 8;
  const int ch = d >> 3;
  for (int i = threadIdx.x; i < TC_ROWS * CH; i += TC_NT) {
    const int r = i / CH, c = i % CH;
    if (c < ch) {
      const bool ok = row0 + r < n;
      cp_async16(dst + swz(r, c, DMAX * 2), src + (size_t)(ok ? row0 + r : 0) * d + c * 8,
                 ok);
    }
  }
}

// acc[16 x D] += A[16 x 16*NKQ] . B[16*NKQ x D] with A in registers and B
// the 16*NKQ rows at address b of a swizzled tile (a multiple of 8 rows
// in), its rows the reduction: ldmatrix.trans gives the column-major B
// fragments.
template <int DMAX, int NKQ>
__device__ __forceinline__ void acc_product(float (&acc)[DMAX / 8][4],
                                            const uint32_t (&a)[NKQ][4], uint32_t b,
                                            int nk, int lane) {
  constexpr int ROWB = DMAX * 2;
  const int l_r = (lane & 7) + ((lane >> 3) & 1) * 8, l_c = lane >> 4;
#pragma unroll
  for (int kq = 0; kq < NKQ; ++kq) {
#pragma unroll
    for (int np = 0; np < DMAX / 16; ++np) {
      if (np < nk) {
        uint32_t f[4];
        ldsm4t(f, b + swz(kq * 16 + l_r, 2 * np + l_c, ROWB));
        mma16816(acc[2 * np], a[kq], f[0], f[1]);
        mma16816(acc[2 * np + 1], a[kq], f[2], f[3]);
      }
    }
  }
}

// Rows r (and r + 8) of a 16 x D accumulator tile, rounded to bf16.
template <int DMAX>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[DMAX / 8][4],
                                           int r, int n, int d, int tig) {
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (j < (d >> 3)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h < n)
          *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8 * h) * d + j * 8 + tig * 2) =
              pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// Registers, local (spill) bytes, static and dynamic shared bytes of a
// compiled kernel, into out[0..3].
template <typename K>
int func_attrs(K kern, int dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kern));
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = dyn_smem;
  return 0;
}

}  // namespace

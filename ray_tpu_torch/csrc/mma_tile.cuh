// Tile helpers of the flash-attention backward kernels (flash_bwd.cu): bf16
// mma.sync on Hopper's tensor cores and the zero-filled row loads that make
// any sequence length safe. The forward kernels (K1, K4) run on wgmma and
// TMA instead (hopper_attn.cuh), and take only pack_bf16 from here.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 tile: a row-major 16x16 bf16, b 16x8 bf16
// (k-major fragment), d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16x16, row-major) of rows [r0, r0 + 16), columns
// [c0, c0 + 16) of a shared tile with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int r0, int c0,
                                       int g, int tig) {
  a[0] = ld32(&t[(r0 + g) * LD + c0 + tig * 2]);
  a[1] = ld32(&t[(r0 + g + 8) * LD + c0 + tig * 2]);
  a[2] = ld32(&t[(r0 + g) * LD + c0 + 8 + tig * 2]);
  a[3] = ld32(&t[(r0 + g + 8) * LD + c0 + 8 + tig * 2]);
}

// rows [r0, r0 + ROWS) of a (n, HD) matrix into dst[ROWS][HD + 8] by a block
// of NTHREADS threads; rows past n are zeros (an uninitialised NaN times a
// masked p = 0 would poison a sum). 16-byte loads, neighbouring threads on
// neighbouring chunks.
template <int HD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int n) {
  constexpr int CH = HD / 8;
  constexpr int LD = HD + 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

}  // namespace

// Tile helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_chunk.cu): bf16 mma.sync on Hopper's tensor cores,
// the zero-filled row loads that make any sequence length safe, and the
// online-softmax step over one K/V tile that K1 and K4 share.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernels' finite mask value

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

// rows [r0, r0 + ROWS) of V (n, HD), transposed into dst[HD][ROWS + 8] so
// that the PV B-fragments are 32-bit words; neighbouring threads take
// neighbouring rows, which keeps the transposing stores conflict-free. Rows
// past n are zeros.
template <int HD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src, int r0,
                                            int n) {
  constexpr int CH = HD / 8;
  constexpr int LD = ROWS + 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTHREADS) {
    const int r = idx % ROWS, c = idx / ROWS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c * 8 + i) * LD + r] = e[i];
  }
}

// One K/V tile of the online softmax for one warp's 16 query rows (K1, K4).
// S = Q K^T from the warp's Q fragments qf and the tile sK[BN][HD + 8] is
// scaled into the log2 domain, masked to NEG_INF (keys at or past sk, and,
// when CAUSAL, keys after the row's position: a top-left mask), folded into
// the running max mrow and this thread's partial denominator lrow (base 2,
// one value per row; the quad's partial sums add up to the row's), the
// accumulator oacc is rescaled, and O += P V with V transposed in
// sVt[HD][BN + 8]. P goes from the score accumulators straight into the A
// operand of PV, rounded to bf16 (the TPU kernels cast p to v's dtype).
// qrow: the thread's two query rows; n0: the tile's first key. A running
// max of -inf (an empty carried state) gives a rescale factor of 0: every
// row sees at least one unmasked key in its first tile.
template <int HD, int BN, bool CAUSAL>
__device__ __forceinline__ void online_softmax_tile(
    const uint32_t (&qf)[HD / 16][4], const __nv_bfloat16* sK,
    const __nv_bfloat16* sVt, float (&oacc)[HD / 8][4], float (&mrow)[2],
    float (&lrow)[2], const int (&qrow)[2], int n0, int sk,
    float scale_log2) {
  constexpr int KLD = HD + 8;   // padded row of sK: conflict-free fragments
  constexpr int VLD = BN + 8;   // padded row of sVt
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_S = BN / 8;  // score n-tiles per warp
  constexpr int NT_O = HD / 8;  // output n-tiles per warp
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  float sacc[NT_S][4];
#pragma unroll
  for (int nt = 0; nt < NT_S; ++nt) {
    sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const __nv_bfloat16* kr = &sK[(nt * 8 + g) * KLD + ks * 16 + tig * 2];
      mma_bf16(sacc[nt], qf[ks], ld32(kr), ld32(kr + 8));
    }
  }

  // scale into the log2 domain, mask, and take the row max
  float mnew[2] = {mrow[0], mrow[1]};
#pragma unroll
  for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + nt * 8 + tig * 2 + (e & 1);
      const int r = e >> 1;
      float x = sacc[nt][e] * scale_log2;
      if (key >= sk || (CAUSAL && key > qrow[r])) x = NEG_INF;
      sacc[nt][e] = x;
      mnew[r] = fmaxf(mnew[r], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mnew[r] = fmaxf(mnew[r], __shfl_xor_sync(0xffffffffu, mnew[r], 1));
    mnew[r] = fmaxf(mnew[r], __shfl_xor_sync(0xffffffffu, mnew[r], 2));
    corr[r] = exp2f(mrow[r] - mnew[r]);
    mrow[r] = mnew[r];
    lrow[r] *= corr[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sacc[nt][e] - mrow[e >> 1]);
      sacc[nt][e] = p;
      lrow[e >> 1] += p;
    }
  }
#pragma unroll
  for (int dt = 0; dt < NT_O; ++dt) {
    oacc[dt][0] *= corr[0];
    oacc[dt][1] *= corr[0];
    oacc[dt][2] *= corr[1];
    oacc[dt][3] *= corr[1];
  }

  // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
  // fragment of a 16-key step
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
    pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
    pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
    pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      const __nv_bfloat16* vr = &sVt[(dt * 8 + g) * VLD + kk * 16 + tig * 2];
      mma_bf16(oacc[dt], pa, ld32(vr), ld32(vr + 8));
    }
  }
}

}  // namespace

// The attention forward that K1 (flash_fwd.cu) and K4 (flash_chunk.cu)
// share, written for Hopper (sm_90a): TMA into a ring of K/V stages in
// shared memory, wgmma for both products, two consumer warpgroups a block,
// and the mbarrier / TMA / wgmma helpers they run on.
//
// A block is 256 threads: two warpgroups, each owning 64 query rows (one
// wgmma M tile). Thread 0 also issues every copy: each warpgroup's Q tile
// once, then K and V tiles of BN keys into a ring of STAGES stages. K and V
// of a stage each have a "full" barrier (the TMA's byte count completes
// it) and an "empty" one on which every warp of both warpgroups arrives
// once it has read the tile; thread 0 refills a stage a step after both
// released it, so copies run STAGES - 1 tiles ahead. Each warpgroup keeps
// its Q tile in shared memory and its fp32 O accumulator and its rows'
// running max m and denominator l in registers for the whole key sweep:
//   S = Q K^T      wgmma m64nBNk16, A = Q and B = K from shared memory
//                  (both K-major, 128-byte swizzled);
//   online softmax S is scaled into base 2, masked, folded into m and l;
//                  the accumulator's rows live on one quad, so the row
//                  reductions are two quad shuffles;
//   O += P V       O rescaled, then wgmma m64nHDk16 with P packed to bf16
//                  in registers as the A operand and V read from shared
//                  memory as an MN-major B (the transpose flag): V is never
//                  transposed.
// Tile j's S and tile j-1's P V are issued together, and the softmax of
// tile j waits only for the first: the tensor cores multiply while the
// warpgroup exponentiates, which a warpgroup running alone (the shorter
// q-tile of a causal pair has finished) needs to keep them busy.
// The Q/K/V maps are 3-D (hd, rows, batch x heads), so rows past the
// sequence are zero-filled by the hardware per head, and a tile never reads
// the next head's rows; keys past sk and, when causal, keys after the
// row's position (a top-left mask, q_pos >= k_pos) are masked to the finite
// -1e30 of the TPU kernels.
//
// The grid pairs q-tiles: block j of a (batch, head) takes the 64-row tiles
// j and T-1-j when causal (T = ceil(sq / 64); with odd T the middle tile
// runs alone), so every causal block does T+1 tile-rows of work instead of
// between 1 and T, and 2j and 2j+1 when not. Thread 0 streams the keys
// the longer of the two needs; the shorter consumer still waits on and
// releases every stage, so the ring's phase bookkeeping stays uniform.
// Block j = 0 has the longest single tile, and runs first.
//
// K1 and K4 differ only in their prologue and epilogue (CARRY): K1 starts
// the state at (0, -1e30, 0) and writes o / l in bf16 and lse = m ln 2 +
// log l; K4 loads the carried fp32 o, m (natural log, -inf when fresh:
// exp2(-inf - m_new) is 0 for the finite m_new every row's first tile
// gives) and l, and stores o, m and l in fp32 to fresh buffers.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {
namespace hattn {

constexpr int BM = 64;        // query rows per consumer warpgroup
constexpr int BN = 128;       // keys per K/V stage
constexpr int STAGES = 3;     // K/V stages in the ring
// 2 warpgroups and no more: the hd-128 step holds S (64), O (64) and P
// (32 registers) at once, and only a 256-thread block may use 255
// registers a thread (a third, producer warpgroup left ptxas 168 and
// setmaxnreg did not lift it: the step spilled and its wgmmas serialized)
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;   // the TPU kernels' finite mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of one block, every tile 1024-byte aligned (the 128-byte
// swizzle's atom): the two consumers' Q tiles, STAGES K tiles, STAGES V
// tiles, then the barriers. A tile of HD columns is HD / 64 column halves
// of rows x 128 bytes each (one TMA box, one swizzle row per tensor row).
template <int HD>
struct Smem {
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 2 + 4 * STAGES;
  static constexpr int ALLOC = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
};

// -- mbarriers, TMA, wgmma ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also tells the barrier how many bytes the TMA brings
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of parity ``parity`` has completed; a
// wait that never ends (a phase-bookkeeping fault) traps, so the launch
// fails with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map into shared memory; completes on ``bar``
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of a wgmma accumulator (or of a
// register A operand) across the asynchronous product
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[i][e])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
// K-major (Q, K): the stride offset is the 1024 bytes between 8-row
// groups, the leading offset is unused, and a 16-column k-step inside a
// 64-column half advances the start by 32 bytes. MN-major (V): the
// leading offset is the distance between 64-column halves, the stride
// offset the 1024 bytes between groups of 8 keys.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define HA_R32                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define HA_R64                                                               \
  HA_R32                                                                     \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63"
#define HA_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HA_D32 HA_D8(0), HA_D8(8), HA_D8(16), HA_D8(24)
#define HA_D64 HA_D32, HA_D8(32), HA_D8(40), HA_D8(48), HA_D8(56)

// d (64 x N fp32, the warpgroup's accumulator fragment) = A B (+ d when
// scale_d), A (64 x 16) and B (N x 16, K-major) from shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HA_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HA_D64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N fp32) += A B, A (64 x 16 bf16) in registers (the accumulator
// layout's rows, packed in pairs), B (16 x N) MN-major from shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HA_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HA_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HA_R32
#undef HA_R64
#undef HA_D8
#undef HA_D32
#undef HA_D64

// -- the kernel ----------------------------------------------------------------

struct Args {
  __nv_bfloat16* o;  // K1: o (b, h, sq, hd) bf16 and lse (b, h, sq) fp32
  float* lse;
  const float* o_in;  // K4: the carried state in and out, fp32
  const float* m_in;
  const float* l_in;
  float* o_out;
  float* m_out;
  float* l_out;
  int h, kvh, sq, sk;
  float scale_log2;  // log2(e) / sqrt(hd)
};

// the q-tile consumer c of block j takes (-1: none)
__device__ __forceinline__ int pair_tile(int j, int c, int n_qt, bool causal) {
  if (causal) {
    const int qt = c == 0 ? j : n_qt - 1 - j;
    return c == 1 && qt == j ? -1 : qt;
  }
  const int qt = 2 * j + c;
  return qt < n_qt ? qt : -1;
}

// the K/V tiles q-tile qt reads: all of them, or when causal those up to
// its last row's position
__device__ __forceinline__ int tiles_for(int qt, int sq, int sk, bool causal) {
  if (qt < 0) return 0;
  const int keys = causal ? min(sk, min(sq, (qt + 1) * BM)) : sk;
  return (keys + BN - 1) / BN;
}

// every warp of a consumer arrives once on ``bar`` (its count is 8: 4 warps
// of 2 consumers), after its own wgmma reads of the stage have completed
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one K/V tile for one consumer thread: the
// raw scores sc (the thread's elements of S = Q K^T for keys n0..n0+BN)
// are masked (keys at or past sk; when CAUSAL, keys after the row) and
// scaled into base 2 (x = s log2(e) / sqrt(hd), rounded to fp32 before the
// exponent: folding the scale into one FFMA with the max moved the serving
// path's exact first token), their row max folded into the running max m, and
// sc becomes P = 2^(x - m), summed into this thread's partial denominator
// l (the quad's partial sums add up to the row's); corr is the factor that
// rescales O to the new max. The max and the sum run as 4 independent
// chains a row.
template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int n0,
                                             int row0, bool need_mask,
                                             int sk, float scale_log2) {
  const int t = threadIdx.x % 4;
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * i + 2 * t + (e & 1);
        if (key >= sk || (CAUSAL && key > row0 + 8 * (e >> 1)))
          sc[4 * i + e] = NEG_INF;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] *= scale_log2;
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[4] = {sc[2 * r], sc[2 * r + 1], sc[4 + 2 * r], sc[4 + 2 * r + 1]};
#pragma unroll
    for (int i = 2; i < BN / 8; ++i) {
      v[(i & 1) * 2] = fmaxf(v[(i & 1) * 2], sc[4 * i + 2 * r]);
      v[(i & 1) * 2 + 1] = fmaxf(v[(i & 1) * 2 + 1], sc[4 * i + 2 * r + 1]);
    }
    float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(sc[4 * i + e] + neg_m[e >> 1]);
      sc[4 * i + e] = x;
      sum[e >> 1][(i & 1) * 2 + (e & 1)] += x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// P (the softmax's sc) in bf16, in the A-operand layout of O += P V:
// k-step kk covers accumulator column chunks 2 kk and 2 kk + 1
__device__ __forceinline__ void to_bf16(const float (&sc)[BN / 2],
                                        uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    o[4 * i + 0] *= corr[0];
    o[4 * i + 1] *= corr[0];
    o[4 * i + 2] *= corr[1];
    o[4 * i + 3] *= corr[1];
  }
}

// issue S = Q K^T (one commit group): Q and K K-major, 128-byte swizzled,
// 64-column halves; a k-step of 16 columns is 32 bytes into a half. A step
// adds its byte offset / 16 to the descriptors' start-address field.
template <int HD>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2], uint32_t q_tile,
                                        uint32_t k_tile) {
  const uint64_t dq = desc_sw128(q_tile, 16, 1024);
  const uint64_t dk = desc_sw128(k_tile, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;
    wgmma_ss<BN>(sc, dq + (((ks / 4) * BM * 128 + off) >> 4),
                 dk + (((ks / 4) * BN * 128 + off) >> 4), ks > 0);
  }
  wg_commit();
}

// issue O += P V (one commit group): V MN-major, 128-byte swizzled; a
// k-step of 16 keys is 2048 bytes, the halves BN x 128 bytes apart
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[BN / 16][4],
                                         uint32_t v_tile) {
  const uint64_t dv = desc_sw128(v_tile, BN * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<HD>(o, p[kk], dv + ((kk * 16 * 128) >> 4));
  wg_commit();
}

template <int HD, bool CAUSAL, bool CARRY>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q_OFF, sK = base + L::K_OFF,
                 sV = base + L::V_OFF, bars = base + L::BAR_OFF;
  // barriers: q_full[2], then per stage k_full, v_full, k_empty, v_empty
  const uint32_t q_full = bars, k_full = bars + 16,
                 v_full = k_full + 8 * STAGES, k_empty = v_full + 8 * STAGES,
                 v_empty = k_empty + 8 * STAGES;

  const int j = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int n_qt = (a.sq + BM - 1) / BM;
  const int qt0 = pair_tile(j, 0, n_qt, CAUSAL);
  const int qt1 = pair_tile(j, 1, n_qt, CAUSAL);
  const int nt0 = tiles_for(qt0, a.sq, a.sk, CAUSAL);
  const int nt1 = tiles_for(qt1, a.sq, a.sk, CAUSAL);
  const int n_kv = max(nt0, nt1);  // the K/V tiles the block streams
  const int kv_slab = bi * a.kvh + hi / (a.h / a.kvh);
  // thread 0 (of consumer 0, whose q-tile always exists) issues the copies
  const bool loader = threadIdx.x == 0;

  auto load_k = [&](int tile) {
    const int s = tile % STAGES;
    mbar_expect_tx(k_full + 8 * s, L::KV_BYTES);
#pragma unroll
    for (int half = 0; half < HD / 64; ++half)
      tma_load_3d(sK + s * L::KV_BYTES + half * BN * 128, &tk, k_full + 8 * s,
                  half * 64, tile * BN, kv_slab);
  };
  auto load_v = [&](int tile) {
    const int s = tile % STAGES;
    mbar_expect_tx(v_full + 8 * s, L::KV_BYTES);
#pragma unroll
    for (int half = 0; half < HD / 64; ++half)
      tma_load_3d(sV + s * L::KV_BYTES + half * BN * 128, &tv, v_full + 8 * s,
                  half * 64, tile * BN, kv_slab);
  };

  if (loader) {
    mbar_init(q_full, 1);
    mbar_init(q_full + 8, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // every warp of both consumers
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int q_slab = bi * a.h + hi;
    const int qts[2] = {qt0, qt1};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (qts[c] < 0) continue;
      mbar_expect_tx(q_full + 8 * c, L::Q_BYTES);
#pragma unroll
      for (int half = 0; half < HD / 64; ++half)
        tma_load_3d(sQ + c * L::Q_BYTES + half * BM * 128, &tq, q_full + 8 * c,
                    half * 64, qts[c] * BM, q_slab);
    }
    for (int tile = 0; tile < min(STAGES, n_kv); ++tile) {
      load_k(tile);
      load_v(tile);
    }
  }
  __syncthreads();

  const int c = threadIdx.x / 128;  // this thread's consumer warpgroup
  const int qt = c == 0 ? qt0 : qt1;
  const int nt = c == 0 ? nt0 : nt1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's rows: row0 and row0 + 8; its accumulator element
  // 4 i + 2 r + e is (row0 + 8 r, column 8 i + 2 t + e)
  const int row0 = qt * BM + warp * 16 + g;
  const size_t q_row0 = (static_cast<size_t>(bi) * a.h + hi) * a.sq;

  float o[HD / 2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = qt >= 0 && row < a.sq;
    if (CARRY) {
      const size_t at = q_row0 + row;
      m[r] = in ? a.m_in[at] * LOG2E : -INFINITY;
      l[r] = in && t == 0 ? a.l_in[at] : 0.f;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        float2 x = make_float2(0.f, 0.f);
        if (in)
          x = *reinterpret_cast<const float2*>(a.o_in + at * HD + 8 * i +
                                               2 * t);
        o[4 * i + 2 * r] = x.x;
        o[4 * i + 2 * r + 1] = x.y;
      }
    } else {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        o[4 * i + 2 * r] = o[4 * i + 2 * r + 1] = 0.f;
    }
  }

  const uint32_t q_tile = sQ + c * L::Q_BYTES;
  float sc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  uint32_t p[BN / 16][4];
  float corr[2] = {1.f, 1.f};
  if (nt > 0) mbar_wait(q_full + 8 * c, 0);

  // Step it multiplies Q by K tile it (S) and P of tile it-1 by V tile
  // it-1 (O += P V): both go out together and run on the tensor cores
  // while the softmax of tile it waits only for S. Steps 0 (S alone), 1 to
  // nt-1 and nt (P V alone) are written out apart, so each wgmma wait
  // depth is fixed and ptxas keeps the products asynchronous. A consumer
  // past its own tiles still waits on and releases each stage, so every
  // empty barrier counts both consumers. At each step the loader refills
  // the K stage of tile it-1 and the V stage of tile it-2, which both
  // consumers released a step ago.
  auto refill = [&](int it) {
    const int rk = it - 1, rv = it - 2;
    if (rk >= 0 && rk + STAGES < n_kv) {
      mbar_wait(k_empty + 8 * (rk % STAGES), (rk / STAGES) & 1);
      load_k(rk + STAGES);
    }
    if (rv >= 0 && rv + STAGES < n_kv) {
      mbar_wait(v_empty + 8 * (rv % STAGES), (rv / STAGES) & 1);
      load_v(rv + STAGES);
    }
  };
  auto pass_k = [&](int tile) {  // K tile only the other consumer reads
    mbar_wait(k_full + 8 * (tile % STAGES), (tile / STAGES) & 1);
    release(k_empty + 8 * (tile % STAGES));
  };
  auto pass_v = [&](int tile) {
    mbar_wait(v_full + 8 * (tile % STAGES), (tile / STAGES) & 1);
    release(v_empty + 8 * (tile % STAGES));
  };
  auto softmax = [&](int it) {
    const int n0 = it * BN;
    softmax_tile<CAUSAL>(sc, m, l, corr, n0, row0,
                         n0 + BN > a.sk || (CAUSAL && n0 + BN - 1 > qt * BM),
                         a.sk, a.scale_log2);
  };

  int it = 1;  // the first step after this consumer's own P V
  if (nt > 0) {
    mbar_wait(q_full + 8 * c, 0);
    mbar_wait(k_full, 0);
    reg_fence(sc);
    wg_fence();
    issue_s<HD>(sc, q_tile, sK);
    wg_wait<0>();
    reg_fence(sc);
    release(k_empty);
    softmax(0);
    to_bf16(sc, p);
    for (; it < nt; ++it) {
      const int s = it % STAGES, ps = (it - 1) % STAGES;
      mbar_wait(k_full + 8 * s, (it / STAGES) & 1);
      reg_fence(sc);
      wg_fence();
      issue_s<HD>(sc, q_tile, sK + s * L::KV_BYTES);
      rescale<HD>(o, corr);  // O to tile it-1's max
      mbar_wait(v_full + 8 * ps, ((it - 1) / STAGES) & 1);
      reg_fence(o);
      reg_fence(p);
      wg_fence();
      issue_pv<HD>(o, p, sV + ps * L::KV_BYTES);
      if (loader) refill(it);
      wg_wait<1>();
      reg_fence(sc);
      release(k_empty + 8 * s);
      softmax(it);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(p);
      release(v_empty + 8 * ps);
      to_bf16(sc, p);
    }
    // step nt: the last P V
    const int ps = (nt - 1) % STAGES;
    rescale<HD>(o, corr);
    mbar_wait(v_full + 8 * ps, ((nt - 1) / STAGES) & 1);
    reg_fence(o);
    reg_fence(p);
    wg_fence();
    issue_pv<HD>(o, p, sV + ps * L::KV_BYTES);
    if (loader) refill(nt);
    if (nt < n_kv) pass_k(nt);
    wg_wait<0>();
    reg_fence(o);
    reg_fence(p);
    release(v_empty + 8 * ps);
    it = nt + 1;
  } else if (n_kv > 0) {
    pass_k(0);
  }
  for (; it <= n_kv; ++it) {
    if (it < n_kv) pass_k(it);
    pass_v(it - 1);
    if (loader) refill(it);
  }

  if (qt < 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.sq) continue;
    const size_t at = q_row0 + row;
    if (CARRY) {
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<float2*>(a.o_out + at * HD + 8 * i + 2 * t) =
            make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
      if (t == 0) {
        a.m_out[at] = m[r] * LN2;
        a.l_out[at] = l[r];
      }
    } else {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<uint32_t*>(a.o + at * HD + 8 * i + 2 * t) =
            pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      if (t == 0) a.lse[at] = m[r] * LN2 + logf(l[r]);
    }
  }
}

// -- host side -----------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// the 3-D map (hd, rows, slabs) of a contiguous (slabs, rows, hd) bf16
// tensor, in boxes of 64 columns x box_rows rows of one slab, 128-byte
// swizzled; rows past ``rows`` read as zeros
inline bool make_map(CUtensorMap* map, const void* ptr, int hd, int rows,
                     int slabs, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slabs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(hd) * 2 * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q (b, h, sq, HD), k/v (b, kvh, sk, HD) contiguous bf16 with 16-byte
// aligned addresses; ``args`` carries the outputs and the sizes
template <int HD, bool CARRY>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Args& args, int b, bool causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, args.sq, b * args.h, BM) ||
      !make_map(&tk, k, HD, args.sk, b * args.kvh, BN) ||
      !make_map(&tv, v, HD, args.sk, b * args.kvh, BN))
    return cudaErrorInvalidValue;
  const int n_qt = (args.sq + BM - 1) / BM;
  const dim3 grid((n_qt + 1) / 2, args.h, b);
  auto kernel = causal ? attn_fwd<HD, true, CARRY> : attn_fwd<HD, false, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::ALLOC);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, Smem<HD>::ALLOC, stream>>>(tq, tk, tv, args);
  return cudaGetLastError();
}

}  // namespace hattn
}  // namespace

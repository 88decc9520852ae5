// The attention forward that K1 (flash_fwd.cu) and K4 (flash_chunk.cu)
// share, written for Hopper (sm_90a): TMA into a ring of K/V stages in
// shared memory, wgmma for both products, two consumer warpgroups a block,
// on the mbarrier / TMA / wgmma helpers and the paired grid of
// hopper_common.cuh.
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

#include "hopper_common.cuh"

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
  const int nt0 = tiles_for<BM, BN>(qt0, a.sq, a.sk, CAUSAL);
  const int nt1 = tiles_for<BM, BN>(qt1, a.sq, a.sk, CAUSAL);
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
    issue_nt<HD, BN>(sc, q_tile, sK);
    wg_wait<0>();
    reg_fence(sc);
    release(k_empty);
    softmax(0);
    to_a<BN>(sc, p);
    for (; it < nt; ++it) {
      const int s = it % STAGES, ps = (it - 1) % STAGES;
      mbar_wait(k_full + 8 * s, (it / STAGES) & 1);
      reg_fence(sc);
      wg_fence();
      issue_nt<HD, BN>(sc, q_tile, sK + s * L::KV_BYTES);
      rescale<HD>(o, corr);  // O to tile it-1's max
      mbar_wait(v_full + 8 * ps, ((it - 1) / STAGES) & 1);
      reg_fence(o);
      reg_fence(p);
      wg_fence();
      issue_nn<HD, BN>(o, p, sV + ps * L::KV_BYTES);
      if (loader) refill(it);
      wg_wait<1>();
      reg_fence(sc);
      release(k_empty + 8 * s);
      softmax(it);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(p);
      release(v_empty + 8 * ps);
      to_a<BN>(sc, p);
    }
    // step nt: the last P V
    const int ps = (nt - 1) % STAGES;
    rescale<HD>(o, corr);
    mbar_wait(v_full + 8 * ps, ((nt - 1) / STAGES) & 1);
    reg_fence(o);
    reg_fence(p);
    wg_fence();
    issue_nn<HD, BN>(o, p, sV + ps * L::KV_BYTES);
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

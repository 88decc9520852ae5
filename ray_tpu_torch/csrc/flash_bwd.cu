// Flash-attention backward, dq (K2; K5a is its fp32-output launch), for
// Hopper, sm_90a: TMA into a ring of K/V stages and wgmma for all three
// products, with delta = rowsum(dO o) computed in K2's prologue. dk/dv
// (K3, K5b) are flash_bwd_dkv.cu's.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_dq_kernel
// (:275), launched by _flash_bwd_tpu (:434, K2) and by _hop_bwd_tpu (:743,
// K5a: the ring hop's dq against one K/V block with the ring's global lse
// and delta, in fp32). Same function: with p = exp(q k^T * scale - lse)
// under a top-left causal mask (q_pos >= k_pos) or none, dp = dO v^T and
// ds = p (dp - delta),
//   dq = ds k * scale,
// for q and dO (b, h, sq, hd), k and v (b, kvh, sk, hd), all contiguous
// bf16, query head hi reading kv head hi / (h / kvh); lse and delta
// (b, h, sq) fp32; dq in bf16, or fp32 (DQ_F32). hd 64 or 128, any sq and
// sk (the hop's sq != sk included). Deterministic, no atomics: a block owns
// its rows and writes them once.
//
// delta: when the entry is given o (K2, the training path), each warpgroup
// computes delta for its rows in fp32 from its shared dO tile and o read
// from global memory, keeps it in registers and writes it to ``delta``,
// which K3 then reads on the same stream: the four eager kernels of a
// torch rowsum (two upcasts, a product, a sum) are gone. When o is null
// (K5a), delta is read: the ring passes the global rows from outside. One
// entry with a nullable o, not two, since the two differ in three lines of
// the prologue.
//
// What bounds it on an H100 (chip_smoke's _k23_bounds): three products of
// 2 b h hd per (q, k) pair; at the training path's b8 h8 kvh4 s2048 hd128,
// causal, 103 GFLOP (0.104 ms at 989 TF/s) against ~0.13 GB (0.04 ms at
// 3.35 TB/s). The tensor-core operations.
//
// The design is K1's (hopper_attn.cuh) with K1's online softmax replaced by
// dS: a 256-thread block of two consumer warpgroups, each owning 64 query
// rows of one (batch, head), the causal q-tiles paired j and T-1-j
// (hopper_common.cuh's pair_tile), 2j and 2j+1 when not. Thread 0 issues
// every copy: each warpgroup's Q and dO tiles once, then K and V tiles of
// 64 keys into a ring of STAGES stages (3-D maps that zero-fill rows past
// the sequence; a "full" barrier per stage completed by the copies' bytes,
// an "empty" one on which every warp of both warpgroups arrives once its
// products have read the stage). Each warpgroup keeps its fp32 dQ
// accumulator and its rows' lse and delta in registers for the whole key
// sweep. For each key tile:
//   S  = Q K^T      wgmma m64n64k16, A = Q and B = K from shared memory,
//                   both K-major, 128-byte swizzled;
//   dP = dO V^T     the same with A = dO and B = V, issued beside S;
//   dS = P (dP - delta), P = 2^(S scale log2(e) - lse log2(e)), in
//                   registers; keys past sk and, when causal, q_pos < k_pos
//                   are p = 0 (only the diagonal tile and a ragged edge take
//                   the masked path); rows past sq have Q = dO = 0 and
//                   lse = delta = 0, so dS = 0 there, and are never stored;
//   dQ += dS K      wgmma m64nHDk16, dS packed to bf16 as the register A
//                   operand, K read MN-major (the transpose flag): one K
//                   tile is read K-major by S and MN-major by dQ.
// dQ is scaled once in the epilogue. Registers (ptxas, nvcc 12.9): ~190 at
// hd 128, ~150 at hd 64, no spills.
//
// Build-order step reached: (a), each tile's S and dP in one batch, then
// its dQ, with fixed wait depths; the two warpgroups' products overlap
// each other's exponentials. Step (b), K1's own overlap (tile j's S and dP
// issued beside tile j-1's dQ, no extra registers: dS of j-1 is packed to
// bf16 before S of j goes out), compiled at ~180 registers with no spill
// or serialisation note but lost to (a) with 3 stages and with 4 (PERF.md
// section 6): it holds each K stage a step longer, which leaves the K copy
// one step of lead with 3 stages, and with 4 stages it still lost. 4 stages
// beat 3 and 2 at the training shape (192 KB at hd 128). Not done yet: the
// causal pairing leaves a block's shorter q-tile's warpgroup idle once it
// is done (at T = 32, 33 tile-steps of work over two warpgroups take 17-32
// steps), so the causal training shape reaches 43% of its bound against
// the unmasked one's 54%.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {
namespace k2 {

using namespace hattn;

constexpr int BM = 64;       // query rows per consumer warpgroup
constexpr int BN = 64;       // keys per K/V stage
constexpr int STAGES = 4;    // K/V stages in the ring
constexpr int THREADS = 256;  // 2 consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, every tile 1024-byte aligned (the 128-byte
// swizzle's atom): consumer c's Q at Q_OFF + 2 c TILE and its dO one TILE
// after, STAGES K tiles, STAGES V tiles, then the barriers. 192 KB at hd
// 128: one block an SM.
template <int HD>
struct Smem {
  static constexpr int TILE = 64 * HD * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = 4 * TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  static constexpr int N_BARS = 2 + 2 * STAGES;
  static constexpr int ALLOC = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
};

struct Args {
  const __nv_bfloat16* o;  // (b, h, sq, hd): delta computed, or null: read
  const float* lse;        // (b, h, sq)
  float* delta;            // (b, h, sq): written when o is given, else read
  void* dq;                // (b, h, sq, hd): bf16, or fp32 when DQ_F32
  int h, kvh, sq, sk;
  float scale, scale_log2;
};

// sum of the products of 8 bf16 pairs, in fp32
__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

template <int HD, bool CAUSAL, bool DQ_F32>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base + L::Q_OFF, sK = base + L::K_OFF,
                 sV = base + L::V_OFF, bars = base + L::BAR_OFF;
  // barriers: q_full[2] (Q and dO), then per stage full (K and V), then
  // per stage empty
  const uint32_t q_full = bars, full = bars + 16, empty = full + 8 * STAGES;

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

  auto load_kv = [&](int tile) {  // K and V tile ``tile`` into its stage
    const int s = tile % STAGES;
    mbar_expect_tx(full + 8 * s, 2 * L::TILE);
#pragma unroll
    for (int half = 0; half < HD / 64; ++half) {
      tma_load_3d(sK + s * L::TILE + half * BN * 128, &tk, full + 8 * s,
                  half * 64, tile * BN, kv_slab);
      tma_load_3d(sV + s * L::TILE + half * BN * 128, &tv, full + 8 * s,
                  half * 64, tile * BN, kv_slab);
    }
  };

  if (loader) {
    mbar_init(q_full, 1);
    mbar_init(q_full + 8, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // every warp of both consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int q_slab = bi * a.h + hi;
    const int qts[2] = {qt0, qt1};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (qts[c] < 0) continue;
      const uint32_t dst = sQ + 2 * c * L::TILE;
      mbar_expect_tx(q_full + 8 * c, 2 * L::TILE);
#pragma unroll
      for (int half = 0; half < HD / 64; ++half) {
        tma_load_3d(dst + half * BM * 128, &tq, q_full + 8 * c, half * 64,
                    qts[c] * BM, q_slab);
        tma_load_3d(dst + L::TILE + half * BM * 128, &tdo, q_full + 8 * c,
                    half * 64, qts[c] * BM, q_slab);
      }
    }
    for (int tile = 0; tile < min(STAGES, n_kv); ++tile) load_kv(tile);
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
  const uint32_t q_tile = sQ + 2 * c * L::TILE, do_tile = q_tile + L::TILE;

  // lse in base 2 and delta of this thread's rows; 0 past sq
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = qt >= 0 && row < a.sq;
    lse2[r] = in ? a.lse[q_row0 + row] * LOG2E : 0.f;
    dl[r] = in && a.o == nullptr ? a.delta[q_row0 + row] : 0.f;
  }
  // delta = rowsum(dO o) of this thread's rows, from the warpgroup's dO
  // tile (the 16-byte chunk ch of row r of a 64-column half lies at
  // r 128 + 16 (ch ^ r % 8): the 128-byte swizzle) and o in global memory;
  // the quad's four threads take every fourth chunk of the rows and sum
  // with two shuffles
  auto fused_delta = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = warp * 16 + g + 8 * r, row = row0 + 8 * r;
      float acc = 0.f;
      if (row < a.sq) {
        const uint4* orow =
            reinterpret_cast<const uint4*>(a.o + (q_row0 + row) * HD);
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) {
          const int ch = t + 4 * i;
          const uint4 x = *reinterpret_cast<const uint4*>(
              smem + (do_tile - base) + (ch / 8) * BM * 128 + lr * 128 +
              (((ch % 8) ^ (lr % 8)) << 4));
          acc += dot8(x, orow[ch]);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dl[r] = acc;
      if (t == 0 && row < a.sq) a.delta[q_row0 + row] = acc;
    }
  };

  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t p[BN / 16][4];

  // Step it multiplies Q and dO by K and V tile it (S, dP), forms dS, and
  // multiplies it by K tile it (dQ), each product waited for in turn; the
  // other consumer's products run while this one exponentiates. A consumer
  // past its own tiles still waits on and releases each stage, so every
  // empty barrier counts both consumers. At each step the loader refills
  // the stages of tile it-1, which both consumers released a step ago, so
  // copies run STAGES - 1 tiles ahead.
  auto refill = [&](int it) {
    const int r = it - 1;
    if (r >= 0 && r + STAGES < n_kv) {
      mbar_wait(empty + 8 * (r % STAGES), (r / STAGES) & 1);
      load_kv(r + STAGES);
    }
  };

  int it = 0;
  if (nt > 0) {
    mbar_wait(q_full + 8 * c, 0);
    for (; it < nt; ++it) {
      const int s = it % STAGES, n0 = it * BN;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      reg_fence(sc);
      reg_fence(dp);
      wg_fence();
      issue_nt<HD, BN>(sc, q_tile, sK + s * L::TILE);   // S = Q K^T
      issue_nt<HD, BN>(dp, do_tile, sV + s * L::TILE);  // dP = dO V^T
      if (it == 0 && a.o != nullptr) fused_delta();     // while they run
      wg_wait<0>();
      reg_fence(sc);
      reg_fence(dp);
      // dS = P (dP - delta), P under the mask
      const bool need_mask =
          n0 + BN > a.sk || (CAUSAL && n0 + BN - 1 > qt * BM);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = ex2(fmaf(sc[4 * i + e], a.scale_log2, -lse2[r]));
          if (need_mask) {
            const int key = n0 + 8 * i + 2 * t + (e & 1);
            if (key >= a.sk || (CAUSAL && key > row0 + 8 * r)) x = 0.f;
          }
          sc[4 * i + e] = x * (dp[4 * i + e] - dl[r]);
        }
      }
      to_a<BN>(sc, p);
      reg_fence(dqa);
      reg_fence(p);
      wg_fence();
      issue_nn<HD, BN>(dqa, p, sK + s * L::TILE);  // dQ += dS K
      if (loader) refill(it);
      wg_wait<0>();
      reg_fence(dqa);
      reg_fence(p);
      release(empty + 8 * s);
    }
  }
  for (; it < n_kv; ++it) {  // tiles only the other consumer reads
    mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
    release(empty + 8 * (it % STAGES));
    if (loader) refill(it);
  }

  if (qt < 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.sq) continue;
    const size_t at = (q_row0 + row) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const float x0 = dqa[4 * i + 2 * r] * a.scale,
                  x1 = dqa[4 * i + 2 * r + 1] * a.scale;
      if (DQ_F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.dq) + at + 8 * i +
                                   2 * t) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.dq) + at +
                                     8 * i + 2 * t) = pack_bf16(x0, x1);
      }
    }
  }
}

// -- host side -----------------------------------------------------------------

template <int HD, bool CAUSAL, bool DQ_F32>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const Args& a, int b, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, HD, a.sq, b * a.h, BM) ||
      !make_map(&tdo, dout, HD, a.sq, b * a.h, BM) ||
      !make_map(&tk, k, HD, a.sk, b * a.kvh, BN) ||
      !make_map(&tv, v, HD, a.sk, b * a.kvh, BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_kernel<HD, CAUSAL, DQ_F32>;
  constexpr int smem = Smem<HD>::ALLOC;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.sq + BM - 1) / BM;
  const dim3 grid((n_qt + 1) / 2, a.h, b);
  kernel<<<grid, THREADS, smem, st>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const Args& a, int b, int causal,
                     int dq_f32, cudaStream_t st) {
  if (causal)
    return dq_f32 ? launch<HD, true, true>(q, k, v, dout, a, b, st)
                  : launch<HD, true, false>(q, k, v, dout, a, b, st);
  return dq_f32 ? launch<HD, false, true>(q, k, v, dout, a, b, st)
                : launch<HD, false, false>(q, k, v, dout, a, b, st);
}

}  // namespace k2
}  // namespace

// q, dO (b, h, sq, hd), k/v (b, kvh, sk, hd): contiguous bf16 at 16-byte
// aligned addresses; lse (b, h, sq) fp32; dq (b, h, sq, hd) bf16, or fp32
// when dq_fp32. With o (b, h, sq, hd) bf16 at a 16-byte aligned address,
// delta (b, h, sq) fp32 is written as rowsum(dO o); with o null it is read.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* o, const void* lse,
                            void* delta, void* dq, int b, int h, int kvh,
                            int sq, int sk, int hd, int causal, int dq_fp32,
                            void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || sq <= 0 || sk <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)hd);
  const k2::Args a{static_cast<const __nv_bfloat16*>(o),
                   static_cast<const float*>(lse), static_cast<float*>(delta),
                   dq, h, kvh, sq, sk, scale, scale * k2::LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)k2::dispatch<64>(q, k, v, dout, a, b, causal, dq_fp32, st);
    case 128:
      return (int)k2::dispatch<128>(q, k, v, dout, a, b, causal, dq_fp32,
                                    st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Flash-attention backward, dk and dv (K3; K5b is its fp32-output launch),
// for Hopper, sm_90a: TMA into a ring of Q/dO stages and wgmma for all four
// products.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_dkv_kernel
// (:320), launched by _flash_bwd_tpu (:467, K3) and by _hop_bwd_tpu (:770,
// K5b, the ring hop's backward with fp32 dk/dv). Same function: with
// p = exp(q k^T * scale - lse) under a top-left causal mask (q_pos >= k_pos)
// or none, dp = dO v^T and ds = p (dp - delta),
//   dv = sum_rep p^T dO,   dk = sum_rep ds^T q * scale,
// each sum over the rep = h / kvh query heads of a kv head. q and dO are
// (b, h, sq, hd), k and v (b, kvh, sk, hd), all contiguous bf16; lse and
// delta (b, h, sq) fp32; dk and dv come out in bf16, or fp32 (DKV_F32: the
// ring accumulates them over hops). hd 64 or 128, any sq and sk.
//
// What bounds it on an H100 (chip_smoke's _k23_bounds: four products of
// 2 b h hd per (q, k) pair; q, k, v, dO, lse and delta read once, dk and dv
// written once): at the training path's b8 h8 kvh4 s2048 hd128, causal,
// 137.5 GFLOP (0.139 ms at 989 TF/s) against 135 MB (0.040 ms at
// 3.35 TB/s); at the ring's hop, b1 h8 kvh4 2048 x 2048 hd128 with fp32
// dk/dv, 34.4 GFLOP unmasked (0.0347 ms) and half that on the diagonal hop
// (0.0174 ms), against 21 MB (0.0063 ms). The tensor-core operations.
//
// The design: a block owns 64 keys of one kv head (one wgmma M tile) and
// sweeps the (query head, q-tile) pairs of its rep query heads, from the
// causal start, with one or two warpgroups of 128 threads. Thread 0 brings
// the K and V tiles once; each warpgroup's first thread streams the 64-row
// Q and dO tiles of its own pairs into its own ring of STAGES stages (TMA,
// 3-D maps that zero-fill rows past the sequence; a "full" barrier
// completed by the copies' bytes and an "empty" one on which each warp
// arrives once its products have read the stage). Each warpgroup keeps
// fp32 dK and dV accumulators (64 + 64 registers at hd 128) in registers
// across its whole sweep; with two, the second takes every other pair and
// its sums are added into the first's through shared memory at the end.
// So the GQA sum is made in one block in a fixed order: deterministic, no
// atomics, and dk / dv are written once. For each pair:
//   S^T  = K Q^T     wgmma m64n64k16, A = K, B = Q, both K-major;
//   dP^T = V dO^T    the same with A = V, B = dO (issued beside S^T, so it
//                    runs while the warpgroup exponentiates);
//   P^T  = 2^(S^T scale log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta),
//                    lse and delta by column from shared memory (a thread's
//                    columns are 8 i + 2 (t % 4) + {0, 1}); keys past sk,
//                    queries past sq and, when causal, q_pos < k_pos are 0;
//   dV  += P^T dO    wgmma m64nHDk16, P^T packed to bf16 as the register A
//                    operand, dO read MN-major (the transpose flag);
//   dK  += dS^T Q    the same with Q read MN-major.
// The Q and dO tiles are each read K-major by one product and MN-major by
// another, from one 128-byte swizzled layout, as the forward (K1) reads its
// K and V. lse and delta of the next q-tile are loaded during this one into
// a double buffer in shared memory. dK is scaled once in the epilogue.
// Causal blocks start at their diagonal q-tile (only it is masked), and a
// grid of more than one wave runs the key tiles with the most q-tiles
// first. Every SM runs two warpgroups, so one's products run while the
// other exponentiates: where the grid fills two waves (the training path's
// 1024 blocks), as two blocks of one warpgroup (96 KB of shared memory each
// at hd 128: K, V and two stages of Q and dO); below that (the ring hop's
// 128 blocks) as one block of two (160 KB). Registers (ptxas, nvcc 12.9):
// 234-240 at hd 128, 166-170 at hd 64, no spills.
//
// Build-order step reached: (a), each pair's products in two batches (S^T
// beside dP^T, then dV beside dK) with fixed wait depths and a 2-stage ring
// a warpgroup, plus the second warpgroup for small grids and the block
// order. Step (b), dV issued while dS^T is formed and the next pair's S^T /
// dP^T behind this pair's dK, was built twice (PERF.md section 6): both
// builds reached 255 registers with spills at hd 128 (and C7515,
// serialised products, at hd 64) and lost on the training shape, so it is
// not kept. Not done yet: a register budget that lets (b) stay
// asynchronous, and a split of the diagonal ring hop's longest key tile
// (its time equals the unmasked hop's: key tile 0's pairs set it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {
namespace dkv {

using namespace hattn;

constexpr int BN = 64;        // keys a block owns (one wgmma M tile)
constexpr int BQ = 64;        // query rows a Q/dO tile
constexpr int STAGES = 2;     // Q/dO stages in each warpgroup's ring
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block of NWG warpgroups, every tile 1024-byte
// aligned (the 128-byte swizzle's atom). A tile of 64 rows and HD columns
// is HD / 64 column halves of 64 rows x 128 bytes (one TMA box each). K,
// V, then each warpgroup's stages of Q and dO, then each warpgroup's lse /
// delta rows (two buffers of 2 x BQ floats), the barriers.
template <int HD, int NWG>
struct Smem {
  static constexpr int TILE = 64 * HD * 2;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = TILE;
  // warpgroup w's stage s: Q at Q_OFF + (w STAGES + s) STAGE, dO + TILE
  static constexpr int Q_OFF = 2 * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int ROW_OFF = Q_OFF + NWG * STAGES * STAGE;
  static constexpr int ROWS = 2 * 2 * BQ;  // floats a warpgroup
  static constexpr int BAR_OFF = ROW_OFF + NWG * ROWS * 4;
  static constexpr int N_BARS = 1 + 2 * STAGES * NWG;
  static constexpr int ALLOC = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
  // the second warpgroup's dK and dV, one float a thread a row, over the
  // stages once both warpgroups are done with them
  static_assert(NWG == 1 || HD * 128 * 4 <= NWG * STAGES * STAGE,
                "merge buffer");
};

struct Args {
  const float* lse;    // (b, h, sq)
  const float* delta;  // (b, h, sq)
  void* dk;            // (b, kvh, sk, hd): bf16, or fp32 when DKV_F32
  void* dv;
  int h, kvh, sq, sk;
  float scale, scale_log2;
  int kt_major;  // grid (b kvh, key tiles) when 1, else (key tiles, b kvh)
};

// the 128 threads of warpgroup ``wg`` wait for each other (named barrier
// 1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int HD, bool CAUSAL, bool DKV_F32, int NWG>
__global__ void __launch_bounds__(128 * NWG)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = Smem<HD, NWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const int tid = threadIdx.x;
  const int wg = tid / 128, ltid = tid % 128;  // warpgroup, thread in it
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF,
                 sQ = base + L::Q_OFF + wg * STAGES * L::STAGE,
                 bars = base + L::BAR_OFF;
  // lse * log2(e) and delta of a q-tile's rows: rows[buffer][0 / 1][row]
  float(*rows)[2][BQ] = reinterpret_cast<float(*)[2][BQ]>(
      smem + L::ROW_OFF + wg * L::ROWS * 4);
  // barriers: kv_full, then per warpgroup and stage full, then empty
  const uint32_t kv_full = bars;
  const uint32_t full = bars + 8 + wg * 16 * STAGES,
                 empty = full + 8 * STAGES;

  // key tile kt of kv head kh of batch row bi
  const int kt = a.kt_major ? blockIdx.y : blockIdx.x;
  const int bk = a.kt_major ? blockIdx.x : blockIdx.y;
  const int kh = bk % a.kvh, bi = bk / a.kvh;
  const int k0 = kt * BN;
  const int rep = a.h / a.kvh;
  const int n_qt = (a.sq + BQ - 1) / BQ;
  // q-tiles before the diagonal see none of these keys
  const int start = CAUSAL ? min(k0 / BQ, n_qt) : 0;
  const int per_head = n_qt - start;
  const int n_it = rep * per_head;  // (query head, q-tile) pairs, in order
  // this warpgroup's pairs: wg, wg + NWG, ...; its j-th is pair_of(j)
  const int n_mine = n_it > wg ? (n_it - wg + NWG - 1) / NWG : 0;
  const int q_slab0 = bi * a.h + kh * rep;
  auto pair_of = [&](int j) { return wg + NWG * j; };

  auto load_q = [&](int j) {  // the Q and dO tiles of this warpgroup's j
    const int s = j % STAGES, it = pair_of(j);
    const int slab = q_slab0 + it / per_head;
    const int row = (start + it % per_head) * BQ;
    const uint32_t dst = sQ + s * L::STAGE;
    mbar_expect_tx(full + 8 * s, 2 * L::TILE);
#pragma unroll
    for (int half = 0; half < HD / 64; ++half) {
      tma_load_3d(dst + half * BQ * 128, &tq, full + 8 * s, half * 64, row,
                  slab);
      tma_load_3d(dst + L::TILE + half * BQ * 128, &tdo, full + 8 * s,
                  half * 64, row, slab);
    }
  };
  // this thread's share of pair it's rows: lse * log2(e) (threads 0-63 of
  // the warpgroup) or delta (64-127) of one row; 0 past sq (those queries
  // are masked)
  auto row_val = [&](int it) -> float {
    const int row = (start + it % per_head) * BQ + ltid % BQ;
    if (row >= a.sq) return 0.f;
    const size_t at =
        static_cast<size_t>(q_slab0 + it / per_head) * a.sq + row;
    return ltid < BQ ? a.lse[at] * LOG2E : a.delta[at];
  };

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2 * STAGES * NWG; ++s)
      mbar_init(bars + 8 + 8 * s, (s / STAGES) % 2 ? 4 : 1);  // empty: warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_it > 0) {
      const int kv_slab = bi * a.kvh + kh;
      mbar_expect_tx(kv_full, 2 * L::TILE);
#pragma unroll
      for (int half = 0; half < HD / 64; ++half) {
        tma_load_3d(sK + half * BN * 128, &tk, kv_full, half * 64, k0,
                    kv_slab);
        tma_load_3d(sV + half * BN * 128, &tv, kv_full, half * 64, k0,
                    kv_slab);
      }
    }
  }
  __syncthreads();  // the barriers are initialised
  if (ltid == 0)  // each warpgroup's first thread loads its own stages
    for (int j = 0; j < min(STAGES, n_mine); ++j) load_q(j);
  if (n_mine > 0) rows[0][ltid / BQ][ltid % BQ] = row_val(pair_of(0));
  wg_sync(wg);

  const int warp = ltid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's keys: key0 and key0 + 8; its accumulator element
  // 4 i + 2 r + e is (key0 + 8 r, column 8 i + 2 t + e)
  const int key0 = k0 + warp * 16 + g;

  float dk[HD / 2], dv[HD / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];

  if (n_mine > 0) mbar_wait(kv_full, 0);
  for (int j = 0; j < n_mine; ++j) {
    const int s = j % STAGES, it = pair_of(j);
    const int q0 = (start + it % per_head) * BQ;
    // the next pair's rows, stored into the other buffer at the end
    const float next = j + 1 < n_mine ? row_val(pair_of(j + 1)) : 0.f;
    const uint32_t q_tile = sQ + s * L::STAGE, do_tile = q_tile + L::TILE;
    mbar_wait(full + 8 * s, (j / STAGES) & 1);

    reg_fence(st);
    reg_fence(dpt);
    wg_fence();
    issue_nt<HD, BQ>(st, sK, q_tile);    // S^T = K Q^T
    issue_nt<HD, BQ>(dpt, sV, do_tile);  // dP^T = V dO^T
    wg_wait<1>();
    reg_fence(st);

    const float* lrow = rows[j & 1][0];
    const float* drow = rows[j & 1][1];
    const bool need_mask = q0 + BQ > a.sq || k0 + BN > a.sk ||
                           (CAUSAL && q0 < k0 + BN - 1);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(lrow + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = (e & 1) ? l2.y : l2.x;
        float p = ex2(fmaf(st[4 * i + e], a.scale_log2, -lse2));
        if (need_mask) {
          const int qpos = q0 + 8 * i + 2 * t + (e & 1);
          const int key = key0 + 8 * (e >> 1);
          if (qpos >= a.sq || key >= a.sk || (CAUSAL && key > qpos)) p = 0.f;
        }
        st[4 * i + e] = p;
      }
    }
    to_a<BQ>(st, pa);
    wg_wait<0>();
    reg_fence(dpt);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(drow + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dl = (e & 1) ? d2.y : d2.x;
        dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - dl);
      }
    }
    to_a<BQ>(dpt, da);

    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pa);
    reg_fence(da);
    wg_fence();
    issue_nn<HD, BQ>(dv, pa, do_tile);  // dV += P^T dO
    issue_nn<HD, BQ>(dk, da, q_tile);   // dK += dS^T Q
    wg_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pa);
    reg_fence(da);
    release(empty + 8 * s);
    if (ltid == 0 && j + STAGES < n_mine) {
      mbar_wait(empty + 8 * s, (j / STAGES) & 1);
      load_q(j + STAGES);
    }
    rows[(j + 1) & 1][ltid / BQ][ltid % BQ] = next;
    wg_sync(wg);  // the rows of pair j + 1 are in; pair j's are read
  }

  if (NWG == 2) {
    // the second warpgroup's sums into the first's, in that fixed order,
    // through the stages (no copy is in flight: each warpgroup waited for
    // every copy it issued)
    float* merge = reinterpret_cast<float*>(smem + L::Q_OFF);
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        merge[i * 128 + ltid] = dk[i];
        merge[(HD / 2 + i) * 128 + ltid] = dv[i];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk[i] += merge[i * 128 + ltid];
      dv[i] += merge[(HD / 2 + i) * 128 + ltid];
    }
  }

  // dk (scaled once here) and dv of this thread's keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.sk) continue;
    const size_t row =
        (static_cast<size_t>(bi * a.kvh + kh) * a.sk + key) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const size_t at = row + 8 * i + 2 * t;
      const float k0v = dk[4 * i + 2 * r] * a.scale,
                  k1v = dk[4 * i + 2 * r + 1] * a.scale;
      const float v0v = dv[4 * i + 2 * r], v1v = dv[4 * i + 2 * r + 1];
      if (DKV_F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.dk) + at) =
            make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(static_cast<float*>(a.dv) + at) =
            make_float2(v0v, v1v);
      } else {
        __nv_bfloat16* const dkb = static_cast<__nv_bfloat16*>(a.dk);
        __nv_bfloat16* const dvb = static_cast<__nv_bfloat16*>(a.dv);
        *reinterpret_cast<uint32_t*>(dkb + at) = pack_bf16(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dvb + at) = pack_bf16(v0v, v1v);
      }
    }
  }
}

template <int HD, bool CAUSAL, bool DKV_F32, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const Args& a, int b, cudaStream_t st) {
  const int n_kt = (a.sk + BN - 1) / BN;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, HD, a.sq, b * a.h, BQ) ||
      !make_map(&tdo, dout, HD, a.sq, b * a.h, BQ) ||
      !make_map(&tk, k, HD, a.sk, b * a.kvh, BN) ||
      !make_map(&tv, v, HD, a.sk, b * a.kvh, BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_kernel<HD, CAUSAL, DKV_F32, NWG>;
  constexpr int smem = Smem<HD, NWG>::ALLOC;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = a.kt_major ? dim3(b * a.kvh, n_kt) : dim3(n_kt, b * a.kvh);
  kernel<<<grid, 128 * NWG, smem, st>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}


// One warpgroup a block, two blocks an SM, where the grid fills two waves
// of the card; below that (the ring hop: b1 kvh4 s2048 is 128 blocks) two
// warpgroups a block, so each SM still runs two. The key tiles run
// slowest-varying, tile 0 (the most causal q-tiles) first, unless the
// whole grid is resident at once: then the key tiles of one kv head sit on
// neighbouring SMs (measured 4-5% faster on the hop). A grid's choices
// depend on its shape alone, so a call's result does not vary from run to
// run.
template <int HD, bool CAUSAL, bool DKV_F32>
cudaError_t pick(const void* q, const void* k, const void* v,
                 const void* dout, Args a, int b, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long blocks = (long)b * a.kvh * ((a.sk + BN - 1) / BN);
  a.kt_major = blocks > sms;
  return blocks < 2L * sms
             ? launch<HD, CAUSAL, DKV_F32, 2>(q, k, v, dout, a, b, st)
             : launch<HD, CAUSAL, DKV_F32, 1>(q, k, v, dout, a, b, st);
}

template <int HD>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const Args& a, int b, int causal,
                     int dkv_f32, cudaStream_t st) {
  if (causal)
    return dkv_f32 ? pick<HD, true, true>(q, k, v, dout, a, b, st)
                   : pick<HD, true, false>(q, k, v, dout, a, b, st);
  return dkv_f32 ? pick<HD, false, true>(q, k, v, dout, a, b, st)
                 : pick<HD, false, false>(q, k, v, dout, a, b, st);
}

}  // namespace dkv
}  // namespace

// q, dO (b, h, sq, hd), k/v (b, kvh, sk, hd): contiguous bf16 at 16-byte
// aligned addresses; lse, delta (b, h, sq) fp32; dk, dv (b, kvh, sk, hd)
// bf16, or fp32 when dkv_fp32, summed over each kv head's query heads.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int b,
                             int h, int kvh, int sq, int sk, int hd,
                             int causal, int dkv_fp32, void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || sq <= 0 || sk <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)hd);
  const dkv::Args a{static_cast<const float*>(lse),
                    static_cast<const float*>(delta), dk, dv, h, kvh, sq, sk,
                    scale, scale * dkv::LOG2E, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)dkv::dispatch<64>(q, k, v, dout, a, b, causal, dkv_fp32, st);
    case 128:
      return (int)dkv::dispatch<128>(q, k, v, dout, a, b, causal, dkv_fp32,
                                     st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_tpu). Same function: online-softmax attention over
// q (b, h, s, hd) and k/v (b, kvh, s, hd), causal with a top-left mask
// (q_pos >= k_pos) or not, query head hi reading kv head hi / (h / kvh).
// Writes o = acc / l in bf16 and lse = m + log(l) per row in fp32.
//
// What bounds it on an H100: at the serving path's prompt buckets
// (s <= 512) the bytes (q, k, v, o read/written once, ~10.5 MB at s = 512)
// over 3.35 TB/s exceed the FLOPs (4 b h s^2 hd, halved when causal) over
// 989 TF/s; from s of about 1k up the tensor-core FLOPs bound it (34.4
// GFLOP, ~35 us at s = 2048 causal with 32 heads).
//
// What the design does about it:
// - one 128-thread block per (q-tile of 64 rows, head, batch); each warp
//   owns 16 query rows and keeps its Q fragments, the fp32 accumulator and
//   the running max / denominator in registers for the whole K/V sweep, so
//   q is read once and o is written once;
// - K and V tiles of 64 keys are staged in shared memory and shared by the
//   4 warps; QK^T and PV run on the tensor cores through
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate), and P goes from the
//   score accumulators straight into the A operand of PV without a trip
//   through shared memory;
// - causal blocks stop at the diagonal tile (work ~ s^2 / 2), and the q
//   tiles are scheduled last-first so the longest rows start early;
// - any s works: rows and keys past s are zero-filled on load, masked in
//   the scores, and never stored.
// Not done yet (a later kernel's work): cp.async/TMA double buffering of the
// K/V tiles, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int BM = 64;        // query rows per block (16 per warp)
constexpr int BN = 64;        // keys per K/V tile
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;  // the TPU kernel's finite mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// rows [r0, r0 + 64) of V (s, HD), transposed into dst[HD][64 + 8] so that
// the PV B-fragments are 32-bit words; neighbouring threads take
// neighbouring keys, which keeps the transposing stores conflict-free.
template <int HD>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src, int r0,
                                            int s) {
  constexpr int CH = HD / 8;
  constexpr int LD = BN + 8;
  for (int idx = threadIdx.x; idx < BN * CH; idx += THREADS) {
    const int r = idx % BN, c = idx / BN;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < s)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c * 8 + i) * LD + r] = e[i];
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int h, int kvh, int s, float scale_log2) {
  constexpr int KLD = HD + 8;   // padded row of sK: conflict-free fragments
  constexpr int VLD = BN + 8;   // padded row of sVt
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_S = BN / 8;  // score n-tiles per warp
  constexpr int NT_O = HD / 8;  // output n-tiles per warp
  __shared__ __align__(16) __nv_bfloat16 sK[BN * KLD];
  __shared__ __align__(16) __nv_bfloat16 sVt[HD * VLD];

  const int qi = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kh = hi / (h / kvh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = qi * BM;
  const __nv_bfloat16* qp = q + (size_t)(bi * h + hi) * s * HD;
  const __nv_bfloat16* kp = k + (size_t)(bi * kvh + kh) * s * HD;
  const __nv_bfloat16* vp = v + (size_t)(bi * kvh + kh) * s * HD;

  // Q tile through shared memory into this warp's A fragments
  load_rows<HD, BN, THREADS>(sK, qp, m0, s);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    qf[ks][0] = ld32(&sK[r0 * KLD + ks * 16 + tig * 2]);
    qf[ks][1] = ld32(&sK[(r0 + 8) * KLD + ks * 16 + tig * 2]);
    qf[ks][2] = ld32(&sK[r0 * KLD + ks * 16 + 8 + tig * 2]);
    qf[ks][3] = ld32(&sK[(r0 + 8) * KLD + ks * 16 + 8 + tig * 2]);
  }
  __syncthreads();

  float oacc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  // this thread's two rows: m0 + r0 and m0 + r0 + 8; l is the thread's
  // partial row sum, reduced over the quad at the end
  float mrow[2] = {NEG_INF, NEG_INF};
  float lrow[2] = {0.f, 0.f};
  const int qrow[2] = {m0 + r0, m0 + r0 + 8};

  int n_tiles = (s + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (m0 + BM + BN - 1) / BN);

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    load_rows<HD, BN, THREADS>(sK, kp, n0, s);
    load_rows_t<HD>(sVt, vp, n0, s);
    __syncthreads();

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
        if (key >= s || (CAUSAL && key > qrow[r])) x = NEG_INF;
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
    __syncthreads();  // the next tile overwrites sK / sVt
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  __nv_bfloat16* op = o + (size_t)(bi * h + hi) * s * HD;
  float* lp = lse + (size_t)(bi * h + hi) * s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= s) continue;
    const float inv = 1.f / lrow[r];
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      *reinterpret_cast<uint32_t*>(op + (size_t)qrow[r] * HD + dt * 8 + tig * 2) =
          pack_bf16(oacc[dt][2 * r] * inv, oacc[dt][2 * r + 1] * inv);
    }
    if (tig == 0) lp[qrow[r]] = mrow[r] * LN2 + logf(lrow[r]);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int h, int kvh, int s, int causal,
                   cudaStream_t stream) {
  const dim3 grid((s + BM - 1) / BM, h, b);
  const float scale_log2 = LOG2E / sqrtf((float)HD);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lb = static_cast<float*>(lse);
  if (causal)
    flash_fwd_kernel<HD, true><<<grid, THREADS, 0, stream>>>(
        qb, kb, vb, ob, lb, h, kvh, s, scale_log2);
  else
    flash_fwd_kernel<HD, false><<<grid, THREADS, 0, stream>>>(
        qb, kb, vb, ob, lb, h, kvh, s, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q (b, h, s, hd), k/v (b, kvh, s, hd), o (b, h, s, hd): contiguous bf16;
// lse (b, h, s) fp32. Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int kvh, int s,
                              int hd, int causal, void* stream) {
  if (b <= 0 || s <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)launch<64>(q, k, v, o, lse, b, h, kvh, s, causal, st);
    case 128:
      return (int)launch<128>(q, k, v, o, lse, b, h, kvh, s, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

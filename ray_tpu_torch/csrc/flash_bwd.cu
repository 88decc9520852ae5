// Flash-attention backward for Hopper, sm_90a: dq (K2; K5a is its
// fp32-output launch). dk/dv (K3, K5b) are flash_bwd_dkv.cu's.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_dq_kernel (K2),
// launched by _flash_bwd_tpu. Same function: with p = exp(q k^T * scale -
// lse) under a top-left causal mask (q_pos >= k_pos) or none, dp = dO v^T
// and ds = p (dp - delta),
//   dq = ds k * scale,
// for q (b, h, sq, hd), k/v (b, kvh, sk, hd), query head hi reading kv head
// hi / (h / kvh). lse and delta = rowsum(dO * o) come in as (b, h, sq) fp32.
// sq and sk are separate and dq may be written in fp32, so the ring-hop
// backward (K5a: _hop_bwd_tpu's dq against one K/V block with the ring's
// global lse and delta, in fp32) is a launch of this same kernel.
//
// What bounds it on an H100: the tensor-core operations. K2 does three
// products per (q, k) pair (QK^T, dO V^T, dS K): 6 b h sq sk hd, halved
// when causal. At the training path's b8 h8 s2048 hd128 that is 68.7 GFLOP
// causal (~69 us at 989 TF/s), against ~0.1 GB of q, k, v, dO, lse, delta
// and dq (~30 us at 3.35 TB/s).
//
// What the design does about it:
// - every product runs on the tensor cores through mma.sync.m16n8k16 (bf16
//   in, fp32 accumulate);
// - one 128-thread block per (64-row q-tile, head, batch), as in K1's first
//   port. Each warp owns 16 query rows and keeps its Q and dO fragments,
//   the fp32 dq accumulator and the rows' lse/delta in registers over the
//   whole K/V sweep; 64-key K and V tiles are staged in shared memory and
//   taken 32 keys at a time, which keeps the S and dP accumulators at 32
//   registers; dS goes from the accumulators straight into the A operand of
//   dS K, and K's B fragments come out of the same row-major tile through
//   ldmatrix.trans, so K is staged once;
// - causal blocks stop at the diagonal tile;
// - any sq and sk work: rows past either are zero-filled on load and masked
//   (p = 0) in the products, and never stored. An uninitialised NaN times a
//   masked p = 0 would poison a sum, so nothing is left uninitialised.
// Not done yet (a later kernel's work): TMA double buffering of the tiles
// (each load is followed by a barrier), wgmma (K3 has them:
// flash_bwd_dkv.cu), and delta fused into the prologue (it is one torch
// reduction today).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int BM = 64;        // query rows per block (16 per warp)
constexpr int BN = 64;        // keys per K/V tile
constexpr int HALF = 32;      // keys per sub-step
constexpr int THREADS = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8. On a row-major tile T[row][col]
// whose rows are the product's k dimension, matrices (k0, n0), (k0 + 8, n0),
// (k0, n0 + 8), (k0 + 8, n0 + 8) come back as the B fragments (b0, b1) of
// n-tile n0 and (b0, b1) of n-tile n0 + 8.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A fragments of one 16-wide k-step from the fp32 accumulators of the two
// 8-wide n-tiles that cover it (the C layout of two n-tiles is the A layout).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

template <int HD, bool CAUSAL, bool DQ_F32>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dq,
                    int h, int kvh, int sq, int sk, float scale,
                    float scale_log2) {
  constexpr int LD = HD + 8;    // padded row: conflict-free fragments
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_O = HD / 8;  // dq n-tiles per warp
  constexpr int NT_S = HALF / 8;  // score n-tiles per sub-step
  __shared__ __align__(16) __nv_bfloat16 sK[BN * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * LD];

  const int qi = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kh = hi / (h / kvh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = qi * BM;
  const size_t qoff = ((size_t)bi * h + hi) * sq;
  const size_t koff = ((size_t)bi * kvh + kh) * sk;
  const __nv_bfloat16* kp = k + koff * HD;
  const __nv_bfloat16* vp = v + koff * HD;

  // Q and dO tiles through shared memory into this warp's A fragments
  load_rows<HD, BM, THREADS>(sK, q + qoff * HD, m0, sq);
  load_rows<HD, BM, THREADS>(sV, dout + qoff * HD, m0, sq);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qf[KSTEPS][4], of[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    load_a<LD>(qf[ks], sK, r0, ks * 16, g, tig);
    load_a<LD>(of[ks], sV, r0, ks * 16, g, tig);
  }
  __syncthreads();

  // this thread's two rows: m0 + r0 + g and m0 + r0 + g + 8; rows past sq
  // read lse = delta = 0 (their dO is zero, so ds is 0, and they are never
  // stored)
  const int qrow[2] = {m0 + r0 + g, m0 + r0 + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qrow[r] < sq;
    lse2[r] = in ? lse[qoff + qrow[r]] * LOG2E : 0.f;
    dl[r] = in ? delta[qoff + qrow[r]] : 0.f;
  }

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_tiles = (sk + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (m0 + BM + BN - 1) / BN);
  const int lrow = ((lane >> 3) & 1) * 8 + (lane & 7);  // ldmatrix row of lane
  const int lcol = (lane >> 4) * 8;                   // and its column

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    load_rows<HD, BN, THREADS>(sK, kp, n0, sk);
    load_rows<HD, BN, THREADS>(sV, vp, n0, sk);
    __syncthreads();

#pragma unroll
    for (int half = 0; half < BN / HALF; ++half) {
      const int c0 = half * HALF;
      float s[NT_S][4], dp[NT_S][4];
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const int off = (c0 + nt * 8 + g) * LD + ks * 16 + tig * 2;
          mma_bf16(s[nt], qf[ks], ld32(&sK[off]), ld32(&sK[off + 8]));
          mma_bf16(dp[nt], of[ks], ld32(&sV[off]), ld32(&sV[off + 8]));
        }
      }
      // p = exp(s * scale - lse) under the mask; ds = p (dp - delta)
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + c0 + nt * 8 + tig * 2 + (e & 1);
          const int r = e >> 1;
          float p = exp2f(s[nt][e] * scale_log2 - lse2[r]);
          if (key >= sk || (CAUSAL && key > qrow[r])) p = 0.f;
          s[nt][e] = p * (dp[nt][e] - dl[r]);
        }
      }
      // dq += ds K: ds is the A operand, K's B fragments come transposed
      // out of the row-major tile
#pragma unroll
      for (int kk = 0; kk < HALF / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
        const __nv_bfloat16* base = &sK[(c0 + kk * 16 + lrow) * LD + lcol];
#pragma unroll
        for (int dt = 0; dt < NT_O; dt += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, base + dt * 8);
          mma_bf16(acc[dt], a, b[0], b[1]);
          mma_bf16(acc[dt + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= sq) continue;
    const size_t row = (qoff + qrow[r]) * HD;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      const float x0 = acc[dt][2 * r] * scale, x1 = acc[dt][2 * r + 1] * scale;
      if (DQ_F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(dq) + row + dt * 8 +
                                   tig * 2) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dq) + row +
                                     dt * 8 + tig * 2) = pack_bf16(x0, x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  int b, h, kvh, sq, sk;
  float scale, scale_log2;
};

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int b, int h, int kvh,
               int sq, int sk, int hd) {
  const float scale = 1.f / sqrtf((float)hd);
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const __nv_bfloat16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              b, h, kvh, sq, sk, scale, scale * LOG2E};
}

template <int HD, bool CAUSAL, bool DQ_F32>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t st) {
  const dim3 grid((a.sq + BM - 1) / BM, a.h, a.b);
  flash_bwd_dq_kernel<HD, CAUSAL, DQ_F32><<<grid, THREADS, 0, st>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.h, a.kvh, a.sq, a.sk,
      a.scale, a.scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_dq(const Args& a, void* dq, int causal, int dq_f32,
                        cudaStream_t st) {
  if (causal)
    return dq_f32 ? launch_dq<HD, true, true>(a, dq, st)
                  : launch_dq<HD, true, false>(a, dq, st);
  return dq_f32 ? launch_dq<HD, false, true>(a, dq, st)
                : launch_dq<HD, false, false>(a, dq, st);
}

bool bad_shape(int b, int h, int kvh, int sq, int sk) {
  return b <= 0 || h <= 0 || kvh <= 0 || sq <= 0 || sk <= 0 || h % kvh != 0;
}

}  // namespace

// q, dO (b, h, sq, hd), k/v (b, kvh, sk, hd): contiguous bf16; lse, delta
// (b, h, sq) fp32; dq (b, h, sq, hd) bf16, or fp32 when dq_fp32. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int b, int h, int kvh,
                            int sq, int sk, int hd, int causal, int dq_fp32,
                            void* stream) {
  if (bad_shape(b, h, kvh, sq, sk)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, b, h, kvh, sq, sk, hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)dispatch_dq<64>(a, dq, causal, dq_fp32, st);
    case 128: return (int)dispatch_dq<128>(a, dq, causal, dq_fp32, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

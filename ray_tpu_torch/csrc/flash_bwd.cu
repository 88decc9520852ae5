// Flash-attention backward for Hopper, sm_90a: dq (K2) and dk/dv (K3).
//
// Replaces the TPU kernels ray_tpu/ops/flash_attention.py::_dq_kernel (K2)
// and ::_dkv_kernel (K3), both launched by _flash_bwd_tpu. Same function:
// with p = exp(q k^T * scale - lse) under a top-left causal mask
// (q_pos >= k_pos) or none, dp = dO v^T and ds = p (dp - delta),
//   dq = ds k * scale,   dk = ds^T q * scale,   dv = p^T dO,
// for q (b, h, sq, hd), k/v (b, kvh, sk, hd), query head hi reading kv head
// hi / (h / kvh). lse and delta = rowsum(dO * o) come in as (b, h, sq) fp32.
// sq and sk are separate and dq may be written in fp32, so the ring-hop
// backward (_hop_bwd_tpu: K2/K3 against one K/V block with global lse and
// delta, dq in fp32) is a launch of these same kernels.
//
// What bounds them on an H100: the tensor-core operations. K2 does three
// products per (q, k) pair (QK^T, dO V^T, dS K), K3 four (K Q^T, V dO^T,
// P^T dO, dS^T Q): 6 and 8 b h sq sk hd, halved when causal. At the training
// path's b8 h8 s2048 hd128 that is 68.7 and 91.6 GFLOP causal (~69 and
// ~93 us at 989 TF/s), against ~0.1 GB of q, k, v, dO, lse, delta and
// outputs (~30 us at 3.35 TB/s).
//
// What the design does about it:
// - every product runs on the tensor cores through mma.sync.m16n8k16 (bf16
//   in, fp32 accumulate);
// - K2: one 128-thread block per (64-row q-tile, head, batch), as in K1.
//   Each warp owns 16 query rows and keeps its Q and dO fragments, the fp32
//   dq accumulator and the rows' lse/delta in registers over the whole K/V
//   sweep; 64-key K and V tiles are staged in shared memory and taken 32
//   keys at a time, which keeps the S and dP accumulators at 32 registers;
//   dS goes from the accumulators straight into the A operand of dS K, and
//   K's B fragments come out of the same row-major tile through
//   ldmatrix.trans, so K is staged once;
// - K3: one block per (64-key tile, kv head, batch). Each warp owns 16 keys
//   and accumulates dK and dV in fp32 registers over the rep query heads of
//   its kv head and, for each, over the q-tiles from the causal start; so
//   the GQA reduction happens in the kernel, with no atomics and no
//   b h s hd fp32 intermediates, and dk/dv are written once in k/v's dtype.
//   The kernel computes S^T = K Q^T with the keys as rows, so P^T and dS^T
//   land in the accumulator layout and feed the A operand of P^T dO and
//   dS^T Q without a trip through shared memory. At hd 128 the two
//   accumulators take 128 registers a thread, so K and V stay in shared
//   memory (fragments read per q-tile) and the q-tile is taken 32 rows at
//   a time; the four tiles (K, V, Q, dO) need 70 KB of dynamic shared memory;
// - causal blocks stop at (K2) or start from (K3) the diagonal tile;
// - any sq and sk work: rows past either are zero-filled on load and masked
//   (p = 0) in the products, and never stored. An uninitialised NaN times a
//   masked p = 0 would poison a sum, so nothing is left uninitialised.
// Not done yet (a later kernel's work): cp.async/TMA double buffering of the
// tiles (each load is followed by a barrier), wgmma, warp specialisation,
// and delta fused into K2's prologue (it is one torch reduction today).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int BM = 64;        // K2: query rows per block (16 per warp)
constexpr int BN = 64;        // keys per K/V tile (K3: 16 per warp)
constexpr int BQ = 64;        // K3: query rows per Q/dO tile
constexpr int HALF = 32;      // keys (K2) or query rows (K3) per sub-step
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
// K3: dk, dv (GQA group reduced in the kernel)
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * BN + 2 * BQ) * (HD + 8) * sizeof(__nv_bfloat16) +
         2 * BQ * sizeof(float);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int h, int kvh, int sq,
                     int sk, float scale, float scale_log2) {
  constexpr int LD = HD + 8;
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_O = HD / 8;    // dk/dv n-tiles per warp
  constexpr int NT_S = HALF / 8;  // score n-tiles (query columns) per sub-step
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BN * LD;
  __nv_bfloat16* sQ = sV + BN * LD;
  __nv_bfloat16* sO = sQ + BQ * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + BQ * LD);  // lse * log2(e)
  float* sD = sL + BQ;                                  // delta

  const int k0 = blockIdx.x * BN;
  const int kh = blockIdx.y, bi = blockIdx.z;
  const int rep = h / kvh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t koff = ((size_t)bi * kvh + kh) * sk;

  load_rows<HD, BN, THREADS>(sK, k + koff * HD, k0, sk);
  load_rows<HD, BN, THREADS>(sV, v + koff * HD, k0, sk);
  // (the first q-tile's barrier makes them visible)

  const int r0 = warp * 16;  // this warp's keys: k0 + r0 + [0, 16)
  const int krow[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }
  const int q_tiles = (sq + BQ - 1) / BQ;
  const int start = CAUSAL ? k0 / BQ : 0;  // query tiles before it see no key
  const int lrow = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lcol = (lane >> 4) * 8;

  for (int rr = 0; rr < rep; ++rr) {
    const size_t qoff = ((size_t)bi * h + kh * rep + rr) * sq;
    for (int i = start; i < q_tiles; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_rows<HD, BQ, THREADS>(sQ, q + qoff * HD, q0, sq);
      load_rows<HD, BQ, THREADS>(sO, dout + qoff * HD, q0, sq);
      for (int t = threadIdx.x; t < BQ; t += THREADS) {
        const bool in = q0 + t < sq;
        sL[t] = in ? lse[qoff + q0 + t] * LOG2E : 0.f;
        sD[t] = in ? delta[qoff + q0 + t] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int half = 0; half < BQ / HALF; ++half) {
        const int c0 = half * HALF;
        // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 queries
        float s[NT_S][4], dp[NT_S][4];
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          uint32_t ak[4], av[4];
          load_a<LD>(ak, sK, r0, ks * 16, g, tig);
          load_a<LD>(av, sV, r0, ks * 16, g, tig);
#pragma unroll
          for (int nt = 0; nt < NT_S; ++nt) {
            const int off = (c0 + nt * 8 + g) * LD + ks * 16 + tig * 2;
            mma_bf16(s[nt], ak, ld32(&sQ[off]), ld32(&sQ[off + 8]));
            mma_bf16(dp[nt], av, ld32(&sO[off]), ld32(&sO[off + 8]));
          }
        }
        // P^T into s, dS^T into dp
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c0 + nt * 8 + tig * 2 + (e & 1);
            const int qpos = q0 + qc;
            const int key = krow[e >> 1];
            float p = exp2f(s[nt][e] * scale_log2 - sL[qc]);
            if (qpos >= sq || key >= sk || (CAUSAL && key > qpos)) p = 0.f;
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - sD[qc]);
          }
        }
        // dV += P^T dO, dK += dS^T Q: dO's and Q's B fragments come
        // transposed out of their row-major tiles
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk) {
          uint32_t pa[4], da[4];
          acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
          acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
          const int off = (c0 + kk * 16 + lrow) * LD + lcol;
#pragma unroll
          for (int dt = 0; dt < NT_O; dt += 2) {
            uint32_t b[4];
            ldsm_x4_t(b, &sO[off + dt * 8]);
            mma_bf16(dva[dt], pa, b[0], b[1]);
            mma_bf16(dva[dt + 1], pa, b[2], b[3]);
            ldsm_x4_t(b, &sQ[off + dt * 8]);
            mma_bf16(dka[dt], da, b[0], b[1]);
            mma_bf16(dka[dt + 1], da, b[2], b[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= sk) continue;
    const size_t row = (koff + krow[r]) * HD;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      const size_t at = row + dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dka[dt][2 * r] * scale, dka[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dva[dt][2 * r], dva[dt][2 * r + 1]);
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

template <int HD, bool CAUSAL>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  auto kernel = flash_bwd_dkv_kernel<HD, CAUSAL>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sk + BN - 1) / BN, a.kvh, a.b);
  kernel<<<grid, THREADS, smem, st>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.h,
      a.kvh, a.sq, a.sk, a.scale, a.scale_log2);
  return cudaGetLastError();
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

// Same inputs; dk, dv (b, kvh, sk, hd) bf16, summed over each kv head's
// query heads. Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int b,
                             int h, int kvh, int sq, int sk, int hd,
                             int causal, void* stream) {
  if (bad_shape(b, h, kvh, sq, sk)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, b, h, kvh, sq, sk, hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return causal ? (int)launch_dkv<64, true>(a, dk, dv, st)
                    : (int)launch_dkv<64, false>(a, dk, dv, st);
    case 128:
      return causal ? (int)launch_dkv<128, true>(a, dk, dv, st)
                    : (int)launch_dkv<128, false>(a, dk, dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Ring-attention hop (K4) for Hopper, sm_90a.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_chunk_kernel
// (launched by _flash_chunk_tpu). Same function: one online-softmax
// accumulation of a K/V chunk into carried state. q (b, h, sq, hd) and k/v
// (b, kvh, sk, hd) in bf16, query head hi reading kv head hi / (h / kvh);
// the state o (b, h, sq, hd) and the running max m and denominator l
// (b, h, sq) come in and go out in fp32, o un-normalised and m in the
// natural log (the ring's own units: m starts at -inf on the first hop).
// Causal masks with LOCAL positions from the top left (q_pos >= k_pos): the
// ring's diagonal hop. The outputs are fresh buffers: the inputs are the
// backward's residuals.
//
// What bounds it on an H100: the tensor-core operations. At the training
// ring's hop, b1 h8 kvh4 sq = sk = 2048 hd128, an unmasked hop is
// 4 b h sq sk hd = 17.2 GFLOP (~17 us at 989 TF/s) against ~25 MB moved
// (the fp32 o read and written dominate; ~8 us at 3.35 TB/s); the
// diagonal hop does half the products.
//
// What the design does about it: it is K1 (flash_fwd.cu) with its state
// carried. One 128-thread block per (q-tile of 64 rows, head, batch); each
// warp keeps its 16 rows' Q fragments, fp32 accumulator and running max /
// denominator in registers for the whole K/V sweep, and K/V tiles of 64
// keys are staged in shared memory for QK^T and PV on the tensor cores
// (mma.sync.m16n8k16, the step in mma_tile.cuh that K1 runs too). The
// accumulator and the running max / denominator start from o_in / m_in /
// l_in instead of zero / -1e30 and are stored without the final division.
// The softmax runs in base 2, so m is converted on load (m * log2 e) and on
// store (m * ln 2); exp2(-inf - m_new) is 0 for the finite m_new that every
// row's first tile gives, so a fresh state needs no special case. Causal
// blocks stop at the diagonal tile, and rows and keys past sq / sk are
// zero-filled on load, masked, and never stored.
// Not done yet (a later kernel's work): cp.async/TMA double buffering of the
// K/V tiles, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int BM = 64;        // query rows per block (16 per warp)
constexpr int BN = 64;        // keys per K/V tile
constexpr int THREADS = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ o_in,
                   const float* __restrict__ m_in,
                   const float* __restrict__ l_in, float* __restrict__ o_out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int h, int kvh, int sq, int sk, float scale_log2) {
  constexpr int KLD = HD + 8;   // padded row of sK
  constexpr int VLD = BN + 8;   // padded row of sVt
  constexpr int KSTEPS = HD / 16;
  constexpr int NT_O = HD / 8;  // output n-tiles per warp
  __shared__ __align__(16) __nv_bfloat16 sK[BN * KLD];
  __shared__ __align__(16) __nv_bfloat16 sVt[HD * VLD];

  const int qi = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kh = hi / (h / kvh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = qi * BM;
  const size_t qoff = ((size_t)bi * h + hi) * sq;  // first row of (bi, hi)
  const size_t koff = ((size_t)bi * kvh + kh) * sk;
  const __nv_bfloat16* kp = k + koff * HD;
  const __nv_bfloat16* vp = v + koff * HD;

  // Q tile through shared memory into this warp's A fragments
  load_rows<HD, BM, THREADS>(sK, q + qoff * HD, m0, sq);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    load_a<KLD>(qf[ks], sK, warp * 16, ks * 16, g, tig);
  __syncthreads();

  // the carried state of this thread's two rows, m0 + warp*16 + g and + 8:
  // its fragment of o, and m and l in base 2 (l on one thread of the quad,
  // whose partial sums add up to the row's). Rows past sq start empty.
  const int qrow[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  float oacc[NT_O][4];
  float mrow[2], lrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qrow[r] < sq;
    const size_t row = qoff + qrow[r];
    mrow[r] = in ? m_in[row] * LOG2E : -INFINITY;
    lrow[r] = in && tig == 0 ? l_in[row] : 0.f;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      float2 x = make_float2(0.f, 0.f);
      if (in)
        x = *reinterpret_cast<const float2*>(o_in + row * HD + dt * 8 +
                                             tig * 2);
      oacc[dt][2 * r] = x.x;
      oacc[dt][2 * r + 1] = x.y;
    }
  }

  int n_tiles = (sk + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (m0 + BM + BN - 1) / BN);

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    load_rows<HD, BN, THREADS>(sK, kp, n0, sk);
    load_rows_t<HD, BN, THREADS>(sVt, vp, n0, sk);
    __syncthreads();
    online_softmax_tile<HD, BN, CAUSAL>(qf, sK, sVt, oacc, mrow, lrow, qrow,
                                        n0, sk, scale_log2);
    __syncthreads();  // the next tile overwrites sK / sVt
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= sq) continue;
    const size_t row = qoff + qrow[r];
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      *reinterpret_cast<float2*>(o_out + row * HD + dt * 8 + tig * 2) =
          make_float2(oacc[dt][2 * r], oacc[dt][2 * r + 1]);
    }
    if (tig == 0) {
      m_out[row] = mrow[r] * LN2;
      l_out[row] = lrow[r];
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o_in, const void* m_in, const void* l_in,
                   void* o_out, void* m_out, void* l_out, int b, int h,
                   int kvh, int sq, int sk, int causal, cudaStream_t stream) {
  const dim3 grid((sq + BM - 1) / BM, h, b);
  const float scale_log2 = LOG2E / sqrtf((float)HD);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* oi = static_cast<const float*>(o_in);
  const auto* mi = static_cast<const float*>(m_in);
  const auto* li = static_cast<const float*>(l_in);
  auto* oo = static_cast<float*>(o_out);
  auto* mo = static_cast<float*>(m_out);
  auto* lo = static_cast<float*>(l_out);
  if (causal)
    flash_chunk_kernel<HD, true><<<grid, THREADS, 0, stream>>>(
        qb, kb, vb, oi, mi, li, oo, mo, lo, h, kvh, sq, sk, scale_log2);
  else
    flash_chunk_kernel<HD, false><<<grid, THREADS, 0, stream>>>(
        qb, kb, vb, oi, mi, li, oo, mo, lo, h, kvh, sq, sk, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q (b, h, sq, hd), k/v (b, kvh, sk, hd): contiguous bf16; o_in/o_out
// (b, h, sq, hd), m_in/l_in/m_out/l_out (b, h, sq): contiguous fp32, the
// outputs distinct from the inputs. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int flash_chunk_bf16(const void* q, const void* k, const void* v,
                                const void* o_in, const void* m_in,
                                const void* l_in, void* o_out, void* m_out,
                                void* l_out, int b, int h, int kvh, int sq,
                                int sk, int hd, int causal, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)launch<64>(q, k, v, o_in, m_in, l_in, o_out, m_out, l_out,
                             b, h, kvh, sq, sk, causal, st);
    case 128:
      return (int)launch<128>(q, k, v, o_in, m_in, l_in, o_out, m_out, l_out,
                              b, h, kvh, sq, sk, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
// What bounds it on an H100 (chip_smoke's _k4_bound: q, k, v and the fp32
// o, m, l read once, the new o, m, l written once): at the training ring's
// hop, b1 h8 kvh4 sq = sk = 2048 hd128, an unmasked (FULL) hop is
// 4 b h sq sk hd = 17.2 GFLOP (17.4 us at 989 TF/s) against 25.4 MB (7.6 us
// at 3.35 TB/s): the tensor-core operations; the diagonal (DIAG) hop does
// half the products (8.6 GFLOP, 8.7 us), a little above its bytes.
//
// The design is K1's (flash_fwd.cu; the kernel is hopper_attn.cuh's with
// CARRY): a 256-thread block of two warpgroups of 64 query rows each,
// K/V tiles of 128 keys streamed by TMA into a ring of 3 stages, S = Q K^T
// and O += P V on wgmma, P from registers, V read MN-major. The warpgroups
// start their accumulator, m (times log2 e) and l (on one thread of each
// quad) from o_in / m_in / l_in, and store them without the final division
// (m times ln 2). The diagonal hop's blocks take the q-tiles j and T-1-j:
// at b1 h8 that is 128 blocks of equal work for 132 SMs, where one 64-row
// block per q-tile let the longest rows set the time. Shared memory per
// block: hd 128 225 KB, hd 64 113 KB. Registers per thread (ptxas -v, nvcc
// 12.9): hd 128 192 (195 causal), hd 64 168 (156 causal), no spills.

#include <cuda_runtime.h>

#include "hopper_attn.cuh"

// q (b, h, sq, hd), k/v (b, kvh, sk, hd): contiguous bf16 at 16-byte
// aligned addresses; o_in/o_out (b, h, sq, hd), m_in/l_in/m_out/l_out
// (b, h, sq): contiguous fp32, the outputs distinct from the inputs.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_chunk_bf16(const void* q, const void* k, const void* v,
                                const void* o_in, const void* m_in,
                                const void* l_in, void* o_out, void* m_out,
                                void* l_out, int b, int h, int kvh, int sq,
                                int sk, int hd, int causal, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  hattn::Args args{};
  args.o_in = static_cast<const float*>(o_in);
  args.m_in = static_cast<const float*>(m_in);
  args.l_in = static_cast<const float*>(l_in);
  args.o_out = static_cast<float*>(o_out);
  args.m_out = static_cast<float*>(m_out);
  args.l_out = static_cast<float*>(l_out);
  args.h = h;
  args.kvh = kvh;
  args.sq = sq;
  args.sk = sk;
  args.scale_log2 = hattn::LOG2E / sqrtf((float)hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)hattn::launch<64, true>(q, k, v, args, b, causal != 0, st);
    case 128:
      return (int)hattn::launch<128, true>(q, k, v, args, b, causal != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_tpu). Same function: online-softmax attention over
// q (b, h, s, hd) and k/v (b, kvh, s, hd), causal with a top-left mask
// (q_pos >= k_pos) or not, query head hi reading kv head hi / (h / kvh).
// Writes o = acc / l in bf16 and lse = m + log(l) per row in fp32.
//
// What bounds it on an H100 (chip_smoke's _k1_bound: q, k, v and o moved
// once, 4 b h hd pairs FLOPs): at the serving path's largest prompt bucket,
// b1 h32 kvh8 s512 hd128 causal, 2.15 GFLOP (2.2 us at 989 TF/s) against
// 10.6 MB (3.15 us at 3.35 TB/s): the bytes. At the training flagship's
// shape, b8 h8 kvh4 s2048 hd128 causal, 68.8 GFLOP (69.5 us) against
// 101 MB (30 us): the tensor-core operations.
//
// The design is the one in hopper_attn.cuh, which K4 (flash_chunk.cu)
// shares: a 256-thread block of two warpgroups, each owning 64 query rows;
// thread 0 streams K/V tiles of 128 keys by TMA into a ring of 3 stages,
// 128-byte swizzled; S = Q K^T and O += P V run on wgmma (P from
// registers, V read MN-major), tile j's S beside tile j-1's P V so the
// softmax overlaps the tensor cores. A causal block takes the q-tiles j
// and T-1-j, so every block does the same work. Shared memory per block:
// hd 128 225 KB (Q 2 x 16 KB, K and V 3 x 2 x 32 KB), hd 64 113 KB.
// Registers per thread (ptxas -v, nvcc 12.9): hd 128 191 (190 causal),
// hd 64 168 (155 causal), no spills.

#include <cuda_runtime.h>

#include "hopper_attn.cuh"

// q (b, h, s, hd), k/v (b, kvh, s, hd), o (b, h, s, hd): contiguous bf16,
// q, k and v at 16-byte aligned addresses; lse (b, h, s) fp32. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int kvh, int s,
                              int hd, int causal, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  hattn::Args args{};
  args.o = static_cast<__nv_bfloat16*>(o);
  args.lse = static_cast<float*>(lse);
  args.h = h;
  args.kvh = kvh;
  args.sq = args.sk = s;
  args.scale_log2 = hattn::LOG2E / sqrtf((float)hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)hattn::launch<64, false>(q, k, v, args, b, causal != 0, st);
    case 128:
      return (int)hattn::launch<128, false>(q, k, v, args, b, causal != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

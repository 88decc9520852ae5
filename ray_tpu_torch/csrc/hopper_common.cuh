// The Hopper (sm_90a) building blocks that the hand-written attention
// kernels share: mbarriers, TMA loads through 3-D tensor maps (encoded on
// the host through the runtime's driver entry point, so no library needs
// -lcuda), wgmma with its shared-memory descriptors and fences, the
// products on 128-byte swizzled tiles that the kernels issue, and the
// paired causal grid. hopper_attn.cuh (K1, K4), flash_bwd.cu (K2, K5a) and
// flash_bwd_dkv.cu (K3, K5b) run on them.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace hattn {

// -- mbarriers, TMA, wgmma ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HA_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HA_D32
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

// -- products on 128-byte swizzled tiles ----------------------------------------
//
// A tile of R rows and HD bf16 columns is HD / 64 column halves of R rows x
// 128 bytes (one TMA box each), 1024-byte aligned (the swizzle's atom).

// issue D = A B^T over HD (one commit group): A (64 rows) and B (NB rows)
// K-major; a k-step of 16 columns is 32 bytes into a half. A step adds its
// byte offset / 16 to the descriptors' start-address field.
template <int HD, int NB>
__device__ __forceinline__ void issue_nt(float (&d)[NB / 2], uint32_t a_tile,
                                         uint32_t b_tile) {
  const uint64_t da = desc_sw128(a_tile, 16, 1024);
  const uint64_t db = desc_sw128(b_tile, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;
    wgmma_ss<NB>(d, da + (((ks / 4) * 64 * 128 + off) >> 4),
                 db + (((ks / 4) * NB * 128 + off) >> 4), ks > 0);
  }
  wg_commit();
}

// issue D += A B (one commit group): A (64 x KB bf16) in registers, in
// k-steps of 16 (``to_a``'s layout), B the KB x HD tile read MN-major (the
// transpose flag): halves KB x 128 bytes apart, a k-step of 16 rows is
// 2048 bytes. The tile is never transposed in memory.
template <int HD, int KB>
__device__ __forceinline__ void issue_nn(float (&d)[HD / 2],
                                         const uint32_t (&a)[KB / 16][4],
                                         uint32_t b_tile) {
  const uint64_t db = desc_sw128(b_tile, KB * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < KB / 16; ++kk)
    wgmma_rs<HD>(d, a[kk], db + ((kk * 16 * 128) >> 4));
  wg_commit();
}

// a warpgroup's fp32 accumulator (64 x N) in bf16, in the A-operand layout
// of a product over N: k-step kk covers accumulator column chunks 2 kk and
// 2 kk + 1
template <int N>
__device__ __forceinline__ void to_a(const float (&c)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// every warp arrives once on ``bar`` (whose count is the number of warps
// that read the stage), after its own wgmma reads of the stage completed
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// -- the paired grid of K1, K4 and K2 -------------------------------------------
//
// A block of two consumer warpgroups takes two BM-row q-tiles of one
// (batch, head): when causal j and T-1-j (T q-tiles; with odd T the middle
// tile runs alone), so every block does T+1 tile-rows of work, and 2j and
// 2j+1 when not. The q-tile consumer c of block j takes (-1: none):
__device__ __forceinline__ int pair_tile(int j, int c, int n_qt, bool causal) {
  if (causal) {
    const int qt = c == 0 ? j : n_qt - 1 - j;
    return c == 1 && qt == j ? -1 : qt;
  }
  const int qt = 2 * j + c;
  return qt < n_qt ? qt : -1;
}

// the BN-key K/V tiles q-tile qt (of BM rows) reads: all of them, or when
// causal those up to its last row's position
template <int BM, int BN>
__device__ __forceinline__ int tiles_for(int qt, int sq, int sk, bool causal) {
  if (qt < 0) return 0;
  const int keys = causal ? min(sk, min(sq, (qt + 1) * BM)) : sk;
  return (keys + BN - 1) / BN;
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

}  // namespace hattn
}  // namespace

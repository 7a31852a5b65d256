// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu, conv3x3.cu): inline PTX for warpgroup MMA
// (wgmma), mbarriers, cp.async and TMA, and the host-side encoding of a TMA
// tensor map.  Header only; every kernel source that includes it is rebuilt
// when it changes (_build.library_path hashes every *.cuh beside the
// sources).
//
// Shared-memory layout used throughout: a bf16 operand tile is cut into
// panels of 64 columns (128 bytes a row), each panel stored row after row at
// a 128-byte pitch with the 128-byte swizzle (16-byte chunk c of row r lands
// at chunk c ^ (r % 8)), on a 1024-byte-aligned base.  That is what a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B writes and what a wgmma descriptor of
// layout type 1 reads:
//   - K-major (the reduction runs along the row): 8-row groups 1024 bytes
//     apart (SBO); the k16 step t of a panel starts 32 * t bytes in.
//   - MN-major (the row is the reduction; wgmma's transpose bit): 64-column
//     panels LBO bytes apart, 8-row groups 1024 bytes apart (SBO); the k16
//     step t starts 16 rows (2048 bytes) further down.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the swizzle is a function of
// address bits 4-9, so a swizzled tile starts on one).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers an asynchronous wgmma reads or writes, so that the compiler
// neither reads an accumulator before the wait nor reuses an A fragment's
// registers while the product is still in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D64                                                      \
  HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), \
      HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_D64_STR                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32, the wgmma accumulator fragment) += A (64 x 16) * B
// (16 x 128), bf16 operands, both from shared memory.  A is K-major; B is
// K-major (TRANS_B = 0) or MN-major (TRANS_B = 1).  Fragment: thread t of
// the warpgroup holds d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2)
// and column 8 j + 2 (t % 4) + e % 2.
// scale_d = 0 overwrites d instead of adding to it.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_STR
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_D64
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// The same with A from registers: a[0..3] hold the 64 x 16 bf16 A tile in
// the layout of mma.sync's m16n8k16 A fragment for each warp's 16 rows
// (a0: row r, k 2q..2q+1; a1: row r+8; a2: row r, k 8+2q..; a3: row r+8,
// k 8+2q..; r = lane / 4, q = lane % 4).  That is the accumulator fragment
// of two neighbouring n8 blocks, so an f32 result feeds the next product
// by packing pairs.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_STR
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

#define HOPPER_D32 HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
#define HOPPER_D32_STR                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) += A (64 x 16) * B (16 x 64), bf16 operands, both from
// shared memory, A K-major, B K-major (TRANS_B = 0) or MN-major
// (TRANS_B = 1).  Fragment: as m64n128k16's with j < 8, thread t of the
// warpgroup holds d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2)
// and column 8 j + 2 (t % 4) + e % 2.  So k16 step u of a product that
// takes this tile as its A operand from registers reads n8 blocks 2u and
// 2u + 1: d[8u .. 8u + 7] packed in pairs, as for the m64n128 fragment.
// scale_d = 0 overwrites d instead of adding to it.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_D32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// The same with A from registers, in m64n128k16_rs's A layout: d (64 x 64,
// f32) += A (64 x 16) * B (16 x 64).  The head-size-64 flash kernels take
// O += P V and the backward's second-stage products in this form.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// d (64 x N, f32) += A (64 x 16, from registers) * B (16 x N) for the head
// sizes the flash kernels take, N = 64 or 128.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_m64nNk16_rs(float (&d)[N / 2],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 128) {
    wgmma_m64n128k16_rs<TRANS_B>(d, a, desc_b);
  } else {
    wgmma_m64n64k16_rs<TRANS_B>(d, a, desc_b);
  }
}

#define HOPPER_D16 HOPPER_D8(0), HOPPER_D8(8)
#define HOPPER_D16_STR                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32, f32) += A (64 x 16) * B (16 x 32), bf16 operands, both from
// shared memory, as m64n64k16_ss with j < 4: thread t of the warpgroup holds
// d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and column
// 8 j + 2 (t % 4) + e % 2, so a product that takes this tile as its A
// operand from registers reads d[8u .. 8u + 7] in k16 step u.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_D16_STR
      ", %16, %17, p, 1, 1, 0, %19;\n}\n"
      : HOPPER_D16
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

#undef HOPPER_D8
#undef HOPPER_D16
#undef HOPPER_D16_STR
#undef HOPPER_D32
#undef HOPPER_D32_STR
#undef HOPPER_D64
#undef HOPPER_D64_STR

// Two f32 values as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive once and add `bytes` to the transaction count of this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of the given parity has completed.  A phase that
// never completes (a byte count that does not match its copies) traps after
// some seconds instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Order this thread's ordinary shared-memory writes (st.shared, cp.async)
// before later reads by the async proxy (wgmma); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------- cp.async

// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest (0: all).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared, zeros if src_bytes is 0.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// Arrive on `bar` once this thread's cp.async copies so far have landed
// (the barrier's count includes this arrival: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -------------------------------------------------------------------- TMA

// One box of a 3-D tensor map into shared memory; completion adds the box's
// bytes to `bar`'s transaction count.  Coordinates innermost first;
// elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint in the
// libcuda that the runtime has already loaded, so the library needs no
// -lcuda.  Returns a cudaError_t (0 = found).
inline int encode_tiled_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !p)
      return (int)cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return 0;
}

// A TMA map of a contiguous bf16 tensor (d2, d1, d0), d0 innermost, read in
// boxes of (1, box1, 64) with the 128-byte swizzle and zeros outside the
// tensor.  Returns a cudaError_t (0 = encoded).
inline int bf16_map_3d(CUtensorMap* map, const void* base, uint64_t d0,
                       uint64_t d1, uint64_t d2, uint32_t box1) {
  EncodeTiledFn encode;
  int e = encode_tiled_fn(&encode);
  if (e) return e;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};   // bytes, dims 1, 2
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper

// One tile of the tensor-core flash-attention forward's two products, alone,
// for the tests (torchmpi_tpu_torch/tools/flash_tile_probe.py): a wrong
// descriptor, swizzle or fragment layout shows up here on its own and not
// as a plausible-looking attention error.
//
// It compiles the forward's source into this library, so the probe runs the
// very TMA maps, shared layouts and wgmma helpers of flash_fwd_wgmma
// (tc::s_product, tc::pack_p, tc::pv_issue, tc::load_kv); the forward's own
// library carries no probe.

#include "../../ops/csrc/flash_attention_fwd.cu"

namespace {
namespace tc {

// s = q k^T (64 x 128, f32) and o = bf16(s) v (64 x 128, f32) for q
// (64, 128), k and v (128, 128) bf16.
__global__ void __launch_bounds__(128, 1)
tile_probe(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, float* __restrict__ s_out,
           float* __restrict__ o_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align1024(smem_raw);
  uint8_t* k_s = q_s + Q_BYTES;
  uint8_t* v_s = k_s + KV_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + KV_BYTES);
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(bar, 2);   // the Q arrival and the K/V one
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, Q_BYTES);
    hopper::tma_load_3d(q_s, &tq, bar, 0, 0, 0);
    hopper::tma_load_3d(q_s + Q_PANEL, &tq, bar, PANEL, 0, 0);
    load_kv(k_s, v_s, &tk, &tv, bar, 0, 0);
  }
  hopper::mbar_wait(bar, 0);
  float sc[64];
  s_product(sc, hopper::smem_u32(q_s), hopper::smem_u32(k_s));
  uint32_t p[32];
  pack_p(sc, p);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  hopper::wgmma_fence();
  pv_issue(acc, p, hopper::smem_u32(v_s));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::fence_regs(p);
  const int row0 = (tid / 32) * 16 + (tid % 32) / 4;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int idx = (row0 + 8 * ((i / 2) % 2)) * D + 8 * (i / 4) +
                    2 * (tid % 4) + i % 2;
    s_out[idx] = sc[i];
    o_out[idx] = acc[i];
  }
}

}  // namespace tc
}  // namespace

// q (64, 128), k and v (128, 128) bf16, 16-byte aligned; s and o (64, 128)
// f32.  Returns the cudaError_t of the launch.
extern "C" int tmpi_flash_tile_probe(const void* q, const void* k,
                                     const void* v, void* s_out, void* o_out,
                                     void* stream) {
  CUtensorMap tq, tk, tv;
  int e = hopper::bf16_map_3d(&tq, q, D, 64, 1, tc::BQ);
  if (!e) e = hopper::bf16_map_3d(&tk, k, D, tc::BKV, 1, tc::BKV);
  if (!e) e = hopper::bf16_map_3d(&tv, v, D, tc::BKV, 1, tc::BKV);
  if (e) return e;
  const int smem = 1024 + tc::Q_BYTES + 2 * tc::KV_BYTES + 64;
  cudaError_t err = cudaFuncSetAttribute(
      tc::tile_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tc::tile_probe<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<float*>(s_out), static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}

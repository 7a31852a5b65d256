// Flash-attention backward for Hopper (sm_90a): the dq pass and the dk/dv
// pass, behind two plain C functions that
// torchmpi_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces the two Pallas kernels of torchmpi_tpu/ops/flash_attention.py's
// _flash_bh_bwd: _attn_bwd_dq_kernel (:140, pallas_call at :254; dq) and
// _attn_bwd_dkv_kernel (:183, pallas_call at :267; dk, dv).  Same function,
// same algebra, from the forward's saved log-sum-exp and delta =
// rowsum(do * o) (both f32, computed by the caller; a ring caller hands in
// a combined lse and another output's delta):
//   s  = (q . k) * scale, causal fill -1e30 where row < col,
//   p  = exp(s - lse),   dp = do . v,   ds = p * (dp - delta) * scale,
//   dq = sum_k ds k,     dk = sum_q ds^T q,   dv = sum_q p^T do.
// Two passes and no atomics, as on the TPU: each output row is summed by
// exactly one CTA in a fixed order, so two calls give bitwise-equal
// gradients.  Rows past the end of q and keys past the end of k carry
// weight exactly 0 and are never written, so any Lq, Lk >= 1 are taken,
// Lk != Lq included.
//
// Two kernels for each pass, chosen by an explicit dispatch on the input
// type in the C entry points (no retry of one on the other):
//
// bf16 inputs: tensor cores (namespace tc).  Both passes have one shape:
// a CTA owns 128 rows of one tensor pair, 64 per consumer warpgroup, and
// streams the other pair through a ring of 64-row tiles in shared memory
// (TMA, 128-byte swizzle, zeros past the end, full/empty mbarriers); one
// CTA an SM.
// - dq (flash_bwd_dq_wgmma): one CTA per (bh, 128 q rows), heaviest causal
//   tiles launched first; two consumer warpgroups and a producer warp (288
//   threads), a two-stage ring (133 KB).  Q and dO come in once; K and V
//   tiles stream up to the diagonal.  Per tile each warpgroup forms
//   S = Q K^T and dP = dO V^T (wgmma m64n64k16, both operands K-major in
//   shared memory, f32 accumulators in registers), then p and ds on the
//   accumulator fragment (exp2 with scale * log2(e) folded in; lse and
//   delta are per row, two registers a thread), masking only the tiles
//   that reach the diagonal or the end of K, and feeds ds from registers
//   into dQ += dS K (m64n128k16, K read MN-major through the transpose
//   bit).  S, dP and dQ make 128 f32 a thread.
// - dk/dv (flash_bwd_dkv_wgmma): one CTA per (bh, 128 k rows), the first
//   k rows (the most q rows when causal) launched first.  K and V come in
//   once; Q and dO tiles stream from the diagonal on through a three-stage
//   ring (166 KB), each with its 64 lse and delta values (4-byte cp.async
//   completing on the same barrier).  Per tile each warpgroup forms
//   S^T = K Q^T and dP^T = V dO^T, then p^T and ds^T, reading lse and
//   delta per fragment column from shared memory, and feeds both from
//   registers into dV += P^T dO and dK += dS^T Q (dO and Q MN-major).
//   Tiles wholly above a warpgroup's diagonal are skipped.  S^T, dP^T, dV
//   and dK make 192 f32 a thread: beside a producer warp ptxas gives each
//   of 288 threads 168 registers and spills, and setmaxnreg cannot lend a
//   consumer more than the CTA holds, so this CTA has no producer warp.
//   Its 256 threads get 255 registers each, and warp 0 stages each tile
//   two tiles ahead, once every warp has let go of the stage.
// Every wgmma's descriptors are formed just before it, so none is held in
// registers across the loop.
//
// Numerics of the bf16 path.  q.k and do.v are exact per product (bf16 x
// bf16 in f32), so s and dp differ from the reference by summation order
// only; p and ds are formed in f32.  The second-stage products take p and
// ds as bf16 A operands.  With a bf16 output that rounding (2^-9 relative
// a term, of both signs) stays inside chip_smoke.py's 1e-2 abs + 1e-2 rel;
// with an f32 output (the ring carry of flash_bwd_block, held at 5e-4 abs
// + 1e-3 rel) it would not (3-7x over on causal rows with few keys, where
// p is of order 1), so each of those products is formed as two, P_hi X +
// P_lo X with P_hi = bf16(p) and P_lo = bf16(p - P_hi), which keeps ~16
// bits of p and of ds (errors of order 1e-5), as the forward does.
//
// f32 inputs: CUDA cores (namespace cuda_core), the first port's kernels.
// - dq: one block of 256 threads per (bh, 64-row q tile).  The q and do
//   tiles, lse and delta stay in shared memory for the whole loop over
//   32-row K/V tiles (only up to the diagonal when causal).  Each thread
//   forms 4 x 2 entries of s and of dp in registers in one pass over the
//   head dimension, turns them into ds in shared memory, and accumulates
//   its 4 x 8 share of the 64 x 128 dq tile in f32 registers.  Causal q
//   tiles are launched heaviest first.
// - dk/dv: one block of 256 threads per (bh, 64-row k tile).  K and V stay
//   in shared memory; the loop runs over 32-row q tiles, starting when
//   causal at the first tile with q_start + bq - 1 >= k_start.  Each tile's
//   q, do, lse and delta are staged, s^T and dp^T formed as above, p^T and
//   ds^T parked in shared memory, and dv += p^T do and dk += ds^T q are
//   accumulated in f32 registers (4 x 8 each a thread).
// Both write their outputs once, at the end; every product and sum is an
// f32 FMA (no TF32, which would break the f32 cases' 5e-4).  Shared memory:
// 108,032 bytes (dq) and 116,224 bytes (dk/dv) a block.
//
// Bound on an H100 at the training path's shape (B=1, H=32, L=2048, D=128,
// causal, bf16): one product over the 2,098,176 causal (q, k) pairs of a
// head is 2 * 32 * 2098176 * 128 = 1.72e10 operations.  dq does three (s, dp,
// dq): 5.2e10, 52 us at the 989 TFLOP/s dense bf16 tensor-core rate; dk/dv
// does four (s, dp, dv, dk): 6.9e10, 70 us.  Their bytes (q, k, v, do read
// once, lse and delta, the outputs written once) are about 67 MB, 20 us at
// 3.35 TB/s: both passes are compute-bound.  On f32 FMAs without tensor
// cores the floor is 0.77 ms (dq) and 1.03 ms (dk/dv) at 67 TFLOP/s.
//
// What the bf16 design still leaves on the table: each warpgroup waits for
// its S and dP products before the exponentials and for its second-stage
// products before the next tile (only the other warpgroup overlaps them);
// the two-pass split forms s and dp twice (7 products against
// FlashAttention-2's 5, the price of no atomics); the f32-output variants
// double the second-stage products; and the causal triangle is balanced
// only by launch order, not by a persistent schedule over the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 128;        // head size: every Llama geometry the repo names
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------- bf16: wgmma (sm_90a)

namespace tc {

// Both passes share one shape: a CTA owns ROWS rows of one tensor pair (q
// and do for dq, k and v for dk/dv), 64 per consumer warpgroup, and streams
// the other pair through shared memory in TILE-row tiles.
constexpr int ROWS = 128;             // the CTA's own rows, 64 a warpgroup
constexpr int TILE = 64;              // rows of a streamed tile
constexpr int DQ_STAGES = 2;          // depth of the streamed-tile rings
constexpr int DKV_STAGES = 3;
constexpr int NCONS = 256;            // two consumer warpgroups
constexpr int DQ_NT = NCONS + 32;     // dq: plus one producer warp
constexpr int PANEL = 64;             // columns of one swizzled panel
constexpr int FIX_PANEL = ROWS * 128; // bytes of a 64-column panel, own rows
constexpr int TILE_PANEL = TILE * 128;   // ... of a streamed tile
constexpr int FIX_BYTES = 2 * FIX_PANEL;
constexpr int TILE_BYTES = 2 * TILE_PANEL;
template <int STAGES>
constexpr int smem_bytes() {
  return 1024 + 2 * FIX_BYTES + STAGES * 2 * TILE_BYTES +
         STAGES * 2 * TILE * 4 + 8 * (1 + 2 * STAGES);
}
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {
  uint8_t* fa;       // own rows, first tensor (q or k)   [FIX_BYTES]
  uint8_t* fb;       // own rows, second tensor (do or v) [FIX_BYTES]
  uint8_t* ta;       // streamed, first (k or q)   [STAGES][TILE_BYTES]
  uint8_t* tb;       // streamed, second (v or do) [STAGES][TILE_BYTES]
  float* rowv;       // dk/dv: [STAGES][2][TILE] lse, delta
  uint64_t* fix_full;
  uint64_t* full;    // [STAGES]
  uint64_t* empty;   // [STAGES]
};

template <int STAGES>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  Smem m;
  m.fa = hopper::align1024(raw);
  m.fb = m.fa + FIX_BYTES;
  m.ta = m.fb + FIX_BYTES;
  m.tb = m.ta + STAGES * TILE_BYTES;
  m.rowv = reinterpret_cast<float*>(m.tb + STAGES * TILE_BYTES);
  m.fix_full = reinterpret_cast<uint64_t*>(m.rowv + STAGES * 2 * TILE);
  m.full = m.fix_full + 1;
  m.empty = m.full + STAGES;
  return m;
}

// A shared-memory address made opaque right before the wgmma that reads
// it: the compiler cannot form a later step's descriptors early (or hoist
// them out of the tile loop) and hold them in registers, which the
// accumulators need.
__device__ __forceinline__ void just_in_time(uint32_t& addr) {
  asm volatile("" : "+r"(addr));
}

// x = A1 . B1^T and y = A2 . B2^T (64 x 64 f32 fragments): A the
// warpgroup's 64 own rows, B a streamed tile, 8 k16 steps over D, both
// K-major.
__device__ __forceinline__ void two_products(float (&x)[32], float (&y)[32],
                                             uint32_t a1, uint32_t b1,
                                             uint32_t a2, uint32_t b2) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // the k16 step within a panel
    uint32_t a = a1 + (kk / 4) * FIX_PANEL + off;
    uint32_t b = b1 + (kk / 4) * TILE_PANEL + off;
    just_in_time(a);
    just_in_time(b);
    hopper::wgmma_m64n64k16_ss<0>(x, hopper::desc_sw128(a, 16, 1024),
                                  hopper::desc_sw128(b, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    uint32_t a = a2 + (kk / 4) * FIX_PANEL + off;
    uint32_t b = b2 + (kk / 4) * TILE_PANEL + off;
    just_in_time(a);
    just_in_time(b);
    hopper::wgmma_m64n64k16_ss<0>(y, hopper::desc_sw128(a, 16, 1024),
                                  hopper::desc_sw128(b, 16, 1024), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(x);
  hopper::fence_regs(y);
}

// A 64 x 64 f32 fragment as the bf16 A operands of 4 k16 steps (step u
// takes n8 blocks 2u and 2u + 1); with `lo`, also the part bf16 dropped.
__device__ __forceinline__ void pack(const float (&x)[32],
                                     uint32_t (&hi)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    hi[i] = hopper::pack_bf16(x[2 * i], x[2 * i + 1]);
}
__device__ __forceinline__ void pack_split(const float (&x)[32],
                                           uint32_t (&hi)[16],
                                           uint32_t (&lo)[16]) {
  pack(x, hi);
  float rest[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) {   // a bf16 is the top half of an f32
    rest[2 * i] = x[2 * i] - __uint_as_float(hi[i] << 16);
    rest[2 * i + 1] = x[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u);
  }
  pack(rest, lo);
}

// acc (64 x 128 f32) += A (64 x 64, from registers) . a streamed tile
// (64 rows x 128), read MN-major: 4 k16 steps over the tile's rows.
__device__ __forceinline__ void tile_product(float (&acc)[64],
                                             const uint32_t (&a)[16],
                                             uint32_t tile_addr) {
#pragma unroll
  for (int u = 0; u < TILE / 16; ++u) {
    const uint32_t frag[4] = {a[4 * u], a[4 * u + 1], a[4 * u + 2],
                              a[4 * u + 3]};
    uint32_t b = tile_addr + u * 16 * 128;
    just_in_time(b);
    hopper::wgmma_m64n128k16_rs<1>(acc, frag,
                                   hopper::desc_sw128(b, TILE_PANEL, 1024));
  }
}

template <int STAGES>
__device__ __forceinline__ void init_barriers(const Smem& m, int full_count) {
  hopper::mbar_init(m.fix_full, 1);
  for (int s = 0; s < STAGES; ++s) {
    hopper::mbar_init(&m.full[s], full_count);
    hopper::mbar_init(&m.empty[s], NCONS / 32);   // one arrive a warp
  }
  hopper::fence_barrier_init();
}

// The producer's loads of one tensor's rows [row, row + box) (two panels).
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* t,
                                          uint64_t* bar, int panel_bytes,
                                          int row, int bh) {
  hopper::tma_load_3d(dst, t, bar, 0, row, bh);
  hopper::tma_load_3d(dst + panel_bytes, t, bar, PANEL, row, bh);
}

// A consumer warp is done with a stage.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty);
}

// Rows of a 64 x 128 f32 accumulator fragment to memory: d[4j + 2h + e] is
// row row0 + 8h, column 8j + col0 + e; rows at or past `len` are not
// written.
template <bool F32_OUT>
__device__ __forceinline__ void store_rows(void* out, size_t base, int row0,
                                           int col0, int len,
                                           const float (&d)[64]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= len) continue;
    const size_t off = (base + row) * D + col0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float a = d[4 * j + 2 * h], b = d[4 * j + 2 * h + 1];
      if constexpr (F32_OUT) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off + 8 * j) =
            make_float2(a, b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           off + 8 * j) =
            __floats2bfloat162_rn(a, b);
      }
    }
  }
}

// dq: a CTA owns 128 q rows (with their do rows, lse and delta) and
// streams 64-row K/V tiles up to the diagonal.
template <bool F32_OUT>
__global__ void __launch_bounds__(DQ_NT, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, void* __restrict__ dq,
                   int Lq, int Lk, float scale, float scale_log2,
                   int causal) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int STAGES = DQ_STAGES;
  const Smem m = carve<STAGES>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heaviest first
  const int q_last = min(q0 + ROWS, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_tiles = (k_end + TILE - 1) / TILE;

  if (tid == 0) init_barriers<STAGES>(m, 1);
  __syncthreads();

  if (tid >= NCONS) {               // the producer warp; one lane issues
    if (tid == NCONS) {
      hopper::mbar_expect_tx(m.fix_full, 2 * FIX_BYTES);
      load_rows(m.fa, &tq, m.fix_full, FIX_PANEL, q0, bh);
      load_rows(m.fb, &tdo, m.fix_full, FIX_PANEL, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&m.empty[s], (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(&m.full[s], 2 * TILE_BYTES);
        load_rows(m.ta + s * TILE_BYTES, &tk, &m.full[s], TILE_PANEL,
                  t * TILE, bh);
        load_rows(m.tb + s * TILE_BYTES, &tv, &m.full[s], TILE_PANEL,
                  t * TILE, bh);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + lane / 4;  // its rows: row0, row0+8
  const int col0 = 2 * (lane % 4);                  // + 8 j + e % 2
  const size_t base = (size_t)bh * Lq;
  // This warpgroup's k tiles: none past its last row when causal, none at
  // all when its rows all lie past Lq.
  const int wg_k_end = causal ? min(Lk, min(wg_row0 + 64, Lq)) : Lk;
  const int wg_tiles = wg_row0 < Lq ? (wg_k_end + TILE - 1) / TILE : 0;

  // lse in log2 units; a row past Lq gets +inf, so its p is exactly 0.
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse2[h] = row < Lq ? lse[base + row] * LOG2E : INFINITY;
    dlt[h] = row < Lq ? delta[base + row] : 0.f;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  hopper::mbar_wait(m.fix_full, 0);
  const uint32_t q_addr = hopper::smem_u32(m.fa) + wg * 64 * 128;
  const uint32_t do_addr = hopper::smem_u32(m.fb) + wg * 64 * 128;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = t * TILE;
    hopper::mbar_wait(&m.full[s], (t / STAGES) & 1);
    if (t < wg_tiles) {
      const uint32_t k_addr = hopper::smem_u32(m.ta + s * TILE_BYTES);
      const uint32_t v_addr = hopper::smem_u32(m.tb + s * TILE_BYTES);
      float sc[32], dp[32];
      two_products(sc, dp, q_addr, k_addr, do_addr, v_addr);   // S, dP
      // Mask only where the tile reaches this warpgroup's diagonal or the
      // end of K; ds overwrites s.
      const bool mask =
          (k0 + TILE > Lk) || (causal && k0 + TILE - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        float x = fmaf(sc[i], scale_log2, -lse2[h]);
        if (mask) {
          const int row = row0 + 8 * h;
          const int col = k0 + 8 * (i / 4) + col0 + i % 2;
          if ((causal && row < col) || col >= Lk) x = -INFINITY;
        }
        sc[i] = exp2f(x) * (dp[i] - dlt[h]) * scale;
      }
      uint32_t hi[16];
      if constexpr (F32_OUT) {
        uint32_t lo[16];
        pack_split(sc, hi, lo);
        hopper::wgmma_fence();
        tile_product(acc, hi, k_addr);   // dq += dS K, K MN-major
        tile_product(acc, lo, k_addr);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(lo);
      } else {
        pack(sc, hi);
        hopper::wgmma_fence();
        tile_product(acc, hi, k_addr);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(acc);
      hopper::fence_regs(hi);
    }
    release(&m.empty[s], lane);
  }
  store_rows<F32_OUT>(dq, base, row0, col0, Lq, acc);
}

// dk/dv: a CTA owns 128 k rows (with their v rows) and streams 64-row
// Q/dO tiles, with their lse and delta, from the diagonal on.  No producer
// warp: warp 0 stages each tile (TMA for Q and dO, 4-byte cp.async for lse
// and delta, all completing on the stage's full barrier) two tiles ahead,
// so every consumer thread keeps the 255 registers of a 256-thread CTA.
template <bool F32_OUT>
__global__ void __launch_bounds__(NCONS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dk,
                    void* __restrict__ dv, int Lq, int Lk, float scale,
                    float scale_log2, int causal) {
  constexpr int STAGES = DKV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Smem m = carve<STAGES>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * ROWS;   // the first k rows see the most q rows
  // Causal: q tiles wholly above the diagonal are skipped; the first that
  // reaches it starts at row k0 (k0 is a multiple of TILE).
  const int t0 = causal ? k0 / TILE : 0;
  const int n_tiles = max(0, (Lq + TILE - 1) / TILE - t0);
  const float* lse_b = lse + (size_t)bh * Lq;
  const float* delta_b = delta + (size_t)bh * Lq;

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool stager = tid < 32;

  // A stage's full barrier completes with warp 0's 32 cp.async arrivals
  // plus lane 0's arrival with the TMA bytes.
  if (tid == 0) init_barriers<STAGES>(m, 33);
  __syncthreads();

  // Tile i into stage i % STAGES.  Rows past Lq arrive as zeros (q, do,
  // lse, delta), so their p^T dO and ds^T q terms are exactly 0.
  auto stage_tile = [&](int i) {
    const int s = i % STAGES;
    const int qs0 = (t0 + i) * TILE;
    float* lse_s = m.rowv + s * 2 * TILE;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane + 32 * half;
      const bool in = qs0 + r < Lq;
      hopper::cp_async_4(lse_s + r, in ? lse_b + qs0 + r : lse_b, in ? 4 : 0);
      hopper::cp_async_4(lse_s + TILE + r, in ? delta_b + qs0 + r : delta_b,
                         in ? 4 : 0);
    }
    hopper::cp_async_mbar_arrive(&m.full[s]);
    if (lane == 0) {
      hopper::mbar_expect_tx(&m.full[s], 2 * TILE_BYTES);
      load_rows(m.ta + s * TILE_BYTES, &tq, &m.full[s], TILE_PANEL, qs0, bh);
      load_rows(m.tb + s * TILE_BYTES, &tdo, &m.full[s], TILE_PANEL, qs0,
                bh);
    }
  };

  if (stager) {
    if (lane == 0) {
      hopper::mbar_expect_tx(m.fix_full, 2 * FIX_BYTES);
      load_rows(m.fa, &tk, m.fix_full, FIX_PANEL, k0, bh);
      load_rows(m.fb, &tv, m.fix_full, FIX_PANEL, k0, bh);
    }
    for (int i = 0; i < min(STAGES - 1, n_tiles); ++i) stage_tile(i);
  }

  const int wg_k0 = k0 + wg * 64;
  const int krow0 = wg_k0 + warp * 16 + lane / 4;  // rows krow0, krow0+8
  const int col0 = 2 * (lane % 4);                 // + 8 j + e % 2
  const bool wg_live = wg_k0 < Lk;

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(m.fix_full, 0);
  const uint32_t k_addr = hopper::smem_u32(m.fa) + wg * 64 * 128;
  const uint32_t v_addr = hopper::smem_u32(m.fb) + wg * 64 * 128;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int qs0 = (t0 + i) * TILE;
    // Refill the stage tile i - 1 used with tile i + STAGES - 1 once every
    // warp has let go of it (the other warpgroup may be up to a tile
    // behind).
    if (stager && i + STAGES - 1 < n_tiles) {
      if (i >= 1)
        hopper::mbar_wait(&m.empty[(i - 1) % STAGES],
                          ((i - 1) / STAGES) & 1);
      stage_tile(i + STAGES - 1);
    }
    hopper::mbar_wait(&m.full[s], (i / STAGES) & 1);
    // Skip a tile wholly above this warpgroup's diagonal.
    if (wg_live && !(causal && qs0 + TILE - 1 < wg_k0)) {
      const uint32_t q_addr = hopper::smem_u32(m.ta + s * TILE_BYTES);
      const uint32_t do_addr = hopper::smem_u32(m.tb + s * TILE_BYTES);
      float st[32], dpt[32];
      two_products(st, dpt, k_addr, q_addr, v_addr, do_addr);  // S^T, dP^T
      // The fragment's column is the q row: its lse and delta come from
      // shared memory, two neighbouring columns at a time.
      const float* lse_s = m.rowv + s * 2 * TILE;
      const bool mask = causal && qs0 < wg_k0 + TILE - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + col0;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(lse_s + TILE + c);
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int idx = 4 * j + e4;
          const int e = e4 % 2;
          float x = fmaf(st[idx], scale_log2, -LOG2E * (e ? l2.y : l2.x));
          if (mask && qs0 + c + e < krow0 + 8 * (e4 / 2)) x = -INFINITY;
          const float p = exp2f(x);
          st[idx] = p;                                          // P^T
          dpt[idx] = p * (dpt[idx] - (e ? d2.y : d2.x)) * scale;  // dS^T
        }
      }
      uint32_t p_hi[16], ds_hi[16];
      if constexpr (F32_OUT) {
        uint32_t p_lo[16], ds_lo[16];
        pack_split(st, p_hi, p_lo);
        pack_split(dpt, ds_hi, ds_lo);
        hopper::wgmma_fence();
        tile_product(dv_acc, p_hi, do_addr);    // dv += P^T dO
        tile_product(dv_acc, p_lo, do_addr);
        tile_product(dk_acc, ds_hi, q_addr);    // dk += dS^T Q
        tile_product(dk_acc, ds_lo, q_addr);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(p_lo);
        hopper::fence_regs(ds_lo);
      } else {
        pack(st, p_hi);
        pack(dpt, ds_hi);
        hopper::wgmma_fence();
        tile_product(dv_acc, p_hi, do_addr);
        tile_product(dk_acc, ds_hi, q_addr);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(p_hi);
      hopper::fence_regs(ds_hi);
    }
    release(&m.empty[s], lane);
  }
  const size_t kbase = (size_t)bh * Lk;
  store_rows<F32_OUT>(dk, kbase, krow0, col0, Lk, dk_acc);
  store_rows<F32_OUT>(dv, kbase, krow0, col0, Lk, dv_acc);
}

template <bool F32_OUT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int lq,
              int lk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int e = hopper::bf16_map_3d(&tq, q, D, lq, bh, ROWS);
  if (!e) e = hopper::bf16_map_3d(&tdo, dout, D, lq, bh, ROWS);
  if (!e) e = hopper::bf16_map_3d(&tk, k, D, lk, bh, TILE);
  if (!e) e = hopper::bf16_map_3d(&tv, v, D, lk, bh, TILE);
  if (e) return e;
  auto kern = flash_bwd_dq_wgmma<F32_OUT>;
  constexpr int smem = smem_bytes<DQ_STAGES>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lq + ROWS - 1) / ROWS);
  kern<<<grid, DQ_NT, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dq, lq, lk, scale, scale * LOG2E,
      causal);
  return (int)cudaGetLastError();
}

template <bool F32_OUT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int lq, int lk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int e = hopper::bf16_map_3d(&tk, k, D, lk, bh, ROWS);
  if (!e) e = hopper::bf16_map_3d(&tv, v, D, lk, bh, ROWS);
  if (!e) e = hopper::bf16_map_3d(&tq, q, D, lq, bh, TILE);
  if (!e) e = hopper::bf16_map_3d(&tdo, dout, D, lq, bh, TILE);
  if (e) return e;
  auto kern = flash_bwd_dkv_wgmma<F32_OUT>;
  constexpr int smem = smem_bytes<DKV_STAGES>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lk + ROWS - 1) / ROWS);
  kern<<<grid, NCONS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, lq, lk, scale, scale * LOG2E,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------- f32: CUDA-core FMAs

namespace cuda_core {


constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int TS = D + 1;     // padded row stride of a D-wide tile: the
                              // column reads of the score loops stay off a
                              // single shared-memory bank

// dq pass: 64 q rows a block, 32 k rows a tile.
constexpr int DQ_BQ = 64;
constexpr int DQ_BK = 32;
constexpr int DQ_PS = DQ_BK + 1;
constexpr int DQ_SMEM_BYTES =
    (2 * DQ_BQ * TS + 2 * DQ_BK * TS + DQ_BQ * DQ_PS + 2 * DQ_BQ) *
    (int)sizeof(float);

// dk/dv pass: 64 k rows a block, 32 q rows a tile.
constexpr int KV_BK = 64;
constexpr int KV_BQ = 32;
constexpr int KV_PS = KV_BQ + 1;
constexpr int KV_SMEM_BYTES =
    (2 * KV_BK * TS + 2 * KV_BQ * TS + 2 * KV_BK * KV_PS + 2 * KV_BQ) *
    (int)sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [r0, r0 + rows) of a (len, D) matrix into a [rows][TS] f32 tile,
// zero past len.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int rows, int len) {
  for (int e = threadIdx.x; e < rows * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * TS + c] = r0 + r < len ? to_f32(src[(size_t)(r0 + r) * D + c])
                                   : 0.f;
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                    const Tin* __restrict__ v, const Tin* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, Tout* __restrict__ dq,
                    int Lq, int Lk, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // [DQ_BQ][TS]
  float* do_s = q_s + DQ_BQ * TS;      // [DQ_BQ][TS]
  float* k_s = do_s + DQ_BQ * TS;      // [DQ_BK][TS]
  float* v_s = k_s + DQ_BK * TS;       // [DQ_BK][TS]
  float* ds_s = v_s + DQ_BK * TS;      // [DQ_BQ][DQ_PS]
  float* lse_s = ds_s + DQ_BQ * DQ_PS;
  float* delta_s = lse_s + DQ_BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;
  const size_t bh = blockIdx.y;
  const Tin* kb = k + bh * Lk * D;
  const Tin* vb = v + bh * Lk * D;

  stage_rows(q_s, q + bh * Lq * D, q0, DQ_BQ, Lq);
  stage_rows(do_s, dout + bh * Lq * D, q0, DQ_BQ, Lq);
  if (tid < DQ_BQ) {
    const bool in = q0 + tid < Lq;
    lse_s[tid] = in ? lse[bh * Lq + q0 + tid] : 0.f;
    delta_s[tid] = in ? delta[bh * Lq + q0 + tid] : 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + DQ_BQ, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_tiles = (k_end + DQ_BK - 1) / DQ_BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * DQ_BK;
    __syncthreads();  // last tile's readers are done; q, do, lse are staged
    stage_rows(k_s, kb, k0, DQ_BK, Lk);
    stage_rows(v_s, vb, k0, DQ_BK, Lk);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = k_s[tx * TS + d], kc = k_s[(tx + 16) * TS + d];
      const float va = v_s[tx * TS + d], vc = v_s[(tx + 16) * TS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = q_s[(ty + 16 * i) * TS + d];
        const float ov = do_s[(ty + 16 * i) * TS + d];
        s[i][0] = fmaf(qv, ka, s[i][0]);
        s[i][1] = fmaf(qv, kc, s[i][1]);
        dp[i][0] = fmaf(ov, va, dp[i][0]);
        dp[i][1] = fmaf(ov, vc, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rl = ty + 16 * i;
        const int row = q0 + rl;
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && row < col) x = NEG_INF;
        // Past the end of K: weight exactly 0.
        const float p = col < Lk ? expf(x - lse_s[rl]) : 0.f;
        ds_s[rl * DQ_PS + tx + 16 * j] = p * (dp[i][j] - delta_s[rl]) * scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < DQ_BK; ++kk) {
      float kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = k_s[kk * TS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = ds_s[(ty + 16 * i) * DQ_PS + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(g, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    Tout* out = dq + (bh * Lq + row) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[tx + 16 * j] = from_f32<Tout>(acc[i][j]);
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                     const Tin* __restrict__ v, const Tin* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, Tout* __restrict__ dk,
                     Tout* __restrict__ dv, int Lq, int Lk, float scale,
                     int causal) {
  extern __shared__ float smem[];
  float* k_s = smem;                   // [KV_BK][TS]
  float* v_s = k_s + KV_BK * TS;       // [KV_BK][TS]
  float* q_s = v_s + KV_BK * TS;       // [KV_BQ][TS]
  float* do_s = q_s + KV_BQ * TS;      // [KV_BQ][TS]
  float* p_s = do_s + KV_BQ * TS;      // [KV_BK][KV_PS]  p^T
  float* ds_s = p_s + KV_BK * KV_PS;   // [KV_BK][KV_PS]  ds^T
  float* lse_s = ds_s + KV_BK * KV_PS;
  float* delta_s = lse_s + KV_BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * KV_BK;
  const size_t bh = blockIdx.y;
  const Tin* qb = q + bh * Lq * D;
  const Tin* ob = dout + bh * Lq * D;

  stage_rows(k_s, k + bh * Lk * D, k0, KV_BK, Lk);
  stage_rows(v_s, v + bh * Lk * D, k0, KV_BK, Lk);

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // Causal: q tiles wholly above the diagonal for this k tile are skipped;
  // the first tile that reaches it is the one holding row k0.
  const int t0 = causal ? k0 / KV_BQ : 0;
  const int n_tiles = (Lq + KV_BQ - 1) / KV_BQ;

  for (int t = t0; t < n_tiles; ++t) {
    const int qs0 = t * KV_BQ;
    __syncthreads();  // last tile's readers are done; K and V are staged
    stage_rows(q_s, qb, qs0, KV_BQ, Lq);
    stage_rows(do_s, ob, qs0, KV_BQ, Lq);
    if (tid < KV_BQ) {
      const bool in = qs0 + tid < Lq;
      lse_s[tid] = in ? lse[bh * Lq + qs0 + tid] : 0.f;
      delta_s[tid] = in ? delta[bh * Lq + qs0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T and dp^T: k rows ty + 16 i, q rows tx + 16 j.
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qa = q_s[tx * TS + d], qc = q_s[(tx + 16) * TS + d];
      const float oa = do_s[tx * TS + d], oc = do_s[(tx + 16) * TS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float kv = k_s[(ty + 16 * i) * TS + d];
        const float vv = v_s[(ty + 16 * i) * TS + d];
        s[i][0] = fmaf(qa, kv, s[i][0]);
        s[i][1] = fmaf(qc, kv, s[i][1]);
        dp[i][0] = fmaf(oa, vv, dp[i][0]);
        dp[i][1] = fmaf(oc, vv, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = ty + 16 * i;
        const int ql = tx + 16 * j;
        const int row = qs0 + ql;
        float x = s[i][j] * scale;
        if (causal && row < k0 + kl) x = NEG_INF;
        // Past the end of q: weight exactly 0.
        const float p = row < Lq ? expf(x - lse_s[ql]) : 0.f;
        p_s[kl * KV_PS + ql] = p;
        ds_s[kl * KV_PS + ql] = p * (dp[i][j] - delta_s[ql]) * scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < KV_BQ; ++qq) {
      float ov[8], qv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ov[j] = do_s[qq * TS + tx + 16 * j];
        qv[j] = q_s[qq * TS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * KV_PS + qq];
        const float g = ds_s[(ty + 16 * i) * KV_PS + qq];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dv_acc[i][j] = fmaf(p, ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(g, qv[j], dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Lk) continue;
    Tout* dkr = dk + (bh * Lk + row) * D;
    Tout* dvr = dv + (bh * Lk + row) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dkr[tx + 16 * j] = from_f32<Tout>(dk_acc[i][j]);
      dvr[tx + 16 * j] = from_f32<Tout>(dv_acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int lq,
              int lk, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<Tin, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lq + DQ_BQ - 1) / DQ_BQ, bh);
  kern<<<grid, NT, DQ_SMEM_BYTES, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const Tin*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<Tout*>(dq), lq, lk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int lq, int lk, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<Tin, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lk + KV_BK - 1) / KV_BK, bh);
  kern<<<grid, NT, KV_SMEM_BYTES, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const Tin*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<Tout*>(dk), static_cast<Tout*>(dv), lq, lk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

bool bad_args(int bh, int lq, int lk, int head_dim) {
  return head_dim != D || bh < 1 || bh > 65535 || lq < 1 || lk < 1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q and do (bh, lq, 128), k and v
// (bh, lk, 128) of the input type; lse and delta (bh, lq) float32; dq
// (bh, lq, 128) of the output type; all contiguous; for bf16 inputs q, k,
// v, do and dq 16-byte aligned (TMA, vector stores).  bf16 inputs run the
// wgmma kernel, f32 inputs the CUDA-core one.  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int tmpi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int lq,
                                 int lk, int head_dim, float scale, int causal,
                                 int in_dtype, int out_dtype, void* stream) {
  if (bad_args(bh, lq, lk, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    return tc::launch_dq<false>(q, k, v, dout, lse, delta, dq, bh, lq, lk,
                                scale, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return tc::launch_dq<true>(q, k, v, dout, lse, delta, dq, bh, lq, lk,
                               scale, causal, s);
  if (in_dtype == 0 && out_dtype == 0)
    return cuda_core::launch_dq<float, float>(q, k, v, dout, lse, delta, dq,
                                              bh, lq, lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return cuda_core::launch_dq<float, __nv_bfloat16>(
        q, k, v, dout, lse, delta, dq, bh, lq, lk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// As tmpi_flash_bwd_dq; dk and dv (bh, lk, 128) of the output type.
extern "C" int tmpi_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int lq, int lk, int head_dim,
                                  float scale, int causal, int in_dtype,
                                  int out_dtype, void* stream) {
  if (bad_args(bh, lq, lk, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    return tc::launch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, bh, lq,
                                 lk, scale, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return tc::launch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, bh, lq,
                                lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 0)
    return cuda_core::launch_dkv<float, float>(q, k, v, dout, lse, delta, dk,
                                               dv, bh, lq, lk, scale, causal,
                                               s);
  if (in_dtype == 0 && out_dtype == 1)
    return cuda_core::launch_dkv<float, __nv_bfloat16>(
        q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

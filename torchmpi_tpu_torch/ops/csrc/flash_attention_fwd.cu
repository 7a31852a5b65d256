// Flash-attention forward for Hopper (sm_90a), behind a plain C function
// that torchmpi_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces torchmpi_tpu/ops/flash_attention.py:36 (_attn_kernel), the
// Pallas online-softmax forward.  Same function, same algebra: scores
// s = (q . k) * scale, causal fill -1e30 where row < col, f32 running max m,
// denominator l and accumulator acc across k tiles, k tiles wholly above the
// diagonal skipped, o = acc / max(l, 1e-20) in the output type and
// lse = m + log(max(l, 1e-20)) in f32; columns past Lk carry no weight.
//
// One kernel, flash_fwd_wgmma, on the tensor cores for both input types,
// instantiated by an explicit dispatch on the types in tmpi_flash_fwd (no
// retry of one on another).  One CTA per (bh, 128-row q tile), heaviest
// causal tiles launched first: two consumer warpgroups of 64 q rows each
// and one producer warp.  The producer stages Q once and then each K and V
// tile with TMA (128-byte swizzle, zeros past the end of the sequence) into
// a two-stage ring of shared buffers tracked by full/empty mbarriers.  Each
// consumer forms S = Q K^T with wgmma (both operands in shared memory, f32
// accumulator in registers), runs the online softmax on the accumulator
// fragment (a row lives in the 4 threads of a quad: two xor-shuffles; exp2
// with scale * log2(e) folded in), masks only the tiles that reach the
// diagonal or the end of K, and feeds P from registers straight into the A
// operand of the second wgmma, O += P V, with V read MN-major through the
// transpose bit.  O stays in registers (64 x 128 f32 a warpgroup) and is
// written once, with lse.  l is summed from the f32 p.
//
// bf16 inputs (SPLIT = false): 128-row K/V tiles, S by m64n128k16; 161 KB
// of shared memory.  A bf16 P rounds each p by at most 2^-9 relative, so o
// moves by at most 2^-9 * sum(p |v|) / l <= 2^-9 max|v|, and on random data
// far less (the roundings have both signs).  For a bf16 output that is
// below the output's own rounding (2^-8 relative) and FlashAttention's
// choice; chip_smoke.py holds it at 1e-2 abs + 1e-2 rel.  An f32 output
// (the ring carry of flash_fwd_block, held at 2e-4 abs) would miss: a short
// causal row has p of order 1, so one rounding moves o by up to 2^-9 |v|,
// ~1e-2.  So with an f32 output P V is formed as two bf16 products,
// P_hi V + P_lo V with P_hi = bf16(p) and P_lo = bf16(p - P_hi), which
// keeps ~16 bits of p: an error of order 2^-17 |v|, ~1e-5.  q.k is exact
// per product (bf16 x bf16 in f32), so S differs from the reference by
// summation order only.
//
// f32 inputs (SPLIT = true): each of q, k and v arrives as its bf16 hi +
// lo split (bf16_split.cuh: one pre-pass launch for all three, made by the
// wrapper), and every product is three bf16 products,
//   S  = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T,
//   O += P_hi V_hi + P_hi V_lo + P_lo V_hi   (P split in registers),
// into the same f32 accumulators, which holds the f32 cases' 2e-4 for an
// f32 output (and the bf16 tolerance for a bf16 one).  Shared memory is the
// constraint: Q in hi and lo is 64 KB, and a 128-row K+V stage in hi and lo
// would be 128 KB, so two of them (256 KB) do not fit in 227 KB.  The split
// kernel takes 64-row K/V tiles in the same two-stage ring: 64 + 2 x 64 =
// 192 KB (193 KB with the alignment pad and barriers), one CTA an SM, and
// S by m64n64k16 (32 f32 a thread); a warpgroup skips the tiles wholly
// above its own rows.  The hi and lo halves of each operand lie in one
// buffer, (2, bh, L, 128), read through one TMA map whose outermost
// coordinate is bh for hi and bh + BH for lo.  Addresses for the 36
// products a tile are made opaque right before each wgmma, so the compiler
// holds no descriptor across the loop.
//
// Bound on an H100 at the generate path's shape (B=1, H=32, L=2048, D=128,
// causal, bf16): 2 products of 2 * 32 * 2,098,176 kept (q, k) pairs * 128 =
// 34.4 GFLOP, 35 us at the 989 TFLOP/s dense bf16 tensor-core rate, against
// about 67 MB of q/k/v/o, 20 us at 3.35 TB/s: bound by operations.  f32
// inputs: the least time for f32-accurate products on this card is three
// bf16 products at that rate, 104 us at the same shape (the CUDA cores' f32
// FMAs reach 67 TFLOP/s, 0.51 ms).
//
// What the design still leaves on the table: overlapping one tile's
// softmax with the next tile's S product (a second S accumulator, or the
// two warpgroups in ping-pong), register rebalancing (setmaxnreg) for
// larger tiles, a persistent schedule over the causal triangle, and for f32
// inputs splitting inside the kernel instead of a pre-pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_split.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;        // head size: every Llama geometry the repo names
constexpr float NEG_INF = -1e30f;

namespace tc {

constexpr int BQ = 128;             // q rows per CTA, 64 per warpgroup
constexpr int STAGES = 2;           // K/V ring depth
constexpr int NCONS = 256;          // two consumer warpgroups
constexpr int NT = NCONS + 32;      // plus one producer warp
constexpr int PANEL = 64;           // columns of one swizzled panel
constexpr int Q_PANEL = BQ * 128;   // bytes of a 64-column panel of Q
constexpr int Q_BYTES = 2 * Q_PANEL;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The tile geometry of each variant: bf16 inputs in one part, f32 inputs
// in two (hi, lo), with K/V tiles half as long to fit shared memory.
template <bool SPLIT>
struct Geo {
  static constexpr int PARTS = SPLIT ? 2 : 1;
  static constexpr int BKV = SPLIT ? 64 : 128;   // k/v rows per tile
  static constexpr int NS = BKV / 2;             // f32 of a thread's S
  static constexpr int KV_PANEL = BKV * 128;     // a 64-column panel of K or V
  static constexpr int KV_BYTES = 2 * KV_PANEL;  // one part of a K or V tile
  static constexpr int SMEM_BYTES =
      1024 + PARTS * Q_BYTES + STAGES * 2 * PARTS * KV_BYTES + 64;
};

// An address made opaque right before the wgmma that reads it (see the
// header); the bf16 variant leaves the compiler free, as before.
template <bool OPAQUE>
__device__ __forceinline__ void just_in_time(uint32_t& addr) {
  if constexpr (OPAQUE) asm volatile("" : "+r"(addr));
}

// s (64 x BKV f32 fragment) += Q rows [64 of q_addr] . K tile^T: 8 k16
// steps over D, two 64-column panels each of Q and K, both K-major.  With
// `first`, the first step overwrites s.
template <bool SPLIT>
__device__ __forceinline__ void s_issue(float (&s)[Geo<SPLIT>::NS],
                                        uint32_t q_addr, uint32_t k_addr,
                                        bool first) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // the k16 step within a panel
    uint32_t a = q_addr + (kk / 4) * Q_PANEL + off;
    uint32_t b = k_addr + (kk / 4) * Geo<SPLIT>::KV_PANEL + off;
    just_in_time<SPLIT>(a);
    just_in_time<SPLIT>(b);
    const uint64_t da = hopper::desc_sw128(a, 16, 1024);
    const uint64_t db = hopper::desc_sw128(b, 16, 1024);
    const int scale_d = first ? kk > 0 : 1;
    if constexpr (SPLIT) {
      hopper::wgmma_m64n64k16_ss<0>(s, da, db, scale_d);
    } else {
      hopper::wgmma_m64n128k16_ss<0>(s, da, db, scale_d);
    }
  }
}

// S = Q K^T: one product for bf16 inputs; for f32 inputs Q_hi K_hi^T +
// Q_hi K_lo^T + Q_lo K_hi^T, each part `q_part` / `k_part` bytes after the
// one before it.
template <bool SPLIT>
__device__ __forceinline__ void s_product(float (&s)[Geo<SPLIT>::NS],
                                          uint32_t q_addr, uint32_t k_addr,
                                          uint32_t q_part, uint32_t k_part) {
  hopper::wgmma_fence();
  s_issue<SPLIT>(s, q_addr, k_addr, true);
  if constexpr (SPLIT) {
    s_issue<SPLIT>(s, q_addr, k_addr + k_part, false);
    s_issue<SPLIT>(s, q_addr + q_part, k_addr, false);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
}

// P (the packed bf16 fragment of a 64 x BKV tile) into the A operands of
// the BKV/16 k16 steps: step t takes n8 blocks 2t and 2t+1 of the
// accumulator.
template <int NS>
__device__ __forceinline__ void pack_p(const float (&p)[NS],
                                       uint32_t (&a)[NS / 2]) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i)
    a[i] = hopper::pack_bf16(p[2 * i], p[2 * i + 1]);
}

// P_lo = bf16(p - P_hi): the part of p that bf16 dropped.
template <int NS>
__device__ __forceinline__ void pack_rest(const float (&p)[NS],
                                          const uint32_t (&hi)[NS / 2],
                                          uint32_t (&lo)[NS / 2]) {
  float rest[NS];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) {   // a bf16 is the top half of an f32
    rest[2 * i] = p[2 * i] - __uint_as_float(hi[i] << 16);
    rest[2 * i + 1] = p[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u);
  }
  pack_p<NS>(rest, lo);
}

// o (64 x 128 f32) += P . V tile: BKV/16 k16 steps over the tile's rows,
// V MN-major (its two 64-column panels KV_PANEL bytes apart).
template <bool SPLIT>
__device__ __forceinline__ void pv_issue(
    float (&o)[64], const uint32_t (&a)[Geo<SPLIT>::NS / 2], uint32_t v_addr) {
#pragma unroll
  for (int t = 0; t < Geo<SPLIT>::BKV / 16; ++t) {
    const uint32_t frag[4] = {a[4 * t], a[4 * t + 1], a[4 * t + 2],
                              a[4 * t + 3]};
    uint32_t b = v_addr + t * 16 * 128;
    just_in_time<SPLIT>(b);
    const uint64_t db =
        hopper::desc_sw128(b, Geo<SPLIT>::KV_PANEL, 1024);
    hopper::wgmma_m64n128k16_rs<1>(o, frag, db);
  }
}

// The producer's loads of `rows` rows of one tensor from row `row` of head
// bh, each of its PARTS parts (the lo part of head bh lies at bh + n_bh)
// `part_bytes` after the one before: two panels a part.
template <int PARTS>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* t,
                                          uint64_t* bar, int panel_bytes,
                                          int row, int bh, int n_bh) {
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
    uint8_t* part = dst + p * 2 * panel_bytes;
    hopper::tma_load_3d(part, t, bar, 0, row, bh + p * n_bh);
    hopper::tma_load_3d(part + panel_bytes, t, bar, PANEL, row,
                        bh + p * n_bh);
  }
}

template <bool F32_OUT, bool SPLIT>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, void* __restrict__ o,
                float* __restrict__ lse, int Lq, int Lk, float scale_log2,
                int causal) {
  using G = Geo<SPLIT>;
  constexpr int BKV = G::BKV;
  constexpr int NS = G::NS;
  constexpr int STAGE_BYTES = G::PARTS * G::KV_BYTES;   // K (or V) of a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align1024(smem_raw);          // [PARTS][Q_BYTES]
  uint8_t* k_s = q_s + G::PARTS * Q_BYTES;             // [STAGES][STAGE_BYTES]
  uint8_t* v_s = k_s + STAGES * STAGE_BYTES;           // [STAGES][STAGE_BYTES]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * STAGE_BYTES);
  uint64_t* full = q_full + 1;                         // [STAGES]
  uint64_t* empty = full + STAGES;                     // [STAGES]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int n_bh = gridDim.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int q_last = min(q0 + BQ, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_tiles = (k_end + BKV - 1) / BKV;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NCONS / 32);   // one arrive a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {               // the producer warp; one lane issues
    if (tid == NCONS) {
      hopper::mbar_expect_tx(q_full, G::PARTS * Q_BYTES);
      load_rows<G::PARTS>(q_s, &tq, q_full, Q_PANEL, q0, bh, n_bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * STAGE_BYTES);
        load_rows<G::PARTS>(k_s + s * STAGE_BYTES, &tk, &full[s],
                            G::KV_PANEL, t * BKV, bh, n_bh);
        load_rows<G::PARTS>(v_s + s * STAGE_BYTES, &tv, &full[s],
                            G::KV_PANEL, t * BKV, bh, n_bh);
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
  // The split variant's 64-row tiles: this warpgroup's k tiles, none past
  // its last row when causal, none at all when its rows all lie past Lq.
  // (With 128-row tiles a warpgroup's last tile always reaches its rows.)
  const int wg_k_end = causal ? min(Lk, min(wg_row0 + 64, Lq)) : Lk;
  const int wg_tiles = wg_row0 < Lq ? (wg_k_end + BKV - 1) / BKV : 0;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};   // this thread's share; the quad's sum at the end

  hopper::mbar_wait(q_full, 0);
  const uint32_t q_addr = hopper::smem_u32(q_s) + wg * 64 * 128;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = t * BKV;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);
    if constexpr (SPLIT) {
      if (t >= wg_tiles) {          // wholly above this warpgroup's rows
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        continue;
      }
    }
    float sc[NS];
    s_product<SPLIT>(sc, q_addr, hopper::smem_u32(k_s + s * STAGE_BYTES),
                     Q_BYTES, G::KV_BYTES);

    // Scale into log2 units; mask only where the tile reaches this
    // warpgroup's diagonal or the end of K.
    const bool mask = (k0 + BKV > Lk) || (causal && k0 + BKV - 1 > wg_row0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = sc[i] * scale_log2;
      if (mask) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int col = k0 + 8 * (i / 4) + col0 + i % 2;
        if (causal && row < col) x = NEG_INF;
        // Past the end of K: no weight at all (column 0 is in the first
        // tile, so m is finite and exp2(-inf - m) is exactly 0).
        if (col >= Lk) x = -INFINITY;
      }
      sc[i] = x;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = exp2f(sc[i] - m[h]);
      ls[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= corr[(i / 2) % 2];

    const uint32_t v_addr = hopper::smem_u32(v_s + s * STAGE_BYTES);
    uint32_t p_hi[NS / 2];
    pack_p<NS>(sc, p_hi);
    if constexpr (SPLIT || F32_OUT) {
      // Both halves of P are written before the one wgmma.fence that
      // orders these register writes before the products that read them.
      uint32_t p_lo[NS / 2];
      pack_rest<NS>(sc, p_hi, p_lo);
      hopper::wgmma_fence();
      pv_issue<SPLIT>(acc, p_hi, v_addr);
      if constexpr (SPLIT) pv_issue<SPLIT>(acc, p_hi, v_addr + G::KV_BYTES);
      pv_issue<SPLIT>(acc, p_lo, v_addr);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(p_lo);
    } else {
      hopper::wgmma_fence();
      pv_issue<SPLIT>(acc, p_hi, v_addr);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs(acc);
    hopper::fence_regs(p_hi);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-20f);
  }
  const size_t base = (size_t)bh * Lq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Lq) continue;
    const size_t off = (base + row) * D + col0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float a = acc[4 * j + 2 * h] / l[h];
      const float b = acc[4 * j + 2 * h + 1] / l[h];
      if constexpr (F32_OUT) {
        *reinterpret_cast<float2*>(static_cast<float*>(o) + off + 8 * j) =
            make_float2(a, b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(o) +
                                           off + 8 * j) =
            __floats2bfloat162_rn(a, b);
      }
    }
    if (lane % 4 == 0) lse[base + row] = m[h] * LN2 + logf(l[h]);
  }
}

template <bool F32_OUT, bool SPLIT>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int lq, int lk, float scale, int causal,
           cudaStream_t stream) {
  using G = Geo<SPLIT>;
  CUtensorMap tq, tk, tv;
  const int depth = G::PARTS * bh;   // hi heads, then lo heads
  int e = hopper::bf16_map_3d(&tq, q, D, lq, depth, BQ);
  if (!e) e = hopper::bf16_map_3d(&tk, k, D, lk, depth, G::BKV);
  if (!e) e = hopper::bf16_map_3d(&tv, v, D, lk, depth, G::BKV);
  if (e) return e;
  auto kern = flash_fwd_wgmma<F32_OUT, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lq + BQ - 1) / BQ);
  kern<<<grid, NT, G::SMEM_BYTES, stream>>>(tq, tk, tv, o,
                                            static_cast<float*>(lse), lq, lk,
                                            scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  o (bh, lq, 128) in the output
// type, lse (bh, lq) float32.  bf16 inputs: q (bh, lq, 128), k and v
// (bh, lk, 128).  f32 inputs reach this function as their bf16 hi + lo
// split (tmpi_bf16_split): q (2, bh, lq, 128), k and v (2, bh, lk, 128)
// bf16, hi first.  All contiguous and 16-byte aligned (TMA, vector
// stores).  Both run the wgmma kernel: bf16 in one product, f32 in three
// bf16 products.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int tmpi_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int lq, int lk,
                              int head_dim, float scale, int causal,
                              int in_dtype, int out_dtype, void* stream) {
  if (head_dim != D || bh < 1 || bh > 65535 || lq < 1 || lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    return tc::launch<false, false>(q, k, v, o, lse, bh, lq, lk, scale,
                                    causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return tc::launch<true, false>(q, k, v, o, lse, bh, lq, lk, scale,
                                   causal, s);
  if (in_dtype == 0 && out_dtype == 0)
    return tc::launch<true, true>(q, k, v, o, lse, bh, lq, lk, scale,
                                  causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return tc::launch<false, true>(q, k, v, o, lse, bh, lq, lk, scale,
                                   causal, s);
  return (int)cudaErrorInvalidValue;
}

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
// One tensor-core kernel for each pass, flash_bwd_dq_wgmma and
// flash_bwd_dkv_wgmma (namespace tc), instantiated for each input and output
// type by an explicit dispatch in the C entry points (no retry of one on
// another).  Both passes have one shape: a CTA owns 128 rows of one tensor
// pair, 64 per consumer warpgroup, and streams the other pair through a ring
// of tiles in shared memory (TMA, 128-byte swizzle, zeros past the end,
// full/empty mbarriers); one CTA an SM.
// - dq (flash_bwd_dq_wgmma): one CTA per (bh, 128 q rows), heaviest causal
//   tiles launched first; two consumer warpgroups and a producer warp (288
//   threads), a two-stage ring.  Q and dO come in once; K and V tiles
//   stream up to the diagonal.  Per tile each warpgroup forms S = Q K^T and
//   dP = dO V^T (wgmma, both operands K-major in shared memory, f32
//   accumulators in registers), then p and ds on the accumulator fragment
//   (exp2 with scale * log2(e) folded in; lse and delta are per row, two
//   registers a thread), masking only the tiles that reach the diagonal or
//   the end of K, and feeds ds from registers into dQ += dS K (m64n128k16,
//   K read MN-major through the transpose bit).
// - dk/dv (flash_bwd_dkv_wgmma): one CTA per (bh, 128 k rows), the first
//   k rows (the most q rows when causal) launched first.  K and V come in
//   once; Q and dO tiles stream from the diagonal on through a three-stage
//   ring, each with its lse and delta values (4-byte cp.async completing on
//   the same barrier).  Per tile each warpgroup forms S^T = K Q^T and
//   dP^T = V dO^T, then p^T and ds^T, reading lse and delta per fragment
//   column from shared memory, and feeds both from registers into
//   dV += P^T dO and dK += dS^T Q (dO and Q MN-major).  Tiles wholly above
//   a warpgroup's diagonal are skipped.  S^T, dP^T, dV and dK make up to
//   192 f32 a thread: beside a producer warp ptxas gives each of 288
//   threads 168 registers and spills, and setmaxnreg cannot lend a consumer
//   more than the CTA holds, so this CTA has no producer warp.  Its 256
//   threads get 255 registers each, and warp 0 stages each tile two tiles
//   ahead, once every warp has let go of the stage.
// Every wgmma's descriptors are formed just before it, so none is held in
// registers across the loop.
//
// Head size: a template parameter D of both kernels and their geometry,
// dispatched on head_dim in the C entry points, 128 (every Llama geometry
// the repo names) or 64 (ViT-B/16: d_model 768 over 12 heads).  A row of D
// bf16 is D / 64 swizzled 128-byte panels, so at D = 64 each own tensor
// and each streamed tile is one panel, S and dP take 4 k16 steps instead
// of 8, and dQ += dS K, dV += P^T dO and dK += dS^T Q are m64n64k16 from
// registers into 32 f32 a thread each instead of m64n128k16 into 64.  The
// tiling (128 own rows, 64- or 32-row streamed tiles, the rings' depths) is
// the same; shared memory is 66 KB (dq) and 83 KB (dk/dv) for bf16 inputs,
// 98 KB and 114 KB split.
//
// bf16 inputs (SPLIT = false): 64-row streamed tiles, S and dP by
// m64n64k16; shared memory 133 KB (dq) and 166 KB (dk/dv).  q.k and do.v
// are exact per product (bf16 x bf16 in f32), so s and dp differ from the
// reference by summation order only; p and ds are formed in f32.  The
// second-stage products take p and ds as bf16 A operands.  With a bf16
// output that rounding (2^-9 relative a term, of both signs) stays inside
// chip_smoke.py's 1e-2 abs + 1e-2 rel; with an f32 output (the ring carry
// of flash_bwd_block, held at 5e-4 abs + 1e-3 rel) it would not (3-7x over
// on causal rows with few keys, where p is of order 1), so each of those
// products is formed as two, P_hi X + P_lo X with P_hi = bf16(p) and
// P_lo = bf16(p - P_hi), which keeps ~16 bits of p and of ds (errors of
// order 1e-5), as the forward does.
//
// f32 inputs (SPLIT = true): each of q, k, v and do arrives as its bf16 hi
// + lo split (bf16_split.cuh: one pre-pass launch for all four, made once a
// backward call by the wrapper and read by both passes), and every product
// is three bf16 products into the same f32 accumulators,
//   S  = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T   (dP likewise from dO, V),
//   dQ += dS_hi K_hi + dS_hi K_lo + dS_lo K_hi      (dS split in registers),
//   dV += P_hi^T dO_hi + P_hi^T dO_lo + P_lo^T dO_hi,
//   dK += dS_hi^T Q_hi + dS_hi^T Q_lo + dS_lo^T Q_hi,
// which holds the f32 cases' 5e-4 abs + 1e-3 rel (and the bf16 tolerance
// for a bf16 output).  The hi and lo halves of each operand lie in one
// buffer, (2, bh, L, 128), read through one TMA map whose outermost
// coordinate is bh for hi and bh + BH for lo.  Shared memory is the
// constraint: the own rows in hi and lo are 128 KB (Q and dO, or K and V),
// and a 64-row streamed stage in hi and lo is 64 KB, so dq's two stages
// (256 KB) and dk/dv's three (320 KB) do not fit in 227 KB.  One stage of
// 64 rows would fit (192 KB) but gives up the overlap of a tile's copy with
// the products of the one before.  So the split kernels stream 32-row tiles
// in the same rings: 128 + 2 x 32 = 192 KB for dq (198,184 bytes with the
// alignment pad, lse/delta slots and barriers) and 128 + 3 x 32 = 224 KB
// for dk/dv (231,224 bytes of the 232,448 a block may have).  S and dP then
// come from m64n32k16 products (16 f32 a thread instead of 32), which gives
// dk/dv 32 registers back, and each second-stage product takes 2 k16 steps
// a part.  Accumulation: the tensor cores add each k16 step into the f32
// accumulator rounding toward zero, so the error grows with the number of
// steps; dq sums over Lk and dk/dv over Lq, 384 steps into one accumulator
// at L = 2048 (2 k16 steps x 3 products x 64 tiles), as many as B4's P V,
// and a numerics model of exactly that (test_torch_flash_attention.py)
// keeps both inside the f32 tolerance with no per-chunk sums.
//
// Bound on an H100 at the training path's shape (B=1, H=32, L=2048, D=128,
// causal, bf16): one product over the 2,098,176 causal (q, k) pairs of a
// head is 2 * 32 * 2098176 * 128 = 1.72e10 operations.  dq does three (s, dp,
// dq): 5.2e10, 52 us at the 989 TFLOP/s dense bf16 tensor-core rate; dk/dv
// does four (s, dp, dv, dk): 6.9e10, 70 us.  Their bytes (q, k, v, do read
// once, lse and delta, the outputs written once) are about 67 MB, 20 us at
// 3.35 TB/s: both passes are compute-bound.  f32 inputs: the least time for
// f32-accurate products on this card is three bf16 products at that rate,
// 156 us (dq) and 209 us (dk/dv) at the same shape (the CUDA cores' f32
// FMAs reach 67 TFLOP/s: 0.77 and 1.03 ms).
//
// What the design still leaves on the table: each warpgroup waits for
// its S and dP products before the exponentials and for its second-stage
// products before the next tile (only the other warpgroup overlaps them);
// the two-pass split forms s and dp twice (7 products against
// FlashAttention-2's 5, the price of no atomics); the f32-output variants
// double the second-stage products; the causal triangle is balanced only by
// launch order, not by a persistent schedule over the 132 SMs; and for f32
// inputs the split is a pre-pass over q, k, v and do rather than a step
// inside the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_split.cuh"
#include "hopper.cuh"

namespace {

namespace tc {

// Both passes share one shape: a CTA owns ROWS rows of one tensor pair (q
// and do for dq, k and v for dk/dv), 64 per consumer warpgroup, and streams
// the other pair through shared memory in tiles of Geo::TILE rows.
constexpr int ROWS = 128;             // the CTA's own rows, 64 a warpgroup
constexpr int DQ_STAGES = 2;          // depth of the streamed-tile rings
constexpr int DKV_STAGES = 3;
constexpr int NCONS = 256;            // two consumer warpgroups
constexpr int DQ_NT = NCONS + 32;     // dq: plus one producer warp
constexpr int PANEL = 64;             // columns of one swizzled panel
constexpr int FIX_PANEL = ROWS * 128; // bytes of a 64-column panel, own rows
constexpr float LOG2E = 1.4426950408889634f;

// The tile geometry of each variant: bf16 inputs in one part with 64-row
// streamed tiles, f32 inputs in two (hi, lo) with 32-row ones, to fit
// shared memory (see the header); the head size D (64 or 128) is one or
// two 64-column panels of every tile.
template <bool SPLIT, int D>
struct Geo {
  static_assert(D == 64 || D == 128, "head size 64 or 128");
  static constexpr int PARTS = SPLIT ? 2 : 1;
  static constexpr int PANELS = D / PANEL;        // 64-column panels of a row
  static constexpr int NO = D / 2;                // f32 of a thread's dQ/dK/dV
  static constexpr int FIX_BYTES = PANELS * FIX_PANEL;  // a part, own rows
  static constexpr int TILE = SPLIT ? 32 : 64;    // rows of a streamed tile
  static constexpr int NS = TILE / 2;             // f32 of a thread's S, dP
  static constexpr int TILE_PANEL = TILE * 128;   // a 64-column panel of it
  static constexpr int TILE_BYTES = PANELS * TILE_PANEL;  // a part of a tile
  static constexpr int STAGE_BYTES = PARTS * TILE_BYTES;
  template <int STAGES>
  static constexpr int smem_bytes() {
    return 1024 + 2 * PARTS * FIX_BYTES + STAGES * 2 * STAGE_BYTES +
           STAGES * 2 * TILE * 4 + 8 * (1 + 2 * STAGES);
  }
};
static_assert(Geo<true, 128>::smem_bytes<DKV_STAGES>() <= 232448,
              "the split dk/dv ring must fit a block's shared memory");

struct Smem {
  uint8_t* fa;       // own rows, first tensor (q or k)   [PARTS][FIX_BYTES]
  uint8_t* fb;       // own rows, second tensor (do or v) [PARTS][FIX_BYTES]
  uint8_t* ta;       // streamed, first (k or q)   [STAGES][STAGE_BYTES]
  uint8_t* tb;       // streamed, second (v or do) [STAGES][STAGE_BYTES]
  float* rowv;       // dk/dv: [STAGES][2][TILE] lse, delta
  uint64_t* fix_full;
  uint64_t* full;    // [STAGES]
  uint64_t* empty;   // [STAGES]
};

template <bool SPLIT, int D, int STAGES>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  using G = Geo<SPLIT, D>;
  Smem m;
  m.fa = hopper::align1024(raw);
  m.fb = m.fa + G::PARTS * G::FIX_BYTES;
  m.ta = m.fb + G::PARTS * G::FIX_BYTES;
  m.tb = m.ta + STAGES * G::STAGE_BYTES;
  m.rowv = reinterpret_cast<float*>(m.tb + STAGES * G::STAGE_BYTES);
  m.fix_full = reinterpret_cast<uint64_t*>(m.rowv + STAGES * 2 * G::TILE);
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

// x (64 x TILE f32 fragment) += A . B^T: A the warpgroup's 64 own rows, B a
// streamed tile, D / 16 k16 steps over D (four a panel), both K-major.
// With `first`, the first step overwrites x.
template <bool SPLIT, int D>
__device__ __forceinline__ void s_steps(float (&x)[Geo<SPLIT, D>::NS],
                                        uint32_t a0, uint32_t b0,
                                        bool first) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // the k16 step within a panel
    uint32_t a = a0 + (kk / 4) * FIX_PANEL + off;
    uint32_t b = b0 + (kk / 4) * Geo<SPLIT, D>::TILE_PANEL + off;
    just_in_time(a);
    just_in_time(b);
    const uint64_t da = hopper::desc_sw128(a, 16, 1024);
    const uint64_t db = hopper::desc_sw128(b, 16, 1024);
    const int scale_d = first ? kk > 0 : 1;
    if constexpr (SPLIT) {
      hopper::wgmma_m64n32k16_ss<0>(x, da, db, scale_d);
    } else {
      hopper::wgmma_m64n64k16_ss<0>(x, da, db, scale_d);
    }
  }
}

// x = A . B^T: one product for bf16 inputs; for f32 inputs A_hi B_hi^T +
// A_hi B_lo^T + A_lo B_hi^T, each lo part one part after its hi part.
template <bool SPLIT, int D>
__device__ __forceinline__ void s_product(float (&x)[Geo<SPLIT, D>::NS],
                                          uint32_t a, uint32_t b) {
  s_steps<SPLIT, D>(x, a, b, true);
  if constexpr (SPLIT) {
    s_steps<SPLIT, D>(x, a, b + Geo<SPLIT, D>::TILE_BYTES, false);
    s_steps<SPLIT, D>(x, a + Geo<SPLIT, D>::FIX_BYTES, b, false);
  }
}

// x = A1 . B1^T and y = A2 . B2^T (S and dP, or S^T and dP^T).
template <bool SPLIT, int D>
__device__ __forceinline__ void two_products(float (&x)[Geo<SPLIT, D>::NS],
                                             float (&y)[Geo<SPLIT, D>::NS],
                                             uint32_t a1, uint32_t b1,
                                             uint32_t a2, uint32_t b2) {
  hopper::wgmma_fence();
  s_product<SPLIT, D>(x, a1, b1);
  s_product<SPLIT, D>(y, a2, b2);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(x);
  hopper::fence_regs(y);
}

// A 64 x (N / 2) f32 fragment as the bf16 A operands of N / 8 k16 steps
// (step u takes n8 blocks 2u and 2u + 1); with `lo`, also the part bf16
// dropped.
template <int N>
__device__ __forceinline__ void pack(const float (&x)[N],
                                     uint32_t (&hi)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    hi[i] = hopper::pack_bf16(x[2 * i], x[2 * i + 1]);
}
template <int N>
__device__ __forceinline__ void pack_split(const float (&x)[N],
                                           uint32_t (&hi)[N / 2],
                                           uint32_t (&lo)[N / 2]) {
  pack<N>(x, hi);
  float rest[N];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {   // a bf16 is the top half of an f32
    rest[2 * i] = x[2 * i] - __uint_as_float(hi[i] << 16);
    rest[2 * i + 1] = x[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u);
  }
  pack<N>(rest, lo);
}

// acc (64 x D f32) += A (64 x TILE, from registers) . a streamed tile
// (TILE rows x D), read MN-major: TILE / 16 k16 steps over its rows, each
// m64n128k16 at D = 128 and m64n64k16 at D = 64.
template <bool SPLIT, int D>
__device__ __forceinline__ void tile_product(
    float (&acc)[D / 2], const uint32_t (&a)[Geo<SPLIT, D>::NS / 2],
    uint32_t tile_addr) {
#pragma unroll
  for (int u = 0; u < Geo<SPLIT, D>::TILE / 16; ++u) {
    const uint32_t frag[4] = {a[4 * u], a[4 * u + 1], a[4 * u + 2],
                              a[4 * u + 3]};
    uint32_t b = tile_addr + u * 16 * 128;
    just_in_time(b);
    hopper::wgmma_m64nNk16_rs<D, 1>(
        acc, frag, hopper::desc_sw128(b, Geo<SPLIT, D>::TILE_PANEL, 1024));
  }
}

// acc += X . T with X given as its bf16 hi and lo fragments: X_hi T + X_lo T
// for a bf16 tile; X_hi T_hi + X_hi T_lo + X_lo T_hi for a split one.
template <bool SPLIT, int D>
__device__ __forceinline__ void split_tile_product(
    float (&acc)[D / 2], const uint32_t (&hi)[Geo<SPLIT, D>::NS / 2],
    const uint32_t (&lo)[Geo<SPLIT, D>::NS / 2], uint32_t tile_addr) {
  tile_product<SPLIT, D>(acc, hi, tile_addr);
  if constexpr (SPLIT)
    tile_product<SPLIT, D>(acc, hi, tile_addr + Geo<SPLIT, D>::TILE_BYTES);
  tile_product<SPLIT, D>(acc, lo, tile_addr);
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

// The loads of one tensor's rows [row, row + box) of head bh, each of its
// PARTS parts (the lo part of head bh lies at bh + n_bh) one part after the
// one before: PANELS panels of `panel_bytes` a part.
template <int PARTS, int PANELS>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* t,
                                          uint64_t* bar, int panel_bytes,
                                          int row, int bh, int n_bh) {
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
    uint8_t* part = dst + p * PANELS * panel_bytes;
#pragma unroll
    for (int c = 0; c < PANELS; ++c)
      hopper::tma_load_3d(part + c * panel_bytes, t, bar, c * PANEL, row,
                          bh + p * n_bh);
  }
}

// A consumer warp is done with a stage.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty);
}

// Rows of a 64 x D f32 accumulator fragment to memory: d[4j + 2h + e] is
// row row0 + 8h, column 8j + col0 + e; rows at or past `len` are not
// written.
template <bool F32_OUT, int D>
__device__ __forceinline__ void store_rows(void* out, size_t base, int row0,
                                           int col0, int len,
                                           const float (&d)[D / 2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= len) continue;
    const size_t off = (base + row) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
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
// streams K/V tiles up to the diagonal.
template <bool F32_OUT, bool SPLIT, int D>
__global__ void __launch_bounds__(DQ_NT, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, void* __restrict__ dq,
                   int Lq, int Lk, float scale, float scale_log2,
                   int causal) {
  using G = Geo<SPLIT, D>;
  constexpr int TILE = G::TILE;
  constexpr int NS = G::NS;
  constexpr int NO = G::NO;
  constexpr int STAGES = DQ_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Smem m = carve<SPLIT, D, STAGES>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int n_bh = gridDim.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heaviest first
  const int q_last = min(q0 + ROWS, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_tiles = (k_end + TILE - 1) / TILE;

  if (tid == 0) init_barriers<STAGES>(m, 1);
  __syncthreads();

  if (tid >= NCONS) {               // the producer warp; one lane issues
    if (tid == NCONS) {
      hopper::mbar_expect_tx(m.fix_full, 2 * G::PARTS * G::FIX_BYTES);
      load_rows<G::PARTS, G::PANELS>(m.fa, &tq, m.fix_full, FIX_PANEL, q0,
                                     bh, n_bh);
      load_rows<G::PARTS, G::PANELS>(m.fb, &tdo, m.fix_full, FIX_PANEL, q0,
                                     bh, n_bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&m.empty[s], (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(&m.full[s], 2 * G::STAGE_BYTES);
        load_rows<G::PARTS, G::PANELS>(m.ta + s * G::STAGE_BYTES, &tk,
                                       &m.full[s], G::TILE_PANEL, t * TILE,
                                       bh, n_bh);
        load_rows<G::PARTS, G::PANELS>(m.tb + s * G::STAGE_BYTES, &tv,
                                       &m.full[s], G::TILE_PANEL, t * TILE,
                                       bh, n_bh);
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
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  hopper::mbar_wait(m.fix_full, 0);
  const uint32_t q_addr = hopper::smem_u32(m.fa) + wg * 64 * 128;
  const uint32_t do_addr = hopper::smem_u32(m.fb) + wg * 64 * 128;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = t * TILE;
    hopper::mbar_wait(&m.full[s], (t / STAGES) & 1);
    if (t < wg_tiles) {
      const uint32_t k_addr = hopper::smem_u32(m.ta + s * G::STAGE_BYTES);
      const uint32_t v_addr = hopper::smem_u32(m.tb + s * G::STAGE_BYTES);
      float sc[NS], dp[NS];
      two_products<SPLIT, D>(sc, dp, q_addr, k_addr, do_addr,
                             v_addr);                       // S, dP
      // Mask only where the tile reaches this warpgroup's diagonal or the
      // end of K; ds overwrites s.
      const bool mask =
          (k0 + TILE > Lk) || (causal && k0 + TILE - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int h = (i / 2) % 2;
        float x = fmaf(sc[i], scale_log2, -lse2[h]);
        if (mask) {
          const int row = row0 + 8 * h;
          const int col = k0 + 8 * (i / 4) + col0 + i % 2;
          if ((causal && row < col) || col >= Lk) x = -INFINITY;
        }
        sc[i] = exp2f(x) * (dp[i] - dlt[h]) * scale;
      }
      uint32_t hi[NS / 2];
      if constexpr (SPLIT || F32_OUT) {
        uint32_t lo[NS / 2];
        pack_split<NS>(sc, hi, lo);
        hopper::wgmma_fence();
        split_tile_product<SPLIT, D>(acc, hi, lo, k_addr);  // dq += dS K
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(lo);
      } else {
        pack<NS>(sc, hi);
        hopper::wgmma_fence();
        tile_product<SPLIT, D>(acc, hi, k_addr);   // K MN-major
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(acc);
      hopper::fence_regs(hi);
    }
    release(&m.empty[s], lane);
  }
  store_rows<F32_OUT, D>(dq, base, row0, col0, Lq, acc);
}

// dk/dv: a CTA owns 128 k rows (with their v rows) and streams Q/dO tiles,
// with their lse and delta, from the diagonal on.  No producer warp: warp
// 0 stages each tile (TMA for Q and dO, 4-byte cp.async for lse and delta,
// all completing on the stage's full barrier) two tiles ahead, so every
// consumer thread keeps the 255 registers of a 256-thread CTA.
template <bool F32_OUT, bool SPLIT, int D>
__global__ void __launch_bounds__(NCONS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dk,
                    void* __restrict__ dv, int Lq, int Lk, float scale,
                    float scale_log2, int causal) {
  using G = Geo<SPLIT, D>;
  constexpr int TILE = G::TILE;
  constexpr int NS = G::NS;
  constexpr int NO = G::NO;
  constexpr int STAGES = DKV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Smem m = carve<SPLIT, D, STAGES>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int n_bh = gridDim.x;
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
    for (int half = 0; half < TILE / 32; ++half) {
      const int r = lane + 32 * half;
      const bool in = qs0 + r < Lq;
      hopper::cp_async_4(lse_s + r, in ? lse_b + qs0 + r : lse_b, in ? 4 : 0);
      hopper::cp_async_4(lse_s + TILE + r, in ? delta_b + qs0 + r : delta_b,
                         in ? 4 : 0);
    }
    hopper::cp_async_mbar_arrive(&m.full[s]);
    if (lane == 0) {
      hopper::mbar_expect_tx(&m.full[s], 2 * G::STAGE_BYTES);
      load_rows<G::PARTS, G::PANELS>(m.ta + s * G::STAGE_BYTES, &tq,
                                     &m.full[s], G::TILE_PANEL, qs0, bh,
                                     n_bh);
      load_rows<G::PARTS, G::PANELS>(m.tb + s * G::STAGE_BYTES, &tdo,
                                     &m.full[s], G::TILE_PANEL, qs0, bh,
                                     n_bh);
    }
  };

  if (stager) {
    if (lane == 0) {
      hopper::mbar_expect_tx(m.fix_full, 2 * G::PARTS * G::FIX_BYTES);
      load_rows<G::PARTS, G::PANELS>(m.fa, &tk, m.fix_full, FIX_PANEL, k0,
                                     bh, n_bh);
      load_rows<G::PARTS, G::PANELS>(m.fb, &tv, m.fix_full, FIX_PANEL, k0,
                                     bh, n_bh);
    }
    for (int i = 0; i < min(STAGES - 1, n_tiles); ++i) stage_tile(i);
  }

  const int wg_k0 = k0 + wg * 64;
  const int krow0 = wg_k0 + warp * 16 + lane / 4;  // rows krow0, krow0+8
  const int col0 = 2 * (lane % 4);                 // + 8 j + e % 2
  const bool wg_live = wg_k0 < Lk;

  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
      const uint32_t q_addr = hopper::smem_u32(m.ta + s * G::STAGE_BYTES);
      const uint32_t do_addr = hopper::smem_u32(m.tb + s * G::STAGE_BYTES);
      float st[NS], dpt[NS];
      two_products<SPLIT, D>(st, dpt, k_addr, q_addr, v_addr,
                             do_addr);                       // S^T, dP^T
      // The fragment's column is the q row: its lse and delta come from
      // shared memory, two neighbouring columns at a time.  Mask where the
      // tile's first q row lies above the warpgroup's last k row.
      const float* lse_s = m.rowv + s * 2 * TILE;
      const bool mask = causal && qs0 < wg_k0 + 64 - 1;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
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
      uint32_t p_hi[NS / 2], ds_hi[NS / 2];
      if constexpr (SPLIT || F32_OUT) {
        uint32_t p_lo[NS / 2], ds_lo[NS / 2];
        pack_split<NS>(st, p_hi, p_lo);
        pack_split<NS>(dpt, ds_hi, ds_lo);
        hopper::wgmma_fence();
        split_tile_product<SPLIT, D>(dv_acc, p_hi, p_lo,
                                     do_addr);               // P^T dO
        split_tile_product<SPLIT, D>(dk_acc, ds_hi, ds_lo,
                                     q_addr);                // dS^T Q
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(p_lo);
        hopper::fence_regs(ds_lo);
      } else {
        pack<NS>(st, p_hi);
        pack<NS>(dpt, ds_hi);
        hopper::wgmma_fence();
        tile_product<SPLIT, D>(dv_acc, p_hi, do_addr);   // dv += P^T dO
        tile_product<SPLIT, D>(dk_acc, ds_hi, q_addr);   // dk += dS^T Q
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
  store_rows<F32_OUT, D>(dk, kbase, krow0, col0, Lk, dk_acc);
  store_rows<F32_OUT, D>(dv, kbase, krow0, col0, Lk, dv_acc);
}

// The launches.  bf16 inputs: q, k, v, do (bh, L, D) bf16.  f32 inputs
// (SPLIT): their (2, bh, L, D) bf16 splits, read through maps of depth
// 2 bh (hi heads, then lo heads).
template <bool F32_OUT, bool SPLIT, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int lq,
              int lk, float scale, int causal, cudaStream_t stream) {
  using G = Geo<SPLIT, D>;
  const int depth = G::PARTS * bh;
  CUtensorMap tq, tk, tv, tdo;
  int e = hopper::bf16_map_3d(&tq, q, D, lq, depth, ROWS);
  if (!e) e = hopper::bf16_map_3d(&tdo, dout, D, lq, depth, ROWS);
  if (!e) e = hopper::bf16_map_3d(&tk, k, D, lk, depth, G::TILE);
  if (!e) e = hopper::bf16_map_3d(&tv, v, D, lk, depth, G::TILE);
  if (e) return e;
  auto kern = flash_bwd_dq_wgmma<F32_OUT, SPLIT, D>;
  constexpr int smem = G::template smem_bytes<DQ_STAGES>();
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

template <bool F32_OUT, bool SPLIT, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int lq, int lk, float scale, int causal, cudaStream_t stream) {
  using G = Geo<SPLIT, D>;
  const int depth = G::PARTS * bh;
  CUtensorMap tq, tk, tv, tdo;
  int e = hopper::bf16_map_3d(&tk, k, D, lk, depth, ROWS);
  if (!e) e = hopper::bf16_map_3d(&tv, v, D, lk, depth, ROWS);
  if (!e) e = hopper::bf16_map_3d(&tq, q, D, lq, depth, G::TILE);
  if (!e) e = hopper::bf16_map_3d(&tdo, dout, D, lq, depth, G::TILE);
  if (e) return e;
  auto kern = flash_bwd_dkv_wgmma<F32_OUT, SPLIT, D>;
  constexpr int smem = G::template smem_bytes<DKV_STAGES>();
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

// The explicit dispatch of each pass on the input and output types at
// head size D.
template <int D>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int bh, int lq,
                int lk, float scale, int causal, int in_dtype, int out_dtype,
                cudaStream_t s) {
  if (in_dtype == 1 && out_dtype == 1)
    return launch_dq<false, false, D>(q, k, v, dout, lse, delta, dq, bh, lq,
                                      lk, scale, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_dq<true, false, D>(q, k, v, dout, lse, delta, dq, bh, lq,
                                     lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_dq<true, true, D>(q, k, v, dout, lse, delta, dq, bh, lq,
                                    lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_dq<false, true, D>(q, k, v, dout, lse, delta, dq, bh, lq,
                                     lk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int bh, int lq, int lk, float scale,
                 int causal, int in_dtype, int out_dtype, cudaStream_t s) {
  if (in_dtype == 1 && out_dtype == 1)
    return launch_dkv<false, false, D>(q, k, v, dout, lse, delta, dk, dv, bh,
                                       lq, lk, scale, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_dkv<true, false, D>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      lq, lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_dkv<true, true, D>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     lq, lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_dkv<false, true, D>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      lq, lk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

bool bad_args(int bh, int lq, int lk, int head_dim) {
  return (head_dim != 64 && head_dim != 128) || bh < 1 || bh > 65535 ||
         lq < 1 || lk < 1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; head_dim D is 64 or 128.  lse
// and delta (bh, lq) float32; dq (bh, lq, D) of the output type.  bf16
// inputs: q and do (bh, lq, D), k and v (bh, lk, D).  f32 inputs reach
// this function as their bf16 hi + lo split (tmpi_bf16_split): q and do
// (2, bh, lq, D), k and v (2, bh, lk, D) bf16, hi first.  All contiguous
// and 16-byte aligned (TMA, vector stores).  Both run the wgmma kernel:
// bf16 in one product, f32 in three bf16 products.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int tmpi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int lq,
                                 int lk, int head_dim, float scale, int causal,
                                 int in_dtype, int out_dtype, void* stream) {
  if (bad_args(bh, lq, lk, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return tc::dispatch_dq<64>(q, k, v, dout, lse, delta, dq, bh, lq, lk,
                               scale, causal, in_dtype, out_dtype, s);
  return tc::dispatch_dq<128>(q, k, v, dout, lse, delta, dq, bh, lq, lk,
                              scale, causal, in_dtype, out_dtype, s);
}

// As tmpi_flash_bwd_dq; dk and dv (bh, lk, D) of the output type.
extern "C" int tmpi_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int lq, int lk, int head_dim,
                                  float scale, int causal, int in_dtype,
                                  int out_dtype, void* stream) {
  if (bad_args(bh, lq, lk, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return tc::dispatch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk,
                                scale, causal, in_dtype, out_dtype, s);
  return tc::dispatch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk,
                               scale, causal, in_dtype, out_dtype, s);
}

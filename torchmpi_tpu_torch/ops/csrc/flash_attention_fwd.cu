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
// Two kernels, chosen by an explicit dispatch on the input type in
// tmpi_flash_fwd (no retry of one on the other):
//
// bf16 inputs: tensor cores (flash_fwd_wgmma).  One CTA per (bh, 128-row q
// tile), heaviest causal tiles launched first: two consumer warpgroups of 64
// q rows each and one producer warp.  The producer stages Q once and then
// each 128-row K and V tile with TMA (128-byte swizzle, zeros past the end
// of the sequence) into a two-stage ring of shared buffers tracked by
// full/empty mbarriers.  Each consumer forms S = Q K^T with wgmma
// (m64n128k16, both operands in shared memory, f32 accumulator in
// registers), runs the online softmax on the accumulator fragment (a row
// lives in the 4 threads of a quad: two xor-shuffles; exp2 with
// scale * log2(e) folded in), masks only the tiles that reach the diagonal
// or the end of K, and feeds P from registers straight into the A operand
// of the second wgmma, O += P V, with V read MN-major through the transpose
// bit.  O stays in registers (64 x 128 f32 a warpgroup) and is written
// once, with lse.  l is summed from the f32 p.
//
// Numerics of the bf16 path.  The TPU kernel keeps p in f32 for P V.  A
// bf16 P rounds each p by at most 2^-9 relative, so o moves by at most
// 2^-9 * sum(p |v|) / l <= 2^-9 max|v|, and on random data far less (the
// roundings have both signs).  For a bf16 output that is below the output's
// own rounding (2^-8 relative) and FlashAttention's choice; chip_smoke.py
// holds it at 1e-2 abs + 1e-2 rel.  An f32 output (the ring carry of
// flash_fwd_block, held at 2e-4 abs) would miss: a short causal row has p
// of order 1, so one rounding moves o by up to 2^-9 |v|, ~1e-2.  So with an
// f32 output P V is formed as two bf16 products, P_hi V + P_lo V with
// P_hi = bf16(p) and P_lo = bf16(p - P_hi), which keeps ~16 bits of p: an
// error of order 2^-17 |v|, ~1e-5.  q.k is exact per product (bf16 x bf16
// in f32), so S differs from the reference by summation order only.
//
// f32 inputs: CUDA cores (flash_fwd_f32), the first port's kernel.  One
// block of 256 threads per (bh, 64-row q tile); the q tile in shared memory
// for the whole loop; each 32-row K/V tile staged in shared memory; S in
// registers, the row softmax through shared memory, P V into a 64 x 128 f32
// accumulator in registers; every product an f32 FMA (no TF32, which would
// break the f32 cases' 2e-4).
//
// Bound on an H100 at the generate path's shape (B=1, H=32, L=2048, D=128,
// causal, bf16): 2 products of 2 * 32 * 2,098,176 kept (q, k) pairs * 128 =
// 34.4 GFLOP, 35 us at the 989 TFLOP/s dense bf16 tensor-core rate, against
// about 67 MB of q/k/v/o, 20 us at 3.35 TB/s: bound by operations.  In f32
// without tensor cores the floor is the 67 TFLOP/s FMA rate, 0.51 ms.
//
// What the bf16 design still leaves on the table: overlapping one tile's
// softmax with the next tile's S product (a second S accumulator, or the
// two warpgroups in ping-pong), register rebalancing (setmaxnreg) for
// larger tiles, and a persistent schedule over the causal triangle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 128;        // head size: every Llama geometry the repo names
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------- bf16: wgmma (sm_90a)

namespace tc {

constexpr int BQ = 128;             // q rows per CTA, 64 per warpgroup
constexpr int BKV = 128;            // k/v rows per tile
constexpr int STAGES = 2;           // K/V ring depth
constexpr int NCONS = 256;          // two consumer warpgroups
constexpr int NT = NCONS + 32;      // plus one producer warp
constexpr int PANEL = 64;           // columns of one swizzled panel
constexpr int Q_PANEL = BQ * 128;   // bytes of a 64-column panel of Q
constexpr int KV_PANEL = BKV * 128; // ... of K or V
constexpr int Q_BYTES = 2 * Q_PANEL;
constexpr int KV_BYTES = 2 * KV_PANEL;
constexpr int SMEM_BYTES = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// S (64 x 128 f32 fragment) = Q rows [64 of q_addr] . K tile^T: 8 k16 steps
// over D, two 64-column panels each of Q and K, both K-major.
__device__ __forceinline__ void s_product(float (&s)[64], uint32_t q_addr,
                                          uint32_t k_addr) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // the k16 step within a panel
    const uint64_t da =
        hopper::desc_sw128(q_addr + (kk / 4) * Q_PANEL + off, 16, 1024);
    const uint64_t db =
        hopper::desc_sw128(k_addr + (kk / 4) * KV_PANEL + off, 16, 1024);
    hopper::wgmma_m64n128k16_ss<0>(s, da, db, kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
}

// P (the packed bf16 fragment of a 64 x 128 tile) into the A operands of
// the 8 k16 steps: step t takes n8 blocks 2t and 2t+1 of the accumulator.
__device__ __forceinline__ void pack_p(const float (&p)[64],
                                       uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    a[i] = hopper::pack_bf16(p[2 * i], p[2 * i + 1]);
}

// o (64 x 128 f32) += P . V tile: 8 k16 steps over the tile's rows, V
// MN-major (its two 64-column panels KV_PANEL bytes apart).
__device__ __forceinline__ void pv_issue(float (&o)[64],
                                         const uint32_t (&a)[32],
                                         uint32_t v_addr) {
#pragma unroll
  for (int t = 0; t < BKV / 16; ++t) {
    const uint32_t frag[4] = {a[4 * t], a[4 * t + 1], a[4 * t + 2],
                              a[4 * t + 3]};
    const uint64_t db =
        hopper::desc_sw128(v_addr + t * 16 * 128, KV_PANEL, 1024);
    hopper::wgmma_m64n128k16_rs<1>(o, frag, db);
  }
}

// The producer's loads of one K and one V tile (two panels each).
__device__ __forceinline__ void load_kv(uint8_t* k_dst, uint8_t* v_dst,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint64_t* bar,
                                        int row, int bh) {
  hopper::mbar_expect_tx(bar, 2 * KV_BYTES);
  hopper::tma_load_3d(k_dst, tk, bar, 0, row, bh);
  hopper::tma_load_3d(k_dst + KV_PANEL, tk, bar, PANEL, row, bh);
  hopper::tma_load_3d(v_dst, tv, bar, 0, row, bh);
  hopper::tma_load_3d(v_dst + KV_PANEL, tv, bar, PANEL, row, bh);
}

template <bool F32_OUT>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, void* __restrict__ o,
                float* __restrict__ lse, int Lq, int Lk, float scale_log2,
                int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align1024(smem_raw);
  uint8_t* k_s = q_s + Q_BYTES;                  // [STAGES][KV_BYTES]
  uint8_t* v_s = k_s + STAGES * KV_BYTES;        // [STAGES][KV_BYTES]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * KV_BYTES);
  uint64_t* full = q_full + 1;                   // [STAGES]
  uint64_t* empty = full + STAGES;               // [STAGES]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
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
      hopper::mbar_expect_tx(q_full, Q_BYTES);
      hopper::tma_load_3d(q_s, &tq, q_full, 0, q0, bh);
      hopper::tma_load_3d(q_s + Q_PANEL, &tq, q_full, PANEL, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        load_kv(k_s + s * KV_BYTES, v_s + s * KV_BYTES, &tk, &tv, &full[s],
                t * BKV, bh);
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
    float sc[64];
    s_product(sc, q_addr, hopper::smem_u32(k_s + s * KV_BYTES));

    // Scale into log2 units; mask only where the tile reaches this
    // warpgroup's diagonal or the end of K.
    const bool mask = (k0 + BKV > Lk) || (causal && k0 + BKV - 1 > wg_row0);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
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
    for (int i = 0; i < 64; ++i)
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
    for (int i = 0; i < 64; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = exp2f(sc[i] - m[h]);
      ls[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= corr[(i / 2) % 2];

    const uint32_t v_addr = hopper::smem_u32(v_s + s * KV_BYTES);
    uint32_t p_hi[32];
    pack_p(sc, p_hi);
    if constexpr (F32_OUT) {
      // P_lo = bf16(p - P_hi): the part of p that bf16 dropped.  Both
      // halves are written before the one wgmma.fence that orders these
      // register writes before the products that read them.
      float rest[64];
#pragma unroll
      for (int i = 0; i < 32; ++i) {   // a bf16 is the top half of an f32
        rest[2 * i] = sc[2 * i] - __uint_as_float(p_hi[i] << 16);
        rest[2 * i + 1] =
            sc[2 * i + 1] - __uint_as_float(p_hi[i] & 0xffff0000u);
      }
      uint32_t p_lo[32];
      pack_p(rest, p_lo);
      hopper::wgmma_fence();
      pv_issue(acc, p_hi, v_addr);
      pv_issue(acc, p_lo, v_addr);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(p_lo);
    } else {
      hopper::wgmma_fence();
      pv_issue(acc, p_hi, v_addr);
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

template <bool F32_OUT>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int lq, int lk, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = hopper::bf16_map_3d(&tq, q, D, lq, bh, BQ);
  if (!e) e = hopper::bf16_map_3d(&tk, k, D, lk, bh, BKV);
  if (!e) e = hopper::bf16_map_3d(&tv, v, D, lk, bh, BKV);
  if (e) return e;
  auto kern = flash_fwd_wgmma<F32_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lq + BQ - 1) / BQ);
  kern<<<grid, NT, SMEM_BYTES, stream>>>(tq, tk, tv, o,
                                         static_cast<float*>(lse), lq, lk,
                                         scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------- f32: CUDA-core FMAs

namespace cuda_core {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 32;        // k rows per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int QS = D + 1;     // padded strides keep the column reads of the
constexpr int KS = D + 1;     // score loop and the row reads of the P V loop
constexpr int PS = BK + 1;    // off a single shared-memory bank

constexpr int SMEM_FLOATS = BQ * QS + BK * KS + BK * D + BQ * PS + 3 * BQ;
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename Tout>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, Tout* __restrict__ o,
              float* __restrict__ lse, int Lq, int Lk, float scale,
              int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][QS]
  float* k_s = q_s + BQ * QS;      // [BK][KS]
  float* v_s = k_s + BK * KS;      // [BK][D]
  float* p_s = v_s + BK * D;       // [BQ][PS] scores, then probabilities
  float* row_m = p_s + BQ * PS;    // running max
  float* row_l = row_m + BQ;       // running denominator
  float* row_c = row_l + BQ;       // this tile's exp(m_prev - m_new)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * Lq * D;
  const float* kb = k + bh * Lk * D;
  const float* vb = v + bh * Lk * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    q_s[r * QS + c] = q0 + r < Lq ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // last tile's readers are done; q_s and rows are set
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Lk;
      const size_t g = (size_t)(k0 + r) * D + c;
      k_s[r * KS + c] = in ? kb[g] : 0.f;
      v_s[r * D + c] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float ka = k_s[tx * KS + d];
      const float kc = k_s[(tx + 16) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = q_s[(ty + 16 * i) * QS + d];
        s[i][0] = fmaf(qv, ka, s[i][0]);
        s[i][1] = fmaf(qv, kc, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = q0 + ty + 16 * i;
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && row < col) x = NEG_INF;
        // Past the end of K: no weight at all (column 0 is always in range,
        // so the running max is finite and exp(-inf - m) is exactly 0).
        if (col >= Lk) x = -INFINITY;
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = x;
      }
    __syncthreads();

    {
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, p_s[r * PS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(p_s[r * PS + c] - m_new);
        p_s[r * PS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = row_c[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = v_s[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * PS + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty + 16 * i;
    const int row = q0 + rl;
    if (row >= Lq) continue;
    const float l = fmaxf(row_l[rl], 1e-20f);
    Tout* orow = o + (bh * Lq + row) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) orow[tx + 16 * j] = from_f32<Tout>(acc[i][j] / l);
    if (tx == 0) lse[bh * Lq + row] = row_m[rl] + logf(l);
  }
}

template <typename Tout>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int lq, int lk, float scale, int causal,
           cudaStream_t stream) {
  auto kern = flash_fwd_f32<Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lq + BQ - 1) / BQ, bh);
  kern<<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<Tout*>(o),
      static_cast<float*>(lse), lq, lk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q (bh, lq, 128), k and v
// (bh, lk, 128), o (bh, lq, 128), lse (bh, lq) float32, all contiguous; for
// bf16 inputs q, k, v 16-byte aligned (TMA).  bf16 inputs run the wgmma
// kernel, f32 inputs the CUDA-core one.  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int tmpi_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int lq, int lk,
                              int head_dim, float scale, int causal,
                              int in_dtype, int out_dtype, void* stream) {
  if (head_dim != D || bh < 1 || bh > 65535 || lq < 1 || lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    return tc::launch<false>(q, k, v, o, lse, bh, lq, lk, scale, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return tc::launch<true>(q, k, v, o, lse, bh, lq, lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 0)
    return cuda_core::launch<float>(q, k, v, o, lse, bh, lq, lk, scale,
                                    causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return cuda_core::launch<__nv_bfloat16>(q, k, v, o, lse, bh, lq, lk,
                                            scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

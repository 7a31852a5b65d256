// Flash-attention forward for Hopper (sm_90a), behind a plain C function
// that torchmpi_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces torchmpi_tpu/ops/flash_attention.py:_attn_kernel, the Pallas
// online-softmax forward.  Same function, same algebra: scores
// s = (q . k) * scale, causal fill -1e30 where row < col, f32 running max m,
// denominator l and accumulator acc across k tiles, k tiles wholly above the
// diagonal skipped, o = acc / max(l, 1e-20) in the output type and
// lse = m + log(max(l, 1e-20)) in f32.
//
// Design.  One CUDA block of 256 threads per (bh, 64-row q tile); the TPU's
// sequential k grid axis becomes a loop inside the block.  The q tile stays
// in shared memory for the whole loop; each 32-row K/V tile is staged in
// shared memory, S = Q K^T is formed in registers (4 x 2 scores a thread)
// and parked in shared memory for the row softmax (four lanes a row), and
// P V is accumulated into the 64 x 128 f32 accumulator held in registers
// (4 x 8 a thread).  o and lse are written once, at the end.  Inputs of either
// type are widened to f32 as they are loaded and every product and sum is an
// f32 FMA on the CUDA cores (no tensor cores, no TF32), so bf16 inputs get
// exactly the arithmetic the TPU kernel does after its casts; only the
// summation order differs.  Causal q tiles are launched heaviest first.
//
// Bound on an H100 at the generate path's shape (B=1, H=32, L=2048, D=128,
// causal, bf16): about 2*B*H*L^2*D = 34.4 GFLOP, 35 us at the 989 TFLOP/s
// dense bf16 tensor-core rate, against about 67 MB of q/k/v/o, 20 us at
// 3.35 TB/s: compute-bound.  In f32 without tensor cores the floor is the
// 67 TFLOP/s FMA rate, 0.51 ms.
//
// What this simple design leaves on the table: the tensor cores (wgmma or
// mma.sync on bf16 with f32 accumulation, the only road to the bf16 bound),
// asynchronous copies (TMA or cp.async) that overlap the next K/V tile's load
// with this tile's math, larger tiles fed by a producer warp, and a persistent
// schedule that balances the causal triangle across the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 128;        // head size: every Llama geometry the repo names
constexpr int BQ = 64;        // q rows per block
constexpr int BK = 32;        // k rows per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int QS = D + 1;     // padded strides keep the column reads of the
constexpr int KS = D + 1;     // score loop and the row reads of the P V loop
constexpr int PS = BK + 1;    // off a single shared-memory bank
constexpr float NEG_INF = -1e30f;

constexpr int SMEM_FLOATS = BQ * QS + BK * KS + BK * D + BQ * PS + 3 * BQ;
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                 const Tin* __restrict__ v, Tout* __restrict__ o,
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
  const Tin* qb = q + bh * Lq * D;
  const Tin* kb = k + bh * Lk * D;
  const Tin* vb = v + bh * Lk * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    q_s[r * QS + c] =
        q0 + r < Lq ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
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
      k_s[r * KS + c] = in ? to_f32(kb[g]) : 0.f;
      v_s[r * D + c] = in ? to_f32(vb[g]) : 0.f;
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

template <typename Tin, typename Tout>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int lq, int lk, float scale, int causal,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<Tin, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lq + BQ - 1) / BQ, bh);
  kern<<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<Tout*>(o),
      static_cast<float*>(lse), lq, lk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q (bh, lq, 128), k and v
// (bh, lk, 128), o (bh, lq, 128), lse (bh, lq) float32, all contiguous.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int tmpi_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int lq, int lk,
                              int head_dim, float scale, int causal,
                              int in_dtype, int out_dtype, void* stream) {
  if (head_dim != D || bh < 1 || bh > 65535 || lq < 1 || lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(q, k, v, o, lse, bh, lq, lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, o, lse, bh, lq, lk, scale,
                                        causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, o, lse, bh, lq, lk, scale,
                                        causal, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, lse, bh, lq, lk,
                                                scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

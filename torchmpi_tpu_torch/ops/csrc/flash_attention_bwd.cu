// Flash-attention backward for Hopper (sm_90a): the dq pass and the dk/dv
// pass, behind two plain C functions that
// torchmpi_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces the two Pallas kernels of torchmpi_tpu/ops/flash_attention.py's
// _flash_bh_bwd: _attn_bwd_dq_kernel (dq) and _attn_bwd_dkv_kernel (dk, dv).
// Same function, same algebra, from the forward's saved log-sum-exp and
// delta = rowsum(do * o) (computed by the caller in f32):
//   s  = (q . k) * scale, causal fill -1e30 where row < col,
//   p  = exp(s - lse),   dp = do . v,   ds = p * (dp - delta) * scale,
//   dq = sum_k ds k,     dk = sum_q ds^T q,   dv = sum_q p^T do.
//
// Design.  Two passes and no atomics, as on the TPU: each output row is
// summed by exactly one block in a fixed order, so the gradients are
// deterministic from run to run.
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
// Both write their outputs once, at the end.  Inputs of either type are
// widened to f32 as they are loaded and every product and sum is an f32 FMA
// on the CUDA cores (no tensor cores, no TF32): bf16 inputs get the TPU
// kernels' own arithmetic after their casts; only the summation order
// differs.  Rows past the end of q and keys past the end of k carry weight
// exactly 0, so any lengths are taken, Lk != Lq included.  Shared memory:
// 108,032 bytes (dq) and 116,224 bytes (dk/dv) a block, above the 48 KB
// default, so each launch raises the kernel's dynamic limit first.
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
// What this simple design leaves on the table: the tensor cores (wgmma or
// mma.sync on bf16 with f32 accumulation, the only road to the bf16
// bound), asynchronous copies (TMA or cp.async) that overlap the next
// tile's load with this tile's math, larger tiles fed by a producer warp,
// s and dp recomputed once for both passes instead of twice (the TPU split
// buys freedom from atomics at the price of one extra s and dp), and a
// persistent schedule that balances the causal triangle across the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 128;        // head size: every Llama geometry the repo names
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int TS = D + 1;     // padded row stride of a D-wide tile: the
                              // column reads of the score loops stay off a
                              // single shared-memory bank
constexpr float NEG_INF = -1e30f;

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

bool bad_args(int bh, int lq, int lk, int head_dim) {
  return head_dim != D || bh < 1 || bh > 65535 || lq < 1 || lk < 1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q and do (bh, lq, 128), k and v
// (bh, lk, 128) of the input type; lse and delta (bh, lq) float32; dq
// (bh, lq, 128) of the output type; all contiguous.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int tmpi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int lq,
                                 int lk, int head_dim, float scale, int causal,
                                 int in_dtype, int out_dtype, void* stream) {
  if (bad_args(bh, lq, lk, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_dq<float, float>(q, k, v, dout, lse, delta, dq, bh, lq, lk,
                                   scale, causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_dq<float, __nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh,
                                           lq, lk, scale, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_dq<__nv_bfloat16, float>(q, k, v, dout, lse, delta, dq, bh,
                                           lq, lk, scale, causal, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_dq<__nv_bfloat16, __nv_bfloat16>(q, k, v, dout, lse, delta,
                                                   dq, bh, lq, lk, scale,
                                                   causal, s);
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
  if (in_dtype == 0 && out_dtype == 0)
    return launch_dkv<float, float>(q, k, v, dout, lse, delta, dk, dv, bh, lq,
                                    lk, scale, causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_dkv<float, __nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                            bh, lq, lk, scale, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_dkv<__nv_bfloat16, float>(q, k, v, dout, lse, delta, dk, dv,
                                            bh, lq, lk, scale, causal, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_dkv<__nv_bfloat16, __nv_bfloat16>(q, k, v, dout, lse, delta,
                                                    dk, dv, bh, lq, lk, scale,
                                                    causal, s);
  return (int)cudaErrorInvalidValue;
}

// 3x3 stride-1 "same" convolution for Hopper (sm_90a), behind a plain C
// function that torchmpi_tpu_torch/ops/conv3x3.py binds with ctypes.
//
// Replaces benchmarks/pallas_conv_bench.py:_conv_kernel (called through
// pallas_conv3x3), the Pallas shifted-window convolution.  Same function,
// same algebra: x (N, H, W, C) NHWC, w (3, 3, C, Cout) HWIO read as
// (9, C, Cout), out (N, H, W, Cout) in x's type, where
//   out[n, i, j, :] = sum over (di, dj) of x[n, i+di-1, j+dj-1, :] @ w[di*3+dj]
// with x zero outside the image, every product and sum in f32 after both
// operands are widened (the TPU kernel's casts), and one cast on store.
//
// Design: an implicit GEMM.  The N*H*W output pixels are the rows, Cout the
// columns and 9*C the reduction.  One CUDA block of 256 threads owns a
// 64-pixel x 64-channel output tile and loops over the 9 taps and, within a
// tap, over C in chunks of 16: it stages the shifted input window (64
// pixels x 16 channels, the halo read as zeros here, so the caller pads
// nothing) and the filter slice (16 x 64) in shared memory as f32, and each
// thread accumulates a 4 x 4 sub-tile in f32 registers with FMAs on the CUDA
// cores.  The output is written once, cast on store.  As in the TPU kernel,
// no (N*H*W, 9*C) patch matrix is ever written to device memory.
//
// Bound on an H100 at the bench's shapes (bf16, x (128, 7, 7, 512) with w
// (3, 3, 512, 512), and x (128, 14, 14, 256) with w (3, 3, 256, 256)):
// 2*N*H*W*9*C*Cout = 29.6 GFLOP each, 30 us at the 989 TFLOP/s dense bf16
// tensor-core rate, against 18-27 MB of x, w and out, 5-8 us at 3.35 TB/s:
// bound by operations.  This kernel's own floor is the 67 TFLOP/s f32 FMA
// rate, 0.44 ms.
//
// What this simple design leaves on the table: the tensor cores (mma.sync
// or wgmma on bf16 with f32 accumulation; a bf16 product is exact in f32,
// so only the summation order would change), asynchronous copies (cp.async
// or TMA) that overlap the next chunk's load with this chunk's math, and
// larger tiles per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // input channels per staged chunk
constexpr int NT = 256;       // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int PAD = 4;        // row padding of the shared tiles

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

template <typename T>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int N, int H, int W, int C, int Cout) {
  __shared__ float a_s[BK][BM + PAD];   // window, channel-major
  __shared__ float b_s[BK][BN + PAD];   // filter slice

  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // The window element this thread stages: pixel row ar of the tile,
  // channels ak .. ak+3 of the chunk.
  const int ar = tid / 4;
  const int ak = (tid % 4) * 4;
  const long long m = m0 + ar;
  const bool m_in = m < M;
  int pn = 0, ph = 0, pw = 0;
  if (m_in) {
    pn = (int)(m / ((long long)H * W));
    const int rem = (int)(m % ((long long)H * W));
    ph = rem / W;
    pw = rem % W;
  }
  // The filter elements it stages: reduction row bk, channels bn .. bn+3.
  const int bk = tid / 16;
  const int bn = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int ih = ph + tap / 3 - 1;
    const int iw = pw + tap % 3 - 1;
    const bool a_in = m_in && ih >= 0 && ih < H && iw >= 0 && iw < W;
    const size_t x_off =
        a_in ? (((size_t)pn * H + ih) * W + iw) * (size_t)C : 0;
    const T* wtap = w + (size_t)tap * C * Cout;
    for (int c0 = 0; c0 < C; c0 += BK) {
      __syncthreads();  // the last chunk's readers are done
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + ak + j;
        a_s[ak + j][ar] = (a_in && c < C) ? to_f32(x[x_off + c]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + bk;
        const int co = n0 + bn + j;
        b_s[bk][bn + j] = (c < C && co < Cout)
                              ? to_f32(wtap[(size_t)c * Cout + co]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = b_s[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Cout) out[row * Cout + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int n, int h, int wd,
           int c, int cout, cudaStream_t stream) {
  const long long m = (long long)n * h * wd;
  dim3 grid((unsigned)((m + BM - 1) / BM), (cout + BN - 1) / BN);
  conv3x3_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), n, h, wd, c, cout);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x, w and out alike.
// x (n, h, w, c), w (3, 3, c, cout), out (n, h, w, cout), all contiguous.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int tmpi_conv3x3(const void* x, const void* w, void* out, int n,
                            int h, int wd, int c, int cout, int dtype,
                            void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || cout < 1 ||
      (cout + BN - 1) / BN > 65535 ||
      ((long long)n * h * wd + BM - 1) / BM > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, n, h, wd, c, cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, n, h, wd, c, cout, s);
  return (int)cudaErrorInvalidValue;
}

// 3x3 stride-1 "same" convolution for Hopper (sm_90a), behind a plain C
// function that torchmpi_tpu_torch/ops/conv3x3.py binds with ctypes.
//
// Replaces benchmarks/pallas_conv_bench.py:52 (_conv_kernel, called through
// pallas_conv3x3), the Pallas shifted-window convolution.  Same function,
// same algebra: x (N, H, W, C) NHWC, w (3, 3, C, Cout) HWIO read as
// (9, C, Cout), out (N, H, W, Cout) in x's type, where
//   out[n, i, j, :] = sum over (di, dj) of x[n, i+di-1, j+dj-1, :] @ w[di*3+dj]
// with x zero outside the image, every product and sum in f32 after both
// operands are widened (the TPU kernel's casts), and one cast on store.  As
// in the TPU kernel, no (N*H*W, 9*C) patch matrix is ever written to device
// memory: both kernels read the shifted window, the halo as zeros, straight
// from x, so the caller pads nothing.
//
// Both kernels are implicit GEMMs: the M = N*H*W output pixels are the
// rows, Cout the columns and K = 9*C the reduction.  tmpi_conv3x3 picks one
// by an explicit dispatch on the type (no retry of one on the other):
//
// bf16: tensor cores (conv3x3_wgmma).  A 128-pixel x 128-channel output
// tile per CTA, two warpgroups of 64 pixels each; the reduction in chunks of
// 64 channels of one tap, through a 3-stage ring of shared buffers.  All 256
// threads stage each chunk with cp.async in 16-byte pieces (8 channels),
// zero-filling (src-size 0) the halo, rows past M and channels past C, into
// the 128-byte-swizzled layout the wgmma descriptors name: the window A (128
// x 64) K-major, the filter slice B (64 x 128, a plain box of w as (9*C,
// Cout)) MN-major through the transpose bit.  A piece that is not whole
// (C or Cout not a multiple of 8, or a base that is not 16-byte aligned)
// takes masked element loads instead, so any C and Cout are taken.  Each
// warpgroup runs 4 wgmma m64n128k16 a chunk into a 64 x 128 f32 accumulator
// in registers while the next two chunks' copies are in flight; the output
// is cast and written once.  bf16 x bf16 is exact in f32, so only the
// summation order differs from the reference.
//
// Waves: 96 KB of shared memory and at most 128 registers a thread let two
// CTAs share an SM, 264 slots on the 132 SMs.  The bench's 7x7 shape
// (M = 6,272, Cout 512) is 49 x 4 = 196 CTAs, all resident at once, and the
// 14x14 shape (M = 25,088, Cout 256) 196 x 2 = 392, a wave and a half; a
// persistent schedule (or split-K for the 7x7 shape) is left for later.
//
// f32: CUDA cores (conv3x3_f32), the first port's kernel.  A 64-pixel x
// 64-channel tile per block of 256 threads, the reduction in 16-channel
// chunks staged in shared memory as f32, a 4 x 4 sub-tile of FMAs a thread
// (no TF32: f32 stays f32).
//
// Bound on an H100 at the bench's shapes (bf16, x (128, 7, 7, 512) with w
// (3, 3, 512, 512), and x (128, 14, 14, 256) with w (3, 3, 256, 256)):
// 2*N*H*W*9*C*Cout = 29.6 GFLOP each, 30 us at the 989 TFLOP/s dense bf16
// tensor-core rate, against 18-27 MB of x, w and out, 5-8 us at 3.35 TB/s:
// bound by operations.  The f32 kernel's floor is the 67 TFLOP/s FMA rate,
// 0.44 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------- bf16: wgmma (sm_90a)

namespace tc {

constexpr int BM = 128;                  // output pixels per CTA
constexpr int BN = 128;                  // output channels per CTA
constexpr int BK = 64;                   // channels of one tap per chunk
constexpr int STAGES = 3;
constexpr int NT = 256;                  // two warpgroups
constexpr int A_BYTES = BM * BK * 2;     // 16 KB: 128 rows of 128 bytes
constexpr int B_PANEL = BK * 128;        // 8 KB: 64 k rows x 64 channels
constexpr int B_BYTES = 2 * B_PANEL;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES;

// Byte offset of 16-byte piece `p` of row `r` in a swizzled 128-byte-row
// panel.
__device__ __forceinline__ uint32_t swz(int r, int p) {
  return r * 128 + ((p ^ (r & 7)) << 4);
}

// Eight elements into a 16-byte piece of shared memory, each read only
// where ok(e) holds and zero elsewhere: the path for pieces that are not
// whole or not aligned.
template <typename Ok>
__device__ __forceinline__ void load_piece_masked(uint8_t* dst,
                                                  const __nv_bfloat16* src,
                                                  Ok ok) {
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = ok(e) ? src[e] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

__global__ void __launch_bounds__(NT, 2)
conv3x3_wgmma(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              __nv_bfloat16* __restrict__ out, int N, int H, int W, int C,
              int Cout, int vec_a, int vec_b) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);

  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int nc = (C + BK - 1) / BK;      // chunks per tap
  const int n_chunks = 9 * nc;

  // The window pieces this thread stages: piece ap (channels 8 ap .. 8 ap
  // + 7 of the chunk) of tile rows ar + 32 i.
  const int ap = tid % 8;
  const int ar = tid / 8;
  long long a_m[4];
  int a_h[4], a_w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ar + 32 * i;
    a_m[i] = m < M ? m : -1;
    const long long rem = m < M ? m % ((long long)H * W) : 0;
    a_h[i] = (int)(rem / W);
    a_w[i] = (int)(rem % W);
  }
  // The filter pieces: piece bp (output channels 8 bp .. 8 bp + 7 of the
  // tile) of reduction rows br + 16 i.
  const int bp = tid % 16;
  const int br = tid / 16;

  auto load_chunk = [&](int chunk, int stage) {
    uint8_t* a_s = smem + stage * STAGE_BYTES;
    uint8_t* b_s = a_s + A_BYTES;
    const int tap = chunk / nc;
    const int c0 = (chunk % nc) * BK;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const int c = c0 + ap * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ar + 32 * i;
      const int ih = a_h[i] + dh, iw = a_w[i] + dw;
      const bool in = a_m[i] >= 0 && ih >= 0 && ih < H && iw >= 0 &&
                      iw < W && c < C;
      // Nothing is read outside x: a piece wholly out points at x itself.
      const __nv_bfloat16* src =
          x + (in ? (a_m[i] + (long long)dh * W + dw) * C + c : 0);
      uint8_t* dst = a_s + swz(r, ap);
      if (vec_a) {   // C % 8 == 0: a piece is wholly in or out
        hopper::cp_async_16(dst, src, in ? 16 : 0);
      } else {
        load_piece_masked(dst, src, [&](int e) { return in && c + e < C; });
      }
    }
    const int col = n0 + bp * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = br + 16 * i;
      const int ck = c0 + kr;
      const bool in = ck < C && col < Cout;
      const __nv_bfloat16* src =
          w + (in ? ((long long)tap * C + ck) * Cout + col : 0);
      uint8_t* dst = b_s + (bp / 8) * B_PANEL + swz(kr, bp % 8);
      if (vec_b) {   // Cout % 8 == 0
        hopper::cp_async_16(dst, src, in ? 16 : 0);
      } else {
        load_piece_masked(dst, src,
                          [&](int e) { return in && col + e < Cout; });
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    hopper::cp_async_commit();
  }

  const int wg = tid / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    hopper::cp_async_wait<STAGES - 2>();   // chunk i's pieces have landed
    hopper::fence_proxy_async();
    __syncthreads();   // ... everyone's; and chunk i-1's products are done
    const int next = i + STAGES - 1;
    if (next < n_chunks) load_chunk(next, next % STAGES);
    hopper::cp_async_commit();

    const uint8_t* a_s = smem + (i % STAGES) * STAGE_BYTES;
    const uint32_t a_addr = hopper::smem_u32(a_s) + wg * 64 * 128;
    const uint32_t b_addr = hopper::smem_u32(a_s + A_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = hopper::desc_sw128(a_addr + ks * 32, 16, 1024);
      const uint64_t db =
          hopper::desc_sw128(b_addr + ks * 16 * 128, B_PANEL, 1024);
      hopper::wgmma_m64n128k16_ss<1>(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }

  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const long long row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool pairs = Cout % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 8 * h;
    if (row >= M) continue;
    __nv_bfloat16* orow = out + row * Cout;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < Cout) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(a, b);
      } else {
        if (col < Cout) orow[col] = __float2bfloat16(a);
        if (col + 1 < Cout) orow[col + 1] = __float2bfloat16(b);
      }
    }
  }
}

int launch(const void* x, const void* w, void* out, int n, int h, int wd,
           int c, int cout, cudaStream_t stream) {
  const long long m = (long long)n * h * wd;
  const int vec_a = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_b = cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((m + BM - 1) / BM), (cout + BN - 1) / BN);
  conv3x3_wgmma<<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), n, h, wd, c, cout, vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------- f32: CUDA-core FMAs

namespace cuda_core {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // input channels per staged chunk
constexpr int NT = 256;       // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int PAD = 4;        // row padding of the shared tiles

__global__ void __launch_bounds__(NT)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, int N, int H, int W, int C, int Cout) {
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
    const float* wtap = w + (size_t)tap * C * Cout;
    for (int c0 = 0; c0 < C; c0 += BK) {
      __syncthreads();  // the last chunk's readers are done
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + ak + j;
        a_s[ak + j][ar] = (a_in && c < C) ? x[x_off + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + bk;
        const int co = n0 + bn + j;
        b_s[bk][bn + j] =
            (c < C && co < Cout) ? wtap[(size_t)c * Cout + co] : 0.f;
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
      if (col < Cout) out[row * Cout + col] = acc[i][j];
    }
  }
}

int launch(const void* x, const void* w, void* out, int n, int h, int wd,
           int c, int cout, cudaStream_t stream) {
  const long long m = (long long)n * h * wd;
  dim3 grid((unsigned)((m + BM - 1) / BM), (cout + BN - 1) / BN);
  conv3x3_f32<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), n, h, wd, c, cout);
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x, w and out alike.
// x (n, h, w, c), w (3, 3, c, cout), out (n, h, w, cout), all contiguous.
// bf16 runs the wgmma kernel, f32 the CUDA-core one.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int tmpi_conv3x3(const void* x, const void* w, void* out, int n,
                            int h, int wd, int c, int cout, int dtype,
                            void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || cout < 1 ||
      (cout + 63) / 64 > 65535 ||
      ((long long)n * h * wd + 63) / 64 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cuda_core::launch(x, w, out, n, h, wd, c, cout, s);
  if (dtype == 1) return tc::launch(x, w, out, n, h, wd, c, cout, s);
  return (int)cudaErrorInvalidValue;
}

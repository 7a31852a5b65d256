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
// memory: the kernel reads the shifted window, the halo as zeros, straight
// from x, so the caller pads nothing.
//
// One kernel, conv3x3_wgmma, on the tensor cores for both types,
// instantiated by an explicit dispatch on the type in tmpi_conv3x3 (no
// retry of one on the other).  An implicit GEMM: the M = N*H*W output
// pixels are the rows, Cout the columns and K = 9*C the reduction.  A
// 128-pixel x 128-channel output tile per CTA, two warpgroups of 64 pixels
// each; the reduction in chunks of 64 channels of one tap, through a
// 3-stage ring of shared buffers.  All 256 threads stage each chunk with
// cp.async in 16-byte pieces (8 channels), zero-filling (src-size 0) the
// halo, rows past M and channels past C, into the 128-byte-swizzled layout
// the wgmma descriptors name: the window A (128 x 64) K-major, the filter
// slice B (64 x 128, a plain box of w as (9*C, Cout)) MN-major through the
// transpose bit.  A piece that is not whole (C or Cout not a multiple of 8,
// or a base that is not 16-byte aligned) takes masked element loads
// instead, so any C and Cout are taken.  Each warpgroup runs its wgmma
// m64n128k16 products a chunk into a 64 x 128 f32 accumulator in registers
// while the next two chunks' copies are in flight; the output is cast (or
// not) and written once.
//
// bf16 (SPLIT = false): 4 products a chunk.  bf16 x bf16 is exact in f32,
// so only the summation order differs from the reference.  A stage is 32
// KB; 96 KB of shared memory and at most 128 registers a thread let two
// CTAs share an SM, 264 slots on the 132 SMs.
//
// f32 (SPLIT = true): x and w arrive as their bf16 hi + lo split
// (bf16_split.cuh: one pre-pass launch for both, made by the wrapper), and
// each chunk stages A_hi, A_lo, B_hi and B_lo and runs 3 x 4 products,
// A_hi B_hi + A_hi B_lo + A_lo B_hi, which holds the f32 cases' 1e-5 of
// the output's scale (a single bf16 or TF32 product would not), on one
// condition: the tensor cores' f32 accumulation is not round-to-nearest.
// Its adds truncate (as Fasi, Higham, Mikaitis and Pranesh found for
// earlier tensor cores), so the error grows with the number of
// accumulating steps, not their square root: the 864 steps of K = 4608
// (7x7x512) summed in one wgmma accumulator missed by 1.7x on the card.  So
// each chunk's 12 products go into a fresh wgmma accumulator, which is
// added into the f32 accumulator by the CUDA cores, round to nearest, 72
// times in all at C = 512.  A stage grows to 64 KB and three of them to
// 193 KB with the alignment pad: one CTA an SM, 132 slots, and up to 255
// registers a thread, which the second accumulator takes.  The output is
// written in f32.
//
// Waves: the bench's 7x7 shape (M = 6,272, Cout 512) is 49 x 4 = 196 CTAs,
// all resident at once in bf16 and a wave and a half in f32, and the 14x14
// shape (M = 25,088, Cout 256) 196 x 2 = 392, a wave and a half in bf16 and
// three in f32; a persistent schedule (or split-K for the 7x7 shape) is
// left for later.
//
// Bound on an H100 at the bench's shapes (x (128, 7, 7, 512) with w (3, 3,
// 512, 512), and x (128, 14, 14, 256) with w (3, 3, 256, 256)):
// 2*N*H*W*9*C*Cout = 29.6 GFLOP each, 30 us at the 989 TFLOP/s dense bf16
// tensor-core rate, against 18-27 MB of x, w and out, 5-8 us at 3.35 TB/s:
// bound by operations.  In f32 the least time for f32-accurate products is
// three bf16 products at that rate, 90 us (the CUDA cores' f32 FMAs reach
// 67 TFLOP/s, 0.44 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_split.cuh"
#include "hopper.cuh"

namespace {

namespace tc {

constexpr int BM = 128;                  // output pixels per CTA
constexpr int BN = 128;                  // output channels per CTA
constexpr int BK = 64;                   // channels of one tap per chunk
constexpr int STAGES = 3;
constexpr int NT = 256;                  // two warpgroups
constexpr int A_BYTES = BM * BK * 2;     // 16 KB: 128 rows of 128 bytes
constexpr int B_PANEL = BK * 128;        // 8 KB: 64 k rows x 64 channels
constexpr int B_BYTES = 2 * B_PANEL;

// bf16 in one part; f32 in two (hi, lo), each stage [A parts][B parts].
template <bool SPLIT>
struct Geo {
  static constexpr int PARTS = SPLIT ? 2 : 1;
  static constexpr int STAGE_BYTES = PARTS * (A_BYTES + B_BYTES);
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES;
  static constexpr int MIN_CTAS = SPLIT ? 1 : 2;   // a multiprocessor
};

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

// acc += the chunk's A (K-major, this warpgroup's 64 rows at a_addr) times
// its B (MN-major, at b_addr): 4 k16 steps.  With `overwrite`, the first
// step overwrites acc.
__device__ __forceinline__ void chunk_product(float (&acc)[64],
                                              uint32_t a_addr,
                                              uint32_t b_addr,
                                              bool overwrite = false) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    const uint64_t da = hopper::desc_sw128(a_addr + ks * 32, 16, 1024);
    const uint64_t db =
        hopper::desc_sw128(b_addr + ks * 16 * 128, B_PANEL, 1024);
    hopper::wgmma_m64n128k16_ss<1>(acc, da, db, overwrite ? ks > 0 : 1);
  }
}

// x (N, H, W, C) and w (9 C, Cout) in bf16; for SPLIT, each followed by its
// lo part (x_lo at x + M C, w_lo at w + 9 C Cout).  out in bf16, or f32
// for SPLIT.
template <bool SPLIT>
__global__ void __launch_bounds__(NT, Geo<SPLIT>::MIN_CTAS)
conv3x3_wgmma(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, void* __restrict__ out,
              int N, int H, int W, int C, int Cout, int vec_a, int vec_b) {
  using G = Geo<SPLIT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);

  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int nc = (C + BK - 1) / BK;      // chunks per tap
  const int n_chunks = 9 * nc;
  const long long x_part = M * C;        // elements of one part
  const long long w_part = 9LL * C * Cout;

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
    uint8_t* st = smem + stage * G::STAGE_BYTES;
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
      const long long off = in ? (a_m[i] + (long long)dh * W + dw) * C + c
                               : 0;
#pragma unroll
      for (int p = 0; p < G::PARTS; ++p) {
        const __nv_bfloat16* src = x + p * x_part + off;
        uint8_t* dst = st + p * A_BYTES + swz(r, ap);
        if (vec_a) {   // C % 8 == 0: a piece is wholly in or out
          hopper::cp_async_16(dst, src, in ? 16 : 0);
        } else {
          load_piece_masked(dst, src, [&](int e) { return in && c + e < C; });
        }
      }
    }
    const int col = n0 + bp * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = br + 16 * i;
      const int ck = c0 + kr;
      const bool in = ck < C && col < Cout;
      const long long off = in ? ((long long)tap * C + ck) * Cout + col : 0;
#pragma unroll
      for (int p = 0; p < G::PARTS; ++p) {
        const __nv_bfloat16* src = w + p * w_part + off;
        uint8_t* dst = st + G::PARTS * A_BYTES + p * B_BYTES +
                       (bp / 8) * B_PANEL + swz(kr, bp % 8);
        if (vec_b) {   // Cout % 8 == 0
          hopper::cp_async_16(dst, src, in ? 16 : 0);
        } else {
          load_piece_masked(dst, src,
                            [&](int e) { return in && col + e < Cout; });
        }
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
  float part[SPLIT ? 64 : 1];   // SPLIT: one chunk's products
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (SPLIT ? 64 : 1); ++i) part[i] = 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    hopper::cp_async_wait<STAGES - 2>();   // chunk i's pieces have landed
    hopper::fence_proxy_async();
    __syncthreads();   // ... everyone's; and chunk i-1's products are done
    const int next = i + STAGES - 1;
    if (next < n_chunks) load_chunk(next, next % STAGES);
    hopper::cp_async_commit();

    const uint8_t* st = smem + (i % STAGES) * G::STAGE_BYTES;
    const uint32_t a_addr = hopper::smem_u32(st) + wg * 64 * 128;
    const uint32_t b_addr = hopper::smem_u32(st + G::PARTS * A_BYTES);
    hopper::wgmma_fence();
    if constexpr (SPLIT) {
      // The chunk's 12 products into `part` on the tensor cores, then one
      // round-to-nearest f32 add into acc on the CUDA cores (see the
      // header: the tensor cores' own accumulation truncates).
      chunk_product(part, a_addr, b_addr, true);        // A_hi B_hi
      chunk_product(part, a_addr, b_addr + B_BYTES);    // A_hi B_lo
      chunk_product(part, a_addr + A_BYTES, b_addr);    // A_lo B_hi
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += part[j];
    } else {
      chunk_product(acc, a_addr, b_addr);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
  }

  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const long long row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool pairs = Cout % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if constexpr (SPLIT) {
        float* orow = static_cast<float*>(out) + row * Cout;
        if (pairs && col + 1 < Cout) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(a, b);
        } else {
          if (col < Cout) orow[col] = a;
          if (col + 1 < Cout) orow[col + 1] = b;
        }
      } else {
        __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(out) + row * Cout;
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
}

template <bool SPLIT>
int launch(const void* x, const void* w, void* out, int n, int h, int wd,
           int c, int cout, cudaStream_t stream) {
  using G = Geo<SPLIT>;
  const long long m = (long long)n * h * wd;
  // The lo parts lie M C and 9 C Cout elements on: 16-byte aligned with
  // their hi parts when C (Cout) is a multiple of 8.
  const int vec_a = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_b = cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kern = conv3x3_wgmma<SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((m + BM - 1) / BM), (cout + BN - 1) / BN);
  kern<<<grid, NT, G::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), out, n, h, wd, c, cout, vec_a,
      vec_b);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x, w and out alike.  out
// (n, h, w, cout) in that type.  bf16: x (n, h, w, c), w (3, 3, c, cout).
// f32 inputs reach this function as their bf16 hi + lo split
// (tmpi_bf16_split): x (2, n, h, w, c) and w (2, 3, 3, c, cout) bf16, hi
// first.  All contiguous.  Both run the wgmma kernel: bf16 in one product,
// f32 in three bf16 products.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int tmpi_conv3x3(const void* x, const void* w, void* out, int n,
                            int h, int wd, int c, int cout, int dtype,
                            void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || cout < 1 ||
      (cout + 63) / 64 > 65535 ||
      ((long long)n * h * wd + 63) / 64 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tc::launch<true>(x, w, out, n, h, wd, c, cout, s);
  if (dtype == 1) return tc::launch<false>(x, w, out, n, h, wd, c, cout, s);
  return (int)cudaErrorInvalidValue;
}

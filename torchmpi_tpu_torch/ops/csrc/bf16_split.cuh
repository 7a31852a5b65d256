// f32 tensors as bf16 hi + lo pairs, the form in which the tensor-core
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu, conv3x3.cu) take
// f32 inputs.  Header only: each of those sources includes it and so
// exports its own tmpi_bf16_split, which
// torchmpi_tpu_torch/ops/bf16_split.py binds with ctypes.
//
// hi = RN_bf16(x) and lo = RN_bf16(x - hi); x - hi is exact in f32, so hi +
// lo keeps 16 of x's 24 significand bits and misses it by at most 2^-17
// |x|.  A product of two such operands, A B, is then formed as three bf16
// products A_hi B_hi + A_hi B_lo + A_lo B_hi, each exact in f32 (8-bit x
// 8-bit significands), whose sum misses A B by about 2^-16 |A| |B| (the
// dropped A_lo B_lo and the two lo roundings): within the f32 cases'
// tolerances, where a single bf16 or TF32 product is not (tests
// test_torch_flash_attention.py, test_torch_conv3x3.py: the numerics
// models).  Three bf16 products at the 989 TFLOP/s dense bf16 rate cost
// half the tensor time of three TF32 ones (494.7 TFLOP/s), and reuse the
// bf16 wgmma forms, TMA maps and MN-major reads of hopper.cuh; tf32 wgmma
// would need K-major operands only, so V and the HWIO filter transposed
// first.
//
// The pass: one launch for all of a call's operands (up to four: the
// backward's q, k, v and do), one grid row (blockIdx.y) each.  A block takes UNROLL x NT float4s of an
// operand, grid-stride: each thread loads UNROLL of them, NT apart, before
// any store, and writes each float4's 4 hi and 4 lo values as one 8-byte
// store each, so a warp's loads and stores each cover one contiguous
// stretch.  An operand whose source or halves are not 8-byte aligned
// (16-byte for the source), and the tail of one whose length is not a
// multiple of 4, go element by element.
// Bound by bytes: 4 read and 4 written per element, 0.06 ms for the
// flash forward's q, k and v at B=1, H=32, L=2048, D=128 on 3.35 TB/s, and
// 0.08 ms for the backward's q, k, v and do (0.070 and 0.092 ms measured,
// 2.9 TB/s).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16_split {

constexpr int MAX_OPERANDS = 4;
constexpr int NT = 256;
constexpr int UNROLL = 4;   // float4s a thread loads before storing

struct Args {
  const float* src[MAX_OPERANDS];
  __nv_bfloat16* dst[MAX_OPERANDS];   // (2, n): hi, then lo
  long long n[MAX_OPERANDS];
};

// Two f32 values as their bf16 hi pair and lo pair, the first value in
// the low half of each (a bf16 is the top half of an f32).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// The table is a __grid_constant__ parameter: indexed by blockIdx.y it is
// read in place, where a plain parameter is first copied to a stack frame
// in every thread.  On an H100 80GB HBM3 at 700 W the flash forward's q, k
// and v split took 0.093 ms device-only with a 72-byte frame (three
// operands), 0.108 ms with a 96-byte one (four) and 0.070 ms read in place.
__global__ void __launch_bounds__(NT)
split_kernel(const __grid_constant__ Args a) {
  const int j = blockIdx.y;
  const float* __restrict__ src = a.src[j];
  __nv_bfloat16* __restrict__ hi = a.dst[j];
  const long long n = a.n[j];
  __nv_bfloat16* __restrict__ lo = hi + n;
  const long long stride = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      ((reinterpret_cast<uintptr_t>(hi) | reinterpret_cast<uintptr_t>(lo)) &
       7) == 0) {
    const long long n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    uint2* h2 = reinterpret_cast<uint2*>(hi);
    uint2* l2 = reinterpret_cast<uint2*>(lo);
    for (long long b = (long long)blockIdx.x * UNROLL * NT; b < n4;
         b += (long long)gridDim.x * UNROLL * NT) {
      float4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long k = b + u * NT + threadIdx.x;
        if (k < n4) x[u] = s4[k];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long k = b + u * NT + threadIdx.x;
        if (k < n4) {
          uint2 h, l;
          split2(x[u].x, x[u].y, h.x, l.x);
          split2(x[u].z, x[u].w, h.y, l.y);
          h2[k] = h;
          l2[k] = l;
        }
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    const float x = src[i];
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
  }
}

}  // namespace bf16_split

// Split `count` (1 to 4) contiguous f32 tensors of n0 .. n3 elements into
// bf16 buffers d0 .. d3 of 2 n elements each (hi, then lo), in one launch
// on `stream`.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int tmpi_bf16_split(const void* s0, void* d0, long long n0,
                               const void* s1, void* d1, long long n1,
                               const void* s2, void* d2, long long n2,
                               const void* s3, void* d3, long long n3,
                               int count, void* stream) {
  using bf16_split::Args;
  if (count < 1 || count > bf16_split::MAX_OPERANDS)
    return (int)cudaErrorInvalidValue;
  const void* srcs[bf16_split::MAX_OPERANDS] = {s0, s1, s2, s3};
  void* dsts[bf16_split::MAX_OPERANDS] = {d0, d1, d2, d3};
  const long long ns[bf16_split::MAX_OPERANDS] = {n0, n1, n2, n3};
  Args a = {};
  long long most = 0;
  for (int j = 0; j < count; ++j) {
    if (!srcs[j] || !dsts[j] || ns[j] < 1) return (int)cudaErrorInvalidValue;
    a.src[j] = static_cast<const float*>(srcs[j]);
    a.dst[j] = static_cast<__nv_bfloat16*>(dsts[j]);
    a.n[j] = ns[j];
    most = ns[j] > most ? ns[j] : most;
  }
  // Enough blocks for UNROLL float4s a thread on the largest operand (at
  // most 65,535; grid-stride beyond).
  constexpr long long per_block = bf16_split::NT * bf16_split::UNROLL * 4;
  long long blocks = (most + per_block - 1) / per_block;
  blocks = blocks > 65535 ? 65535 : blocks;
  bf16_split::split_kernel<<<dim3((unsigned)blocks, count), bf16_split::NT,
                             0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

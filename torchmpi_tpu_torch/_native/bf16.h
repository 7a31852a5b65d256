// bfloat16 wire helpers shared by the host-plane ring (hostcomm.cpp) and
// the parameter server (ps.cpp): bf16 = the high 16 bits of an IEEE-754
// float32 (the TPU-native reduced precision).  Reductions widen each pair
// to f32 and round back nearest-even, so bf16 traffic needs no f32 wire
// format (reference dtype breadth:
// generic/torch_collectives_wrappers.cpp.in:12-69).  ONE definition: both
// engines must agree bit-for-bit or a PS shard and a ring reduction of the
// same values diverge.
#pragma once

#include <cstdint>
#include <cstring>

static inline float bf16ToF32(uint16_t b) {
  uint32_t u = static_cast<uint32_t>(b) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

static inline uint16_t f32ToBF16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  // NaN first: the rounding add below would carry a low-16-bit-only
  // mantissa payload into the exponent, turning NaN into +/-Inf.
  if (f != f)
    return static_cast<uint16_t>(((u >> 16) & 0x8000u) | 0x7FC0u);
  uint32_t rounding = 0x7FFFu + ((u >> 16) & 1u);
  return static_cast<uint16_t>((u + rounding) >> 16);
}

// IEEE-754 binary16 (f16), same widen/reduce/narrow discipline as bf16 —
// the sub-word dtype breadth of the reference's collective matrix
// (generic/torch_collectives_wrappers.cpp.in:12-69).  Round-to-nearest-even
// on narrowing; subnormals handled both ways.

static inline float f16ToF32(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t man = h & 0x3FFu;
  uint32_t u;
  if (exp == 0) {
    if (man == 0) {
      u = sign;                            // +-0
    } else {                               // subnormal: renormalize
      int e = 127 - 15 + 1;
      while (!(man & 0x400u)) { man <<= 1; --e; }
      man &= 0x3FFu;
      u = sign | (static_cast<uint32_t>(e) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    u = sign | 0x7F800000u | (man << 13);  // inf / NaN (payload kept)
  } else {
    u = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

static inline uint16_t f32ToF16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  uint16_t sign = static_cast<uint16_t>((u >> 16) & 0x8000u);
  if (f != f) return static_cast<uint16_t>(sign | 0x7E00u);       // NaN
  int exp = static_cast<int>((u >> 23) & 0xFFu) - 127 + 15;
  uint32_t man = u & 0x7FFFFFu;
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);    // -> inf
  if (exp <= 0) {
    if (exp < -10) return sign;                                   // -> 0
    man |= 0x800000u;                       // make the implicit bit explicit
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1u);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1u))) ++half;  // RNE
    return static_cast<uint16_t>(sign | half);
  }
  uint32_t rem = man & 0x1FFFu;
  uint16_t out = static_cast<uint16_t>(
      sign | (static_cast<uint32_t>(exp) << 10) | (man >> 13));
  // RNE increment; a mantissa carry rolls into the exponent (and to inf)
  // with the same +1.
  if (rem > 0x1000u || (rem == 0x1000u && (out & 1u))) ++out;
  return out;
}

// int8 pairwise add with a widened accumulate and saturating narrow:
// chunked ring reductions add one rank per hop, so each hop widens to
// int32 and clamps back — deterministic (order-independent for the clamp
// only at the extremes, like any saturating fixed-point pipeline) instead
// of silent wrap-around.
static inline int8_t addSatI8(int8_t a, int8_t b) {
  int32_t s = static_cast<int32_t>(a) + static_cast<int32_t>(b);
  if (s > 127) return 127;
  if (s < -128) return -128;
  return static_cast<int8_t>(s);
}

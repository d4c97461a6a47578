// CPU emulation of the part of cuda_bf16.h that r2d2_tpu_torch/csrc uses:
// the 16-bit storage type and its two conversions, float32 -> bf16 rounding
// to nearest even (NaN kept a quiet NaN) and bf16 -> float32 (exact).
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { std::uint16_t bits; };

inline float __bfloat162float(__nv_bfloat16 b) {
  const std::uint32_t u = std::uint32_t(b.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {std::uint16_t((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {std::uint16_t(u >> 16)};
}

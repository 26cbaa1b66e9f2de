// A CPU stand-in for the part of CUDA's bf16 header that the port's kernels
// use (see cuda_runtime.h): the types and the rounding conversions, round to
// nearest even as on the card.
#pragma once
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline unsigned short emu_float_to_bf16(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return static_cast<unsigned short>((u >> 16) | 0x40u);  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<unsigned short>(u >> 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {emu_float_to_bf16(f)}; }
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {{emu_float_to_bf16(lo)}, {emu_float_to_bf16(hi)}};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  const unsigned u = static_cast<unsigned>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

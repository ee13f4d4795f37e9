// bf16 types and round-to-nearest-even conversions of the host emulation.
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  uint32_t r = u + 0x7fff + ((u >> 16) & 1); return {(uint16_t)(r >> 16)}; }
inline float __bfloat162float(__nv_bfloat16 b) { return bf2f(b.v); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)}; }

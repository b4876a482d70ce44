// CPU stand-in of cuda_bf16.h: bf16 as its 16 bits, rounded to nearest
// even from float32.
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.x; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u = __float_as_uint(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16(float f) { return __float2bfloat16_rn(f); }

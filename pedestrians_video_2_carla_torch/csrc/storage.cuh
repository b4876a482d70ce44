// Storage types of the transformer kernels: float32, or bf16 (__nv_bfloat16)
// in global memory with the arithmetic in float32. Loads widen a bf16 value
// to float32 exactly (its bits in the top half); stores round float32 to
// bf16 to nearest, ties to even, as torch's .to(torch.bfloat16) does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

template <typename S>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<bf16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) {
  return bits_to_float(__bfloat16_as_ushort(v));
}

// v rounded to bf16, to nearest even, as its 16 bits.
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v rounded to bf16 (to nearest even), as a float32.
__device__ __forceinline__ float round_bf(float v) {
  return bits_to_float(bf16_bits(v));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One element through the read-only cache.
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16* p) {
  return bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Four elements (16 bytes of float32, 8 of bf16; p aligned to that).
__device__ __forceinline__ float4 unpack4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  return unpack4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  return static_cast<unsigned>(bf16_bits(a)) |
         (static_cast<unsigned>(bf16_bits(b)) << 16);
}

__device__ __forceinline__ void st4g(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4g(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

// Two elements (8 bytes of float32, 4 of bf16).
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void st2g(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void st2g(bf16* p, float2 v) {
  *reinterpret_cast<unsigned*>(p) = pack2(v.x, v.y);
}

// src (float32) -> dst in storage type S, n elements.
template <typename S>
__global__ void to_storage_kernel(const float* __restrict__ src,
                                  S* __restrict__ dst, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) put(dst + i, src[i]);
}

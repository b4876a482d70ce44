// The pieces of the 3xTF32 tensor-core products and their cp.async rings,
// shared by fused_temporal_transformer.cu, fused_graph_gru.cu and
// fused_spatial_transformer.cu (which also takes mma_bf16, at the end).
//
// An fp32 operand is split into a TF32 value and a TF32 remainder, and
// a b = a_small b_big + a_big b_small + a_big b_big (3xTF32), which keeps
// fp32's accuracy as long as the three products of each 8-deep step are
// summed in the tensor cores (which round towards zero) and then added to a
// running fp32 sum outside them with round-to-nearest: a running sum kept in
// the tensor cores loses about K x 2^-24.
#pragma once

#include <cuda_runtime.h>

// 16 bytes global -> shared, asynchronously; zeros when !ok (src is then
// not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// 16 bytes global -> shared, asynchronously, of which the first `bytes` (0
// to 16) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16_part(float* dst, const float* src,
                                                int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared, asynchronously; zero when !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// 8 bytes global -> shared, asynchronously; zeros when !ok (four bf16
// values: the bf16 forms' tiles, which cp.async copies as bytes).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small to about 2^-22 of |x| (the 3xTF32 split): big is x
// rounded to TF32's 10 mantissa bits, its low 13 bits zero, so that x - big
// is exact; the tensor cores read small's top 19 bits.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b on one 16 x 8 x 8 tile in the tensor cores, TF32 inputs and an
// fp32 sum; a, b and d in the fragment layout of the PTX ISA's
// mma.m16n8k8 (g = lane / 4, t = lane % 4): a = A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4]; b = B[t][g], B[t + 4][g]; d = D[g][2t],
// D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 forms' operands: a bf16 value widened to fp32 has its low 16
// bits zero, so it is a TF32 value, and one TF32 product of such operands
// is exact (bf16's 8-bit significand fits TF32's 10 bits); the sum then
// stays in the tensor cores, in fp32, as a native bf16 product's does.
// tf32_of_bf16 rounds x to bf16 (to nearest even) and gives the TF32 bits.
__device__ __forceinline__ unsigned tf32_of_bf16(float x) {
  unsigned u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return u & 0xffff0000u;
}

// x rounded to TF32 (10 mantissa bits, ties away from zero: split_tf32's
// big part), as a float: one TF32 product reads it exactly.
__device__ __forceinline__ float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// d += a b in 3xTF32 on split fragments (see the top of this file): the
// three products summed in the tensor cores, the small ones first, then
// added to d in fp32.
__device__ __forceinline__ void mma_3xtf32(float* d, const unsigned* ab,
                                           const unsigned* as,
                                           const unsigned* bb,
                                           const unsigned* bs) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb);
  mma_tf32(t, ab, bs);
  mma_tf32(t, ab, bb);
#pragma unroll
  for (int c = 0; c < 4; ++c) d[c] += t[c];
}

// d += a b on one 16 x 8 x 16 tile in the tensor cores, bf16 inputs and an
// fp32 sum; in the fragment layout of the PTX ISA's mma.m16n8k16 (g = lane
// / 4, t = lane % 4; each register two bf16 neighbours along k, the lower k
// in the low half): a = A[g][2t..], A[g + 8][2t..], A[g][2t + 8..], A[g +
// 8][2t + 8..]; b = B[2t..][g], B[2t + 8..][g]; d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stand-in of csrc/mma_tf32.cuh: cp.async as synchronous copies, mma.sync
// as a per-warp exchange computing each lane's part of the 16 x 8 x 8 tile.
#pragma once
#include "cuda_runtime.h"

inline void cp_async16(float* dst, const float* src, bool ok) {
  if (ok) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async16_part(float* dst, const float* src, int bytes) {
  std::memset(dst, 0, 16);
  if (bytes > 0) std::memcpy(dst, src, bytes);
}
inline void cp_async4(float* dst, const float* src, bool ok) {
  if (ok) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4);
}
inline void cp_async8(void* dst, const void* src, bool ok) {
  if (ok) std::memcpy(dst, src, 8); else std::memset(dst, 0, 8);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

inline void split_tf32(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

inline float standin_tf32(unsigned u) { return __uint_as_float(u & 0xffffe000u); }

inline void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  StandinBlock* blk = standin_block;
  const unsigned lane = threadIdx.x % 32, w = threadIdx.x / 32;
  unsigned* xa = &blk->xa[w * 32 * 4];
  unsigned* xb = &blk->xb[w * 32 * 2];
  for (int e = 0; e < 4; ++e) xa[lane * 4 + e] = a[e];
  xb[lane * 2] = b[0];
  xb[lane * 2 + 1] = b[1];
  __syncwarp();
  const auto A = [&](int m, int k) {
    return standin_tf32(xa[((m % 8) * 4 + k % 4) * 4 + m / 8 + 2 * (k / 4)]);
  };
  const auto B = [&](int k, int n) {
    return standin_tf32(xb[(n * 4 + k % 4) * 2 + k / 4]);
  };
  const int g = lane / 4, t = lane % 4;
  float out[4];
  for (int c = 0; c < 4; ++c) {
    const int m = g + 8 * (c / 2), n = 2 * t + (c % 2);
    double s = 0;
    for (int k = 0; k < 8; ++k) s += double(A(m, k)) * double(B(k, n));
    out[c] = float(s);
  }
  __syncwarp();
  for (int c = 0; c < 4; ++c) d[c] += out[c];
}

inline unsigned tf32_of_bf16(float x) {
  unsigned u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return u & 0xffff0000u;
}

inline float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

inline void mma_3xtf32(float* d, const unsigned* ab, const unsigned* as,
                       const unsigned* bb, const unsigned* bs) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb);
  mma_tf32(t, ab, bs);
  mma_tf32(t, ab, bb);
  for (int c = 0; c < 4; ++c) d[c] += t[c];
}

// m16n8k16 with bf16 inputs (two a register, the lower k in the low half):
// the same exchange.
inline float standin_bf16(unsigned r, int half) {
  return __uint_as_float(((r >> (16 * half)) & 0xffffu) << 16);
}

inline void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  StandinBlock* blk = standin_block;
  const unsigned lane = threadIdx.x % 32, w = threadIdx.x / 32;
  unsigned* xa = &blk->xa[w * 32 * 4];
  unsigned* xb = &blk->xb[w * 32 * 2];
  for (int e = 0; e < 4; ++e) xa[lane * 4 + e] = a[e];
  xb[lane * 2] = b[0];
  xb[lane * 2 + 1] = b[1];
  __syncwarp();
  const auto A = [&](int m, int k) {
    return standin_bf16(
        xa[((m % 8) * 4 + (k % 8) / 2) * 4 + m / 8 + 2 * (k / 8)], k % 2);
  };
  const auto B = [&](int k, int n) {
    return standin_bf16(xb[(n * 4 + (k % 8) / 2) * 2 + k / 8], k % 2);
  };
  const int g = lane / 4, t = lane % 4;
  float out[4];
  for (int c = 0; c < 4; ++c) {
    const int m = g + 8 * (c / 2), n = 2 * t + (c % 2);
    double s = 0;
    for (int k = 0; k < 16; ++k) s += double(A(m, k)) * double(B(k, n));
    out[c] = float(s);
  }
  __syncwarp();
  for (int c = 0; c < 4; ++c) d[c] += out[c];
}

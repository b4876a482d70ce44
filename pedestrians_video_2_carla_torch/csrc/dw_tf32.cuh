// The weight gradients of the scan kernels on the tensor cores: dW = A^T Bm
// over many rows, the rows split across thread blocks (3xTF32 mma.sync
// through a 3-stage cp.async ring), then the splits summed in a fixed
// order: no float atomics, the same bits on every launch. Shared by
// fused_graph_gru.cu (both GRU weight gradients in one launch) and
// fused_dense_lstm.cu (the dense LSTM's).
//
// Operand types TA and TB: float32, or bf16 (the scans' bf16 forms), whose
// tiles stay bf16 in shared memory (cp.async copies bytes) and are widened
// as the fragments are read. Where Bm is bf16 the callers' A holds TF32
// values (bf16 values, or the bf16 scans' graph terms rounded to TF32), so
// one TF32 product a step is exact and the sums stay in the tensor cores,
// in fp32; else 3xTF32. The partial sums are fp32; the sum of the splits is
// stored in the weight's type.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "mma_tf32.cuh"
#include "storage.cuh"

namespace {

// One problem of the weight-gradient launch: part[split] (M x N) = A^T Bm
// over the split's rows; A (rows x M, row stride lda), Bm (rows x N, row
// stride ldb).
template <typename TA, typename TB>
struct DwProblem {
  const TA* A;
  const TB* Bm;
  float* part;
  int lda, M, ldb, N;
};

constexpr int kDwThreads = 256;  // 8 warps: 2 (M) x 4 (N), each 64 x 32
constexpr int kDwTile = 128;
constexpr int kDwLd = kDwTile + 8;  // k-major tiles: the fragment reads meet
                                    // 32 banks
constexpr int kDwKT = 16;          // depth of a k-step
constexpr int kDwStages = 3;       // the ring's depth
constexpr int kDwStage = 2 * kDwKT * kDwLd;
constexpr int kDwSmemBytes = kDwStages * kDwStage * sizeof(float);

// Two problems in one launch (blockIdx.x: p0's 128 x 128 tiles, then
// p1's; blockIdx.y: the split of the rows), 3xTF32 products (bf16 Bm: one
// TF32 product) through a 3-stage cp.async ring. VEC: both operands' rows,
// strides and widths multiples of 4 elements (16-byte copies, 8-byte ones
// of bf16), else 4-byte copies (bf16: ordinary loads).
template <bool VEC, typename TA, typename TB>
__global__ void __launch_bounds__(kDwThreads, 2)
dw_tf32_kernel(DwProblem<TA, TB> p0, DwProblem<TA, TB> p1, int tiles0,
               int rows, int chunk) {
  constexpr bool kOnePass = IsBf16<TB>::value;
  extern __shared__ __align__(16) float smem[];  // A and B tiles, fp32 layout
  const bool first = static_cast<int>(blockIdx.x) < tiles0;
  const DwProblem<TA, TB> p = first ? p0 : p1;
  const int tile = first ? blockIdx.x : blockIdx.x - tiles0;
  const int tn = (p.N + kDwTile - 1) / kDwTile;
  const int m0 = (tile / tn) * kDwTile, n0 = (tile % tn) * kDwTile;
  const int kbeg = blockIdx.y * chunk, kend = min(rows, kbeg + chunk);
  const int steps = kend > kbeg ? (kend - kbeg + kDwKT - 1) / kDwKT : 0;
  const int tid = threadIdx.x;

  // 4 elements of a row of X (row stride ld, width W) from column col on
  const auto copy4 = [](auto* dst, const auto* X, size_t at, int ld, int W,
                        int col, bool in) {
    constexpr bool kBf = sizeof(*X) == 2;
    if (VEC) {
      const bool ok = in && col < W;
      if constexpr (kBf)
        cp_async8(dst, ok ? X + at * ld + col : X, ok);
      else
        cp_async16(dst, ok ? X + at * ld + col : X, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in && col + e < W;
        if constexpr (kBf)
          put(dst + e, ok ? ldg1(X + at * ld + col + e) : 0.f);
        else
          cp_async4(dst + e, ok ? X + at * ld + col + e : X, ok);
      }
    }
  };
  // a slot's A tile, then its B tile, each kDwKT x kDwLd elements in the
  // space of as many floats
  const auto a_tile = [&](int slot) {
    return reinterpret_cast<TA*>(smem + slot * kDwStage);
  };
  const auto b_tile = [&](int slot) {
    return reinterpret_cast<TB*>(smem + slot * kDwStage + kDwKT * kDwLd);
  };
  auto load = [&](int slot, int k0) {
    TA* As = a_tile(slot);
    TB* Bs = b_tile(slot);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kDwThreads;
      const int r = c >> 5, col = (c & 31) * 4;
      const bool in = k0 + r < kend;
      const size_t at = static_cast<size_t>(k0 + r);
      copy4(As + r * kDwLd + col, p.A, at, p.lda, p.M, m0 + col, in);
      copy4(Bs + r * kDwLd + col, p.Bm, at, p.ldb, p.N, n0 + col, in);
    }
  };

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < steps) load(s, kbeg + s * kDwKT);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // k-step `step` has landed; slot step - 1 is free
    const int next = step + kDwStages - 1;
    if (next < steps) load(next % kDwStages, kbeg + next * kDwKT);
    cp_async_commit();
    const TA* As = a_tile(step % kDwStages);
    const TB* Bs = b_tile(step % kDwStages);
#pragma unroll
    for (int ks = 0; ks < kDwKT; ks += 8) {
      if constexpr (kOnePass) {  // exact TF32 values: one product
        unsigned bb[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn + j * 8 + g;
          bb[j][0] = __float_as_uint(to_f(Bs[(ks + t) * kDwLd + n]));
          bb[j][1] = __float_as_uint(to_f(Bs[(ks + t + 4) * kDwLd + n]));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = wm + i * 16 + g;
          const unsigned ab[4] = {
              __float_as_uint(to_f(As[(ks + t) * kDwLd + m])),
              __float_as_uint(to_f(As[(ks + t) * kDwLd + m + 8])),
              __float_as_uint(to_f(As[(ks + t + 4) * kDwLd + m])),
              __float_as_uint(to_f(As[(ks + t + 4) * kDwLd + m + 8]))};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ab, bb[j]);
        }
      } else {
        unsigned bb[4][2], bs[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn + j * 8 + g;
          split_tf32(Bs[(ks + t) * kDwLd + n], bb[j][0], bs[j][0]);
          split_tf32(Bs[(ks + t + 4) * kDwLd + n], bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = wm + i * 16 + g;
          unsigned ab[4], as[4];
          split_tf32(As[(ks + t) * kDwLd + m], ab[0], as[0]);
          split_tf32(As[(ks + t) * kDwLd + m + 8], ab[1], as[1]);
          split_tf32(As[(ks + t + 4) * kDwLd + m], ab[2], as[2]);
          split_tf32(As[(ks + t + 4) * kDwLd + m + 8], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  float* out = p.part + static_cast<size_t>(blockIdx.y) * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if (n < p.N) out[static_cast<size_t>(m) * p.N + n] = acc[i][j][2 * h];
        if (n + 1 < p.N)
          out[static_cast<size_t>(m) * p.N + n + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// out0 and out1 = the sums of their parts (splits of count0 and count1
// floats), each in the order of the splits, stored in St.
template <typename St>
__global__ void reduce_two_kernel(const float* __restrict__ part0, int count0,
                                  St* __restrict__ out0,
                                  const float* __restrict__ part1, int count1,
                                  St* __restrict__ out1, int splits) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* part = part0;
  St* out = out0;
  int count = count0;
  if (i >= count0) {
    i -= count0;
    part = part1;
    out = out1;
    count = count1;
  }
  if (i >= count) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z)
    sum += part[static_cast<size_t>(z) * count + i];
  put(out + i, sum);
}

// Thread-block tiles of one problem's M x N output.
inline int dw_tiles(int M, int N) {
  return ((M + kDwTile - 1) / kDwTile) * ((N + kDwTile - 1) / kDwTile);
}

// Splits of the rows over `tiles` output tiles: two thread blocks an SM,
// each split at least min_rows rows (a split's k-steps run one after
// another, so fewer rows a split shorten the launch where the sum of the
// splits stays small).
inline int dw_tf32_splits(int rows, int tiles, int sms, int min_rows = 256) {
  return std::max(1, std::min(2 * sms / tiles,
                              (rows + min_rows - 1) / min_rows));
}

}  // namespace

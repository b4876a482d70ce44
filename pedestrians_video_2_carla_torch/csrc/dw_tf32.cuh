// The weight gradients of the scan kernels on the tensor cores: dW = A^T Bm
// over many rows, the rows split across thread blocks (3xTF32 mma.sync
// through a 3-stage cp.async ring), then the splits summed in a fixed
// order: no float atomics, the same bits on every launch. Shared by
// fused_graph_gru.cu (both GRU weight gradients in one launch) and
// fused_dense_lstm.cu (the dense LSTM's).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "mma_tf32.cuh"

namespace {

// One problem of the weight-gradient launch: part[split] (M x N) = A^T Bm
// over the split's rows; A (rows x M, row stride lda), Bm (rows x N, row
// stride ldb).
struct DwProblem {
  const float* A;
  const float* Bm;
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
// p1's; blockIdx.y: the split of the rows), 3xTF32 products
// through a 3-stage cp.async ring. VEC: both operands' rows, strides and
// widths multiples of 4 floats (16-byte copies), else 4-byte copies.
template <bool VEC>
__global__ void __launch_bounds__(kDwThreads, 2)
dw_tf32_kernel(DwProblem p0, DwProblem p1, int tiles0, int rows, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const bool first = static_cast<int>(blockIdx.x) < tiles0;
  const DwProblem p = first ? p0 : p1;
  const int tile = first ? blockIdx.x : blockIdx.x - tiles0;
  const int tn = (p.N + kDwTile - 1) / kDwTile;
  const int m0 = (tile / tn) * kDwTile, n0 = (tile % tn) * kDwTile;
  const int kbeg = blockIdx.y * chunk, kend = min(rows, kbeg + chunk);
  const int steps = kend > kbeg ? (kend - kbeg + kDwKT - 1) / kDwKT : 0;
  const int tid = threadIdx.x;

  // 4 floats of a row of X (row stride ld, width W) from column col on
  const auto copy4 = [](float* dst, const float* X, size_t at, int ld, int W,
                        int col, bool in) {
    if (VEC) {
      const bool ok = in && col < W;
      cp_async16(dst, ok ? X + at * ld + col : X, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in && col + e < W;
        cp_async4(dst + e, ok ? X + at * ld + col + e : X, ok);
      }
    }
  };
  auto load = [&](int slot, int k0) {
    float* As = smem + slot * kDwStage;
    float* Bs = As + kDwKT * kDwLd;
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
    const float* As = smem + (step % kDwStages) * kDwStage;
    const float* Bs = As + kDwKT * kDwLd;
#pragma unroll
    for (int ks = 0; ks < kDwKT; ks += 8) {
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
// floats), each in the order of the splits.
__global__ void reduce_two_kernel(const float* __restrict__ part0, int count0,
                                  float* __restrict__ out0,
                                  const float* __restrict__ part1, int count1,
                                  float* __restrict__ out1, int splits) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* part = part0;
  float* out = out0;
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
  out[i] = sum;
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

// The frame recurrences of the graph-convolutional GRU and LSTM layers
// (classification GNNs), forward and backward, for sm_90a, float32 or bf16
// (see "bf16" below). The LSTM at k = 1 (no graph term: a dense LSTM over
// the B J rows) runs on the kernels of fused_dense_lstm.cu where its width
// fits them (H <= 64); this file's LSTM kernels take k >= 2 and the wider H
// (the graph form).
//
// Replaces the TPU kernels _fwd_kernel, _bwd_kernel, _lstm_fwd_kernel and
// _lstm_bwd_kernel of the JAX package's ops/pallas/fused_graph_gru.py (the
// bodies of _scan_fwd, _scan_bwd, _lstm_scan_fwd and _lstm_scan_bwd).
//
// What a frame computes, with carry h (zeros before frame 0), per clip of J
// joints and H hidden units, T_0 = I and T_n the Chebyshev matrices of the
// graph operator:
//   GRU   zr = xg[:, :2H] + [h | T_1 h | ..] Wzr;  z, r = sigmoid(zr)
//         h~ = tanh(xg[:, 2H:] + [r h | T_1 (r h) | ..] Wh)
//         h' = z h + (1 - z) h~
//   LSTM  a = xg + [h | T_1 h | ..] W;  i, f, o = sigmoid, g = tanh
//         c' = f c + i g;  h' = o tanh(c')
// The graph is applied to the H-wide carry first and one product follows
// (the same sum as the TPU kernel's sum_n T_n (h W_n), at half the graph
// work). Every kernel reads the caller's (H, k G H) weights in place (see
// "The operand's column order").
//
// What bounds them on an H100: operations. At B=256, L=16, J=26, H=128, k=2
// a GRU layer's forward is 22.4 GFLOP (0.14 ms at the 3xTF32 rate) against
// 0.22 GB of traffic (0.07 ms), an LSTM layer's 28.6 GFLOP (0.17 ms). The
// recurrence is sequential over frames and independent across clips, so a
// thread block owns a few clips (2 at that shape: 52 rows, 128 thread
// blocks for 132 SMs), keeps their carry in shared memory and loops over
// all frames inside one launch: no launch and no trip of the carry through
// device memory per frame. The weights (up to 512 KB) do not fit beside the
// activations; they stream from L2.
//
// Both cells (see "The scans on the tensor cores" below) run their products
// in 3xTF32 on the tensor cores, 16 warps a thread block, the weight tiles
// through a cp.async ring; their training forwards keep the activated gates
// and the expanded operands, so that the backward recomputes no forward
// product (the GRU runs two products a frame instead of four, the LSTM one
// instead of two), and the weight gradients are one 3xTF32 split-K launch
// and one fixed-order sum (dw_tf32.cuh).
//
// The ragged last thread block (B not a multiple of the clips per block)
// masks its rows. No float atomics anywhere: the same bits on every launch.
//
// Numerics: 1 / (1 + expf(-x)), tanhf, no fast math; the products in 3xTF32
// (fp32 accuracy, mma_tf32.cuh).
//
// bf16 (the _bf16 entries; every kernel templated on the storage type St
// of the caller's tensors), as the JAX kernels run on bf16 inputs: the
// products' operands where the JAX kernel rounds one to bf16 are rounded to
// bf16 (the carry, r h, the backward's cotangents da; the weights and graph
// matrices are bf16 values), and the graph terms, which the JAX kernel
// forms in another order (its products first, then the graph: the port's
// T_n h and the transposed products' outputs P_n have no JAX counterpart),
// to TF32; so one TF32 product a step is exact (a bf16 value is a TF32
// value) and the sums stay fp32. Graph terms at bf16 instead put a
// GConvLSTM's bf16 gradient 1.4x as far from its fp32 one as the JAX
// kernel's (tests/test_torch_bf16.py). The carries (h, the LSTM's c, dh,
// dc) and every elementwise op stay fp32. Stored in bf16: ys, cs, dxg and
// the weight gradients (summed in fp32); in fp32: the activated gates,
// which the JAX backward recomputes in fp32, and the expanded operands sa
// and sb, whose graph columns are TF32 values. The weight tiles stay bf16
// in the ring (cp.async copies bytes: 8-byte copies, or ordinary loads
// where H is not a multiple of 4) and are widened as the fragments are
// read. Each launch plan is the fp32 one (the bf16 ring uses half its
// slots' bytes), but the GRU forward's 128-column ring parks z in a float32
// scratch (zpark, B J H) instead of in ys.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>

#include "dw_tf32.cuh"
#include "mma_tf32.cuh"
#include "storage.cuh"

namespace {

constexpr int kMaxSmemBytes = 232448;  // 227 KB, a block's limit

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// A product operand as the bf16 forms (BF) round it; fp32 keeps it.
template <bool BF>
__device__ __forceinline__ float operand(float v) {
  return BF ? round_bf(v) : v;
}

// A graph term (T_n h, or P_n of the backward) as the bf16 forms round it
// for its product: to TF32.
template <bool BF>
__device__ __forceinline__ float graph_term(float v) {
  return BF ? round_tf32(v) : v;
}

// ---------------------------------------------------------------------------
// The scans on the tensor cores.
//
// A thread block of 16 warps owns C clips (R = C J rows) and runs all L
// frames of them in one launch, the carry in shared memory. Each
// hidden-side product is a block product in 3xTF32 (mma_tf32.cuh): the A
// operand (R rows, row stride its depth rounded up to 32, + 4, so that the
// fragment reads meet 32 banks) in shared memory, read in row tiles of 64
// rows (16 in the LSTM's few-rows tiling; rows past R read row R - 1 and
// their sums are dropped); the weights read straight from the caller's
// tensors (see "The operand's column order"), streaming from L2 through a
// 2-stage cp.async ring of 32-deep tiles with one barrier a tile, zeros
// past their edges; the outputs in RT x NT tiles, the warps laid out over
// them as a Tiling says, each warp's part in mma tiles of 16 x 8. A tile's
// products are summed in the tensor cores over its 32 rows, then added to
// the fp32 sums outside them. The first tile of a product is put in flight
// as soon as the previous product has left the ring, so its loads overlap
// the gating and the graph products in between. The graph products (T_n
// applied to the carry, and T_n^T to the cotangents in the backward) run
// on the tensor cores too, as small block-diagonal products
// (graph_product).
//
// On an H100 the products are issue-bound, not tensor-core-bound (a frame
// keeps most of its time with the mma instructions taken out): loading and
// splitting the fragments and the sums outside the tensor cores set the
// pace, so a k-step is 32 rows deep (one barrier and one exit from the
// tensor cores per 32 rows). The ring's widest tile NT is 256 columns, or
// narrower where a thread block's shared memory cannot hold one clip beside
// the wider ring (large H or k).
constexpr int kGThreads = 512;  // 16 warps
constexpr int kGWarps = kGThreads / 32;
constexpr int kGRows = 64;      // rows of a block tile (but the few-rows one)
constexpr int kGKT = 32;        // depth of a weight tile
constexpr int kGStages = 2;     // the ring's depth
constexpr int kGWide = 256;     // columns of the widest block tile
constexpr int kGPad = 32;       // an operand's depth is read in steps of this

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline int kpad(int K) { return round_up(K, kGPad); }

// The row stride of the backward's cotangent operand [da_z | da_r], whose
// second half first holds da_h (read kpad(H) deep from column H).
__host__ __device__ inline int bwd_da_ld(int H) {
  const int wide = kpad(2 * H), shifted = H + kpad(H);
  return round_up(wide > shifted ? wide : shifted, kGPad) + 4;
}

// The operand's column order. The expanded operand [h | T_1 h | ..] keeps
// its columns unit-major: column i k + n is (T_n h)[:, i]. The caller's
// hidden-side weight (H, k N), columns (n, gate, unit), read as a (k H, N)
// row-major matrix, then has row i k + n = row i of W_n: the product's
// weight as it lies in memory, nothing copied, padded or gathered, and the
// weight gradients come out in the caller's layout too. The ring's loads put
// zeros past the matrix's edges.

// How a ring slot holds a weight tile, and where a product's column n at
// depth d of the tile is:
//   kByDepth:  32 rows of depth x NT columns, row stride NT + 8;
//   kZR:       as kByDepth over wzr, whose product column 2u is
//              z of unit u and 2u + 1 its r (the accumulator pair of a
//              thread then holds both gates of one unit): the tile's z
//              columns, then 4 floats on its r columns;
//   kByColumn: NT columns x 32 of depth, row stride 36: the transposed
//              weight of the backward, each column a run of a weight row;
//   kGates:    as kByDepth over the LSTM's w (N = 4H, gate-major), whose
//              product column c of a tile is gate (c / 8) % 4 of unit
//              (tile's first unit) + 8 (c / 32) + c % 8: a warp's 32
//              columns are its 4 mma tiles, one gate each, of the same 8
//              units, so that a thread's accumulators hold all four gates
//              of its units.
// Each layout's fragment reads meet 32 banks.
enum TileLayout { kByDepth, kZR, kByColumn, kGates };

template <int NT, int LAYOUT>
__host__ __device__ constexpr int slot_at(int n, int d) {
  if (LAYOUT == kByColumn) return n * (kGKT + 4) + d;
  if (LAYOUT == kZR) return d * (NT + 8) + (n & 1) * (NT / 2 + 4) + (n >> 1);
  return d * (NT + 8) + n;
}

// Floats of a ring slot: the forward's tiles are by depth, the backward's
// by column.
template <int NT>
__host__ __device__ constexpr int fwd_slot() { return kGKT * (NT + 8); }
template <int NT>
__host__ __device__ constexpr int bwd_slot() { return NT * (kGKT + 4); }

// Ring slot s % kGStages (slot floats each) <- the weight tile of step s of
// a block product over W, K deep and N columns (row-major: K x N by depth,
// N x K by column, kZR's N = 2H, kGates' 4H): ceil(K / 32) steps a column
// tile, column tiles of NT, row tiles outermost (they reload the same
// tiles). vec: 16-byte copies (H a multiple of 4, W 16-byte aligned; bf16:
// 8-byte ones), else 4-byte ones (bf16: ordinary loads).
template <int NT, int LAYOUT, typename St>
__device__ __forceinline__ void load_step(St* ring, int slot, int s,
                                          const St* __restrict__ W, int K,
                                          int N, int ks, int ct, bool vec) {
  const int k0 = (s % ks) * kGKT, n0 = ((s / ks) % ct) * NT;
  St* dst = ring + (s % kGStages) * slot;
  // the tile as runs of contiguous source floats
  constexpr int kRuns = LAYOUT == kByColumn ? NT : kGKT;
  constexpr int kLen = LAYOUT == kByColumn ? kGKT : NT;
  constexpr int kLd = LAYOUT == kByColumn ? kGKT + 4 : NT + 8;
  const int step = vec ? 4 : 1;
  for (int e = threadIdx.x * step; e < kRuns * kLen; e += kGThreads * step) {
    const int r = e / kLen, c = e - r * kLen;
    size_t from;  // the source float
    int at = c;   // the slot column
    bool ok;
    if (LAYOUT == kByColumn) {
      ok = n0 + r < N && k0 + c < K;
      from = static_cast<size_t>(n0 + r) * K + k0 + c;
    } else if (LAYOUT == kZR) {
      const int half = c >= NT / 2, u = n0 / 2 + c - half * (NT / 2);
      ok = k0 + r < K && 2 * u < N;
      from = static_cast<size_t>(k0 + r) * N + half * (N / 2) + u;
      at = c + 4 * half;
    } else if (LAYOUT == kGates) {
      const int u = n0 / 4 + (c >> 5) * 8 + (c & 7), gate = (c >> 3) & 3;
      ok = k0 + r < K && u < N / 4;
      from = static_cast<size_t>(k0 + r) * N + gate * (N / 4) + u;
    } else {
      ok = k0 + r < K && n0 + c < N;
      from = static_cast<size_t>(k0 + r) * N + n0 + c;
    }
    St* d = dst + r * kLd + at;
    const St* src = ok ? W + from : W;
    if constexpr (IsBf16<St>::value) {
      if (vec)
        cp_async8(d, src, ok);
      else
        put(d, ok ? ldg1(src) : 0.f);
    } else {
      if (vec)
        cp_async16(d, src, ok);
      else
        cp_async4(d, src, ok);
    }
  }
}

__device__ __forceinline__ int row_tiles(int R) {
  return (R + kGRows - 1) / kGRows;
}

// The first kGStages - 1 steps of a block product over W for R rows, in
// flight. Every thread calls it, after a barrier that freed the ring.
template <int NT, int LAYOUT, typename St>
__device__ __forceinline__ void product_prologue(St* ring, int slot,
                                                 const St* __restrict__ W,
                                                 int K, int N, int R,
                                                 bool vec) {
  const int ks = (K + kGKT - 1) / kGKT, ct = (N + NT - 1) / NT;
  const int total = row_tiles(R) * ct * ks;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < total) load_step<NT, LAYOUT>(ring, slot, s, W, K, N, ks, ct, vec);
    cp_async_commit();
  }
}

// init + A W for the block: A (R x K, row stride lda, finite up to column
// kpad(K)) in shared memory, W (K x N) in device memory with its prologue
// in flight. The tiling: WARPS_N warps along the NT columns of a block
// tile, the others along its rows, MI mma tiles of 16 rows each: row tiles
// of RT = 16 MI (16 / WARPS_N) rows (64 but for the LSTM's few-rows
// tiling's 16). init(row, col, v0, v1) sets the starting values of columns
// col and col + 1 (col even) of a row (its loads fly while the tile is
// multiplied), epi(row, col, v0, v1) takes their sums; kGates: init(row,
// unit, v) and epi(row, unit, v) with v[4] the gates i, f, g, o of a unit.
// Both for every row of the row tiles and every column (unit) of the column
// tiles (they mask). epi runs per tile while other warps may still multiply
// later tiles, so it must not write A. bf16 (St): A holds TF32 values
// (bf16-rounded h, r h or da, TF32-rounded graph terms, rounded as they
// were written), the ring bf16 tiles: one TF32 product a step.
template <int NT, int LAYOUT, int WARPS_N = 8, int MI = 2, typename St,
          class Init, class Epi>
__device__ __forceinline__ void block_product(const float* A, int lda, int R,
                                              const St* __restrict__ W,
                                              int K, int N, St* ring,
                                              int slot, bool vec, Init init,
                                              Epi epi) {
  constexpr int WN = NT / WARPS_N;   // columns of a warp
  constexpr int NJ = WN / 8;         // its mma tiles of 8 columns
  constexpr int RT = 16 * MI * (kGWarps / WARPS_N);  // rows of a row tile
  constexpr int kDeep4 = slot_at<NT, LAYOUT>(0, 4);  // 4 deeper in the slot
  static_assert(LAYOUT != kGates || NJ == 4, "a warp holds the four gates");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * 16 * MI, wn = (warp % WARPS_N) * WN;
  const int ks = (K + kGKT - 1) / kGKT, ct = (N + NT - 1) / NT;
  const int total = (R + RT - 1) / RT * ct * ks;
  float acc[MI][NJ][4];
  for (int s = 0; s < total; ++s) {
    float part[MI][NJ][4];  // this k-step's products, summed in the tensor cores
    const int kstep = s % ks, tile = s / ks;
    const int r0 = (tile / ct) * RT, n0 = (tile % ct) * NT;
    if (kstep == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + wm + i * 16 + g + 8 * h;
          if constexpr (LAYOUT == kGates) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v[4];
              init(row, (n0 + wn) / 4 + 2 * t + e, v);
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j][2 * h + e] = v[j];
            }
          } else {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              init(row, n0 + wn + j * 8 + 2 * t, acc[i][j][2 * h],
                   acc[i][j][2 * h + 1]);
          }
        }
    }
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // step s has landed; step s - 1's slot is free
    if (s + kGStages - 1 < total)
      load_step<NT, LAYOUT>(ring, slot, s + kGStages - 1, W, K, N, ks, ct,
                            vec);
    cp_async_commit();
    const St* Bs = ring + (s % kGStages) * slot;
    // the A rows of this thread's fragments; rows past R read row R - 1
    const float* arow[MI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        arow[i][h] = A + min(r0 + wm + i * 16 + g + 8 * h, R - 1) * lda +
                     kstep * kGKT + t;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kGKT; kk += 8) {
      if constexpr (IsBf16<St>::value) {  // exact TF32 values: one product
        unsigned bb[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const St* b = Bs + slot_at<NT, LAYOUT>(wn + j * 8 + g, kk + t);
          bb[j][0] = __float_as_uint(to_f(b[0]));
          bb[j][1] = __float_as_uint(to_f(b[kDeep4]));
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const unsigned ab[4] = {__float_as_uint(arow[i][0][kk]),
                                  __float_as_uint(arow[i][1][kk]),
                                  __float_as_uint(arow[i][0][kk + 4]),
                                  __float_as_uint(arow[i][1][kk + 4])};
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_tf32(part[i][j], ab, bb[j]);
        }
      } else {
        unsigned bb[NJ][2], bs[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const St* b = Bs + slot_at<NT, LAYOUT>(wn + j * 8 + g, kk + t);
          split_tf32(b[0], bb[j][0], bs[j][0]);
          split_tf32(b[kDeep4], bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          unsigned ab[4], as[4];
          split_tf32(arow[i][0][kk], ab[0], as[0]);
          split_tf32(arow[i][1][kk], ab[1], as[1]);
          split_tf32(arow[i][0][kk + 4], ab[2], as[2]);
          split_tf32(arow[i][1][kk + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            mma_tf32(part[i][j], as, bb[j]);
            mma_tf32(part[i][j], ab, bs[j]);
            mma_tf32(part[i][j], ab, bb[j]);
          }
        }
      }
    }
    // the k-step's sums leave the tensor cores (which round towards zero)
    // for the running fp32 sums, rounded to nearest
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
    if (kstep == ks - 1) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + wm + i * 16 + g + 8 * h;
          if constexpr (LAYOUT == kGates) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v[4] = {acc[i][0][2 * h + e], acc[i][1][2 * h + e],
                                  acc[i][2][2 * h + e], acc[i][3][2 * h + e]};
              epi(row, (n0 + wn) / 4 + 2 * t + e, v);
            }
          } else {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              epi(row, n0 + wn + j * 8 + 2 * t, acc[i][j][2 * h],
                  acc[i][j][2 * h + 1]);
          }
        }
    }
  }
}

// The graph matrices in shared memory for the scans: T_1 .. T_{k-1},
// each zero-padded to Jm x Jm (Jm = J rounded up to 16) with row stride
// Jm + 4.
__host__ __device__ inline int graph_rows(int J) { return round_up(J, 16); }

template <typename St>
__device__ __forceinline__ void load_graph(float* Tp, const St* cheb,
                                           int J, int k) {
  const int Jm = graph_rows(J), lt = Jm + 4;
  for (int idx = threadIdx.x; idx < (k - 1) * Jm * lt; idx += kGThreads) {
    const int n = idx / (Jm * lt), rem = idx - n * Jm * lt;
    const int i = rem / lt, j = rem - i * lt;
    Tp[idx] = i < J && j < J ? to_f(cheb[(n * J + i) * J + j]) : 0.f;
  }
}

// The graph convolution of the scans on the tensor cores (3xTF32), clip
// by clip in 16 x 8 output tiles, each warp kGGraphTiles tiles at a time
// (independent chains of products), on operands in the unit-major column
// order (column u k + n):
//   !TRANS: S[c J + i][u k + n] = sum_j T_n[i][j] S[c J + j][u k] for n =
//           1 .. k - 1 (the operand's expansion from the carry in the
//           columns u k);
//   TRANS:  S[c J + i][u k] += sum_n sum_j T_n[j][i] S[c J + j][u k + n]
//           (the cotangent of the expansion's source, in place: each tile
//           reads only its own part of the columns u k).
// For rows < R (whole clips) and units < H. Ends with a barrier. BF: T
// holds bf16 values and S's columns are read as TF32 (one product a step);
// !TRANS rounds its outputs, the operand's graph columns, to TF32.
constexpr int kGGraphTiles = 4;

template <bool TRANS, bool BF>
__device__ __forceinline__ void graph_product(float* S, int ld, int R, int J,
                                              int H, int k,
                                              const float* Tp) {
  if (k == 1) {
    __syncthreads();
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Jm = graph_rows(J), lt = Jm + 4, Jk = round_up(J, 8);
  const int mt = Jm / 16, nt = (H + 7) / 8, clips = R / J;
  const int per_n = clips * mt * nt;
  const int units = TRANS ? per_n : (k - 1) * per_n;
  constexpr int kTiles = kGGraphTiles, kWarps = kGThreads / 32;
  for (int base = warp * kTiles; base < units; base += kWarps * kTiles) {
    int n[kTiles], m0[kTiles], u0[kTiles];
    float* Sc[kTiles];
    float acc[kTiles][4];
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      const int unit = min(base + q, units - 1);  // a repeat is not written
      n[q] = TRANS ? 1 : 1 + unit / per_n;
      const int rem = TRANS ? unit : unit - (n[q] - 1) * per_n;
      Sc[q] = S + (rem / (mt * nt)) * J * ld;
      m0[q] = ((rem / nt) % mt) * 16;
      u0[q] = (rem % nt) * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0[q] + g + 8 * h, u = u0[q] + 2 * t;
        const bool in = TRANS && i < J;
        acc[q][2 * h] = in && u < H ? Sc[q][i * ld + u * k] : 0.f;
        acc[q][2 * h + 1] = in && u + 1 < H ? Sc[q][i * ld + (u + 1) * k] : 0.f;
      }
    }
    for (int nn = 1; nn < (TRANS ? k : 2); ++nn) {
      for (int kk = 0; kk < Jk; kk += 8) {
#pragma unroll
        for (int q = 0; q < kTiles; ++q) {
          const float* T = Tp + ((TRANS ? nn : n[q]) - 1) * Jm * lt;
          const int m = m0[q] + g;
          float a[4];
          if (TRANS) {  // A[i][j] = T[j][i]
            a[0] = T[(kk + t) * lt + m];
            a[1] = T[(kk + t) * lt + m + 8];
            a[2] = T[(kk + t + 4) * lt + m];
            a[3] = T[(kk + t + 4) * lt + m + 8];
          } else {
            a[0] = T[m * lt + kk + t];
            a[1] = T[(m + 8) * lt + kk + t];
            a[2] = T[m * lt + kk + t + 4];
            a[3] = T[(m + 8) * lt + kk + t + 4];
          }
          // rows past the clip multiply zeros of T; read them (and units
          // past H) as zeros too
          const bool uok = u0[q] + g < H;
          const float* src = Sc[q] + (u0[q] + g) * k + (TRANS ? nn : 0);
          const float b0 = uok && kk + t < J ? src[(kk + t) * ld] : 0.f;
          const float b1 = uok && kk + t + 4 < J ? src[(kk + t + 4) * ld] : 0.f;
          unsigned ab[4], as[4], bb[2], bs[2];
          if constexpr (BF) {
#pragma unroll
            for (int e = 0; e < 4; ++e) ab[e] = __float_as_uint(a[e]);
            bb[0] = __float_as_uint(round_tf32(b0));
            bb[1] = __float_as_uint(round_tf32(b1));
            mma_tf32(acc[q], ab, bb);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
            split_tf32(b0, bb[0], bs[0]);
            split_tf32(b1, bb[1], bs[1]);
            mma_3xtf32(acc[q], ab, as, bb, bs);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      if (base + q >= units) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0[q] + g + 8 * h;
        if (i >= J) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = u0[q] + 2 * t + e;
          if (u < H)
            Sc[q][i * ld + u * k + (TRANS ? 0 : n[q])] =
                TRANS ? acc[q][2 * h + e] : graph_term<BF>(acc[q][2 * h + e]);
        }
      }
    }
  }
  __syncthreads();
}

// dst[row][c] <- src[row][c] for R rows of W columns (row strides ldd and
// lds); vec: W and both strides multiples of 4, both 16-byte aligned.
__device__ __forceinline__ void copy_rows(float* dst, int ldd,
                                          const float* src, int lds, int R,
                                          int W, bool vec) {
  if (vec) {
    const int q = W / 4;
    for (int i = threadIdx.x; i < R * q; i += kGThreads) {
      const int row = i / q, c = (i - row * q) * 4;
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * ldd + c) =
          *reinterpret_cast<const float4*>(src + static_cast<size_t>(row) * lds + c);
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += kGThreads) {
      const int row = i / W, c = i - row * W;
      dst[static_cast<size_t>(row) * ldd + c] =
          src[static_cast<size_t>(row) * lds + c];
    }
  }
}

// S[row][u k] <- src[row][u] (row strides ld and H) for R rows, H units:
// the carry (or r h) into the expanded operand's order-0 columns, rounded
// to bf16 where BF; a warp a row at a time.
template <bool BF, typename T>
__device__ __forceinline__ void put_units(float* S, int ld, int k,
                                          const T* src, int R, int H) {
  for (int row = threadIdx.x >> 5; row < R; row += kGThreads / 32)
    for (int u = threadIdx.x & 31; u < H; u += 32)
      S[row * ld + u * k] = operand<BF>(to_f(src[row * H + u]));
}

// Shared memory of a GRU scan with C clips a thread block and a ring of NT
// columns: the ring; the operand (C J rows of kpad(k H) + 4: forward [h |
// T_n h], then [r h | T_n r h]; backward a transposed product's output);
// forward: C J x H buffers for the carry, r h and, with the 256-column
// ring, z (the 128-column one parks z in ys); backward: the cotangents
// [da_z | da_r] (C J x bwd_da_ld(H)) and the dh carry (C J x H); the graph
// matrices.
size_t gru_smem_bytes(int C, int J, int H, int k, bool bwd, int NT) {
  const size_t ring = kGStages * (bwd ? NT * (kGKT + 4) : kGKT * (NT + 8));
  const size_t fwd_units = NT == kGWide ? 3 : 2;
  const size_t per_row =
      kpad(k * H) + 4 + (bwd ? bwd_da_ld(H) + H : fwd_units * H);
  return sizeof(float) *
         (ring + static_cast<size_t>(C) * J * per_row +
          static_cast<size_t>(k - 1) * graph_rows(J) * (graph_rows(J) + 4));
}

// How a GRU scan is launched: C clips a thread block, the ring's widest
// tile NT, the shared memory. Clips: enough thread blocks to cover the SMs
// first, then up to a 64-row tile, within the shared memory; the 256-column
// ring where one clip fits beside it, else the 128-column one; C = 0 if one
// clip fits beside neither. At B=256, J=26, H=128, k=2 on 132 SMs: 2 clips
// (52 of the 64 tile rows; 128 thread blocks of 16 warps, one an SM, as
// the shared memory allows no more), NT = 256.
struct GruPlan {
  int C, NT;
  size_t bytes;
};

GruPlan plan_gru(int B, int J, int H, int k, bool bwd, int sms) {
  for (int NT = kGWide; NT >= kGWide / 2; NT /= 2) {
    int C = std::max(1, std::min(kGRows / J, (B + sms - 1) / sms));
    while (C > 1 && gru_smem_bytes(C, J, H, k, bwd, NT) > kMaxSmemBytes) --C;
    const size_t bytes = gru_smem_bytes(C, J, H, k, bwd, NT);
    if (bytes <= kMaxSmemBytes) return {C, NT, bytes};
  }
  return {0, 0, 0};
}

// The forward. Per frame: S = [h | T_n h] (the carry put into S and
// expanded; columns unit-major, as all operands here); z, r = sigmoid(x +
// S Wzr), with r h and z kept (with the 128-column ring, which is for
// shapes whose shared memory is short, z is parked in the frame's ys and
// read back by the thread that overwrites it with h'); S = [r h | T_n r h];
// h~ = tanh(x + S Wh) and h' = z h + (1 - z) h~ written over the carry.
// KEEP (a gradient will be asked for): also gates (L, B, J, 3H) = z | r |
// h~ and both expanded operands of every frame, sa and sb (L B J x k H,
// columns unit-major), which the backward reads instead of recomputing.
// bf16 (St): z parks in zpark (B J x H, float32) instead of ys.
template <bool KEEP, int NT, typename St>
__global__ void __launch_bounds__(kGThreads, 1)
gru_scan_fwd_kernel(const St* __restrict__ xg, const St* __restrict__ cheb,
                    const St* __restrict__ wzr, const St* __restrict__ wh,
                    St* __restrict__ ys, float* __restrict__ gates,
                    float* __restrict__ sa, float* __restrict__ sb,
                    float* __restrict__ zpark, int L, int B, int J, int H,
                    int k, int C, bool vec) {
  constexpr bool kBf = IsBf16<St>::value;
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * C;
  const int R = min(C, B - b0) * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, ld = kpad(KH) + 4, CJH = C * J * H;
  constexpr int slot = fwd_slot<NT>();
  St* ring = reinterpret_cast<St*>(smem);
  float* S = smem + kGStages * slot;  // the operand of the product
  constexpr bool kZShared = NT == kGWide;
  // z of (frame at, row, unit) where shared memory has no room for it
  const auto zpark_at = [&](size_t at, int row, int u) -> float& {
    if constexpr (kBf)
      return zpark[(static_cast<size_t>(row0) + row) * H + u];
    else
      return ys[(at + row) * H + u];
  };
  float* hb = S + C * J * ld;         // the carry h
  float* rh = hb + CJH;               // r h
  float* zb = rh + CJH;               // z (kZShared)
  float* Tm = zb + (kZShared ? CJH : 0);
  load_graph(Tm, cheb, J, k);
  for (int i = threadIdx.x; i < C * J * ld + CJH; i += kGThreads) S[i] = 0.f;
  __syncthreads();
  product_prologue<NT, kZR>(ring, slot, wzr, KH, 2 * H, R, vec);
  for (int t = 0; t < L; ++t) {
    const size_t at = static_cast<size_t>(t) * rows + row0;
    const St* x = xg + at * 3 * H;
    if (t > 0) {  // (frame 0's operand is the zeros S starts with)
      put_units<kBf>(S, ld, k, hb, R, H);
      __syncthreads();
      graph_product<false, kBf>(S, ld, R, J, H, k, Tm);
    }
    if (KEEP) copy_rows(sa + at * KH, KH, S, ld, R, KH, vec);
    block_product<NT, kZR>(
        S, ld, R, wzr, KH, 2 * H, ring, slot, vec,
        [&](int row, int col, float& vz, float& vr) {
          const int u = col >> 1;
          const bool in = row < R && u < H;
          vz = in ? to_f(x[row * 3 * H + u]) : 0.f;
          vr = in ? to_f(x[row * 3 * H + H + u]) : 0.f;
        },
        [&](int row, int col, float vz, float vr) {
          const int u = col >> 1;
          if (row < R && u < H) {
            const float z = sigmoid(vz);
            const float r = sigmoid(vr);
            if (kZShared)
              zb[row * H + u] = z;
            else
              zpark_at(at, row, u) = z;
            rh[row * H + u] = r * hb[row * H + u];
            if (KEEP) {
              gates[(at + row) * 3 * H + u] = z;
              gates[(at + row) * 3 * H + H + u] = r;
            }
          }
        });
    __syncthreads();  // r h and z are written; S and the ring are free
    product_prologue<NT / 2, kByDepth>(ring, slot, wh, KH, H, R, vec);
    put_units<kBf>(S, ld, k, rh, R, H);
    __syncthreads();
    graph_product<false, kBf>(S, ld, R, J, H, k, Tm);
    if (KEEP) copy_rows(sb + at * KH, KH, S, ld, R, KH, vec);
    block_product<NT / 2, kByDepth>(
        S, ld, R, wh, KH, H, ring, slot, vec,
        [&](int row, int col, float& v0, float& v1) {
          const St* xh = x + row * 3 * H + 2 * H;
          v0 = row < R && col < H ? to_f(xh[col]) : 0.f;
          v1 = row < R && col + 1 < H ? to_f(xh[col + 1]) : 0.f;
        },
        [&](int row, int col, float v0, float v1) {
          if (row >= R) return;
          const float v[2] = {v0, v1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = col + e;
            if (u < H) {
              const float ht = tanhf(v[e]);
              const float z =
                  kZShared ? zb[row * H + u] : zpark_at(at, row, u);
              const float h = hb[row * H + u];
              const float hn = z * h + (1.f - z) * ht;
              hb[row * H + u] = hn;
              put(ys + (at + row) * H + u, hn);
              if (KEEP) gates[(at + row) * 3 * H + 2 * H + u] = ht;
            }
          }
        });
    __syncthreads();  // the carry is complete; S and the ring are free
    if (t + 1 < L) product_prologue<NT, kZR>(ring, slot, wzr, KH, 2 * H, R, vec);
  }
}

// The reverse scan, from the forward's residuals (nothing recomputed). Per
// frame, in reverse: dh = dy + the carry (+ the last frame's P'_0 + sum_n
// T_n^T P'_n); da_z, da_h -> dxg; P = da_h Wh^T; d(r h) = P_0 + sum_n T_n^T
// P_n; da_r -> dxg; P' = [da_z | da_r] Wzr^T. Two dependent products a frame
// (the old design recomputed the forward's two first), dh in shared memory;
// P's columns unit-major (P_n of unit u in column u k + n).
template <int NT, typename St>
__global__ void __launch_bounds__(kGThreads, 1)
gru_scan_bwd_kernel(const St* __restrict__ cheb, const St* __restrict__ wzr,
                    const St* __restrict__ wh,
                    const float* __restrict__ gates,
                    const float* __restrict__ sa, const St* __restrict__ dys,
                    St* __restrict__ dxg, int L, int B, int J, int H, int k,
                    int C, bool vec) {
  constexpr bool kBf = IsBf16<St>::value;
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * C;
  const int R = min(C, B - b0) * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, ldp = kpad(KH) + 4, ldd = bwd_da_ld(H);
  constexpr int slot = bwd_slot<NT>();
  St* ring = reinterpret_cast<St*>(smem);
  float* P = smem + kGStages * slot;  // a transposed product's output
  float* da = P + C * J * ldp;        // [da_z | da_r] (da_h before da_r)
  float* dhb = da + C * J * ldd;      // the dh carry
  float* Tm = dhb + C * J * H;
  load_graph(Tm, cheb, J, k);
  for (int i = threadIdx.x; i < C * J * (ldp + ldd + H); i += kGThreads)
    P[i] = 0.f;
  __syncthreads();
  product_prologue<NT, kByColumn>(ring, slot, wh, H, KH, R, vec);
  const auto zero = [](int, int, float& v0, float& v1) { v0 = v1 = 0.f; };
  const auto keep_p = [&](int row, int col, float v0, float v1) {
    if (row < R) {
      if (col < KH) P[row * ldp + col] = v0;
      if (col + 1 < KH) P[row * ldp + col + 1] = v1;
    }
  };
  for (int t = L - 1; t >= 0; --t) {
    const size_t at = static_cast<size_t>(t) * rows + row0;
    const float* gt = gates + at * 3 * H;
    const float* hp = sa + at * KH;  // the previous hidden state: sa[:, u k]
    const St* dy = dys + at * H;
    St* dx = dxg + at * 3 * H;
    // the residuals through the read-only path, several rows' loads in
    // flight at once
#pragma unroll 4
    for (int idx = threadIdx.x; idx < R * H; idx += kGThreads) {
      const int row = idx / H, u = idx - row * H;
      float dh = ldg1(dy + idx) + dhb[idx];
      if (t < L - 1) dh += P[row * ldp + u * k];
      const float z = __ldg(gt + row * 3 * H + u);
      const float ht = __ldg(gt + row * 3 * H + 2 * H + u);
      const float h = __ldg(hp + row * KH + u * k);
      const float da_z = operand<kBf>(dh * (h - ht) * z * (1.f - z));
      const float da_h = operand<kBf>(dh * (1.f - z) * (1.f - ht * ht));
      dhb[idx] = dh * z;
      put(dx + row * 3 * H + u, da_z);
      put(dx + row * 3 * H + 2 * H + u, da_h);
      da[row * ldd + u] = da_z;
      da[row * ldd + H + u] = da_h;
    }
    __syncthreads();
    block_product<NT, kByColumn>(da + H, ldd, R, wh, H, KH, ring, slot, vec,
                                 zero, keep_p);
    __syncthreads();  // P is complete; the ring is free
    product_prologue<NT, kByColumn>(ring, slot, wzr, 2 * H, KH, R, vec);
    graph_product<true, kBf>(P, ldp, R, J, H, k, Tm);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < R * H; idx += kGThreads) {
      const int row = idx / H, u = idx - row * H;
      const float drh = P[row * ldp + u * k];
      const float r = __ldg(gt + row * 3 * H + H + u);
      const float h = __ldg(hp + row * KH + u * k);
      const float da_r = operand<kBf>(drh * h * r * (1.f - r));
      put(dx + row * 3 * H + H + u, da_r);
      da[row * ldd + H + u] = da_r;
      dhb[idx] += drh * r;
    }
    __syncthreads();
    block_product<NT, kByColumn>(da, ldd, R, wzr, 2 * H, KH, ring, slot, vec,
                                 zero, keep_p);
    __syncthreads();  // P' is complete; the ring is free
    if (t > 0) {
      product_prologue<NT, kByColumn>(ring, slot, wh, H, KH, R, vec);
      graph_product<true, kBf>(P, ldp, R, J, H, k, Tm);
    }
  }
}

// ---------------------------------------------------------------------------
// The graph-form LSTM scans (rows 12 and 13 at k >= 2, and at k = 1 past the
// dense kernels' width).
//
// One product a frame, a = x + [h | T_n h] W, with W (H, k 4H) read in place
// as a (k H, 4H) matrix (kGates: a thread's accumulators hold the four
// gates of its units, so the gating runs on them); c stays in shared memory
// across frames. The training forward (KEEP) writes the activated gates
// and every frame's expanded operand; the reverse scan reads them, carries
// dh and dc on chip and runs one product a frame, P = da W^T (W read by
// column), dh = P_0 + sum_n T_n^T P_n; then dW = S^T dxg in one split-K
// launch and a fixed-order sum.
//
// Three tilings (block_product): the wide one, 256-column tiles, 8 warps
// along them, 2 m16 tiles a warp along the 64 rows; the narrow one, 128
// columns, 4 warps along them, 1 m16 tile a warp, where one clip's shared
// memory does not fit beside the wide ring (the forward then keeps h in ys
// instead of shared memory); the few-rows one, 512 columns (the backward:
// 128), all 16 warps along them, one 16-row tile, where a 64-row tile
// would hold 16 rows or fewer (small J B: a J = 1 LSTM layer), at a quarter
// of the wide tiling's tensor-core work a frame. The backward's ring is by
// column, its widths 128 or 64 (a 256-column one does not fit beside two
// clips at GConvLSTM's layer, and two clips a thread block, not one, cover
// the SMs there).
struct LstmTiling {
  int NT, warps_n, mi;
};

__host__ __device__ constexpr LstmTiling lstm_tiling(bool bwd, int v) {
  return bwd ? (v == 0   ? LstmTiling{128, 8, 2}
                : v == 1 ? LstmTiling{64, 8, 2}
                         : LstmTiling{128, 16, 1})
             : (v == 0   ? LstmTiling{256, 8, 2}
                : v == 1 ? LstmTiling{128, 4, 1}
                         : LstmTiling{512, 16, 1});
}
constexpr int kFewRows = 2;   // the few-rows tiling's index
constexpr int kFewRowsMax = 16;

// Shared memory of a graph-form LSTM scan with C clips a thread block and
// tiling v: the ring; the operand (C J rows of kpad(k H) + 4: forward [h |
// T_n h], backward the transposed product's output P); forward: c and,
// but in the narrow tiling, h (C J x H each); backward: the cotangents da
// (C J x kpad(4H) + 4) and the dc carry (C J x H); the graph matrices.
size_t lstm_smem_bytes(int C, int J, int H, int k, bool bwd, int v) {
  const int NT = lstm_tiling(bwd, v).NT;
  const size_t ring = kGStages * (bwd ? NT * (kGKT + 4) : kGKT * (NT + 8));
  const size_t per_row = kpad(k * H) + 4 +
                         (bwd ? kpad(4 * H) + 4 + H : (v == 1 ? 1 : 2) * H);
  return sizeof(float) *
         (ring + static_cast<size_t>(C) * J * per_row +
          static_cast<size_t>(k - 1) * graph_rows(J) * (graph_rows(J) + 4));
}

// How a graph-form LSTM scan is launched: C clips a thread block, the
// tiling, the shared memory. As many clips as cover the SMs, up to a
// 64-row tile, in the widest tiling that fits, fewer clips only where no
// tiling fits; the few-rows tiling first where those clips hold 16 rows or
// fewer. C = 0 if one clip fits in none. At B=256, J=26, H=128, k=2 on 132
// SMs: 2 clips, the wide tiling forward, the 128-column ring backward; at
// J=1, H=128: 2 rows a thread block in the few-rows tiling (the gating and
// the backward's elementwise work a frame spread over 128 SMs: 10-16 %
// faster than 16 rows on 16 SMs, PERF.md).
struct LstmPlan {
  int C, v;
  size_t bytes;
};

LstmPlan plan_lstm(int B, int J, int H, int k, bool bwd, int sms) {
  const int want = std::max(1, std::min(kGRows / J, (B + sms - 1) / sms));
  const bool few = want * J <= kFewRowsMax;
  const int order[3] = {few ? kFewRows : 0, few ? 0 : 1, few ? 1 : -1};
  for (int C = want; C >= 1; --C)
    for (const int v : order) {
      if (v < 0) continue;
      const size_t bytes = lstm_smem_bytes(C, J, H, k, bwd, v);
      if (bytes <= kMaxSmemBytes) return {C, v, bytes};
    }
  return {0, 0, 0};
}

// The forward. Per frame: S = [h | T_n h] (the carry put into S and
// expanded, columns unit-major); a = x + S W on the tensor cores, the
// gating on the accumulators: c' = f c + i g over c in shared memory, h' =
// o tanh(c') into the carry (the narrow tiling: into ys, read back the
// next frame), ys and cs. KEEP (a gradient will be asked for): also gates
// (L, B, J, 4H) = i | f | g | o and the expanded operand sa (L B J x k H,
// columns unit-major) of every frame, which the backward reads instead of
// recomputing.
template <bool KEEP, int V, typename St>
__global__ void __launch_bounds__(kGThreads, 1)
lstm_scan_fwd_kernel(const St* __restrict__ xg, const St* __restrict__ cheb,
                     const St* __restrict__ w, St* __restrict__ ys,
                     St* __restrict__ cs, float* __restrict__ gates,
                     float* __restrict__ sa, int L, int B, int J, int H, int k,
                     int C, bool vec) {
  constexpr LstmTiling kT = lstm_tiling(false, V);
  constexpr int NT = kT.NT;
  constexpr bool kHShared = V != 1;
  constexpr bool kBf = IsBf16<St>::value;
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * C;
  const int R = min(C, B - b0) * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, ld = kpad(KH) + 4, CJH = C * J * H;
  constexpr int slot = fwd_slot<NT>();
  St* ring = reinterpret_cast<St*>(smem);
  float* S = smem + kGStages * slot;  // the operand of the product
  float* cb = S + C * J * ld;         // the carry c
  float* hb = cb + CJH;               // the carry h (kHShared)
  float* Tm = hb + (kHShared ? CJH : 0);
  load_graph(Tm, cheb, J, k);
  for (int i = threadIdx.x; i < C * J * ld + CJH; i += kGThreads) S[i] = 0.f;
  __syncthreads();
  product_prologue<NT, kGates>(ring, slot, w, KH, 4 * H, R, vec);
  for (int t = 0; t < L; ++t) {
    const size_t at = static_cast<size_t>(t) * rows + row0;
    const St* x = xg + at * 4 * H;
    if (t > 0) {  // (frame 0's operand is the zeros S starts with)
      if (kHShared)
        put_units<kBf>(S, ld, k, hb, R, H);
      else
        put_units<kBf>(S, ld, k, ys + (at - rows) * H, R, H);
      __syncthreads();
      graph_product<false, kBf>(S, ld, R, J, H, k, Tm);
    }
    if (KEEP) copy_rows(sa + at * KH, KH, S, ld, R, KH, vec);
    block_product<NT, kGates, kT.warps_n, kT.mi>(
        S, ld, R, w, KH, 4 * H, ring, slot, vec,
        [&](int row, int u, float* v) {
          const bool in = row < R && u < H;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            v[gate] = in ? to_f(x[row * 4 * H + gate * H + u]) : 0.f;
        },
        [&](int row, int u, const float* v) {
          if (row >= R || u >= H) return;
          const float i = sigmoid(v[0]), f = sigmoid(v[1]), g = tanhf(v[2]),
                      o = sigmoid(v[3]);
          const int idx = row * H + u;
          const float c = f * cb[idx] + i * g;
          const float h = o * tanhf(c);
          cb[idx] = c;
          if (kHShared) hb[idx] = h;
          put(ys + at * H + idx, h);
          put(cs + at * H + idx, c);
          if (KEEP) {
            float* gt = gates + (at + row) * 4 * H + u;
            gt[0] = i;
            gt[H] = f;
            gt[2 * H] = g;
            gt[3 * H] = o;
          }
        });
    __syncthreads();  // the carries are complete; S and the ring are free
    if (t + 1 < L) product_prologue<NT, kGates>(ring, slot, w, KH, 4 * H, R, vec);
  }
}

// The reverse scan, from the forward's residuals (nothing recomputed). Per
// frame, in reverse: dh = dy + the carry (the next frame's P_0 + sum_n
// T_n^T P_n); dc = dh o (1 - tanh(c)^2) + the carry (+ dcs); da from the
// kept gates, c and the previous c -> dxg and shared memory; dc f carried;
// P = da W^T (W by column, P's columns unit-major), then the transposed
// graph on P. One product a frame, the carries in shared memory.
template <int V, typename St>
__global__ void __launch_bounds__(kGThreads, 1)
lstm_scan_bwd_kernel(const St* __restrict__ cheb, const St* __restrict__ w,
                     const float* __restrict__ gates,
                     const St* __restrict__ cs, const St* __restrict__ dys,
                     const St* __restrict__ dcs, St* __restrict__ dxg, int L,
                     int B, int J, int H, int k, int C, bool vec) {
  constexpr LstmTiling kT = lstm_tiling(true, V);
  constexpr int NT = kT.NT;
  constexpr bool kBf = IsBf16<St>::value;
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * C;
  const int R = min(C, B - b0) * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, ldp = kpad(KH) + 4, ldd = kpad(4 * H) + 4;
  constexpr int slot = bwd_slot<NT>();
  St* ring = reinterpret_cast<St*>(smem);
  float* P = smem + kGStages * slot;  // the transposed product's output
  float* da = P + C * J * ldp;        // the cotangents of a
  float* dcb = da + C * J * ldd;      // the dc carry
  float* Tm = dcb + C * J * H;
  load_graph(Tm, cheb, J, k);
  for (int i = threadIdx.x; i < C * J * (ldp + ldd + H); i += kGThreads)
    P[i] = 0.f;
  __syncthreads();
  product_prologue<NT, kByColumn>(ring, slot, w, 4 * H, KH, R, vec);
  for (int t = L - 1; t >= 0; --t) {
    const size_t at = static_cast<size_t>(t) * rows + row0;
    const float* gt = gates + at * 4 * H;
    const St* c_now = cs + at * H;
    const St* c_prev = t > 0 ? cs + (at - rows) * H : nullptr;
    const St* dy = dys + at * H;
    const St* dc_in = dcs ? dcs + at * H : nullptr;
    St* dx = dxg + at * 4 * H;
    // the residuals through the read-only path, several rows' loads in
    // flight at once
#pragma unroll 4
    for (int idx = threadIdx.x; idx < R * H; idx += kGThreads) {
      const int row = idx / H, u = idx - row * H;
      const float* g4 = gt + row * 4 * H + u;
      const float i = __ldg(g4), f = __ldg(g4 + H), g = __ldg(g4 + 2 * H),
                  o = __ldg(g4 + 3 * H);
      const float tc = tanhf(ldg1(c_now + idx));
      const float dh = ldg1(dy + idx) + P[row * ldp + u * k];
      float dc = dh * o * (1.f - tc * tc) + dcb[idx];
      if (dc_in) dc += ldg1(dc_in + idx);
      const float cp = c_prev ? ldg1(c_prev + idx) : 0.f;
      const float d[4] = {operand<kBf>(dc * g * i * (1.f - i)),
                          operand<kBf>(dc * cp * f * (1.f - f)),
                          operand<kBf>(dc * i * (1.f - g * g)),
                          operand<kBf>(dh * tc * o * (1.f - o))};
      dcb[idx] = dc * f;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        put(dx + row * 4 * H + gate * H + u, d[gate]);
        da[row * ldd + gate * H + u] = d[gate];
      }
    }
    __syncthreads();
    block_product<NT, kByColumn, kT.warps_n, kT.mi>(
        da, ldd, R, w, 4 * H, KH, ring, slot, vec,
        [](int, int, float& v0, float& v1) { v0 = v1 = 0.f; },
        [&](int row, int col, float v0, float v1) {
          if (row < R) {
            if (col < KH) P[row * ldp + col] = v0;
            if (col + 1 < KH) P[row * ldp + col + 1] = v1;
          }
        });
    __syncthreads();  // P is complete; the ring is free
    if (t > 0) {
      product_prologue<NT, kByColumn>(ring, slot, w, 4 * H, KH, R, vec);
      graph_product<true, kBf>(P, ldp, R, J, H, k, Tm);
    }
  }
}

// Splits of the rows for the GRU's weight gradients, over both products'
// tiles.
int gru_dw_splits(int rows, int KH, int H, int sms) {
  return dw_tf32_splits(rows, dw_tiles(KH, 2 * H) + dw_tiles(KH, H), sms);
}

// The same for the LSTM's one weight gradient.
int lstm_dw_splits(int rows, int KH, int H, int sms) {
  return dw_tf32_splits(rows, dw_tiles(KH, 4 * H), sms);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

bool valid(int L, int B, int J, int H, int k) {
  return L >= 1 && B >= 1 && J >= 1 && H >= 1 && k >= 1;
}

// Launches a scan kernel with its shared memory; returns the first error.
template <class Kernel, class... Args>
cudaError_t launch_scan(Kernel kernel, int blocks, size_t bytes,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kGThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// The launches behind the entries below, for either storage type.
template <typename St>
int gru_scan_fwd(const St* xg, const St* cheb, const St* wzr, const St* wh,
                 St* ys, float* gates, float* sa, float* sb, float* zpark, int L,
                 int B, int J, int H, int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  const bool keep = gates != nullptr;
  if (keep != (sa != nullptr) || keep != (sb != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GruPlan plan = plan_gru(B, J, H, k, false, sms);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (IsBf16<St>::value && plan.NT != kGWide && zpark == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = H % 4 == 0 && aligned16(wzr) && aligned16(wh) &&
                   (!keep || (aligned16(sa) && aligned16(sb)));
  auto kernel = plan.NT == kGWide
                    ? (keep ? gru_scan_fwd_kernel<true, kGWide, St>
                            : gru_scan_fwd_kernel<false, kGWide, St>)
                    : (keep ? gru_scan_fwd_kernel<true, kGWide / 2, St>
                            : gru_scan_fwd_kernel<false, kGWide / 2, St>);
  return static_cast<int>(launch_scan(
      kernel, (B + plan.C - 1) / plan.C, plan.bytes, stream, xg, cheb, wzr,
      wh, ys, gates, sa, sb, zpark, L, B, J, H, k, plan.C, vec));
}

template <typename St>
int gru_scan_bwd(const St* cheb, const St* wzr, const St* wh,
                 const float* gates, const float* sa, const float* sb,
                 const St* dys, St* dxg, float* part, St* dwzr, St* dwh,
                 int L, int B, int J, int H, int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GruPlan plan = plan_gru(B, J, H, k, true, sms);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = H % 4 == 0 && aligned16(wzr) && aligned16(wh) &&
                   aligned16(sa) && aligned16(sb) && aligned16(dxg);
  auto kernel = plan.NT == kGWide ? gru_scan_bwd_kernel<kGWide, St>
                                  : gru_scan_bwd_kernel<kGWide / 2, St>;
  err = launch_scan(kernel, (B + plan.C - 1) / plan.C, plan.bytes, stream,
                    cheb, wzr, wh, gates, sa, dys, dxg, L, B, J, H, k, plan.C,
                    vec);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = L * B * J, KH = k * H;
  const int splits = gru_dw_splits(rows, KH, H, sms);
  const int chunk = round_up((rows + splits - 1) / splits, kDwKT);
  const int tiles0 = dw_tiles(KH, 2 * H), tiles1 = dw_tiles(KH, H);
  const DwProblem<float, St> p0{sa, dxg, part, KH, KH, 3 * H, 2 * H};
  const DwProblem<float, St> p1{
      sb, dxg + 2 * H, part + static_cast<size_t>(splits) * KH * 2 * H, KH,
      KH, 3 * H, H};
  auto dw = vec ? dw_tf32_kernel<true, float, St>
                : dw_tf32_kernel<false, float, St>;
  err = cudaFuncSetAttribute(dw, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDwSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw<<<dim3(tiles0 + tiles1, splits), kDwThreads, kDwSmemBytes, stream>>>(
      p0, p1, tiles0, rows, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int count0 = KH * 2 * H, count1 = KH * H;
  reduce_two_kernel<St><<<(count0 + count1 + 255) / 256, 256, 0, stream>>>(
      p0.part, count0, dwzr, p1.part, count1, dwh, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename St>
int lstm_scan_fwd(const St* xg, const St* cheb, const St* w, St* ys, St* cs,
                  float* gates, float* sa, int L, int B, int J, int H, int k,
                  cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  const bool keep = gates != nullptr;
  if (keep != (sa != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const LstmPlan plan = plan_lstm(B, J, H, k, false, sms);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = H % 4 == 0 && aligned16(w) && (!keep || aligned16(sa));
  decltype(&lstm_scan_fwd_kernel<true, 0, St>) kernels[2][3] = {
      {lstm_scan_fwd_kernel<false, 0, St>, lstm_scan_fwd_kernel<false, 1, St>,
       lstm_scan_fwd_kernel<false, 2, St>},
      {lstm_scan_fwd_kernel<true, 0, St>, lstm_scan_fwd_kernel<true, 1, St>,
       lstm_scan_fwd_kernel<true, 2, St>}};
  return static_cast<int>(launch_scan(
      kernels[keep][plan.v], (B + plan.C - 1) / plan.C, plan.bytes, stream,
      xg, cheb, w, ys, cs, gates, sa, L, B, J, H, k, plan.C, vec));
}

template <typename St>
int lstm_scan_bwd(const St* cheb, const St* w, const float* gates,
                  const float* sa, const St* cs, const St* dys, const St* dcs,
                  St* dxg, float* part, St* dw, int L, int B, int J, int H,
                  int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const LstmPlan plan = plan_lstm(B, J, H, k, true, sms);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      H % 4 == 0 && aligned16(w) && aligned16(sa) && aligned16(dxg);
  decltype(&lstm_scan_bwd_kernel<0, St>) kernels[3] = {
      lstm_scan_bwd_kernel<0, St>, lstm_scan_bwd_kernel<1, St>,
      lstm_scan_bwd_kernel<2, St>};
  err = launch_scan(kernels[plan.v], (B + plan.C - 1) / plan.C, plan.bytes,
                    stream, cheb, w, gates, cs, dys, dcs, dxg, L, B, J, H, k,
                    plan.C, vec);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = L * B * J, KH = k * H, count = KH * 4 * H;
  const int splits = lstm_dw_splits(rows, KH, H, sms);
  const int chunk = round_up((rows + splits - 1) / splits, kDwKT);
  const int tiles = dw_tiles(KH, 4 * H);
  const DwProblem<float, St> p{sa, dxg, part, KH, KH, 4 * H, 4 * H};
  auto dw_kernel = vec ? dw_tf32_kernel<true, float, St>
                       : dw_tf32_kernel<false, float, St>;
  err = cudaFuncSetAttribute(dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDwSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3(tiles, splits), kDwThreads, kDwSmemBytes, stream>>>(
      p, p, tiles, rows, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_two_kernel<St><<<(count + 255) / 256, 256, 0, stream>>>(
      part, count, dw, part, 0, dw, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The GRU scan: xg (L, B, J, 3H) gate pre-activations z|r|h, cheb (k-1, J, J)
// the matrices T_1 .. T_{k-1}, wzr (H, k 2H) and wh (H, k H) the
// hidden-side weights as the caller holds them (columns by Chebyshev order,
// then gate) -> ys (L, B, J, H). With gates, sa and sb (all three or
// none): the residuals the backward reads (KEEP), gates (L, B, J, 3H) and
// sa, sb (L B J, k H; columns unit-major). float32, contiguous. One launch
// on `stream`; returns the first CUDA error, or 0.
int pv2c_graph_gru_scan_fwd(const float* xg, const float* cheb,
                            const float* wzr, const float* wh, float* ys,
                            float* gates, float* sa, float* sb, int L, int B,
                            int J, int H, int k, cudaStream_t stream) {
  return gru_scan_fwd<float>(xg, cheb, wzr, wh, ys, gates, sa, sb, nullptr,
                             L, B, J, H, k, stream);
}

// The same in bf16 (every tensor but gates, sa and sb, which stay
// float32); zpark: a float32 scratch of B J H, needed where the plan's ring
// is 128 columns wide (pv2c_graph_gru_plan), else it may be null.
int pv2c_graph_gru_scan_fwd_bf16(const bf16* xg, const bf16* cheb,
                                 const bf16* wzr, const bf16* wh, bf16* ys,
                                 float* gates, float* sa, float* sb,
                                 float* zpark, int L, int B, int J, int H,
                                 int k, cudaStream_t stream) {
  return gru_scan_fwd<bf16>(xg, cheb, wzr, wh, ys, gates, sa, sb, zpark, L,
                            B, J, H, k, stream);
}

// How the GRU scan (bwd = 0) or its reverse scan (bwd = 1) is launched on
// the current device at this shape, in either storage type: plan[0] clips
// a thread block, plan[1] the ring's widest tile, plan[2] the shared
// memory bytes; zeros where one clip does not fit. Returns a CUDA error, or
// 0.
int pv2c_graph_gru_plan(int B, int J, int H, int k, int bwd, int* plan) {
  if (!valid(1, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GruPlan p = plan_gru(B, J, H, k, bwd != 0, sms);
  plan[0] = p.C;
  plan[1] = p.NT;
  plan[2] = static_cast<int>(p.bytes);
  return 0;
}

// Floats of the backward's `part` scratch, for gates = 3 (GRU) or 4 (LSTM),
// on the current device (float32 in both storage types). Returns minus a
// CUDA error code on failure.
int pv2c_graph_scan_part_floats(int L, int B, int J, int H, int k, int gates) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int rows = L * B * J, KH = k * H;
  const size_t floats =
      gates == 4 ? static_cast<size_t>(lstm_dw_splits(rows, KH, H, sms)) *
                       KH * 4 * H
                 : static_cast<size_t>(gru_dw_splits(rows, KH, H, sms)) * KH *
                       3 * H;
  if (floats > 0x7fffffff) return -static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(floats);
}

// The GRU scan's backward from the residuals of the KEEP forward (gates, sa,
// sb) and the cotangent dys: dxg (L, B, J, 3H), dwzr (H, k 2H) and dwh
// (H, k H), in the weights' own layout. Scratch: part
// (pv2c_graph_scan_part_floats). Three launches on `stream` (the reverse
// scan, both weight-gradient products, the sum of their splits); returns
// the first CUDA error, or 0.
int pv2c_graph_gru_scan_bwd(const float* cheb, const float* wzr,
                            const float* wh, const float* gates,
                            const float* sa, const float* sb,
                            const float* dys, float* dxg, float* part,
                            float* dwzr, float* dwh, int L, int B, int J,
                            int H, int k, cudaStream_t stream) {
  return gru_scan_bwd<float>(cheb, wzr, wh, gates, sa, sb, dys, dxg, part,
                             dwzr, dwh, L, B, J, H, k, stream);
}

// The same in bf16 (gates, sa, sb and part float32).
int pv2c_graph_gru_scan_bwd_bf16(const bf16* cheb, const bf16* wzr,
                                 const bf16* wh, const float* gates,
                                 const float* sa, const float* sb,
                                 const bf16* dys, bf16* dxg, float* part,
                                 bf16* dwzr, bf16* dwh, int L, int B, int J,
                                 int H, int k, cudaStream_t stream) {
  return gru_scan_bwd<bf16>(cheb, wzr, wh, gates, sa, sb, dys, dxg, part,
                            dwzr, dwh, L, B, J, H, k, stream);
}

// How the graph-form LSTM scan (bwd = 0) or its reverse scan (bwd = 1) is
// launched on the current device at this shape, in either storage type:
// plan[0] clips a thread block, plan[1] the ring's widest tile, plan[2] the
// shared memory bytes, plan[3] the rows of a block tile (64, or 16 in the
// few-rows tiling); zeros where one clip does not fit. Returns a CUDA
// error, or 0.
int pv2c_graph_lstm_plan(int B, int J, int H, int k, int bwd, int* plan) {
  if (!valid(1, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const LstmPlan p = plan_lstm(B, J, H, k, bwd != 0, sms);
  plan[0] = p.C;
  plan[1] = p.C ? lstm_tiling(bwd != 0, p.v).NT : 0;
  plan[2] = static_cast<int>(p.bytes);
  plan[3] = p.C ? (p.v == kFewRows ? kFewRowsMax : kGRows) : 0;
  return 0;
}

// The graph-form LSTM scan: xg (L, B, J, 4H) gate pre-activations i|f|c|o,
// cheb (k-1, J, J), w (H, k 4H) as the caller holds it (columns by
// Chebyshev order, then gate) -> ys and cs (L, B, J, H). With gates and sa
// (both or neither): the residuals the backward reads (KEEP), gates (L, B,
// J, 4H) = i|f|g|o activated and sa (L B J, k H; columns unit-major).
// float32, contiguous. One launch on `stream`; returns the first CUDA
// error, or 0.
int pv2c_graph_lstm_scan_fwd(const float* xg, const float* cheb,
                             const float* w, float* ys, float* cs,
                             float* gates, float* sa, int L, int B, int J,
                             int H, int k, cudaStream_t stream) {
  return lstm_scan_fwd<float>(xg, cheb, w, ys, cs, gates, sa, L, B, J, H, k,
                              stream);
}

// The same in bf16 (every tensor but gates and sa, which stay float32).
int pv2c_graph_lstm_scan_fwd_bf16(const bf16* xg, const bf16* cheb,
                                  const bf16* w, bf16* ys, bf16* cs,
                                  float* gates, float* sa, int L, int B, int J,
                                  int H, int k, cudaStream_t stream) {
  return lstm_scan_fwd<bf16>(xg, cheb, w, ys, cs, gates, sa, L, B, J, H, k,
                             stream);
}

// The graph-form LSTM scan's backward from the residuals of the KEEP
// forward (gates, sa), its cell states cs, the cotangent dys and, unless
// nullptr, the cell states' cotangent dcs: dxg (L, B, J, 4H) and dw
// (H, k 4H), in the weight's own layout. Scratch: part
// (pv2c_graph_scan_part_floats). Three launches on `stream` (the reverse
// scan, the weight-gradient product, the sum of its splits); returns the
// first CUDA error, or 0.
int pv2c_graph_lstm_scan_bwd(const float* cheb, const float* w,
                             const float* gates, const float* sa,
                             const float* cs, const float* dys,
                             const float* dcs, float* dxg, float* part,
                             float* dw, int L, int B, int J, int H, int k,
                             cudaStream_t stream) {
  return lstm_scan_bwd<float>(cheb, w, gates, sa, cs, dys, dcs, dxg, part,
                              dw, L, B, J, H, k, stream);
}

// The same in bf16 (gates, sa and part float32).
int pv2c_graph_lstm_scan_bwd_bf16(const bf16* cheb, const bf16* w,
                                  const float* gates, const float* sa,
                                  const bf16* cs, const bf16* dys,
                                  const bf16* dcs, bf16* dxg, float* part,
                                  bf16* dw, int L, int B, int J, int H, int k,
                                  cudaStream_t stream) {
  return lstm_scan_bwd<bf16>(cheb, w, gates, sa, cs, dys, dcs, dxg, part, dw,
                             L, B, J, H, k, stream);
}

}  // extern "C"

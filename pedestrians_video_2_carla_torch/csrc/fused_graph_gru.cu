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
// of the caller's tensors, but the LSTM's: its bf16 entries run kernels of
// their own, "The graph-form LSTM scans in bf16" below, whose graph terms
// are two bf16 parts), as the JAX kernels run on bf16 inputs: the
// products' operands where the JAX kernel rounds one to bf16 are rounded to
// bf16 (the carry, r h, the backward's cotangents da; the weights and graph
// matrices are bf16 values), and the graph terms, which the JAX kernel
// forms in another order (its products first, then the graph: the port's
// T_n h and the transposed products' outputs P_n have no JAX counterpart),
// to TF32; so one TF32 product a step is exact (a bf16 value is a TF32
// value) and the sums stay fp32. Graph terms at bf16 instead put a
// GConvLSTM's bf16 gradient 1.4x as far from its fp32 one as the JAX
// kernel's (tests/test_torch_graph_lstm_bf16.py holds the two-part terms to
// 1.1x). The carries (h, the LSTM's c, dh,
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

#include "bf16_fragments.cuh"
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
template <bool KEEP, int V>
__global__ void __launch_bounds__(kGThreads, 1)
lstm_scan_fwd_kernel(const float* __restrict__ xg,
                     const float* __restrict__ cheb,
                     const float* __restrict__ w, float* __restrict__ ys,
                     float* __restrict__ cs, float* __restrict__ gates,
                     float* __restrict__ sa, int L, int B, int J, int H, int k,
                     int C, bool vec) {
  constexpr LstmTiling kT = lstm_tiling(false, V);
  constexpr int NT = kT.NT;
  constexpr bool kHShared = V != 1;
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * C;
  const int R = min(C, B - b0) * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, ld = kpad(KH) + 4, CJH = C * J * H;
  constexpr int slot = fwd_slot<NT>();
  float* ring = smem;
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
    const float* x = xg + at * 4 * H;
    if (t > 0) {  // (frame 0's operand is the zeros S starts with)
      if (kHShared)
        put_units<false>(S, ld, k, hb, R, H);
      else
        put_units<false>(S, ld, k, ys + (at - rows) * H, R, H);
      __syncthreads();
      graph_product<false, false>(S, ld, R, J, H, k, Tm);
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
template <int V>
__global__ void __launch_bounds__(kGThreads, 1)
lstm_scan_bwd_kernel(const float* __restrict__ cheb,
                     const float* __restrict__ w,
                     const float* __restrict__ gates,
                     const float* __restrict__ cs,
                     const float* __restrict__ dys,
                     const float* __restrict__ dcs,
                     float* __restrict__ dxg, int L, int B, int J, int H,
                     int k, int C, bool vec) {
  constexpr LstmTiling kT = lstm_tiling(true, V);
  constexpr int NT = kT.NT;
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * C;
  const int R = min(C, B - b0) * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, ldp = kpad(KH) + 4, ldd = kpad(4 * H) + 4;
  constexpr int slot = bwd_slot<NT>();
  float* ring = smem;
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
    const float* c_now = cs + at * H;
    const float* c_prev = t > 0 ? cs + (at - rows) * H : nullptr;
    const float* dy = dys + at * H;
    const float* dc_in = dcs ? dcs + at * H : nullptr;
    float* dx = dxg + at * 4 * H;
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
      const float d[4] = {dc * g * i * (1.f - i),
                          dc * cp * f * (1.f - f),
                          dc * i * (1.f - g * g),
                          dh * tc * o * (1.f - o)};
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
      graph_product<true, false>(P, ldp, R, J, H, k, Tm);
    }
  }
}

// ---------------------------------------------------------------------------
// The graph-form LSTM scans in bf16 (rows 12 and 13 in bf16): kernels of
// their own for Hopper, in place of the float32 template's one TF32 pass.
//
// The products run on bf16 tensor cores: mma.sync m16n8k16, fp32 sums,
// every fragment loaded whole by ldmatrix from bf16 tiles in shared memory
// (bf16_fragments.cuh); no operand is widened. Rows of every bf16 tile are
// padded by 16 bytes, so that the eight rows of an 8 x 8 matrix meet
// distinct banks.
//
// The forward's operand is bf16: [h | hi_1 | lo_1 | .. | hi_{k-1} | lo_{k-1}]
// (column blocks of Hp = H rounded up to 16), against the weight's Chebyshev
// blocks [W_0; W_1; W_1; ..; W_{k-1}; W_{k-1}] (rows kappa = n Hp + u hold
// row u of W_n; a block is read twice, never copied): hi_n = bf16(T_n h) and
// lo_n = bf16(T_n h - hi_n), T_n h a bf16 product of the exact bf16 T_n and
// h summed in fp32. The graph terms so keep 16 significant bits (the
// float32 template rounded them to TF32's 11) at (2k - 1) H of depth
// instead of k H; the kept operand sa holds their sums rounded to TF32, which
// dW's one TF32 pass (dw_tf32.cuh) reads exactly. The backward's P = da W^T
// takes bf16 values as they are (da rounded to bf16, W); its transposed graph
// (graph_product) and dW stay the float32 template's.
//
// The weight on chip. Where a thread block's part of W fits its shared
// memory ("resident"), it is loaded once per launch and read every frame:
// the forward at J = 1, H = 128 (128 KB), and, over a cluster of 2 thread
// blocks, at GConvLSTM's layer (256 KB): each block of a cluster owns half
// the units (the columns of all four gates of them, all k H rows: 128 KB),
// computes their gates for every row of the cluster's clips, and sends its
// half of h and of the graph terms into its peer's operand through
// distributed shared memory once a frame, between two cluster barriers; c
// stays in registers (a thread owns the same (row, unit) pairs every frame).
// Where it does not fit ("streamed": the backward at GConvLSTM's layer, whose
// cotangents and P leave no room, and large H or k), W streams from L2
// through a 2-stage cp.async ring of 64-deep tiles (one barrier a tile;
// a 3-stage ring of 48-deep ones, two tiles in flight, measured 5 %
// slower in the backward at GConvLSTM's layer, PERF.md), and the forward
// keeps c in shared memory. Each frame
// also asks L2 for the next frame's inputs (prefetch.global.L2), so that
// their loads wait on L2 rather than on device memory.
//
// A frame of the resident forward: the product and the gating of each
// warp's items (an item: 16 MI rows x 8 units x 4 gates), no barrier
// between them; a barrier (the cluster's: the peer reads its own copy of
// the operand) before h goes into the operand; one before the graph terms;
// one after. The backward's frame: the gating backward into da; a barrier;
// the product into P; a barrier; the transposed graph on P (ends with one).
constexpr int kBThreads = 512;  // 16 warps
constexpr int kBWarps = kBThreads / 32;
constexpr int kBKT = 64;        // depth of a streamed weight tile
constexpr int kBStages = 2;     // a streamed weight ring's tiles
constexpr int kBItems = 2;      // a warp's items of a pass, at most
constexpr int kBPad = 8;        // a bf16 row's padding: 16 bytes

// The sites of the kernels' phase split (an instrumented copy defines
// PV2C_PHASE to stamp the clock at each; tools/graph_lstm_bf16_probe.py).
enum LstmPhase {
  kPhaseStart,
  kPhaseSetup,
  kPhaseSa,
  kPhaseRingWait,
  kPhaseProducts,
  kPhaseGating,
  kPhaseExchangeWait,
  kPhaseHPut,
  kPhaseGraph,
  kPhaseFrameWait,
  kPhaseElementwise,
  kPhasePStore,
  kPhaseGraphBwd
};
#ifndef PV2C_PHASE
#define PV2C_PHASE(site)
#endif

typedef unsigned short u16;  // a bf16 value's bits in shared memory

// The forward's shared memory, bytes from its start: the operand (C J rows
// of (2k - 1) Hp + 8 bf16); the weight (rows of 4 Upp + 8 bf16, gate g's
// units from column g Upp; resident: all k Hp rows, streamed: kBStages
// tiles of kBKT rows); the graph matrices T_1 .. T_{k-1} (Jp x Jp + 8
// bf16, Jp = J rounded up to 16, zero-padded); streamed: c (C J x H
// float).
struct LstmBf16Fwd {
  int Hp, KA, lda, Upp, ldw, KW, Jp, ldt;
  size_t w, t, c, bytes;
  __host__ __device__ LstmBf16Fwd(int C, int J, int H, int k, bool res,
                                  int up) {
    Hp = round_up(H, 16);
    KA = (2 * k - 1) * Hp;
    lda = KA + kBPad;
    Upp = round_up(up, 8);
    ldw = 4 * Upp + kBPad;
    KW = k * Hp;
    Jp = round_up(J, 16);
    ldt = Jp + kBPad;
    w = static_cast<size_t>(C) * J * lda * 2;
    t = w + static_cast<size_t>(res ? KW : kBStages * kBKT) * ldw * 2;
    c = t + static_cast<size_t>(k - 1) * Jp * ldt * 2;
    bytes = c + (res ? 0 : static_cast<size_t>(C) * J * H * 4);
  }
};

// The backward's: P (C J x kpad(k H) + 4 float, graph_product's unit-major
// columns); the dc carry (C J x H float); the graph matrices (load_graph's
// float); the weight W[kappa][c] = w(u, n 4H + c) (rows of C4 + 8 bf16, C4 =
// 4H rounded up to 16; resident: k Hp rows rounded up to 32, streamed:
// kBStages tiles of nt rows x kBKT + 8); the cotangents da (C J x C4 + 8
// bf16).
struct LstmBf16Bwd {
  int Hp, KB, C4, ldp, ldd, ldw, wrows;
  size_t dc, t, w, da, bytes;
  __host__ __device__ LstmBf16Bwd(int C, int J, int H, int k, bool res,
                                  int nt) {
    Hp = round_up(H, 16);
    KB = k * Hp;
    C4 = round_up(4 * H, 16);
    ldp = kpad(k * H) + 4;
    ldd = C4 + kBPad;
    ldw = res ? C4 + kBPad : kBKT + kBPad;
    wrows = res ? round_up(KB, 32) : kBStages * nt;
    const size_t R = static_cast<size_t>(C) * J;
    dc = R * ldp * 4;
    t = round_up(static_cast<int>(dc + R * H * 4), 16);
    w = round_up(static_cast<int>(t + static_cast<size_t>(k - 1) *
                                          graph_rows(J) *
                                          (graph_rows(J) + 4) * 4),
                 16);
    da = w + static_cast<size_t>(wrows) * ldw * 2;
    bytes = da + R * ldd * 2;
  }
};

__device__ __forceinline__ float bf_at(const u16* p) {
  return bits_to_float(*p);
}

__device__ __forceinline__ u16 raw_bf(const bf16* p) {
  return *reinterpret_cast<const u16*>(p);
}

// A barrier of the block, or of its cluster where it has a peer.
__device__ __forceinline__ void sync_all(int NS) {
  if (NS > 1)
    cluster_sync();
  else
    __syncthreads();
}

// Weight rows kappa in [r0, r0 + nr) of the forward's (k Hp)-row weight, the
// columns of units [ub, ub + nu) of each gate, into dst (rows of ldw, gate g
// from column g Upp), zeros where u >= H or past the units. The caller's w
// is (H, k 4H), or with wt the transpose of a contiguous (k 4H, H). vec:
// 16-byte cp.async copies (H a multiple of 8, w 16-byte aligned, not wt;
// the caller commits), else ordinary loads.
__device__ __forceinline__ void stage_fwd_w(u16* dst, const bf16* w, int wt,
                                            bool vec, int H, int k, int Hp,
                                            int Upp, int ldw, int r0, int nr,
                                            int ub, int nu) {
  const u16* src = reinterpret_cast<const u16*>(w);
  const size_t N = static_cast<size_t>(k) * 4 * H;
  if (vec) {
    const int per = Upp / 8;  // 16-byte pieces of a gate's units
    for (int e = threadIdx.x; e < nr * 4 * per; e += kBThreads) {
      const int r = e / (4 * per), rem = e - r * 4 * per;
      const int gate = rem / per, c0 = (rem - gate * per) * 8;
      const int kap = r0 + r, n = kap / Hp, u = kap - n * Hp;
      const bool ok = u < H && c0 < nu;
      const u16* from =
          ok ? src + u * N + n * 4 * H + gate * H + ub + c0 : src;
      cp_async16(reinterpret_cast<float*>(dst + r * ldw + gate * Upp + c0),
                 reinterpret_cast<const float*>(from), ok);
    }
  } else {
    for (int e = threadIdx.x; e < nr * 4 * Upp; e += kBThreads) {
      const int r = e / (4 * Upp), rem = e - r * 4 * Upp;
      const int gate = rem / Upp, c = rem - gate * Upp;
      const int kap = r0 + r, n = kap / Hp, u = kap - n * Hp;
      u16 v = 0;
      if (u < H && c < nu) {
        const size_t col = static_cast<size_t>(n) * 4 * H + gate * H + ub + c;
        v = wt ? src[col * H + u] : src[u * N + col];
      }
      dst[r * ldw + gate * Upp + c] = v;
    }
  }
}

// Weight rows kappa in [r0, r0 + nr), columns c in [c0, c0 + nc) of the
// backward's W[kappa][c] = w(u, n 4H + c) into dst (rows of ldw), zeros where
// u >= H, n >= k or c >= 4H. vec: 16-byte cp.async copies (H even, w
// 16-byte aligned, not wt), else ordinary loads.
__device__ __forceinline__ void stage_bwd_w(u16* dst, const bf16* w, int wt,
                                            bool vec, int H, int k, int Hp,
                                            int ldw, int r0, int nr, int c0,
                                            int nc) {
  const u16* src = reinterpret_cast<const u16*>(w);
  const size_t N = static_cast<size_t>(k) * 4 * H;
  const int per = vec ? nc / 8 : nc;
  for (int e = threadIdx.x; e < nr * per; e += kBThreads) {
    const int r = e / per, c = (e - r * per) * (vec ? 8 : 1);
    const int kap = r0 + r, n = kap / Hp, u = kap - n * Hp;
    const bool ok = n < k && u < H && c0 + c < 4 * H;
    const size_t col = static_cast<size_t>(n) * 4 * H + c0 + c;
    if (vec) {
      cp_async16(reinterpret_cast<float*>(dst + r * ldw + c),
                 reinterpret_cast<const float*>(ok ? src + u * N + col : src),
                 ok);
    } else {
      dst[r * ldw + c] = ok ? (wt ? src[col * H + u] : src[u * N + col]) : 0;
    }
  }
}

// acc[MI][gate] += the item's rows of the forward's operand A times weight
// rows [kap0, kap1) of the tile Wt (its row 0 is weight row tile_r0), unit
// group ug of the tile's columns: per 16 rows two transposed ldmatrix of W
// (the four gates), one ldmatrix of A per m16 tile (two in a Chebyshev
// block n >= 1: hi, then lo against the same W rows), 4 MI (or 8 MI) mma.
// Rows past Rv read row Rv - 1 (their sums are dropped).
template <int MI>
__device__ __forceinline__ void fwd_item_product(float (*acc)[4][4],
                                                 const u16* A, int lda,
                                                 int arow0, int Rv,
                                                 const u16* Wt, int ldw,
                                                 int Upp, int ug, int kap0,
                                                 int kap1, int tile_r0,
                                                 int Hp) {
  const int lane = threadIdx.x & 31;
  const u16* arow[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    arow[mi] = A +
               min(arow0 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                   Rv - 1) * lda +
               (lane >> 4) * 8;
  const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const u16* b01 = Wt + krow * ldw + (lane >> 4) * Upp + ug * 8;
  // the four gates' B fragments of weight rows kap .. kap + 15
  const auto load_b = [&](unsigned (*b)[2], int kap) {
    const u16* bk = b01 + (kap - tile_r0) * ldw;
    unsigned r4[4];
    ldsm_x4_t(r4, bk);  // gates 0 | 1
    b[0][0] = r4[0], b[0][1] = r4[1], b[1][0] = r4[2], b[1][1] = r4[3];
    ldsm_x4_t(r4, bk + 2 * Upp);  // gates 2 | 3
    b[2][0] = r4[0], b[2][1] = r4[1], b[3][0] = r4[2], b[3][1] = r4[3];
  };
  // a Chebyshev block at a time: h (n = 0), or hi_n then lo_n against
  // the same weight rows
  for (int n = kap0 / Hp; n * Hp < kap1; ++n) {
    const int k0 = max(kap0, n * Hp), k1 = min(kap1, (n + 1) * Hp);
    if (n == 0) {
#pragma unroll 2
      for (int kap = k0; kap < k1; kap += 16) {
        unsigned b[4][2];
        load_b(b, kap);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          unsigned a[4];
          ldsm_x4(a, arow[mi] + kap);
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            mma_bf16(acc[mi][gate], a, b[gate]);
        }
      }
    } else {
      const int col = (n - 1) * Hp;  // hi_n of weight row kap: kap + col
#pragma unroll 2
      for (int kap = k0; kap < k1; kap += 16) {
        unsigned b[4][2];
        load_b(b, kap);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          unsigned a[4], a2[4];
          ldsm_x4(a, arow[mi] + kap + col);
          ldsm_x4(a2, arow[mi] + kap + col + Hp);
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) {
            mma_bf16(acc[mi][gate], a, b[gate]);
            mma_bf16(acc[mi][gate], a2, b[gate]);
          }
        }
      }
    }
  }
}

// acc[MI][j] += the item's rows of da times the tile Wt's kappa rows
// [wrow0, wrow0 + 32) (four mma tiles of 8), over c in [c0, c1) (the
// tile's column 0 is c = tile_c0): two ldmatrix of W, one of da per m16
// tile, 4 MI mma per 16 of depth.
template <int MI>
__device__ __forceinline__ void bwd_item_product(float (*acc)[4][4],
                                                 const u16* da, int ldd,
                                                 int arow0, int Rv,
                                                 const u16* Wt, int ldw,
                                                 int wrow0, int c0, int c1,
                                                 int tile_c0) {
  const int lane = threadIdx.x & 31;
  const u16* arow[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    arow[mi] = da +
               min(arow0 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                   Rv - 1) * ldd +
               (lane >> 4) * 8;
  const u16* brow =
      Wt + (wrow0 + (lane & 7) + (lane >> 4) * 8) * ldw + ((lane >> 3) & 1) * 8;
  for (int c = c0; c < c1; c += 16) {
    unsigned b[4][2], r4[4];
    ldsm_x4(r4, brow + (c - tile_c0));
    b[0][0] = r4[0], b[0][1] = r4[1], b[1][0] = r4[2], b[1][1] = r4[3];
    ldsm_x4(r4, brow + 16 * ldw + (c - tile_c0));
    b[2][0] = r4[0], b[2][1] = r4[1], b[3][0] = r4[2], b[3][1] = r4[3];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      unsigned a[4];
      ldsm_x4(a, arow[mi] + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[mi][j], a, b[j]);
    }
  }
}

// The forward. C clips a cluster of NS thread blocks (1 or 2; block q owns
// units [q H / NS, (q + 1) H / NS)); up: units of a pass (resident: all the
// block's). Per frame: a = x + [h | hi_n | lo_n] [W_0; W_n; W_n] for the
// block's units, the gating on the accumulators (c' = f c + i g, h' = o
// tanh(c')) into ys, cs and (KEEP) gates; then h' and its graph terms into
// the operand, the peer's too. KEEP also writes sa, every frame's operand
// (unit-major, the graph terms' hi + lo rounded to TF32).
template <bool KEEP, bool RES, int MI>
__global__ void __launch_bounds__(kBThreads, 1)
lstm_bf16_fwd_kernel(const bf16* __restrict__ xg, const bf16* __restrict__ cheb,
                     const bf16* __restrict__ w, bf16* __restrict__ ys,
                     bf16* __restrict__ cs, float* __restrict__ gates,
                     float* __restrict__ sa, int L, int B, int J, int H, int k,
                     int C, int NS, int up, int wt, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PV2C_PHASE(kPhaseStart);
  const LstmBf16Fwd lay(C, J, H, k, RES, up);
  u16* A = reinterpret_cast<u16*>(smem_raw);
  u16* Wsm = reinterpret_cast<u16*>(smem_raw + lay.w);
  u16* Tm = reinterpret_cast<u16*>(smem_raw + lay.t);
  float* cb = reinterpret_cast<float*>(smem_raw + lay.c);
  const int q = NS > 1 ? static_cast<int>(cluster_rank()) : 0;
  u16* Apeer = NS > 1 ? cluster_peer(A, q ^ 1) : nullptr;
  const int b0 = (blockIdx.x / NS) * C;
  const int Rv = min(C, B - b0) * J, R = C * J, rows = B * J, row0 = b0 * J;
  const int Hq = H / NS, ubeg = q * Hq, uend = ubeg + Hq;
  const int KH = k * H, Hp = lay.Hp, lda = lay.lda, ldw = lay.ldw;
  const int Upp = lay.Upp, KW = lay.KW, Jp = lay.Jp, ldt = lay.ldt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nrg = (R + 16 * MI - 1) / (16 * MI);  // row groups of an item
  const int passes = (Hq + up - 1) / up;
  const int nchunks = RES ? 1 : (KW + kBKT - 1) / kBKT;
  const int tiles = passes * nchunks;  // streamed tiles a frame

  for (int i = threadIdx.x; i < R * lda / 2; i += kBThreads)
    reinterpret_cast<unsigned*>(A)[i] = 0u;
  if (!RES)
    for (int i = threadIdx.x; i < R * H; i += kBThreads) cb[i] = 0.f;
  for (int i = threadIdx.x; i < (k - 1) * Jp * ldt; i += kBThreads) {
    const int n = i / (Jp * ldt), rem = i - n * Jp * ldt;
    const int r = rem / ldt, c = rem - r * ldt;
    Tm[i] = r < J && c < J ? raw_bf(cheb + (n * J + r) * J + c) : 0;
  }
  // streamed: tile s of the ring (pass (s % tiles) / nchunks, its chunk)
  // into slot s % kBStages (NS = 1)
  const auto stage_tile = [&](int s) {
    const int s1 = s % tiles, p1 = s1 / nchunks;
    const int r1 = (s1 - p1 * nchunks) * kBKT;
    stage_fwd_w(Wsm + (s % kBStages) * kBKT * ldw, w, wt, vec, H, k, Hp,
                Upp, ldw, r1, min(kBKT, KW - r1), p1 * up,
                min(up, Hq - p1 * up));
  };
  if (RES) {
    stage_fwd_w(Wsm, w, wt, vec, H, k, Hp, Upp, ldw, 0, KW, ubeg, Hq);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int s = 0; s < kBStages - 1; ++s) {
      if (s < L * tiles) stage_tile(s);
      cp_async_commit();
    }
  }
  sync_all(NS);  // (a cluster's blocks have all started)
  PV2C_PHASE(kPhaseSetup);

  // streamed: the starting sums of an item, x of its rows and units (zeros
  // past them)
  const auto init = [&](float (*acc)[4][4], const bf16* x, int r0, int u0,
                        int ulim) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + mi * 16 + g + 8 * (e >> 1);
        const int u = u0 + 2 * tq + (e & 1);
        const bool ok = row < Rv && u < ulim;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          acc[mi][gate][e] =
              ok ? ldg1(x + static_cast<size_t>(row) * 4 * H + gate * H + u)
                 : 0.f;
      }
  };
  // resident: an item's x as bf16 pairs (units u, u + 1), loaded before its
  // product and added after it, so that the loads wait behind the product
  const auto load_x = [&](unsigned (*xv)[4][2], const bf16* x, int r0,
                          int u0, int ulim) {
    const int u = u0 + 2 * tq;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + mi * 16 + g + 8 * hh;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          const bf16* p = x + static_cast<size_t>(row) * 4 * H + gate * H + u;
          unsigned v = 0;
          if (row < Rv && u < ulim) {
            if (H % 2 == 0)  // (u even, so u + 1 < ulim too)
              v = __ldg(reinterpret_cast<const unsigned*>(p));
            else
              v = raw_bf(p) | (u + 1 < ulim ? static_cast<unsigned>(
                                                  raw_bf(p + 1)) << 16
                                            : 0u);
          }
          xv[mi][gate][hh] = v;
        }
      }
  };
  float creg[kBItems][MI][4], hreg[kBItems][MI][4];  // RES: c and h'
#pragma unroll
  for (int j = 0; j < kBItems; ++j)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) creg[j][mi][e] = hreg[j][mi][e] = 0.f;

  for (int t = 0; t < L; ++t) {
    const size_t at = static_cast<size_t>(t) * rows + row0;
    const bf16* x = xg + at * 4 * H;
    if (t + 1 < L)  // the next frame's x (the cluster's rows), into L2
      prefetch_l2(x + static_cast<size_t>(rows) * 4 * H,
                  static_cast<size_t>(Rv) * 4 * H * 2);
    if (KEEP) {  // this frame's operand, the block's units
      for (int row = warp; row < Rv; row += kBWarps)
        for (int u = ubeg + lane; u < uend; u += 32) {
          const u16* a = A + row * lda + u;
          float* out = sa + (at + row) * KH + u * k;
          out[0] = bf_at(a);
          for (int n = 1; n < k; ++n)
            out[n] = round_tf32(bf_at(a + (2 * n - 1) * Hp) +
                                bf_at(a + 2 * n * Hp));
        }
      PV2C_PHASE(kPhaseSa);
    }
    // the gating of an item's accumulators: c (registers where resident,
    // else shared memory), h', ys, cs, the kept gates; the units u, u + 1
    // of a row stored as pairs where H is even
    const auto gating = [&](float (*acc)[4][4], int r0, int u0, int ulim,
                            float (*cr)[4], float (*hr)[4]) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + mi * 16 + g + 8 * hh;
          const int u = u0 + 2 * tq;
          float hv[2], cv[2], gv[4][2];
          bool ok[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q2 = 2 * hh + e;
            ok[e] = row < Rv && u + e < ulim;
            gv[0][e] = sigmoid(acc[mi][0][q2]);
            gv[1][e] = sigmoid(acc[mi][1][q2]);
            gv[2][e] = tanhf(acc[mi][2][q2]);
            gv[3][e] = sigmoid(acc[mi][3][q2]);
            const float cp =
                RES ? cr[mi][q2] : (ok[e] ? cb[row * H + u + e] : 0.f);
            cv[e] = gv[1][e] * cp + gv[0][e] * gv[2][e];
            hv[e] = gv[3][e] * tanhf(cv[e]);
            if (RES) {
              cr[mi][q2] = ok[e] ? cv[e] : 0.f;
              hr[mi][q2] = ok[e] ? hv[e] : 0.f;
            } else if (ok[e]) {
              cb[row * H + u + e] = cv[e];
            }
          }
          const size_t idx = (at + row) * H + u;
          float* gt = KEEP ? gates + (at + row) * 4 * H + u : nullptr;
          if (ok[0] && ok[1] && H % 2 == 0) {
            st2g(ys + idx, make_float2(hv[0], hv[1]));
            st2g(cs + idx, make_float2(cv[0], cv[1]));
            if (KEEP)
#pragma unroll
              for (int gate = 0; gate < 4; ++gate)
                st2g(gt + gate * H, make_float2(gv[gate][0], gv[gate][1]));
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (ok[e]) {
                put(ys + idx + e, hv[e]);
                put(cs + idx + e, cv[e]);
                if (KEEP)
#pragma unroll
                  for (int gate = 0; gate < 4; ++gate)
                    gt[gate * H + e] = gv[gate][e];
              }
          }
        }
    };
    if constexpr (RES) {
      const int ngr = (Hq + 7) / 8, items = nrg * ngr;
#pragma unroll
      for (int j = 0; j < kBItems; ++j) {
        const int it = warp + j * kBWarps;
        if (it < items) {
          const int r0 = (it / ngr) * 16 * MI, ug = it % ngr;
          unsigned xv[MI][4][2];
          load_x(xv, x, r0, ubeg + ug * 8, uend);
          float acc[MI][4][4];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int gate = 0; gate < 4; ++gate)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][gate][e] = 0.f;
          fwd_item_product<MI>(acc, A, lda, r0, Rv, Wsm, ldw, Upp, ug, 0, KW,
                               0, Hp);
          PV2C_PHASE(kPhaseProducts);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int gate = 0; gate < 4; ++gate)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const unsigned v = xv[mi][gate][e >> 1];
                acc[mi][gate][e] += __uint_as_float(e & 1 ? v & 0xffff0000u
                                                          : v << 16);
              }
          gating(acc, r0, ubeg + ug * 8, uend, creg[j], hreg[j]);
        }
      }
      PV2C_PHASE(kPhaseGating);
    } else {
      for (int p = 0; p < passes; ++p) {
        const int pb = p * up, pn = min(up, Hq - pb);  // (NS = 1)
        const int ngr = (pn + 7) / 8, items = nrg * ngr;
        float acc[kBItems][MI][4][4];
#pragma unroll
        for (int j = 0; j < kBItems; ++j) {
          const int it = warp + j * kBWarps;
          if (it < items)
            init(acc[j], x, (it / ngr) * 16 * MI, pb + (it % ngr) * 8,
                 pb + pn);
        }
        for (int kc = 0; kc < nchunks; ++kc) {
          const int s = t * tiles + p * nchunks + kc;
          cp_async_wait<kBStages - 2>();
          __syncthreads();  // tile s has landed; slot s - 1's is free
          PV2C_PHASE(kPhaseRingWait);
          if (s + kBStages - 1 < L * tiles) stage_tile(s + kBStages - 1);
          cp_async_commit();
          const u16* Wt = Wsm + (s % kBStages) * kBKT * ldw;
          const int r0 = kc * kBKT, r1 = min(KW, r0 + kBKT);
#pragma unroll
          for (int j = 0; j < kBItems; ++j) {
            const int it = warp + j * kBWarps;
            if (it < items)
              fwd_item_product<MI>(acc[j], A, lda, (it / ngr) * 16 * MI, Rv,
                                   Wt, ldw, Upp, it % ngr, r0, r1, r0, Hp);
          }
          PV2C_PHASE(kPhaseProducts);
        }
#pragma unroll
        for (int j = 0; j < kBItems; ++j) {
          const int it = warp + j * kBWarps;
          if (it < items)
            gating(acc[j], (it / ngr) * 16 * MI, pb + (it % ngr) * 8, pb + pn,
                   nullptr, nullptr);
        }
        PV2C_PHASE(kPhaseGating);
      }
    }
    if (t + 1 == L) break;  // the last frame's h is read by no frame
    sync_all(NS);  // every read of the operand is done, the peer's too
    PV2C_PHASE(kPhaseExchangeWait);
    if constexpr (RES) {  // h' from registers, the block's units
      const int ngr = (Hq + 7) / 8, items = nrg * ngr;
#pragma unroll
      for (int j = 0; j < kBItems; ++j) {
        const int it = warp + j * kBWarps;
        if (it < items) {
          const int r0 = (it / ngr) * 16 * MI;
          const int u = ubeg + (it % ngr) * 8 + 2 * tq;
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = r0 + mi * 16 + g + 8 * hh;
              if (row < Rv) {
                const unsigned v =
                    pack2(hreg[j][mi][2 * hh], hreg[j][mi][2 * hh + 1]);
                const int off = row * lda + u;
                *reinterpret_cast<unsigned*>(A + off) = v;
                if (NS > 1) *reinterpret_cast<unsigned*>(Apeer + off) = v;
              }
            }
        }
      }
    } else {  // h' from ys (bf16, as the operand takes it)
      for (int i = threadIdx.x; i < Rv * H; i += kBThreads) {
        const int row = i / H, u = i - row * H;
        A[row * lda + u] = raw_bf(ys + at * H + i);
      }
    }
    PV2C_PHASE(kPhaseHPut);
    if (k > 1) {  // the graph terms of the block's units, both halves
      __syncthreads();  // h' is in the operand
      const int mt = Jp / 16, ngu = (Hq + 7) / 8, clips = Rv / J;
      const int tasks = (k - 1) * clips * mt * ngu;
      for (int task = warp; task < tasks; task += kBWarps) {
        const int n = 1 + task / (clips * mt * ngu);
        int rem = task - (n - 1) * clips * mt * ngu;
        const int c = rem / (mt * ngu);
        rem -= c * mt * ngu;
        const int m0 = (rem / ngu) * 16, u0 = ubeg + (rem % ngu) * 8;
        const u16* Tn = Tm + (n - 1) * Jp * ldt +
                        (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldt +
                        (lane >> 4) * 8;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j0 = 0; j0 < Jp; j0 += 16) {
          unsigned a[4], b[2];
          ldsm_x4(a, Tn + j0);
          ldsm_x2_t(b, A + min(c * J + j0 + (lane & 15), Rv - 1) * lda + u0);
          mma_bf16(acc, a, b);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = m0 + g + 8 * hh;
          if (i < J) {
            const float x0 = acc[2 * hh], x1 = acc[2 * hh + 1];
            const float hi0 = round_bf(x0), hi1 = round_bf(x1);
            const unsigned vhi = pack2(hi0, hi1);
            const unsigned vlo = pack2(x0 - hi0, x1 - hi1);
            const int off = (c * J + i) * lda + (2 * n - 1) * Hp + u0 + 2 * tq;
            *reinterpret_cast<unsigned*>(A + off) = vhi;
            *reinterpret_cast<unsigned*>(A + off + Hp) = vlo;
            if (NS > 1) {
              *reinterpret_cast<unsigned*>(Apeer + off) = vhi;
              *reinterpret_cast<unsigned*>(Apeer + off + Hp) = vlo;
            }
          }
        }
      }
      PV2C_PHASE(kPhaseGraph);
    }
    sync_all(NS);  // the operand is whole, in both blocks
    PV2C_PHASE(kPhaseFrameWait);
  }
}

// The reverse scan, from the forward's residuals. Per frame, in reverse: dh
// = dy + the carry; dc = dh o (1 - tanh(c)^2) + the carry (+ dcs); da from
// the kept gates, c and the previous c (rounded to bf16) -> dxg and shared
// memory; dc f carried; P = da W^T on the bf16 tensor cores (items of 16 MI
// rows x 32 weight rows; nt weight rows a pass); then the transposed graph
// on P (the carry dh in its columns u k).
template <bool RES, int MI>
__global__ void __launch_bounds__(kBThreads, 1)
lstm_bf16_bwd_kernel(const bf16* __restrict__ cheb, const bf16* __restrict__ w,
                     const float* __restrict__ gates,
                     const bf16* __restrict__ cs, const bf16* __restrict__ dys,
                     const bf16* __restrict__ dcs, bf16* __restrict__ dxg,
                     int L, int B, int J, int H, int k, int C, int nt, int wt,
                     int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PV2C_PHASE(kPhaseStart);
  const LstmBf16Bwd lay(C, J, H, k, RES, nt);
  float* P = reinterpret_cast<float*>(smem_raw);
  float* dcb = reinterpret_cast<float*>(smem_raw + lay.dc);
  float* Tm = reinterpret_cast<float*>(smem_raw + lay.t);
  u16* Wsm = reinterpret_cast<u16*>(smem_raw + lay.w);
  u16* da = reinterpret_cast<u16*>(smem_raw + lay.da);
  const int b0 = blockIdx.x * C;
  const int Rv = min(C, B - b0) * J, R = C * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, Hp = lay.Hp, KB = lay.KB, C4 = lay.C4;
  const int ldp = lay.ldp, ldd = lay.ldd, ldw = lay.ldw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nrg = (R + 16 * MI - 1) / (16 * MI);
  const int passes = RES ? 1 : (KB + nt - 1) / nt;
  const int nchunks = RES ? 1 : (C4 + kBKT - 1) / kBKT;
  const int tiles = passes * nchunks;

  for (int i = threadIdx.x; i < R * (ldp + H); i += kBThreads) P[i] = 0.f;
  for (int i = threadIdx.x; i < R * ldd / 2; i += kBThreads)
    reinterpret_cast<unsigned*>(da)[i] = 0u;
  load_graph(Tm, cheb, J, k);
  // streamed: tile s of the ring (pass (s % tiles) / nchunks, its chunk of
  // depth) into slot s % kBStages
  const auto stage_tile = [&](int s) {
    const int s1 = s % tiles, p1 = s1 / nchunks;
    const int c1 = (s1 - p1 * nchunks) * kBKT;
    stage_bwd_w(Wsm + (s % kBStages) * nt * ldw, w, wt, vec, H, k, Hp, ldw,
                p1 * nt, nt, c1, min(kBKT, C4 - c1));
  };
  if (RES) {
    stage_bwd_w(Wsm, w, wt, vec, H, k, Hp, ldw, 0, lay.wrows, 0, C4);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int s = 0; s < kBStages - 1; ++s) {
      if (s < L * tiles) stage_tile(s);
      cp_async_commit();
    }
  }
  __syncthreads();
  PV2C_PHASE(kPhaseSetup);

  // P's columns of an item's sums: weight row kappa = n Hp + u -> u k + n
  const auto store_p = [&](float (*acc)[4][4], int r0, int kb) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + mi * 16 + g + 8 * (e >> 1);
          const int kap = kb + j * 8 + 2 * tq + (e & 1);
          const int n = kap / Hp, u = kap - n * Hp;
          if (row < Rv && u < H && n < k)
            P[row * ldp + u * k + n] = acc[mi][j][e];
        }
  };
  for (int t = L - 1; t >= 0; --t) {
    const size_t at = static_cast<size_t>(t) * rows + row0;
    const float* gt = gates + at * 4 * H;
    const bf16* c_now = cs + at * H;
    const bf16* c_prev = t > 0 ? cs + (at - rows) * H : nullptr;
    const bf16* dy = dys + at * H;
    const bf16* dc_in = dcs ? dcs + at * H : nullptr;
    bf16* dx = dxg + at * 4 * H;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < Rv * H; idx += kBThreads) {
      const int row = idx / H, u = idx - row * H;
      const float* g4 = gt + row * 4 * H + u;
      const float i = __ldg(g4), f = __ldg(g4 + H), gg = __ldg(g4 + 2 * H),
                  o = __ldg(g4 + 3 * H);
      const float tc = tanhf(ldg1(c_now + idx));
      const float dh = ldg1(dy + idx) + P[row * ldp + u * k];
      float dc = dh * o * (1.f - tc * tc) + dcb[idx];
      if (dc_in) dc += ldg1(dc_in + idx);
      const float cp = c_prev ? ldg1(c_prev + idx) : 0.f;
      const float d[4] = {round_bf(dc * gg * i * (1.f - i)),
                          round_bf(dc * cp * f * (1.f - f)),
                          round_bf(dc * i * (1.f - gg * gg)),
                          round_bf(dh * tc * o * (1.f - o))};
      dcb[idx] = dc * f;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        put(dx + row * 4 * H + gate * H + u, d[gate]);
        da[row * ldd + gate * H + u] = bf16_bits(d[gate]);
      }
    }
    if (t > 0) {  // the next frame's residuals and cotangents, into L2,
                  // while this frame's product runs
      const size_t n1 = static_cast<size_t>(Rv) * H * 2;
      prefetch_l2(gates + (at - rows) * 4 * H, 8 * n1);
      prefetch_l2(dys + (at - rows) * H, n1);
      if (dcs) prefetch_l2(dcs + (at - rows) * H, n1);
      if (t > 1) prefetch_l2(cs + (at - 2 * rows) * H, n1);
    }
    __syncthreads();  // da is complete; P is free
    PV2C_PHASE(kPhaseElementwise);
    if constexpr (RES) {
      const int ngk = lay.wrows / 32, items = nrg * ngk;
      for (int it = warp; it < items; it += kBWarps) {
        const int r0 = (it / ngk) * 16 * MI, kb = (it % ngk) * 32;
        float acc[MI][4][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
        bwd_item_product<MI>(acc, da, ldd, r0, Rv, Wsm, ldw, kb, 0, C4, 0);
        store_p(acc, r0, kb);
      }
    } else {
      for (int p = 0; p < passes; ++p) {
        const int kb0 = p * nt;
        const int ngk = min(nt, round_up(KB - kb0, 32)) / 32;
        const int items = nrg * ngk;
        float acc[kBItems][MI][4][4];
#pragma unroll
        for (int j = 0; j < kBItems; ++j)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][mi][jj][e] = 0.f;
        for (int kc = 0; kc < nchunks; ++kc) {
          const int s = (L - 1 - t) * tiles + p * nchunks + kc;
          cp_async_wait<kBStages - 2>();
          __syncthreads();  // tile s has landed; slot s - 1's is free
          PV2C_PHASE(kPhaseRingWait);
          if (s + kBStages - 1 < L * tiles) stage_tile(s + kBStages - 1);
          cp_async_commit();
          const u16* Wt = Wsm + (s % kBStages) * nt * ldw;
          const int c0 = kc * kBKT, c1 = min(C4, c0 + kBKT);
#pragma unroll
          for (int j = 0; j < kBItems; ++j) {
            const int it = warp + j * kBWarps;
            if (it < items)
              bwd_item_product<MI>(acc[j], da, ldd, (it / ngk) * 16 * MI, Rv,
                                   Wt, ldw, (it % ngk) * 32, c0, c1, c0);
          }
          PV2C_PHASE(kPhaseProducts);
        }
#pragma unroll
        for (int j = 0; j < kBItems; ++j) {
          const int it = warp + j * kBWarps;
          if (it < items)
            store_p(acc[j], (it / ngk) * 16 * MI, kb0 + (it % ngk) * 32);
        }
      }
    }
    __syncthreads();  // P is complete
    PV2C_PHASE(kPhasePStore);
    if (t > 0) {
      graph_product<true, true>(P, ldp, Rv, J, H, k, Tm);
      PV2C_PHASE(kPhaseGraphBwd);
    }
  }
}

// dW = sa^T dxg of the bf16 reverse scan on the bf16 tensor cores, in
// place of the float32 template's one TF32 pass: part[split] (k H x 4H) =
// the split's rows of sa^T dxg, the splits summed in a fixed order after
// (reduce_two_kernel). sa's values are TF32 values (h's bf16, the graph
// terms' hi + lo rounded to TF32): each is hi + lo of two bf16 values
// exactly, so hi^T dxg + lo^T dxg gives the same products as the TF32
// pass, summed in fp32. A thread block: a 128 x 128 tile of dW (8 warps, 2
// x 4, each 64 x 32) over its split's rows, 32 rows a step: sa's fp32 rows
// loaded into registers a step ahead and split into two bf16 tiles,
// dxg's bf16 rows by cp.async, two stages; every fragment by ldmatrix,
// transposed (both tiles lie row by row). Grid and part as dw_tf32's.
constexpr int kBDwThreads = 256;
constexpr int kBDwKT = 32;
constexpr int kBDwLd = kDwTile + kBPad;  // a tile row: 128 + 8 bf16
constexpr int kBDwStage = 3 * kBDwKT * kBDwLd;  // hi, lo, dxg (bf16 each)
constexpr int kBDwSmemBytes = 2 * kBDwStage * 2;

template <bool VEC>
__global__ void __launch_bounds__(kBDwThreads, 2)
lstm_bf16_dw_kernel(const float* __restrict__ sa, const bf16* __restrict__ dxg,
                    float* __restrict__ part, int M, int N, int rows,
                    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u16* stage0 = reinterpret_cast<u16*>(smem_raw);
  const int tn = (N + kDwTile - 1) / kDwTile;
  const int m0 = (blockIdx.x / tn) * kDwTile, n0 = (blockIdx.x % tn) * kDwTile;
  const int kbeg = blockIdx.y * chunk, kend = min(rows, kbeg + chunk);
  const int steps = kend > kbeg ? (kend - kbeg + kBDwKT - 1) / kBDwKT : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const auto hi_of = [&](int s) { return stage0 + (s & 1) * kBDwStage; };
  // sa's rows of a step, 16 floats a thread (4 runs of 4 columns)
  float4 next[4];
  const auto load_a = [&](int step) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kBDwThreads, r = e >> 5, c = (e & 31) * 4;
      const int row = kbeg + step * kBDwKT + r, col = m0 + c;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = 0.f;
      if (row < kend) {
        const float* p = sa + static_cast<size_t>(row) * M + col;
        if (VEC && col < M) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p));
          v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
        } else if (!VEC) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < M) v[j] = __ldg(p + j);
        }
      }
      next[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  // ... split into the stage's hi and lo tiles
  const auto store_a = [&](int s) {
    u16* hi = hi_of(s);
    u16* lo = hi + kBDwKT * kBDwLd;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kBDwThreads, r = e >> 5, c = (e & 31) * 4;
      const float v[4] = {next[i].x, next[i].y, next[i].z, next[i].w};
      float h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = round_bf(v[j]);
        l[j] = v[j] - h[j];
      }
      *reinterpret_cast<uint2*>(hi + r * kBDwLd + c) =
          make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
      *reinterpret_cast<uint2*>(lo + r * kBDwLd + c) =
          make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
    }
  };
  // dxg's rows of a step into the stage's third tile
  const auto load_b = [&](int step, int s) {
    u16* dst = hi_of(s) + 2 * kBDwKT * kBDwLd;
    const u16* src = reinterpret_cast<const u16*>(dxg);
    if (VEC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + i * kBDwThreads, r = e >> 4, c = (e & 15) * 8;
        const int row = kbeg + step * kBDwKT + r, col = n0 + c;
        const bool ok = row < kend && col < N;
        cp_async16(reinterpret_cast<float*>(dst + r * kBDwLd + c),
                   reinterpret_cast<const float*>(
                       ok ? src + static_cast<size_t>(row) * N + col : src),
                   ok);
      }
    } else {
      for (int e = tid; e < kBDwKT * kDwTile; e += kBDwThreads) {
        const int r = e / kDwTile, c = e - r * kDwTile;
        const int row = kbeg + step * kBDwKT + r, col = n0 + c;
        dst[r * kBDwLd + c] = row < kend && col < N
                                  ? src[static_cast<size_t>(row) * N + col]
                                  : 0;
      }
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  if (steps > 0) {
    load_a(0);
    store_a(0);
    load_b(0, 0);
  }
  cp_async_commit();
  // this lane's ldmatrix rows: A^T from sa's rows (k) at columns m, B from
  // dxg's rows (k) at columns n
  const int ak = (lane & 7) + (lane >> 4) * 8, am = ((lane >> 3) & 1) * 8;
  const int bk = (lane & 7) + ((lane >> 3) & 1) * 8, bn = (lane >> 4) * 8;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // stage step % 2 is whole; the other stage is free
    if (step + 1 < steps) {
      load_b(step + 1, step + 1);
      load_a(step + 1);
    }
    cp_async_commit();
    const u16* hi = hi_of(step);
    const u16* lo = hi + kBDwKT * kBDwLd;
    const u16* bt = hi + 2 * kBDwKT * kBDwLd;
#pragma unroll
    for (int kk = 0; kk < kBDwKT; kk += 16) {
      unsigned b[4][2], r4[4];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        ldsm_x4_t(r4, bt + (kk + bk) * kBDwLd + wn + jp * 16 + bn);
        b[2 * jp][0] = r4[0], b[2 * jp][1] = r4[1];
        b[2 * jp + 1][0] = r4[2], b[2 * jp + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (kk + ak) * kBDwLd + wm + i * 16 + am;
        unsigned a[4], a2[4];
        ldsm_x4_t(a, hi + off);
        ldsm_x4_t(a2, lo + off);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][j], a, b[j]);
          mma_bf16(acc[i][j], a2, b[j]);
        }
      }
    }
    if (step + 1 < steps) store_a(step + 1);
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * tq;
        if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j][2 * h];
        if (n + 1 < N)
          out[static_cast<size_t>(m) * N + n + 1] = acc[i][j][2 * h + 1];
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

int lstm_scan_fwd(const float* xg, const float* cheb, const float* w,
                  float* ys, float* cs, float* gates, float* sa, int L, int B,
                  int J, int H, int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  const bool keep = gates != nullptr;
  if (keep != (sa != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const LstmPlan plan = plan_lstm(B, J, H, k, false, sms);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = H % 4 == 0 && aligned16(w) && (!keep || aligned16(sa));
  decltype(&lstm_scan_fwd_kernel<true, 0>) kernels[2][3] = {
      {lstm_scan_fwd_kernel<false, 0>, lstm_scan_fwd_kernel<false, 1>,
       lstm_scan_fwd_kernel<false, 2>},
      {lstm_scan_fwd_kernel<true, 0>, lstm_scan_fwd_kernel<true, 1>,
       lstm_scan_fwd_kernel<true, 2>}};
  return static_cast<int>(launch_scan(
      kernels[keep][plan.v], (B + plan.C - 1) / plan.C, plan.bytes, stream,
      xg, cheb, w, ys, cs, gates, sa, L, B, J, H, k, plan.C, vec));
}

int lstm_scan_bwd(const float* cheb, const float* w, const float* gates,
                  const float* sa, const float* cs, const float* dys,
                  const float* dcs, float* dxg, float* part, float* dw, int L,
                  int B, int J, int H, int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const LstmPlan plan = plan_lstm(B, J, H, k, true, sms);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      H % 4 == 0 && aligned16(w) && aligned16(sa) && aligned16(dxg);
  decltype(&lstm_scan_bwd_kernel<0>) kernels[3] = {
      lstm_scan_bwd_kernel<0>, lstm_scan_bwd_kernel<1>,
      lstm_scan_bwd_kernel<2>};
  err = launch_scan(kernels[plan.v], (B + plan.C - 1) / plan.C, plan.bytes,
                    stream, cheb, w, gates, cs, dys, dcs, dxg, L, B, J, H, k,
                    plan.C, vec);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = L * B * J, KH = k * H, count = KH * 4 * H;
  const int splits = lstm_dw_splits(rows, KH, H, sms);
  const int chunk = round_up((rows + splits - 1) / splits, kDwKT);
  const int tiles = dw_tiles(KH, 4 * H);
  const DwProblem<float, float> p{sa, dxg, part, KH, KH, 4 * H, 4 * H};
  auto dw_kernel = vec ? dw_tf32_kernel<true, float, float>
                       : dw_tf32_kernel<false, float, float>;
  err = cudaFuncSetAttribute(dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDwSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3(tiles, splits), kDwThreads, kDwSmemBytes, stream>>>(
      p, p, tiles, rows, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_two_kernel<float><<<(count + 255) / 256, 256, 0, stream>>>(
      part, count, dw, part, 0, dw, splits);
  return static_cast<int>(cudaGetLastError());
}

// How a bf16 graph-form LSTM scan is launched: C clips a cluster of NS
// thread blocks (1 or 2), the weight resident or streamed, up (forward:
// units a pass; backward: weight rows a pass, nt), MI (m16 tiles of an
// item's rows), the shared memory. The forward: resident in one block where
// it fits (clips: enough blocks to cover the SMs); else resident over a
// cluster of 2 (H a multiple of 16; clips: enough clusters to cover the
// clusters the card runs at once); else streamed, the widest pass that fits.
// The backward: resident where it fits, else streamed. Items (a pass's
// m16 MI x 8-unit, or x 32-row, tiles) at most kBItems a warp where their
// sums live across tiles (streamed, and the resident forward's c). At B=256,
// J=26, H=128, k=2 on 132 SMs (66 clusters): forward 4 clips a cluster of 2
// (104 rows, 64 units a block, 214 KB), backward 2 clips a block streamed
// (nt = 256); at J=1, H=128, k=1: 2 rows a block, resident, both.
struct LstmBf16Plan {
  int C, NS, res, up, mi;
  size_t bytes;
};

inline int lstm_bf16_mi(int R) { return R > 16 ? 2 : 1; }

inline int lstm_bf16_row_groups(int R) {
  const int mi = lstm_bf16_mi(R);
  return (R + 16 * mi - 1) / (16 * mi);
}

LstmBf16Plan plan_lstm_bf16(int B, int J, int H, int k, bool bwd, int sms,
                            int clusters) {
  constexpr int kMaxItems = kBWarps * kBItems;
  const int C1 = std::max(1, (B + sms - 1) / sms);
  if (bwd) {
    const int Hp = round_up(H, 16), KB = k * Hp;
    const LstmBf16Bwd res(C1, J, H, k, true, 0);
    if (res.bytes <= kMaxSmemBytes)
      return {C1, 1, 1, round_up(KB, 32), lstm_bf16_mi(C1 * J), res.bytes};
    for (int C = C1; C >= 1; --C) {
      const int nrg = lstm_bf16_row_groups(C * J);
      for (int nt = std::min(round_up(KB, 32), 32 * (kMaxItems / nrg));
           nt >= 32; nt -= 32) {
        const LstmBf16Bwd lay(C, J, H, k, false, nt);
        if (lay.bytes <= kMaxSmemBytes)
          return {C, 1, 0, nt, lstm_bf16_mi(C * J), lay.bytes};
      }
    }
    return {0, 0, 0, 0, 0, 0};
  }
  {
    const LstmBf16Fwd lay(C1, J, H, k, true, H);
    if (lstm_bf16_row_groups(C1 * J) * ((H + 7) / 8) <= kMaxItems &&
        lay.bytes <= kMaxSmemBytes)
      return {C1, 1, 1, H, lstm_bf16_mi(C1 * J), lay.bytes};
  }
  if (H % 16 == 0 && clusters > 0) {
    const int C = std::max(1, (B + clusters - 1) / clusters);
    const LstmBf16Fwd lay(C, J, H, k, true, H / 2);
    if (lstm_bf16_row_groups(C * J) * (H / 16) <= kMaxItems &&
        lay.bytes <= kMaxSmemBytes)
      return {C, 2, 1, H / 2, lstm_bf16_mi(C * J), lay.bytes};
  }
  for (int C = C1; C >= 1; --C) {
    const int nrg = lstm_bf16_row_groups(C * J);
    for (int up = std::min(round_up(H, 8), 8 * (kMaxItems / nrg)); up >= 8;
         up -= 8) {
      const LstmBf16Fwd lay(C, J, H, k, false, up);
      if (lay.bytes <= kMaxSmemBytes)
        return {C, 1, 0, up, lstm_bf16_mi(C * J), lay.bytes};
    }
  }
  return {0, 0, 0, 0, 0, 0};
}

// Launches a bf16 LSTM scan kernel in clusters of ns thread blocks along x
// with its shared memory; returns the first error.
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int blocks, int ns,
                           size_t bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of 2 blocks (one an SM, at the most shared memory) the current
// device runs at once: asked once per process; sms / 2 if it cannot say.
int lstm_bf16_clusters(int sms) {
  static int cached = -1;
  if (cached < 0) {
    auto kernel = lstm_bf16_fwd_kernel<false, true, 2>;
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err == cudaSuccess) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 2;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(2 * sms);
      cfg.blockDim = dim3(kBThreads);
      cfg.dynamicSmemBytes = kMaxSmemBytes;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    }
    cudaGetLastError();  // a refused query leaves no error behind
    cached = err == cudaSuccess && n > 0 ? n : sms / 2;
  }
  return cached;
}

cudaError_t lstm_bf16_plan_now(int B, int J, int H, int k, bool bwd,
                               LstmBf16Plan* plan) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *plan = plan_lstm_bf16(B, J, H, k, bwd, sms,
                         bwd ? 0 : lstm_bf16_clusters(sms));
  return cudaSuccess;
}

int lstm_bf16_scan_fwd(const bf16* xg, const bf16* cheb, const bf16* w,
                       int wt, bf16* ys, bf16* cs, float* gates, float* sa,
                       int L, int B, int J, int H, int k,
                       cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  const bool keep = gates != nullptr;
  if (keep != (sa != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  LstmBf16Plan plan;
  const cudaError_t err = lstm_bf16_plan_now(B, J, H, k, false, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = H % 8 == 0 && !wt && aligned16(w);
  decltype(&lstm_bf16_fwd_kernel<false, false, 1>) kernels[2][2][2] = {
      {{lstm_bf16_fwd_kernel<false, false, 1>,
        lstm_bf16_fwd_kernel<false, false, 2>},
       {lstm_bf16_fwd_kernel<false, true, 1>,
        lstm_bf16_fwd_kernel<false, true, 2>}},
      {{lstm_bf16_fwd_kernel<true, false, 1>,
        lstm_bf16_fwd_kernel<true, false, 2>},
       {lstm_bf16_fwd_kernel<true, true, 1>,
        lstm_bf16_fwd_kernel<true, true, 2>}}};
  const int blocks = (B + plan.C - 1) / plan.C * plan.NS;
  return static_cast<int>(launch_cluster(
      kernels[keep][plan.res][plan.mi - 1], blocks, plan.NS, plan.bytes,
      stream, xg, cheb, w, ys, cs, gates, sa, L, B, J, H, k, plan.C, plan.NS,
      plan.up, wt, vec));
}

int lstm_bf16_scan_bwd(const bf16* cheb, const bf16* w, int wt,
                       const float* gates, const float* sa, const bf16* cs,
                       const bf16* dys, const bf16* dcs, bf16* dxg,
                       float* part, bf16* dw, int L, int B, int J, int H,
                       int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  LstmBf16Plan plan;
  cudaError_t err = lstm_bf16_plan_now(B, J, H, k, true, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = H % 2 == 0 && !wt && aligned16(w);
  decltype(&lstm_bf16_bwd_kernel<false, 1>) kernels[2][2] = {
      {lstm_bf16_bwd_kernel<false, 1>, lstm_bf16_bwd_kernel<false, 2>},
      {lstm_bf16_bwd_kernel<true, 1>, lstm_bf16_bwd_kernel<true, 2>}};
  err = launch_cluster(kernels[plan.res][plan.mi - 1],
                       (B + plan.C - 1) / plan.C, 1, plan.bytes, stream, cheb,
                       w, gates, cs, dys, dcs, dxg, L, B, J, H, k, plan.C,
                       plan.up, wt, vec);
  if (err != cudaSuccess) return static_cast<int>(err);

  // dW = sa^T dxg on the bf16 tensor cores (lstm_bf16_dw_kernel) split
  // over the rows, then their fixed-order sum; the splits and part as the
  // float32 template's
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return static_cast<int>(err);
  const int rows = L * B * J, KH = k * H, count = KH * 4 * H;
  const int splits = lstm_dw_splits(rows, KH, H, sms);
  const int chunk = round_up((rows + splits - 1) / splits, kDwKT);
  const int tiles = dw_tiles(KH, 4 * H);
  auto dw_kernel = KH % 4 == 0 && H % 2 == 0 && aligned16(sa) &&
                           aligned16(dxg)
                       ? lstm_bf16_dw_kernel<true>
                       : lstm_bf16_dw_kernel<false>;
  err = cudaFuncSetAttribute(dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBDwSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<<<dim3(tiles, splits), kBDwThreads, kBDwSmemBytes, stream>>>(
      sa, dxg, part, KH, 4 * H, rows, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_two_kernel<bf16><<<(count + 255) / 256, 256, 0, stream>>>(
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
  return lstm_scan_fwd(xg, cheb, w, ys, cs, gates, sa, L, B, J, H, k,
                       stream);
}

// The same in bf16 (every tensor but gates and sa, which stay float32), on
// the bf16 kernels (lstm_bf16_fwd_kernel): w (H, k 4H) contiguous, or with
// wt = 1 the transpose of a contiguous (k 4H, H), read in place; sa's graph
// columns are the graph terms' hi + lo rounded to TF32.
int pv2c_graph_lstm_scan_fwd_bf16(const bf16* xg, const bf16* cheb,
                                  const bf16* w, int wt, bf16* ys, bf16* cs,
                                  float* gates, float* sa, int L, int B, int J,
                                  int H, int k, cudaStream_t stream) {
  return lstm_bf16_scan_fwd(xg, cheb, w, wt, ys, cs, gates, sa, L, B, J, H,
                            k, stream);
}

// How the bf16 graph-form LSTM scan (bwd = 0) or its reverse scan (bwd = 1)
// is launched on the current device at this shape: plan[0] clips a cluster,
// plan[1] thread blocks a cluster (1 or 2), plan[2] 1 where the weight is
// resident, 0 where it streams, plan[3] units a pass (backward: weight rows
// a pass), plan[4] m16 tiles of an item's rows, plan[5] the shared memory
// bytes, plan[6] the thread blocks; zeros where one clip does not fit.
// Returns a CUDA error, or 0.
int pv2c_graph_lstm_bf16_plan(int B, int J, int H, int k, int bwd,
                              int* plan) {
  if (!valid(1, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  LstmBf16Plan p;
  const cudaError_t err = lstm_bf16_plan_now(B, J, H, k, bwd != 0, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.C;
  plan[1] = p.NS;
  plan[2] = p.res;
  plan[3] = p.up;
  plan[4] = p.mi;
  plan[5] = static_cast<int>(p.bytes);
  plan[6] = p.C ? (B + p.C - 1) / p.C * p.NS : 0;
  return 0;
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
  return lstm_scan_bwd(cheb, w, gates, sa, cs, dys, dcs, dxg, part, dw, L,
                       B, J, H, k, stream);
}

// The same in bf16 (gates, sa and part float32), on the bf16 reverse scan
// (lstm_bf16_bwd_kernel), then dW's two launches; w as the bf16 forward
// takes it (wt), dw (H, k 4H) contiguous.
int pv2c_graph_lstm_scan_bwd_bf16(const bf16* cheb, const bf16* w, int wt,
                                  const float* gates, const float* sa,
                                  const bf16* cs, const bf16* dys,
                                  const bf16* dcs, bf16* dxg, float* part,
                                  bf16* dw, int L, int B, int J, int H, int k,
                                  cudaStream_t stream) {
  return lstm_bf16_scan_bwd(cheb, w, wt, gates, sa, cs, dys, dcs, dxg, part,
                            dw, L, B, J, H, k, stream);
}

}  // extern "C"

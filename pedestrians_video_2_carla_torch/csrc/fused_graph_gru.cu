// The frame recurrences of the graph-convolutional GRU and LSTM layers
// (classification GNNs), forward and backward, for sm_90a, float32. The
// LSTM at k = 1 (no graph term: a dense LSTM over the B J rows) runs on the
// kernels of fused_dense_lstm.cu where its width fits them (H <= 64); this
// file's LSTM kernels take k >= 2 and the wider H.
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
// work): the LSTM's weights arrive "stacked", (k H, G H) with rows (n,
// unit); the GRU reads the caller's (H, k G H) weights in place (see "The
// operand's column order").
//
// What bounds them on an H100: operations. At B=256, L=16, J=26, H=128, k=2
// a GRU layer's forward is 22.4 GFLOP (0.33 ms at the fp32 peak, 0.14 ms at
// the 3xTF32 rate) against 0.22 GB of traffic (0.07 ms). The recurrence is
// sequential over frames and independent across clips, so a thread block
// owns a few clips (2 at that shape: 52 rows, 128 thread blocks for 132
// SMs), keeps their carry in shared memory and loops over all frames inside
// one launch: no launch and no trip of the carry through device memory per
// frame. The weights (up to 512 KB) do not fit beside the activations; they
// stream from L2.
//
// The GRU (rows 10 and 11; see "The GRU scans on the tensor cores" below)
// runs its products on the tensor cores in 3xTF32, 16 warps a thread block,
// the weight tiles through a cp.async ring; its training forward keeps the
// gates and the expanded operands, so that its backward runs two products a
// frame instead of four, and its weight gradients are one 3xTF32 split-K
// launch and one fixed-order sum.
//
// The graph-form LSTM (rows 12 and 13 at k >= 2, and at k = 1 for H > 64)
// runs on the CUDA cores: 256 threads, each a
// 4-row x 8-column tile of a product, the weight tiles (16 rows) prefetched
// into registers while the previous tile is multiplied; with several gates
// in one product a thread's 8 columns are the gates of the same units, so
// the gating runs on the accumulators without an exchange. Its backward
// walks the frames in reverse with dh and dc in shared memory, recomputes
// the gates from ys[t-1] and cs, writes dxg, and carries dh through P = da
// W^T, dh = P_0 + sum_n T_n^T P_n; the scan writes each frame's expanded
// operand [h | T_n h], and a split-K product dW = S^T dxg follows (128 x 128
// tiles, the slices summed in a fixed order by a second launch).
//
// The ragged last thread block (B not a multiple of the clips per block)
// masks its rows. No float atomics anywhere: the same bits on every launch.
//
// Numerics: 1 / (1 + expf(-x)), tanhf, fmaf sums, no fast math; the GRU's
// products in 3xTF32 (fp32 accuracy, mma_tf32.cuh).
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>

#include "dw_tf32.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4, kTN = 8;   // a thread's tile of a product
constexpr int kBM = 16 * kTM;     // rows of a thread block's tile
constexpr int kBN = 16 * kTN;     // columns of a thread block's tile
constexpr int kKT = 16;           // depth of a weight tile
constexpr int kWtFloats = kKT * kBN;
constexpr int kLoads = kWtFloats / kThreads;  // tile elements per thread
constexpr int kMaxSmemBytes = 232448;         // 227 KB, a block's limit

constexpr int kDT = 128;  // the weight-gradient product's tile, 8 x 8 a thread
constexpr int kDK = 16;
constexpr int kDLoads = kDK * kDT / kThreads;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// A thread's kLoads elements of the weight tile at depth k0 for the units
// from u0 on (every gate's), zeros outside the matrix.
template <int G>
__device__ __forceinline__ void fetch_tile(float (&pre)[kLoads],
                                           const float* __restrict__ W, int k0,
                                           int K, int u0, int N, int ldw,
                                           int gs) {
  constexpr int U = 16 * (kTN / G);
#pragma unroll
  for (int s = 0; s < kLoads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int kg = k0 + e / kBN, lin = e % kBN;
    const int g = lin / U, u = u0 + lin % U;
    pre[s] = (kg < K && u < N) ? W[static_cast<size_t>(kg) * ldw + g * gs + u]
                               : 0.f;
  }
}

// acc(R x G gates x N units) = init + A (R x K, shared memory) * W, then
// epi. W is (K x .) row-major in device memory with leading dimension ldw,
// gate g's unit u in column g * gs + u. Thread (ty, tx) owns rows r0 + 4 ty
// + i and, in every gate, units u0 + tx UT + uu (UT = 8 / G): init(row, u, v)
// fills v[G] with the starting values and epi(row, u, v) takes the sums, for
// rows < R and units < N only. W tiles go through wt (kWtFloats). The caller
// has A complete (a barrier behind it) and puts a barrier after the call
// before anyone reads what epi wrote.
template <int G, class Init, class Epi>
__device__ __forceinline__ void block_gemm(const float* A, int lda, int R,
                                           int K, const float* __restrict__ W,
                                           int ldw, int gs, int N, float* wt,
                                           Init init, Epi epi) {
  constexpr int UT = kTN / G;
  constexpr int U = 16 * UT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int r0 = 0; r0 < R; r0 += kBM) {
    int arow[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) arow[i] = min(r0 + ty * kTM + i, R - 1) * lda;
    for (int u0 = 0; u0 < N; u0 += U) {
      float acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int row = r0 + ty * kTM + i;
#pragma unroll
        for (int uu = 0; uu < UT; ++uu) {
          const int u = u0 + tx * UT + uu;
          float v[G];
#pragma unroll
          for (int g = 0; g < G; ++g) v[g] = 0.f;
          if (row < R && u < N) init(row, u, v);
#pragma unroll
          for (int g = 0; g < G; ++g) acc[i][g * UT + uu] = v[g];
        }
      }
      float pre[kLoads];
      fetch_tile<G>(pre, W, 0, K, u0, N, ldw, gs);
      for (int k0 = 0; k0 < K; k0 += kKT) {
        __syncthreads();  // the previous tile is consumed
#pragma unroll
        for (int s = 0; s < kLoads; ++s) {
          const int e = tid + s * kThreads;
          const int kk = e / kBN, lin = e % kBN;
          const int g = lin / U, ul = lin % U;
          wt[kk * kBN + (ul / UT) * kTN + g * UT + ul % UT] = pre[s];
        }
        __syncthreads();
        // the next tile's loads fly while this one is multiplied (past the
        // last tile every element is out of range: no load)
        fetch_tile<G>(pre, W, k0 + kKT, K, u0, N, ldw, gs);
        const int kmax = min(kKT, K - k0);
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          if (kk < kmax) {
            float a[kTM];
#pragma unroll
            for (int i = 0; i < kTM; ++i) a[i] = A[arow[i] + k0 + kk];
            const float4 b0 =
                *reinterpret_cast<const float4*>(wt + kk * kBN + tx * kTN);
            const float4 b1 =
                *reinterpret_cast<const float4*>(wt + kk * kBN + tx * kTN + 4);
            const float b[kTN] = {b0.x, b0.y, b0.z, b0.w,
                                  b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int row = r0 + ty * kTM + i;
#pragma unroll
        for (int uu = 0; uu < UT; ++uu) {
          const int u = u0 + tx * UT + uu;
          if (row < R && u < N) {
            float v[G];
#pragma unroll
            for (int g = 0; g < G; ++g) v[g] = acc[i][g * UT + uu];
            epi(row, u, v);
          }
        }
      }
    }
  }
}

// S[:, n H + u] = sum_j T_n[j_row, j] S[clip's row j, u] for n = 1 .. k-1,
// from S[:, :H], which is complete (a barrier behind it). Tm holds T_1 ..
// T_{k-1}. Ends with a barrier.
__device__ __forceinline__ void expand_graph(float* S, int lds, int R, int J,
                                             int H, int k, const float* Tm) {
  const int per = R * H;
  for (int idx = threadIdx.x; idx < per * (k - 1); idx += kThreads) {
    const int n = idx / per, rem = idx - n * per;
    const int row = rem / H, u = rem - row * H;
    const int c0 = (row / J) * J, jr = row - c0;
    const float* t = Tm + (n * J + jr) * J;
    const float* src = S + c0 * lds + u;
    float sum = 0.f;
    for (int j = 0; j < J; ++j) sum = fmaf(t[j], src[j * lds], sum);
    S[row * lds + (n + 1) * H + u] = sum;
  }
  __syncthreads();
}

// P[row, u] + sum_{n >= 1} sum_j T_n[j, j_row] P[clip's row j, n H + u]: the
// transposed graph applied to the k column blocks of P, summed.
__device__ __forceinline__ float gather_graph_t(const float* P, int ldp,
                                                int row, int u, int J, int H,
                                                int k, const float* Tm) {
  const int c0 = (row / J) * J, jr = row - c0;
  float sum = P[row * ldp + u];
  for (int n = 1; n < k; ++n) {
    const float* t = Tm + (n - 1) * J * J + jr;
    const float* src = P + c0 * ldp + n * H + u;
    for (int j = 0; j < J; ++j) sum = fmaf(t[j * J], src[j * ldp], sum);
  }
  return sum;
}

// What every scan kernel starts with: its clips, the carve of shared memory
// that all four share (weight tile, graph matrices, the expanded operand S),
// and the graph matrices loaded.
struct Block {
  int R, KH, rows, row0;
  float *wt, *Tm, *S, *rest;
};

__device__ __forceinline__ Block block_setup(float* smem, const float* cheb,
                                             int B, int J, int H, int k,
                                             int C) {
  Block b;
  const int b0 = blockIdx.x * C;
  b.R = min(C, B - b0) * J;
  b.KH = k * H;
  b.rows = B * J;
  b.row0 = b0 * J;
  const int tfloats = ((k - 1) * J * J + 3) & ~3;
  b.wt = smem;
  b.Tm = b.wt + kWtFloats;
  b.S = b.Tm + tfloats;
  b.rest = b.S + C * J * b.KH;
  for (int i = threadIdx.x; i < (k - 1) * J * J; i += kThreads)
    b.Tm[i] = cheb[i];
  return b;
}

// S[:, :H] = src (R x H, contiguous) times mul (or 1), or zeros without src;
// then the graph expansion; then, with dump, the whole of S to device memory.
__device__ __forceinline__ void fill_operand(const Block& b, int J, int H,
                                             int k, const float* src,
                                             const float* mul, float* dump) {
  for (int idx = threadIdx.x; idx < b.R * H; idx += kThreads) {
    const int row = idx / H, u = idx - row * H;
    float v = src ? src[idx] : 0.f;
    if (mul) v *= mul[idx];
    b.S[row * b.KH + u] = v;
  }
  __syncthreads();
  expand_graph(b.S, b.KH, b.R, J, H, k, b.Tm);
  if (dump)
    for (int idx = threadIdx.x; idx < b.R * b.KH; idx += kThreads)
      dump[idx] = b.S[idx];
}

__global__ void __launch_bounds__(kThreads)
lstm_scan_fwd_kernel(const float* __restrict__ xg,
                     const float* __restrict__ cheb,
                     const float* __restrict__ w, float* __restrict__ ys,
                     float* __restrict__ cs, int L, int B, int J, int H, int k,
                     int C) {
  extern __shared__ __align__(16) float smem[];
  const Block b = block_setup(smem, cheb, B, J, H, k, C);
  const int R = b.R, KH = b.KH, RH = C * J * H;
  float* hb = b.rest;
  float* cb = hb + RH;
  for (int i = threadIdx.x; i < R * H; i += kThreads) hb[i] = cb[i] = 0.f;
  __syncthreads();
  for (int t = 0; t < L; ++t) {
    const size_t at = static_cast<size_t>(t) * b.rows + b.row0;
    const float* x = xg + at * 4 * H;
    float* y = ys + at * H;
    float* c_out = cs + at * H;
    fill_operand(b, J, H, k, hb, nullptr, nullptr);
    // the products read S, a copy of the carry, so hb is updated in place
    block_gemm<4>(
        b.S, KH, R, KH, w, 4 * H, H, H, b.wt,
        [&](int row, int u, float* v) {
#pragma unroll
          for (int g = 0; g < 4; ++g) v[g] = x[row * 4 * H + g * H + u];
        },
        [&](int row, int u, const float* v) {
          const int at_u = row * H + u;
          const float i = sigmoid(v[0]), f = sigmoid(v[1]), g = tanhf(v[2]),
                      o = sigmoid(v[3]);
          const float c = f * cb[at_u] + i * g;
          const float h = o * tanhf(c);
          cb[at_u] = c;
          hb[at_u] = h;
          y[at_u] = h;
          c_out[at_u] = c;
        });
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_scan_bwd_kernel(const float* __restrict__ xg,
                     const float* __restrict__ cheb,
                     const float* __restrict__ w,
                     const float* __restrict__ w_t,
                     const float* __restrict__ ys,
                     const float* __restrict__ cs,
                     const float* __restrict__ dys,
                     const float* __restrict__ dcs, float* __restrict__ dxg,
                     float* __restrict__ sa, int L, int B, int J, int H, int k,
                     int C) {
  extern __shared__ __align__(16) float smem[];
  const Block b = block_setup(smem, cheb, B, J, H, k, C);
  const int R = b.R, KH = b.KH, RH = C * J * H;
  float* da = b.rest;       // (R, 4H)
  float* dhb = da + 4 * RH;  // the dh carry
  float* dcb = dhb + RH;    // the dc carry
  for (int i = threadIdx.x; i < R * H; i += kThreads) dhb[i] = dcb[i] = 0.f;
  __syncthreads();
  for (int t = L - 1; t >= 0; --t) {
    const size_t at = static_cast<size_t>(t) * b.rows + b.row0;
    const float* x = xg + at * 4 * H;
    float* dx = dxg + at * 4 * H;
    const float* dy = dys + at * H;
    const float* dc_in = dcs ? dcs + at * H : nullptr;
    const float* c_now = cs + at * H;
    // frame 0's previous states are the zero start
    const float* hp = t > 0 ? ys + (at - b.rows) * H : nullptr;
    const float* cp = t > 0 ? cs + (at - b.rows) * H : nullptr;
    fill_operand(b, J, H, k, hp, nullptr, sa + at * KH);
    block_gemm<4>(
        b.S, KH, R, KH, w, 4 * H, H, H, b.wt,
        [&](int row, int u, float* v) {
#pragma unroll
          for (int g = 0; g < 4; ++g) v[g] = x[row * 4 * H + g * H + u];
        },
        [&](int row, int u, const float* v) {
          const int at_u = row * H + u;
          const float i = sigmoid(v[0]), f = sigmoid(v[1]), g = tanhf(v[2]),
                      o = sigmoid(v[3]);
          const float tc = tanhf(c_now[at_u]);
          const float dh = dy[at_u] + dhb[at_u];
          float dc = dh * o * (1.f - tc * tc) + dcb[at_u];
          if (dc_in) dc += dc_in[at_u];
          const float c_prev = cp ? cp[at_u] : 0.f;
          const float d[4] = {dc * g * i * (1.f - i),
                              dc * c_prev * f * (1.f - f),
                              dc * i * (1.f - g * g),
                              dh * tc * o * (1.f - o)};
          dcb[at_u] = dc * f;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) {
            da[row * 4 * H + gate * H + u] = d[gate];
            dx[row * 4 * H + gate * H + u] = d[gate];
          }
        });
    __syncthreads();
    // P = da W^T into S; dh = P_0 + sum_n T_n^T P_n
    block_gemm<1>(
        da, 4 * H, R, 4 * H, w_t, KH, 0, KH, b.wt,
        [&](int, int, float*) {},
        [&](int row, int q, const float* v) { b.S[row * KH + q] = v[0]; });
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int row = idx / H, u = idx - row * H;
      dhb[idx] = gather_graph_t(b.S, KH, row, u, J, H, k, b.Tm);
    }
    __syncthreads();
  }
}

// A thread's elements of the 16-row tiles of A and Bm from row r0 on, zeros
// from row hi on and outside the matrices.
__device__ __forceinline__ void dw_fetch(float (&pa)[kDLoads],
                                         float (&pb)[kDLoads],
                                         const float* __restrict__ A, int lda,
                                         int M, int m0,
                                         const float* __restrict__ Bm, int ldb,
                                         int N, int n0, int r0, int hi) {
#pragma unroll
  for (int s = 0; s < kDLoads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int row = r0 + e / kDT, c = e % kDT;
    const bool in = row < hi;
    pa[s] = (in && m0 + c < M) ? A[static_cast<size_t>(row) * lda + m0 + c]
                               : 0.f;
    pb[s] = (in && n0 + c < N) ? Bm[static_cast<size_t>(row) * ldb + n0 + c]
                               : 0.f;
  }
}

// One slice of a weight gradient: part[z] (M x N) = sum over the rows
// [z chunk, (z + 1) chunk) of A[row, :M]^T Bm[row, :N]. A thread block takes a
// 128 x 128 tile, a thread 8 x 8 of it.
__global__ void __launch_bounds__(kThreads)
dw_gemm_kernel(const float* __restrict__ A, int lda, int M,
               const float* __restrict__ Bm, int ldb, int N, int rows,
               int chunk, float* __restrict__ part) {
  __shared__ __align__(16) float As[kDK][kDT];
  __shared__ __align__(16) float Bs[kDK][kDT];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kDT, n0 = blockIdx.x * kDT;
  const int lo = blockIdx.z * chunk, hi = min(rows, lo + chunk);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float pa[kDLoads], pb[kDLoads];
  dw_fetch(pa, pb, A, lda, M, m0, Bm, ldb, N, n0, lo, hi);
  for (int r0 = lo; r0 < hi; r0 += kDK) {
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kDLoads; ++s) {
      const int e = tid + s * kThreads;
      As[e / kDT][e % kDT] = pa[s];
      Bs[e / kDT][e % kDT] = pb[s];
    }
    __syncthreads();
    dw_fetch(pa, pb, A, lda, M, m0, Bm, ldb, N, n0, r0 + kDK, hi);
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
  float* out = part + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ..., in that order.
__global__ void reduce_parts_kernel(const float* __restrict__ part, int splits,
                                    int count, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z)
    sum += part[static_cast<size_t>(z) * count + i];
  out[i] = sum;
}

// ---------------------------------------------------------------------------
// The GRU scans on the tensor cores (rows 10 and 11).
//
// A thread block of 16 warps owns C clips (R = C J rows) and runs all L
// frames of them in one launch, the carry in shared memory. Each
// hidden-side product is a block product in 3xTF32 (mma_tf32.cuh): the A
// operand (R rows, row stride its depth rounded up to 32, + 4, so that the
// fragment reads meet 32 banks) in shared memory, read in tiles of 64 rows
// (rows past R read row R - 1 and their sums are dropped); the weights read
// straight from the caller's tensors (see "The operand's column order"),
// streaming from L2 through a 2-stage cp.async ring of 32-deep tiles with
// one barrier a tile, zeros past their edges; the outputs in 64 x NT tiles, each warp 32 x NT/8
// of them as 2 x NT/64 mma tiles of 16 x 8. A tile's products are summed in
// the tensor cores over its 32 rows, then added to the fp32 sums outside
// them. The first tile of a product is put in flight as soon as the
// previous product has left the ring, so its loads overlap the gating and
// the graph products in between. The graph products (T_n applied to the
// carry, and T_n^T to the cotangents in the backward) run on the tensor
// cores too, as small block-diagonal products (graph_product).
//
// On an H100 the products are issue-bound, not tensor-core-bound (a frame
// keeps most of its time with the mma instructions taken out): loading and
// splitting the fragments and the sums outside the tensor cores set the
// pace, so a k-step is 32 rows deep (one barrier and one exit from the
// tensor cores per 32 rows). The ring's widest tile NT is 256 columns, or
// 128 where a thread block's shared memory cannot hold one clip beside the
// wider ring (large H or k).
constexpr int kGThreads = 512;  // 16 warps: 2 along the rows, 8 along the columns
constexpr int kGWarpsN = kGThreads / 64;  // warps along the columns
constexpr int kGRows = 64;      // rows of a block tile
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
//              weight of the backward, each column a run of a weight row.
// Each layout's fragment reads meet 32 banks.
enum TileLayout { kByDepth, kZR, kByColumn };

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
// N x K by column, kZR's N = 2H): ceil(K / 32) steps a column tile, column
// tiles of NT, row tiles outermost (they reload the same tiles). vec:
// 16-byte copies (H a multiple of 4, W 16-byte aligned), else 4-byte ones.
template <int NT, int LAYOUT>
__device__ __forceinline__ void load_step(float* ring, int slot, int s,
                                          const float* __restrict__ W, int K,
                                          int N, int ks, int ct, bool vec) {
  const int k0 = (s % ks) * kGKT, n0 = ((s / ks) % ct) * NT;
  float* dst = ring + (s % kGStages) * slot;
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
    } else {
      ok = k0 + r < K && n0 + c < N;
      from = static_cast<size_t>(k0 + r) * N + n0 + c;
    }
    float* d = dst + r * kLd + at;
    const float* src = ok ? W + from : W;
    if (vec)
      cp_async16(d, src, ok);
    else
      cp_async4(d, src, ok);
  }
}

__device__ __forceinline__ int row_tiles(int R) {
  return (R + kGRows - 1) / kGRows;
}

// The first kGStages - 1 steps of a block product over W for R rows, in
// flight. Every thread calls it, after a barrier that freed the ring.
template <int NT, int LAYOUT>
__device__ __forceinline__ void product_prologue(float* ring, int slot,
                                                 const float* __restrict__ W,
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
// in flight. init(row, col, v0, v1) sets the starting values of columns col
// and col + 1 (col even) of a row (its loads fly while the tile is
// multiplied), epi(row, col, v0, v1) takes their sums; both for every row
// of the row tiles and every column of the column tiles (they mask). epi
// runs per tile while other warps may still multiply later tiles, so it
// must not write A.
template <int NT, int LAYOUT, class Init, class Epi>
__device__ __forceinline__ void block_product(const float* A, int lda, int R,
                                              const float* __restrict__ W,
                                              int K, int N, float* ring,
                                              int slot, bool vec, Init init,
                                              Epi epi) {
  constexpr int WN = NT / kGWarpsN;  // columns of a warp
  constexpr int NJ = WN / 8;         // its mma tiles of 8 columns
  constexpr int kDeep4 = slot_at<NT, LAYOUT>(0, 4);  // 4 deeper in the slot
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kGWarpsN) * 32, wn = (warp % kGWarpsN) * WN;
  const int ks = (K + kGKT - 1) / kGKT, ct = (N + NT - 1) / NT;
  const int total = row_tiles(R) * ct * ks;
  float acc[2][NJ][4];
  for (int s = 0; s < total; ++s) {
    float part[2][NJ][4];  // this k-step's products, summed in the tensor cores
    const int kstep = s % ks, tile = s / ks;
    const int r0 = (tile / ct) * kGRows, n0 = (tile % ct) * NT;
    if (kstep == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            init(r0 + wm + i * 16 + g + 8 * h, n0 + wn + j * 8 + 2 * t,
                 acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // step s has landed; step s - 1's slot is free
    if (s + kGStages - 1 < total)
      load_step<NT, LAYOUT>(ring, slot, s + kGStages - 1, W, K, N, ks, ct,
                            vec);
    cp_async_commit();
    const float* Bs = ring + (s % kGStages) * slot;
    // the A rows of this thread's fragments; rows past R read row R - 1
    const float* arow[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        arow[i][h] = A + min(r0 + wm + i * 16 + g + 8 * h, R - 1) * lda +
                     kstep * kGKT + t;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kGKT; kk += 8) {
      unsigned bb[NJ][2], bs[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* b = Bs + slot_at<NT, LAYOUT>(wn + j * 8 + g, kk + t);
        split_tf32(b[0], bb[j][0], bs[j][0]);
        split_tf32(b[kDeep4], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
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
    // the k-step's sums leave the tensor cores (which round towards zero)
    // for the running fp32 sums, rounded to nearest
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
    if (kstep == ks - 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            epi(r0 + wm + i * 16 + g + 8 * h, n0 + wn + j * 8 + 2 * t,
                acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

// The graph matrices in shared memory for the GRU scans: T_1 .. T_{k-1},
// each zero-padded to Jm x Jm (Jm = J rounded up to 16) with row stride
// Jm + 4.
__host__ __device__ inline int graph_rows(int J) { return round_up(J, 16); }

__device__ __forceinline__ void load_graph(float* Tp, const float* cheb,
                                           int J, int k) {
  const int Jm = graph_rows(J), lt = Jm + 4;
  for (int idx = threadIdx.x; idx < (k - 1) * Jm * lt; idx += kGThreads) {
    const int n = idx / (Jm * lt), rem = idx - n * Jm * lt;
    const int i = rem / lt, j = rem - i * lt;
    Tp[idx] = i < J && j < J ? cheb[(n * J + i) * J + j] : 0.f;
  }
}

// The graph convolution of the GRU scans on the tensor cores (3xTF32), clip
// by clip in 16 x 8 output tiles, each warp kGGraphTiles tiles at a time
// (independent chains of products), on operands in the unit-major column
// order (column u k + n):
//   !TRANS: S[c J + i][u k + n] = sum_j T_n[i][j] S[c J + j][u k] for n =
//           1 .. k - 1 (the operand's expansion from the carry in the
//           columns u k);
//   TRANS:  S[c J + i][u k] += sum_n sum_j T_n[j][i] S[c J + j][u k + n]
//           (the cotangent of the expansion's source, in place: each tile
//           reads only its own part of the columns u k).
// For rows < R (whole clips) and units < H. Ends with a barrier.
constexpr int kGGraphTiles = 4;

template <bool TRANS>
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
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
          split_tf32(b0, bb[0], bs[0]);
          split_tf32(b1, bb[1], bs[1]);
          mma_3xtf32(acc[q], ab, as, bb, bs);
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
          if (u < H) Sc[q][i * ld + u * k + (TRANS ? 0 : n[q])] = acc[q][2 * h + e];
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
// the carry (or r h) into the expanded operand's order-0 columns; a warp a
// row at a time.
__device__ __forceinline__ void put_units(float* S, int ld, int k,
                                          const float* src, int R, int H) {
  for (int row = threadIdx.x >> 5; row < R; row += kGThreads / 32)
    for (int u = threadIdx.x & 31; u < H; u += 32)
      S[row * ld + u * k] = src[row * H + u];
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
template <bool KEEP, int NT>
__global__ void __launch_bounds__(kGThreads, 1)
gru_scan_fwd_kernel(const float* __restrict__ xg,
                    const float* __restrict__ cheb,
                    const float* __restrict__ wzr,
                    const float* __restrict__ wh, float* __restrict__ ys,
                    float* __restrict__ gates, float* __restrict__ sa,
                    float* __restrict__ sb, int L, int B, int J, int H, int k,
                    int C, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * C;
  const int R = min(C, B - b0) * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, ld = kpad(KH) + 4, CJH = C * J * H;
  constexpr int slot = fwd_slot<NT>();
  float* ring = smem;
  float* S = ring + kGStages * slot;  // the operand of the product
  constexpr bool kZShared = NT == kGWide;
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
    const float* x = xg + at * 3 * H;
    if (t > 0) {  // (frame 0's operand is the zeros S starts with)
      put_units(S, ld, k, hb, R, H);
      __syncthreads();
      graph_product<false>(S, ld, R, J, H, k, Tm);
    }
    if (KEEP) copy_rows(sa + at * KH, KH, S, ld, R, KH, vec);
    block_product<NT, kZR>(
        S, ld, R, wzr, KH, 2 * H, ring, slot, vec,
        [&](int row, int col, float& vz, float& vr) {
          const int u = col >> 1;
          const bool in = row < R && u < H;
          vz = in ? x[row * 3 * H + u] : 0.f;
          vr = in ? x[row * 3 * H + H + u] : 0.f;
        },
        [&](int row, int col, float vz, float vr) {
          const int u = col >> 1;
          if (row < R && u < H) {
            const float z = sigmoid(vz);
            const float r = sigmoid(vr);
            if (kZShared)
              zb[row * H + u] = z;
            else
              ys[(at + row) * H + u] = z;
            rh[row * H + u] = r * hb[row * H + u];
            if (KEEP) {
              gates[(at + row) * 3 * H + u] = z;
              gates[(at + row) * 3 * H + H + u] = r;
            }
          }
        });
    __syncthreads();  // r h and z are written; S and the ring are free
    product_prologue<NT / 2, kByDepth>(ring, slot, wh, KH, H, R, vec);
    put_units(S, ld, k, rh, R, H);
    __syncthreads();
    graph_product<false>(S, ld, R, J, H, k, Tm);
    if (KEEP) copy_rows(sb + at * KH, KH, S, ld, R, KH, vec);
    block_product<NT / 2, kByDepth>(
        S, ld, R, wh, KH, H, ring, slot, vec,
        [&](int row, int col, float& v0, float& v1) {
          const float* xh = x + row * 3 * H + 2 * H;
          v0 = row < R && col < H ? xh[col] : 0.f;
          v1 = row < R && col + 1 < H ? xh[col + 1] : 0.f;
        },
        [&](int row, int col, float v0, float v1) {
          if (row >= R) return;
          const float v[2] = {v0, v1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = col + e;
            if (u < H) {
              const float ht = tanhf(v[e]);
              const float z = kZShared ? zb[row * H + u] : ys[(at + row) * H + u];
              const float h = hb[row * H + u];
              const float hn = z * h + (1.f - z) * ht;
              hb[row * H + u] = hn;
              ys[(at + row) * H + u] = hn;
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
template <int NT>
__global__ void __launch_bounds__(kGThreads, 1)
gru_scan_bwd_kernel(const float* __restrict__ cheb,
                    const float* __restrict__ wzr,
                    const float* __restrict__ wh,
                    const float* __restrict__ gates,
                    const float* __restrict__ sa,
                    const float* __restrict__ dys, float* __restrict__ dxg,
                    int L, int B, int J, int H, int k, int C, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * C;
  const int R = min(C, B - b0) * J, rows = B * J, row0 = b0 * J;
  const int KH = k * H, ldp = kpad(KH) + 4, ldd = bwd_da_ld(H);
  constexpr int slot = bwd_slot<NT>();
  float* ring = smem;
  float* P = ring + kGStages * slot;  // a transposed product's output
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
    const float* dy = dys + at * H;
    float* dx = dxg + at * 3 * H;
    // the residuals through the read-only path, several rows' loads in
    // flight at once
#pragma unroll 4
    for (int idx = threadIdx.x; idx < R * H; idx += kGThreads) {
      const int row = idx / H, u = idx - row * H;
      float dh = __ldg(dy + idx) + dhb[idx];
      if (t < L - 1) dh += P[row * ldp + u * k];
      const float z = __ldg(gt + row * 3 * H + u);
      const float ht = __ldg(gt + row * 3 * H + 2 * H + u);
      const float h = __ldg(hp + row * KH + u * k);
      const float da_z = dh * (h - ht) * z * (1.f - z);
      const float da_h = dh * (1.f - z) * (1.f - ht * ht);
      dhb[idx] = dh * z;
      dx[row * 3 * H + u] = da_z;
      dx[row * 3 * H + 2 * H + u] = da_h;
      da[row * ldd + u] = da_z;
      da[row * ldd + H + u] = da_h;
    }
    __syncthreads();
    block_product<NT, kByColumn>(da + H, ldd, R, wh, H, KH, ring, slot, vec,
                                 zero, keep_p);
    __syncthreads();  // P is complete; the ring is free
    product_prologue<NT, kByColumn>(ring, slot, wzr, 2 * H, KH, R, vec);
    graph_product<true>(P, ldp, R, J, H, k, Tm);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < R * H; idx += kGThreads) {
      const int row = idx / H, u = idx - row * H;
      const float drh = P[row * ldp + u * k];
      const float r = __ldg(gt + row * 3 * H + H + u);
      const float h = __ldg(hp + row * KH + u * k);
      const float da_r = drh * h * r * (1.f - r);
      dx[row * 3 * H + H + u] = da_r;
      da[row * ldd + H + u] = da_r;
      dhb[idx] += drh * r;
    }
    __syncthreads();
    block_product<NT, kByColumn>(da, ldd, R, wzr, 2 * H, KH, ring, slot, vec,
                                 zero, keep_p);
    __syncthreads();  // P' is complete; the ring is free
    if (t > 0) {
      product_prologue<NT, kByColumn>(ring, slot, wh, H, KH, R, vec);
      graph_product<true>(P, ldp, R, J, H, k, Tm);
    }
  }
}

// Splits of the rows for the GRU's weight gradients, over both products'
// tiles.
int gru_dw_splits(int rows, int KH, int H, int sms) {
  return dw_tf32_splits(rows, dw_tiles(KH, 2 * H) + dw_tiles(KH, H), sms);
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

// Slices of a weight-gradient product: about two thread blocks per SM over
// all tiles, each slice at least 256 rows.
int dw_splits(int rows, int M, int N, int sms) {
  const int tiles = ((M + kDT - 1) / kDT) * ((N + kDT - 1) / kDT);
  const int by_rows = (rows + 255) / 256;
  return std::max(1, std::min(2 * sms / tiles, by_rows));
}

size_t dw_part_floats(int rows, int M, int N, int sms) {
  return static_cast<size_t>(dw_splits(rows, M, N, sms)) * M * N;
}

// dW (M x N) = A[:, :M]^T Bm[:, :N] over `rows` rows: the slices, then their
// sum in a fixed order.
cudaError_t weight_grad(const float* A, int lda, int M, const float* Bm,
                        int ldb, int N, int rows, float* part, float* out,
                        int sms, cudaStream_t stream) {
  const int splits = dw_splits(rows, M, N, sms);
  int chunk = (rows + splits - 1) / splits;
  chunk = (chunk + kDK - 1) / kDK * kDK;
  const dim3 grid((N + kDT - 1) / kDT, (M + kDT - 1) / kDT, splits);
  dw_gemm_kernel<<<grid, kThreads, 0, stream>>>(A, lda, M, Bm, ldb, N, rows,
                                                chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = M * N;
  reduce_parts_kernel<<<(count + 255) / 256, 256, 0, stream>>>(part, splits,
                                                               count, out);
  return cudaGetLastError();
}

// Shared memory of a scan kernel with C clips a thread block: the weight
// tile, the graph matrices, S (C J x k H) and `units` more C J x H buffers.
size_t scan_smem_bytes(int C, int J, int H, int k, int units) {
  const size_t tfloats = ((k - 1) * J * J + 3) & ~3;
  return sizeof(float) * (kWtFloats + tfloats
                          + static_cast<size_t>(C) * J * H * (k + units));
}

// Clips per thread block: enough thread blocks to cover the SMs first, then
// up to a 64-row tile, within the shared memory; 0 if one clip does not fit.
int pick_clips(int B, int J, int H, int k, int units, int sms) {
  int C = std::max(1, std::min(kBM / J, (B + sms - 1) / sms));
  while (C > 1 && scan_smem_bytes(C, J, H, k, units) > kMaxSmemBytes) --C;
  return scan_smem_bytes(C, J, H, k, units) <= kMaxSmemBytes ? C : 0;
}

bool valid(int L, int B, int J, int H, int k) {
  return L >= 1 && B >= 1 && J >= 1 && H >= 1 && k >= 1;
}

// C J x H buffers beside S: forward LSTM h, c; backward LSTM da (4), dh, dc.
constexpr int kLstmFwdUnits = 2, kLstmBwdUnits = 6;

template <class Kernel>
cudaError_t prepare(Kernel kernel, int B, int J, int H, int k, int units,
                    int* C, size_t* bytes) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *C = pick_clips(B, J, H, k, units, sms);
  if (*C == 0) return cudaErrorInvalidValue;
  *bytes = scan_smem_bytes(*C, J, H, k, units);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace

extern "C" {

// The GRU scan: xg (L, B, J, 3H) gate pre-activations z|r|h, cheb (k-1, J, J)
// the matrices T_1 .. T_{k-1}, wzr (H, k 2H) and wh (H, k H) the
// hidden-side weights as the caller holds them (columns by Chebyshev order,
// then gate) -> ys (L, B, J, H). With gates, sa and sb (all three or
// none): the residuals the backward reads (KEEP), gates (L, B, J, 3H) and
// sa, sb (L B J, k H; columns unit-major). float32, contiguous. One launch on `stream`; returns
// the first CUDA error, or 0.
int pv2c_graph_gru_scan_fwd(const float* xg, const float* cheb,
                            const float* wzr, const float* wh, float* ys,
                            float* gates, float* sa, float* sb, int L, int B,
                            int J, int H, int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  const bool keep = gates != nullptr;
  if (keep != (sa != nullptr) || keep != (sb != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GruPlan plan = plan_gru(B, J, H, k, false, sms);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = H % 4 == 0 && aligned16(wzr) && aligned16(wh) &&
                   (!keep || (aligned16(sa) && aligned16(sb)));
  auto kernel = plan.NT == kGWide
                    ? (keep ? gru_scan_fwd_kernel<true, kGWide>
                            : gru_scan_fwd_kernel<false, kGWide>)
                    : (keep ? gru_scan_fwd_kernel<true, kGWide / 2>
                            : gru_scan_fwd_kernel<false, kGWide / 2>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + plan.C - 1) / plan.C, kGThreads, plan.bytes, stream>>>(
      xg, cheb, wzr, wh, ys, gates, sa, sb, L, B, J, H, k, plan.C, vec);
  return static_cast<int>(cudaGetLastError());
}

// How the GRU scan (bwd = 0) or its reverse scan (bwd = 1) is launched on
// the current device at this shape: plan[0] clips a thread block, plan[1]
// the ring's widest tile, plan[2] the shared memory bytes; zeros where one
// clip does not fit. Returns a CUDA error, or 0.
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
// on the current device. Returns minus a CUDA error code on failure.
int pv2c_graph_scan_part_floats(int L, int B, int J, int H, int k, int gates) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int rows = L * B * J, KH = k * H;
  const size_t floats =
      gates == 4 ? dw_part_floats(rows, KH, 4 * H, sms)
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
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GruPlan plan = plan_gru(B, J, H, k, true, sms);
  if (plan.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = H % 4 == 0 && aligned16(wzr) && aligned16(wh) &&
                   aligned16(sa) && aligned16(sb) && aligned16(dxg);
  auto kernel = plan.NT == kGWide ? gru_scan_bwd_kernel<kGWide>
                                  : gru_scan_bwd_kernel<kGWide / 2>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + plan.C - 1) / plan.C, kGThreads, plan.bytes, stream>>>(
      cheb, wzr, wh, gates, sa, dys, dxg, L, B, J, H, k, plan.C, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int rows = L * B * J, KH = k * H;
  const int splits = gru_dw_splits(rows, KH, H, sms);
  const int chunk = round_up((rows + splits - 1) / splits, kDwKT);
  const int tiles0 = dw_tiles(KH, 2 * H), tiles1 = dw_tiles(KH, H);
  const DwProblem p0{sa, dxg, part, KH, KH, 3 * H, 2 * H};
  const DwProblem p1{sb, dxg + 2 * H,
                     part + static_cast<size_t>(splits) * KH * 2 * H, KH, KH,
                     3 * H, H};
  auto dw = vec ? dw_tf32_kernel<true> : dw_tf32_kernel<false>;
  err = cudaFuncSetAttribute(dw, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDwSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw<<<dim3(tiles0 + tiles1, splits), kDwThreads, kDwSmemBytes, stream>>>(
      p0, p1, tiles0, rows, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int count0 = KH * 2 * H, count1 = KH * H;
  reduce_two_kernel<<<(count0 + count1 + 255) / 256, 256, 0, stream>>>(
      p0.part, count0, dwzr, p1.part, count1, dwh, splits);
  return static_cast<int>(cudaGetLastError());
}
// The LSTM scan: xg (L, B, J, 4H) gate pre-activations i|f|c|o, w (k H, 4H)
// stacked -> ys and cs (L, B, J, H). One launch on `stream`.
int pv2c_graph_lstm_scan_fwd(const float* xg, const float* cheb,
                             const float* w, float* ys, float* cs, int L,
                             int B, int J, int H, int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int C = 0;
  size_t bytes = 0;
  cudaError_t err =
      prepare(lstm_scan_fwd_kernel, B, J, H, k, kLstmFwdUnits, &C, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_scan_fwd_kernel<<<(B + C - 1) / C, kThreads, bytes, stream>>>(
      xg, cheb, w, ys, cs, L, B, J, H, k, C);
  return static_cast<int>(cudaGetLastError());
}

// The LSTM scan's backward on its inputs, its outputs (ys, cs), the
// cotangent dys and, unless nullptr, the cell states' cotangent dcs: dxg
// (L, B, J, 4H) and dw (k H, 4H), stacked. w_t (4H, k H) is the stacked
// weight transposed. Scratch: sa (L B J, k H), part. Three launches on
// `stream`.
int pv2c_graph_lstm_scan_bwd(const float* xg, const float* cheb,
                             const float* w, const float* w_t, const float* ys,
                             const float* cs, const float* dys,
                             const float* dcs, float* dxg, float* sa,
                             float* part, float* dw, int L, int B, int J,
                             int H, int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int C = 0, sms = 0;
  size_t bytes = 0;
  cudaError_t err =
      prepare(lstm_scan_bwd_kernel, B, J, H, k, kLstmBwdUnits, &C, &bytes);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_scan_bwd_kernel<<<(B + C - 1) / C, kThreads, bytes, stream>>>(
      xg, cheb, w, w_t, ys, cs, dys, dcs, dxg, sa, L, B, J, H, k, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int rows = L * B * J, KH = k * H;
  err = weight_grad(sa, KH, KH, dxg, 4 * H, 4 * H, rows, part, dw, sms, stream);
  return static_cast<int>(err);
}

}  // extern "C"

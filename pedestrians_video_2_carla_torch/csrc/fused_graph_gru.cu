// The frame recurrences of the graph-convolutional GRU and LSTM layers
// (classification GNNs; the dense LSTM is the case J = 1, k = 1), forward and
// backward, for sm_90a, float32.
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
// The weights arrive "stacked": (k H, G H) with rows (n, unit), so that the
// graph is applied to the H-wide carry first and one product follows (the
// same sum as the TPU kernel's sum_n T_n (h W_n), at half the graph work).
//
// What bounds it on an H100: operations. At B=256, L=16, J=26, H=128, k=2 a
// GRU layer's forward is 22.3 GFLOP (0.33 ms at the fp32 peak) against 0.22
// GB of traffic (0.07 ms). The recurrence is sequential over frames and
// independent across clips, so a thread block owns a few clips (2 at that
// shape: 52 rows, 128 thread blocks for 132 SMs), keeps their carry in shared
// memory and loops over all frames inside one launch: no launch and no trip
// of the carry through device memory per frame. The weights (up to 512 KB)
// do not fit beside the activations; they stream from L2 in 16-row tiles,
// prefetched into registers while the previous tile is multiplied. A thread
// owns a 4-row x 8-column tile of each product; with several gates in one
// product its 8 columns are the gates of the same units, so the gating runs
// on the accumulators without an exchange. The ragged last thread block
// (B not a multiple of the clips per block) masks its rows.
//
// The backward walks the frames in reverse with dh (and dc) in shared memory,
// recomputes the gates from ys[t-1] (and cs), writes dxg, and carries dh
// through P = da W^T, dh += P_0 + sum_n T_n^T P_n. The weight gradients sum
// over all L B J rows: the scan writes each frame's expanded operand
// [h | T_n h] to device memory, and a split-K product dW = S^T dxg follows
// (128 x 128 tiles, the row range cut into slices, each slice summed by one
// thread block, the slices then summed in a fixed order by a second launch).
// No float atomics anywhere: the same bits on every launch.
//
// Numerics: 1 / (1 + expf(-x)), tanhf, fmaf sums, no fast math.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

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
gru_scan_fwd_kernel(const float* __restrict__ xg,
                    const float* __restrict__ cheb,
                    const float* __restrict__ wzr,
                    const float* __restrict__ wh, float* __restrict__ ys,
                    int L, int B, int J, int H, int k, int C) {
  extern __shared__ __align__(16) float smem[];
  const Block b = block_setup(smem, cheb, B, J, H, k, C);
  const int R = b.R, KH = b.KH, RH = C * J * H;
  float* hb = b.rest;    // the carry
  float* zb = hb + RH;   // z
  float* rhb = zb + RH;  // r h
  for (int i = threadIdx.x; i < R * H; i += kThreads) hb[i] = 0.f;
  __syncthreads();
  for (int t = 0; t < L; ++t) {
    const size_t at = static_cast<size_t>(t) * b.rows + b.row0;
    const float* x = xg + at * 3 * H;
    float* y = ys + at * H;
    fill_operand(b, J, H, k, hb, nullptr, nullptr);
    block_gemm<2>(
        b.S, KH, R, KH, wzr, 2 * H, H, H, b.wt,
        [&](int row, int u, float* v) {
          v[0] = x[row * 3 * H + u];
          v[1] = x[row * 3 * H + H + u];
        },
        [&](int row, int u, const float* v) {
          zb[row * H + u] = sigmoid(v[0]);
          rhb[row * H + u] = sigmoid(v[1]) * hb[row * H + u];
        });
    __syncthreads();
    fill_operand(b, J, H, k, rhb, nullptr, nullptr);
    block_gemm<1>(
        b.S, KH, R, KH, wh, H, 0, H, b.wt,
        [&](int row, int u, float* v) { v[0] = x[row * 3 * H + 2 * H + u]; },
        [&](int row, int u, const float* v) {
          const float ht = tanhf(v[0]), z = zb[row * H + u];
          const float hn = z * hb[row * H + u] + (1.f - z) * ht;
          hb[row * H + u] = hn;
          y[row * H + u] = hn;
        });
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
gru_scan_bwd_kernel(const float* __restrict__ xg,
                    const float* __restrict__ cheb,
                    const float* __restrict__ wzr,
                    const float* __restrict__ wh,
                    const float* __restrict__ wzr_t,
                    const float* __restrict__ wh_t,
                    const float* __restrict__ ys,
                    const float* __restrict__ dys, float* __restrict__ dxg,
                    float* __restrict__ sa, float* __restrict__ sb, int L,
                    int B, int J, int H, int k, int C) {
  extern __shared__ __align__(16) float smem[];
  const Block b = block_setup(smem, cheb, B, J, H, k, C);
  const int R = b.R, KH = b.KH, RH = C * J * H;
  float* da = b.rest;     // (R, 2H): da_z | z, later da_r
  float* rb = da + 2 * RH;  // r
  float* dahb = rb + RH;  // da_h
  float* dhb = dahb + RH;  // the dh carry
  for (int i = threadIdx.x; i < R * H; i += kThreads) dhb[i] = 0.f;
  __syncthreads();
  for (int t = L - 1; t >= 0; --t) {
    const size_t at = static_cast<size_t>(t) * b.rows + b.row0;
    const float* x = xg + at * 3 * H;
    float* dx = dxg + at * 3 * H;
    const float* dy = dys + at * H;
    // frame 0's previous hidden state is the zero start, not ys[-1]
    const float* hp = t > 0 ? ys + (at - b.rows) * H : nullptr;
    fill_operand(b, J, H, k, hp, nullptr, sa + at * KH);
    block_gemm<2>(
        b.S, KH, R, KH, wzr, 2 * H, H, H, b.wt,
        [&](int row, int u, float* v) {
          v[0] = x[row * 3 * H + u];
          v[1] = x[row * 3 * H + H + u];
        },
        [&](int row, int u, const float* v) {
          da[row * 2 * H + H + u] = sigmoid(v[0]);
          rb[row * H + u] = sigmoid(v[1]);
        });
    __syncthreads();
    fill_operand(b, J, H, k, hp, rb, sb + at * KH);
    block_gemm<1>(
        b.S, KH, R, KH, wh, H, 0, H, b.wt,
        [&](int row, int u, float* v) { v[0] = x[row * 3 * H + 2 * H + u]; },
        [&](int row, int u, const float* v) {
          const int at_u = row * H + u;
          const float ht = tanhf(v[0]), z = da[row * 2 * H + H + u];
          const float h_prev = hp ? hp[at_u] : 0.f;
          const float dh = dy[at_u] + dhb[at_u];
          const float da_z = dh * (h_prev - ht) * z * (1.f - z);
          const float da_h = dh * (1.f - z) * (1.f - ht * ht);
          da[row * 2 * H + u] = da_z;
          dahb[at_u] = da_h;
          dhb[at_u] = dh * z;
          dx[row * 3 * H + u] = da_z;
          dx[row * 3 * H + 2 * H + u] = da_h;
        });
    __syncthreads();
    // P = da_h Wh^T into S; d(r h) = P_0 + sum_n T_n^T P_n
    block_gemm<1>(
        dahb, H, R, H, wh_t, KH, 0, KH, b.wt,
        [&](int, int, float*) {},
        [&](int row, int q, const float* v) { b.S[row * KH + q] = v[0]; });
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int row = idx / H, u = idx - row * H;
      const float drh = gather_graph_t(b.S, KH, row, u, J, H, k, b.Tm);
      const float r = rb[idx], h_prev = hp ? hp[idx] : 0.f;
      const float da_r = drh * h_prev * r * (1.f - r);
      da[row * 2 * H + H + u] = da_r;  // z is used up
      dx[row * 3 * H + H + u] = da_r;
      dhb[idx] += drh * r;
    }
    __syncthreads();
    // P = [da_z | da_r] Wzr^T into S; dh += P_0 + sum_n T_n^T P_n
    block_gemm<1>(
        da, 2 * H, R, 2 * H, wzr_t, KH, 0, KH, b.wt,
        [&](int, int, float*) {},
        [&](int row, int q, const float* v) { b.S[row * KH + q] = v[0]; });
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
      const int row = idx / H, u = idx - row * H;
      dhb[idx] += gather_graph_t(b.S, KH, row, u, J, H, k, b.Tm);
    }
    __syncthreads();
  }
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

// C J x H buffers beside S: forward GRU h, z, r h; backward GRU da (2), r,
// da_h, dh; forward LSTM h, c; backward LSTM da (4), dh, dc.
constexpr int kGruFwdUnits = 3, kGruBwdUnits = 5, kLstmFwdUnits = 2,
              kLstmBwdUnits = 6;

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
// the matrices T_1 .. T_{k-1}, wzr (k H, 2H) and wh (k H, H) the stacked
// hidden-side weights -> ys (L, B, J, H). float32, contiguous. One launch on
// `stream`; returns the first CUDA error, or 0.
int pv2c_graph_gru_scan_fwd(const float* xg, const float* cheb,
                            const float* wzr, const float* wh, float* ys, int L,
                            int B, int J, int H, int k, cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int C = 0;
  size_t bytes = 0;
  cudaError_t err =
      prepare(gru_scan_fwd_kernel, B, J, H, k, kGruFwdUnits, &C, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_scan_fwd_kernel<<<(B + C - 1) / C, kThreads, bytes, stream>>>(
      xg, cheb, wzr, wh, ys, L, B, J, H, k, C);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the backward's `part` scratch, for gates = 3 (GRU) or 4 (LSTM),
// on the current device. Returns minus a CUDA error code on failure.
int pv2c_graph_scan_part_floats(int L, int B, int J, int H, int k, int gates) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int rows = L * B * J, KH = k * H;
  size_t floats = gates == 4 ? dw_part_floats(rows, KH, 4 * H, sms)
                             : std::max(dw_part_floats(rows, KH, 2 * H, sms),
                                        dw_part_floats(rows, KH, H, sms));
  if (floats > 0x7fffffff) return -static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(floats);
}

// The GRU scan's backward on its inputs, its output ys and the cotangent
// dys: dxg (L, B, J, 3H), dwzr (k H, 2H) and dwh (k H, H), stacked as the
// weights. wzr_t (2H, k H) and wh_t (H, k H) are the stacked weights
// transposed. Scratch: sa and sb (L B J, k H) each, part
// (pv2c_graph_scan_part_floats). Five launches on `stream` (the reverse
// scan, then two weight-gradient products of two launches each); returns the
// first CUDA error, or 0.
int pv2c_graph_gru_scan_bwd(const float* xg, const float* cheb,
                            const float* wzr, const float* wh,
                            const float* wzr_t, const float* wh_t,
                            const float* ys, const float* dys, float* dxg,
                            float* sa, float* sb, float* part, float* dwzr,
                            float* dwh, int L, int B, int J, int H, int k,
                            cudaStream_t stream) {
  if (!valid(L, B, J, H, k)) return static_cast<int>(cudaErrorInvalidValue);
  int C = 0, sms = 0;
  size_t bytes = 0;
  cudaError_t err =
      prepare(gru_scan_bwd_kernel, B, J, H, k, kGruBwdUnits, &C, &bytes);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_scan_bwd_kernel<<<(B + C - 1) / C, kThreads, bytes, stream>>>(
      xg, cheb, wzr, wh, wzr_t, wh_t, ys, dys, dxg, sa, sb, L, B, J, H, k, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int rows = L * B * J, KH = k * H;
  err = weight_grad(sa, KH, KH, dxg, 3 * H, 2 * H, rows, part, dwzr, sms,
                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = weight_grad(sb, KH, KH, dxg + 2 * H, 3 * H, H, rows, part, dwh, sms,
                    stream);
  return static_cast<int>(err);
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

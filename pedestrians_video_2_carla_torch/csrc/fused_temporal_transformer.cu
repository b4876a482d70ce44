// ONE pre-norm transformer block of PoseFormer's temporal stage (LayerNorm
// -> packed-qkv multi-head attention -> proj -> residual -> LayerNorm ->
// fc1 -> exact GELU -> fc2 -> residual) on (N, T, D) token-major windows,
// fp32 on the CUDA cores.
//
// Replaces the TPU kernels `_fwd_kernel_tl` (`_fwd_impl_slab_tl`, the
// token-leading default layout) and `_fwd_kernel` (`_fwd_impl_slab`, the
// legacy padded layout) of the JAX package's
// ops/pallas/fused_temporal_transformer.py, entries `fused_temporal_block`
// and `fused_temporal_stack`: both layouts compute the same function, so
// one kernel sequence is the counterpart of both.
//
// Bound on an H100 SXM: operations. At B=256, L=16 a block sees N = 2048
// windows of T=9 tokens x D=832 (hidden 1664, 8 heads of 104): 18,432
// tokens x 11,105,536 FLOP = 204.7 GFLOP, 3.06 ms at the 67 TFLOP/s fp32
// peak, against 123 MB of activations in and out and 22 MB of weights
// (43 us at 3.35 TB/s).
//
// Design. The intermediates do not fit on chip (one 64-row tile of the
// residual stream is 213 KB, its qkv 639 KB), so the entry is a fixed
// sequence of seven launches on the caller's stream, intermediates in
// buffers the wrapper allocates:
//   (a) LN1 row statistics; the qkv GEMM normalises A as it loads it;
//   (b) attention, one thread block per (window, head): T x T scores,
//       max-subtracted softmax, x V;
//   (c) the proj GEMM with a bias + residual epilogue (x2);
//   (d) LN2 row statistics; the fc1 GEMM with the LayerNorm on load and a
//       bias + GELU epilogue;
//   (e) the fc2 GEMM with a bias + residual epilogue.
// The GEMM is one template, C = A W^T with W in nn.Linear layout (out, in):
// 128 x 128 output tiles, k-steps of 8 through shared memory (stored
// k-major, rows padded by 4 floats so the transposing stores hit 32 banks),
// the next k-step prefetched into registers, 8 x 8 outputs per thread from
// float4 shared loads (64 FMAs per 4 loads). The TPU kernel's head-
// interleave permutation of the qkv columns is not carried over: it exists
// so that a (q, k) score tile is one (8, 128) vreg. LayerNorm uses flax's
// statistics, var = max(mean(x^2) - mean(x)^2, 0), eps 1e-5; GELU is exact
// (erff). Ragged M and N are masked.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kPad = 4;
constexpr int kGemmThreads = 256;
constexpr int kStatsThreads = 256;
constexpr int kMaxT = 16;     // tokens per window
constexpr int kMaxHd = 128;   // head width
constexpr int kAttnThreads = 128;
constexpr float kEps = 1e-5f;
constexpr float kSqrtHalf = 0.70710678118654752440f;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * kSqrtHalf));
}

// One warp per row of x (M x K, K a multiple of 4): mean and rsqrt(var +
// eps) with var = max(mean(x^2) - mean^2, 0).
__global__ void __launch_bounds__(kStatsThreads)
    row_stats_kernel(const float* __restrict__ x, int M, int K,
                     float* __restrict__ mu, float* __restrict__ inv) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kStatsThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const float4* xr =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * K);
  float sum = 0.f, sq = 0.f;
  for (int k = lane; k < K / 4; k += 32) {
    const float4 v = __ldg(xr + k);
    sum += (v.x + v.y) + (v.z + v.w);
    sq += fmaf(v.x, v.x, v.y * v.y) + fmaf(v.z, v.z, v.w * v.w);
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  if (lane == 0) {
    const float m = sum / K;
    mu[row] = m;
    inv[row] = rsqrtf(fmaxf(sq / K - m * m, 0.f) + kEps);
  }
}

enum Epilogue { kStore, kGelu, kResidual };

struct GemmArgs {
  const float* A;      // M x K
  const float* W;      // N x K (nn.Linear layout)
  const float* bias;   // N
  const float* R;      // M x N residual (kResidual)
  float* C;            // M x N
  int M, N, K;
  const float *mu, *inv, *gamma, *beta;  // LayerNorm of A's rows (LN)
  float* H = nullptr;  // kGelu: the pre-activation as well, if given
};

// C = epi(LN?(A) W^T + bias). K a multiple of 8, N of 4, pointers 16-byte
// aligned.
template <bool LN, int EPI>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Ws[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // loader: one float4 of A and one of W per thread and k-step
  const int lrow = tid >> 1, lk = (tid & 1) * 4;
  const bool a_ok = m0 + lrow < g.M, w_ok = n0 + lrow < g.N;
  const float* a_src =
      g.A + static_cast<size_t>(a_ok ? m0 + lrow : 0) * g.K + lk;
  const float* w_src =
      g.W + static_cast<size_t>(w_ok ? n0 + lrow : 0) * g.K + lk;
  float a_mu = 0.f, a_inv = 0.f;
  if (LN && a_ok) {
    a_mu = g.mu[m0 + lrow];
    a_inv = g.inv[m0 + lrow];
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 av, wv;
  auto load = [&](int k0) {
    av = a_ok ? __ldg(reinterpret_cast<const float4*>(a_src + k0)) : zero;
    wv = w_ok ? __ldg(reinterpret_cast<const float4*>(w_src + k0)) : zero;
    if (LN && a_ok) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(g.gamma + k0 + lk));
      const float4 b = __ldg(reinterpret_cast<const float4*>(g.beta + k0 + lk));
      av.x = (av.x - a_mu) * a_inv * s.x + b.x;
      av.y = (av.y - a_mu) * a_inv * s.y + b.y;
      av.z = (av.z - a_mu) * a_inv * s.z + b.z;
      av.w = (av.w - a_mu) * a_inv * s.w + b.w;
    }
  };
  auto store = [&]() {
    As[lk + 0][lrow] = av.x;
    As[lk + 1][lrow] = av.y;
    As[lk + 2][lrow] = av.z;
    As[lk + 3][lrow] = av.w;
    Ws[lk + 0][lrow] = wv.x;
    Ws[lk + 1][lrow] = wv.y;
    Ws[lk + 2][lrow] = wv.z;
    Ws[lk + 3][lrow] = wv.w;
  };

  // compute: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    const bool more = k0 + kBK < g.K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= g.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= g.N) continue;
      const float4 bv = __ldg(reinterpret_cast<const float4*>(g.bias + n));
      float4 v = make_float4(acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y,
                             acc[i][4 * h + 2] + bv.z,
                             acc[i][4 * h + 3] + bv.w);
      const size_t at = static_cast<size_t>(m) * g.N + n;
      if (EPI == kGelu) {
        if (g.H != nullptr) *reinterpret_cast<float4*>(g.H + at) = v;
        v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
      } else if (EPI == kResidual) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(g.R + at));
        v = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);
      }
      *reinterpret_cast<float4*>(g.C + at) = v;
    }
  }
}

// One thread block per (window, head). qkv: (N*T) x 3D rows [q | k | v],
// heads in (head, dim) order -> o: (N*T) x D.
__global__ void __launch_bounds__(kAttnThreads)
    attention_kernel(const float* __restrict__ qkv, float* __restrict__ o,
                     int T, int D, int H, float scale) {
  __shared__ float q[kMaxT * kMaxHd], k[kMaxT * kMaxHd], v[kMaxT * kMaxHd];
  __shared__ float p[kMaxT * kMaxT];
  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = D / H;
  const float* base = qkv + static_cast<size_t>(n) * T * 3 * D + h * hd;
  for (int idx = threadIdx.x; idx < T * hd; idx += kAttnThreads) {
    const int t = idx / hd, c = idx % hd;
    const float* row = base + static_cast<size_t>(t) * 3 * D + c;
    q[idx] = __ldg(row) * scale;
    k[idx] = __ldg(row + D);
    v[idx] = __ldg(row + 2 * D);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * T; idx += kAttnThreads) {
    const int i = idx / T, j = idx % T;
    float acc = 0.f;
    for (int c = 0; c < hd; ++c) acc = fmaf(q[i * hd + c], k[j * hd + c], acc);
    p[idx] = acc;
  }
  __syncthreads();
  if (threadIdx.x < T) {
    float* row = p + threadIdx.x * T;
    float m = -INFINITY;
    for (int j = 0; j < T; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < T; ++j) {
      row[j] = expf(row[j] - m);
      sum += row[j];
    }
    for (int j = 0; j < T; ++j) row[j] = row[j] / sum;
  }
  __syncthreads();
  float* dst = o + static_cast<size_t>(n) * T * D + h * hd;
  for (int idx = threadIdx.x; idx < T * hd; idx += kAttnThreads) {
    const int i = idx / hd, c = idx % hd;
    float acc = 0.f;
    for (int j = 0; j < T; ++j) acc = fmaf(p[i * T + j], v[j * hd + c], acc);
    dst[static_cast<size_t>(i) * D + c] = acc;
  }
}

template <bool LN, int EPI>
cudaError_t gemm(const GemmArgs& g, cudaStream_t stream) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM);
  gemm_kernel<LN, EPI><<<grid, kGemmThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward of one block: dx and the 12 weight gradients.
//
// Replaces the TPU kernels of `_bwd_impl_slab_tl` (`_bwd_mlp_kernel_tl`,
// `_bwd_attn_kernel_tl`, `_attn_bwd_stream_tl`; token-leading layout) and
// `_bwd_impl_slab` (`_bwd_mlp_kernel`, `_bwd_attn_kernel`; legacy layout):
// one function in two TPU layouts, one counterpart here.
//
// Bound on an H100 SXM: operations. dx + dW are twice the forward's dense
// products and four attention products against two: at B=1024, L=16 a
// block sees 73,728 tokens x 22,211,072 FLOP = 1,637.6 GFLOP, 24.44 ms at
// the 67 TFLOP/s fp32 peak.
//
// Design. The forward keeps, when a gradient is needed, its LayerNorm row
// statistics, qkv, the attention output, x2, the pre-GELU hidden h and
// gelu(h) (about 2.2 GB a block at B=1024; the TPU kernel recomputes them
// from x and x2 in VMEM instead). The backward is a fixed sequence of
// launches on the caller's stream, in the TPU kernel's order (the MLP half,
// then the attention half):
//   dh = (du W2) * GELU'(h), dW2 = du^T gelu(h), dy2 = dh W1,
//   dW1 = dh^T LN2(x2), dx2 = du + LN2'(dy2); do = dx2 Wp, dWp = dx2^T o,
//   attention backward -> dqkv, dy1 = dqkv Wqkv, dWqkv = dqkv^T LN1(x),
//   dx = dx2 + LN1'(dy1); the biases' and LayerNorms' gradients are column
//   sums.
// Products: dX = dY W is the forward's 128 x 128 tile GEMM with W read
// row-wise (K = the layer's outputs); dW = dY^T X reduces over all M rows
// into a small output (49 to 140 tiles), so it is split over M into enough
// parts to fill the card, each part's sum written to its own slice, and the
// slices summed in a fixed order by a second launch. Column sums go the
// same way (64 row chunks, then a fixed-order sum). No atomics: two
// backward calls give the same bits. LayerNorm's input of dW1 and dWqkv is
// rebuilt from x2 and x on load, with the forward's statistics. Attention
// backward, one thread block per (window, head): the probabilities
// recomputed from qkv, ds = p (dp - sum_j dp p), dq scaled by hd^-0.5.

constexpr int kSumChunks = 64;  // row chunks of a column sum
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

__device__ __forceinline__ float dgelu(float v) {
  return 0.5f * (1.0f + erff(v * kSqrtHalf)) + v * expf(-0.5f * v * v) *
                                                   kInvSqrt2Pi;
}

enum BwdMode { kNN, kTN };
enum BwdEpilogue { kSet, kDGelu };

struct BwdGemmArgs {
  const float* A;  // kNN: M x K; kTN: K x M
  const float* B;  // K x N
  float* C;        // M x N; kTN: one M x N slice per split
  int M, N, K;
  const float* aux;                      // kDGelu: the pre-activation, M x N
  const float *mu, *inv, *gamma, *beta;  // LN: LayerNorm of B's rows
  int k_split;                           // kTN: rows of K per split
};

// kNN: C = epi(A B); kTN: C[split] = A^T B over split's rows of K (LN: of
// LN(B)). N, M (kTN) multiples of 4, K (kNN) a multiple of 8, pointers
// 16-byte aligned. Tiles, thread layout and inner loop as gemm_kernel.
template <int MODE, bool LN, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_bwd_kernel(BwdGemmArgs g) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = MODE == kTN ? blockIdx.z * g.k_split : 0;
  const int kend = MODE == kTN ? min(g.K, kbeg + g.k_split) : g.K;

  // kNN's A: a float4 along k of row m0 + arow, stored transposed; rows of
  // B (and kTN's A): a float4 of row k0 + rk at column rc, stored as is
  const int arow = tid >> 1, ak = (tid & 1) * 4;
  const int rk = tid >> 5, rc = (tid & 31) * 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 av, bv;
  auto load = [&](int k0) {
    const int k = k0 + rk;
    if (MODE == kNN) {
      av = m0 + arow < g.M
               ? __ldg(reinterpret_cast<const float4*>(
                     g.A + static_cast<size_t>(m0 + arow) * g.K + k0 + ak))
               : zero;
    } else {
      av = k < kend && m0 + rc < g.M
               ? __ldg(reinterpret_cast<const float4*>(
                     g.A + static_cast<size_t>(k) * g.M + m0 + rc))
               : zero;
    }
    const bool b_ok = k < kend && n0 + rc < g.N;
    bv = b_ok ? __ldg(reinterpret_cast<const float4*>(
                    g.B + static_cast<size_t>(k) * g.N + n0 + rc))
              : zero;
    if (LN && b_ok) {
      const float m = g.mu[k], iv = g.inv[k];
      const float4 s = __ldg(reinterpret_cast<const float4*>(g.gamma + n0 + rc));
      const float4 b = __ldg(reinterpret_cast<const float4*>(g.beta + n0 + rc));
      bv.x = (bv.x - m) * iv * s.x + b.x;
      bv.y = (bv.y - m) * iv * s.y + b.y;
      bv.z = (bv.z - m) * iv * s.z + b.z;
      bv.w = (bv.w - m) * iv * s.w + b.w;
    }
  };
  auto store = [&]() {
    if (MODE == kNN) {
      As[ak + 0][arow] = av.x;
      As[ak + 1][arow] = av.y;
      As[ak + 2][arow] = av.z;
      As[ak + 3][arow] = av.w;
    } else {
      *reinterpret_cast<float4*>(&As[rk][rc]) = av;
    }
    *reinterpret_cast<float4*>(&Bs[rk][rc]) = bv;
  };

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(kbeg);
  store();
  __syncthreads();
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    const bool more = k0 + kBK < kend;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  float* C = g.C;
  if (MODE == kTN) C += static_cast<size_t>(blockIdx.z) * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= g.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= g.N) continue;
      const size_t at = static_cast<size_t>(m) * g.N + n;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (EPI == kDGelu) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(g.aux + at));
        v = make_float4(v.x * dgelu(p.x), v.y * dgelu(p.y), v.z * dgelu(p.z),
                        v.w * dgelu(p.w));
      }
      *reinterpret_cast<float4*>(C + at) = v;
    }
  }
}

// Partial column sums of dy (rows x ncol) over row chunk blockIdx.y:
// s1[chunk][c] = sum_r dy[r][c]; LN: s2[chunk][c] = sum_r dy[r][c]
// (x[r][c] - mu[r]) inv[r].
template <bool LN>
__global__ void column_sums_kernel(const float* __restrict__ dy,
                                   const float* __restrict__ x,
                                   const float* __restrict__ mu,
                                   const float* __restrict__ inv, int rows,
                                   int ncol, int chunk, float* __restrict__ s1,
                                   float* __restrict__ s2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncol) return;
  const int r1 = min(rows, (blockIdx.y + 1) * chunk);
  float sb = 0.f, ss = 0.f;
  for (int r = blockIdx.y * chunk; r < r1; ++r) {
    const size_t at = static_cast<size_t>(r) * ncol + c;
    const float v = __ldg(dy + at);
    sb += v;
    if (LN) ss = fmaf(v, (__ldg(x + at) - mu[r]) * inv[r], ss);
  }
  s1[blockIdx.y * ncol + c] = sb;
  if (LN) s2[blockIdx.y * ncol + c] = ss;
}

// out[e] = sum over p < parts, in order, of part[p][e] (row length len).
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       int parts, int len,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[static_cast<size_t>(p) * len + e];
  out[e] = s;
}

// One warp per row (K a multiple of 4): with xh = (x - mu) inv and dxh =
// dy s, out = res + inv (dxh - mean(dxh) - xh mean(dxh xh)).
__global__ void __launch_bounds__(kStatsThreads)
    ln_bwd_rows_kernel(const float* __restrict__ dy,
                       const float* __restrict__ x,
                       const float* __restrict__ mu,
                       const float* __restrict__ inv,
                       const float* __restrict__ s,
                       const float* __restrict__ res, float* __restrict__ out,
                       int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kStatsThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = static_cast<size_t>(row) * K;
  const float4* d4 = reinterpret_cast<const float4*>(dy + base);
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float m = mu[row], iv = inv[row];
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < K / 4; k += 32) {
    const float4 d = __ldg(d4 + k), v = __ldg(x4 + k), sc = __ldg(s4 + k);
    const float e0 = d.x * sc.x, e1 = d.y * sc.y, e2 = d.z * sc.z,
                e3 = d.w * sc.w;
    s1 += (e0 + e1) + (e2 + e3);
    s2 += fmaf(e0, (v.x - m) * iv, e1 * ((v.y - m) * iv)) +
          fmaf(e2, (v.z - m) * iv, e3 * ((v.w - m) * iv));
  }
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float m1 = s1 / K, m2 = s2 / K;
  const float4* r4 = reinterpret_cast<const float4*>(res + base);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  for (int k = lane; k < K / 4; k += 32) {
    const float4 d = __ldg(d4 + k), v = __ldg(x4 + k), sc = __ldg(s4 + k),
                 r = __ldg(r4 + k);
    o4[k] = make_float4(
        r.x + iv * (d.x * sc.x - m1 - (v.x - m) * iv * m2),
        r.y + iv * (d.y * sc.y - m1 - (v.y - m) * iv * m2),
        r.z + iv * (d.z * sc.z - m1 - (v.z - m) * iv * m2),
        r.w + iv * (d.w * sc.w - m1 - (v.w - m) * iv * m2));
  }
}

// Attention backward, one thread block per (window, head): qkv rows [q | k
// | v] and do (N*T) x D -> dqkv (N*T) x 3D, the probabilities recomputed as
// attention_kernel computes them.
__global__ void __launch_bounds__(kAttnThreads)
    attention_bwd_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ dout,
                         float* __restrict__ dqkv, int T, int D, int H,
                         float scale) {
  __shared__ float q[kMaxT * kMaxHd], k[kMaxT * kMaxHd], v[kMaxT * kMaxHd],
      dov[kMaxT * kMaxHd];
  __shared__ float p[kMaxT * kMaxT], ds[kMaxT * kMaxT];
  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = D / H;
  const float* base = qkv + static_cast<size_t>(n) * T * 3 * D + h * hd;
  const float* dbase = dout + static_cast<size_t>(n) * T * D + h * hd;
  for (int idx = threadIdx.x; idx < T * hd; idx += kAttnThreads) {
    const int t = idx / hd, c = idx % hd;
    const float* row = base + static_cast<size_t>(t) * 3 * D + c;
    q[idx] = __ldg(row) * scale;
    k[idx] = __ldg(row + D);
    v[idx] = __ldg(row + 2 * D);
    dov[idx] = __ldg(dbase + static_cast<size_t>(t) * D + c);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * T; idx += kAttnThreads) {
    const int i = idx / T, j = idx % T;
    float acc = 0.f, dacc = 0.f;
    for (int c = 0; c < hd; ++c) {
      acc = fmaf(q[i * hd + c], k[j * hd + c], acc);
      dacc = fmaf(dov[i * hd + c], v[j * hd + c], dacc);
    }
    p[idx] = acc;
    ds[idx] = dacc;  // dp, until the softmax rows are done
  }
  __syncthreads();
  if (threadIdx.x < T) {
    float* row = p + threadIdx.x * T;
    float* drow = ds + threadIdx.x * T;
    float m = -INFINITY;
    for (int j = 0; j < T; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < T; ++j) {
      row[j] = expf(row[j] - m);
      sum += row[j];
    }
    float cdp = 0.f;
    for (int j = 0; j < T; ++j) {
      row[j] = row[j] / sum;
      cdp = fmaf(drow[j], row[j], cdp);
    }
    for (int j = 0; j < T; ++j) drow[j] = row[j] * (drow[j] - cdp);
  }
  __syncthreads();
  float* dst = dqkv + static_cast<size_t>(n) * T * 3 * D + h * hd;
  for (int idx = threadIdx.x; idx < T * hd; idx += kAttnThreads) {
    const int i = idx / hd, c = idx % hd;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int j = 0; j < T; ++j) {
      dq = fmaf(ds[i * T + j], k[j * hd + c], dq);
      dk = fmaf(ds[j * T + i], q[j * hd + c], dk);
      dv = fmaf(p[j * T + i], dov[j * hd + c], dv);
    }
    float* row = dst + static_cast<size_t>(i) * 3 * D + c;
    row[0] = dq * scale;
    row[D] = dk;
    row[2 * D] = dv;
  }
}

template <int MODE, bool LN, int EPI>
cudaError_t gemm_bwd(const BwdGemmArgs& g, int splits, cudaStream_t stream) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, splits);
  gemm_bwd_kernel<MODE, LN, EPI><<<grid, kGemmThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

// How a weight gradient of rows x cols over K summed rows is split: parts
// enough for about two waves of the card, at least 512 rows each.
void split_k(int rows, int cols, int K, int sms, int* splits, int* k_split) {
  const int tiles = ((rows + kBM - 1) / kBM) * ((cols + kBN - 1) / kBN);
  int s = (2 * sms + tiles - 1) / tiles;
  const int most = K / (kBK * 64) > 1 ? K / (kBK * 64) : 1;
  s = s < 1 ? 1 : (s > most ? most : s);
  *k_split = (((K + s - 1) / s) + kBK - 1) / kBK * kBK;
  *splits = (K + *k_split - 1) / *k_split;
}

// dW (rows x cols) = A^T B (LN: A^T LN(B)) over K rows: split, then the
// fixed-order sum of the parts into out. part holds splits x rows x cols.
template <bool LN>
cudaError_t weight_grad(const float* A, const float* B, int rows, int cols,
                        int K, const float* mu, const float* inv,
                        const float* gamma, const float* beta, float* part,
                        float* out, int sms, cudaStream_t stream) {
  int splits, k_split;
  split_k(rows, cols, K, sms, &splits, &k_split);
  cudaError_t err = gemm_bwd<kTN, LN, kSet>(
      BwdGemmArgs{A, B, part, rows, cols, K, nullptr, mu, inv, gamma, beta,
                  k_split},
      splits, stream);
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(rows * cols + 255) / 256, 256, 0, stream>>>(
      part, splits, rows * cols, out);
  return cudaGetLastError();
}

// out_b = sum_r dy[r]; LN: out_s = sum_r dy[r] xh[r] as well. part holds
// 2 x kSumChunks x ncol.
template <bool LN>
cudaError_t column_grads(const float* dy, int M, int ncol, const float* x,
                         const float* mu, const float* inv, float* part,
                         float* out_b, float* out_s, cudaStream_t stream) {
  const int chunk = (M + kSumChunks - 1) / kSumChunks;
  float* part_s = part + kSumChunks * ncol;
  column_sums_kernel<LN><<<dim3((ncol + 255) / 256, kSumChunks), 256, 0,
                           stream>>>(dy, x, mu, inv, M, ncol, chunk, part,
                                     part_s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(ncol + 255) / 256, 256, 0, stream>>>(
      part, kSumChunks, ncol, out_b);
  if (LN)
    reduce_partials_kernel<<<(ncol + 255) / 256, 256, 0, stream>>>(
        part_s, kSumChunks, ncol, out_s);
  return cudaGetLastError();
}

// Floats of the backward's `part` scratch for M rows: the largest split
// weight gradient, or the column sums' parts.
int part_floats(int M, int D, int hidden, int sms) {
  const int shapes[4][2] = {{D, hidden}, {hidden, D}, {D, D}, {3 * D, D}};
  int most = 2 * kSumChunks * (3 * D > hidden ? 3 * D : hidden);
  for (const auto& rc : shapes) {
    int splits, k_split;
    split_k(rc[0], rc[1], M, sms, &splits, &k_split);
    const int need = splits * rc[0] * rc[1];
    most = need > most ? need : most;
  }
  return most;
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

bool valid(int n, int T, int D, int H, int hidden) {
  return T <= kMaxT && D >= 8 && D % 8 == 0 && hidden >= 8 &&
         hidden % 8 == 0 && H >= 1 && D % H == 0 && D / H <= kMaxHd &&
         (n * T + kBM - 1) / kBM <= 65535;
}

}  // namespace

extern "C" {

// One block on x (n, T, D) -> out (n, T, D), float32 contiguous. Weights in
// nn.Linear layout: qkv_w (3D, D), proj_w (D, D), fc1_w (hidden, D), fc2_w
// (D, hidden). Scratch: stats (4 n T), qkv (n T, 3D), attn (n T, D), x2
// (n T, D), mlp (n T, hidden), and h (n T, hidden), the pre-GELU hidden,
// which only training keeps (nullptr: not written). Requires T <= 16, D and
// hidden multiples of 8, D / H <= 128 and 16-byte aligned pointers.
// Launches seven kernels on `stream`; returns the first CUDA error, or 0.
int pv2c_fused_temporal_block(
    const float* x, float* out, const float* ln1_s, const float* ln1_b,
    const float* qkv_w, const float* qkv_b, const float* proj_w,
    const float* proj_b, const float* ln2_s, const float* ln2_b,
    const float* fc1_w, const float* fc1_b, const float* fc2_w,
    const float* fc2_b, float* stats, float* qkv, float* attn, float* x2,
    float* mlp, float* h, int n, int T, int D, int H, int hidden, float scale,
    cudaStream_t stream) {
  const int M = n * T;
  if (M <= 0) return 0;
  if (!valid(n, T, D, H, hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  float *mu1 = stats, *inv1 = stats + M, *mu2 = stats + 2 * M,
        *inv2 = stats + 3 * M;
  const int stats_blocks = (M + kStatsThreads / 32 - 1) / (kStatsThreads / 32);
  cudaError_t err;

  row_stats_kernel<<<stats_blocks, kStatsThreads, 0, stream>>>(x, M, D, mu1,
                                                               inv1);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = gemm<true, kStore>(GemmArgs{x, qkv_w, qkv_b, nullptr, qkv, M, 3 * D,
                                    D, mu1, inv1, ln1_s, ln1_b},
                           stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<<<n * H, kAttnThreads, 0, stream>>>(qkv, attn, T, D, H,
                                                        scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = gemm<false, kResidual>(GemmArgs{attn, proj_w, proj_b, x, x2, M, D, D,
                                        nullptr, nullptr, nullptr, nullptr},
                               stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_stats_kernel<<<stats_blocks, kStatsThreads, 0, stream>>>(x2, M, D, mu2,
                                                               inv2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = gemm<true, kGelu>(GemmArgs{x2, fc1_w, fc1_b, nullptr, mlp, M, hidden,
                                   D, mu2, inv2, ln2_s, ln2_b, h},
                          stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm<false, kResidual>(GemmArgs{mlp, fc2_w, fc2_b, x2, out, M, D,
                                        hidden, nullptr, nullptr, nullptr,
                                        nullptr},
                               stream);
  return static_cast<int>(err);
}

// Floats of the backward's `part` scratch (below), on the current device.
// Returns minus a CUDA error code on failure.
int pv2c_temporal_block_bwd_part_floats(int n, int T, int D, int hidden) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return part_floats(n * T, D, hidden, sms);
}

// The backward of pv2c_fused_temporal_block on its input x, its weights,
// the scratch it filled (stats, qkv, attn, x2, h, mlp; h written) and the
// output's cotangent g: dx (n, T, D) and grads, the 12 weight gradients
// flat, each in its weight's layout, in the weights' order. Scratch: dh
// (n T, hidden), dy (n T, D), dx2 (n T, D), dqkv (n T, 3D) and part
// (pv2c_temporal_block_bwd_part_floats). Requirements as the forward's.
// Launches its kernels on `stream`; returns the first CUDA error, or 0.
int pv2c_fused_temporal_block_bwd(
    const float* x, const float* ln1_s, const float* ln1_b,
    const float* qkv_w, const float* qkv_b, const float* proj_w,
    const float* proj_b, const float* ln2_s, const float* ln2_b,
    const float* fc1_w, const float* fc1_b, const float* fc2_w,
    const float* fc2_b, const float* stats, const float* qkv,
    const float* attn, const float* x2, const float* h, const float* mlp,
    const float* g, float* dx, float* grads, float* dh, float* dy,
    float* dx2, float* dqkv, float* part, int n, int T, int D, int H,
    int hidden, float scale, cudaStream_t stream) {
  const int M = n * T, G = hidden;
  if (M <= 0) return 0;
  if (!valid(n, T, D, H, hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  const float *mu1 = stats, *inv1 = stats + M, *mu2 = stats + 2 * M,
              *inv2 = stats + 3 * M;
  // the gradients' offsets in grads, in the weights' order
  float* g_ln1_s = grads;
  float* g_ln1_b = g_ln1_s + D;
  float* g_qkv_w = g_ln1_b + D;
  float* g_qkv_b = g_qkv_w + 3 * D * D;
  float* g_proj_w = g_qkv_b + 3 * D;
  float* g_proj_b = g_proj_w + D * D;
  float* g_ln2_s = g_proj_b + D;
  float* g_ln2_b = g_ln2_s + D;
  float* g_fc1_w = g_ln2_b + D;
  float* g_fc1_b = g_fc1_w + G * D;
  float* g_fc2_w = g_fc1_b + G;
  float* g_fc2_b = g_fc2_w + D * G;
  const int rows_blocks =
      (M + kStatsThreads / 32 - 1) / (kStatsThreads / 32);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
#define PV2C_STEP(call)                                        \
  if (err == cudaSuccess) err = (call)

  // MLP half: du = g
  PV2C_STEP((gemm_bwd<kNN, false, kDGelu>(
      BwdGemmArgs{g, fc2_w, dh, M, G, D, h, nullptr, nullptr, nullptr,
                  nullptr, 0},
      1, stream)));
  PV2C_STEP(weight_grad<false>(g, mlp, D, G, M, nullptr, nullptr, nullptr,
                               nullptr, part, g_fc2_w, sms, stream));
  PV2C_STEP(column_grads<false>(g, M, D, nullptr, nullptr, nullptr, part,
                                g_fc2_b, nullptr, stream));
  PV2C_STEP((gemm_bwd<kNN, false, kSet>(
      BwdGemmArgs{dh, fc1_w, dy, M, D, G, nullptr, nullptr, nullptr, nullptr,
                  nullptr, 0},
      1, stream)));
  PV2C_STEP(weight_grad<true>(dh, x2, G, D, M, mu2, inv2, ln2_s, ln2_b, part,
                              g_fc1_w, sms, stream));
  PV2C_STEP(column_grads<false>(dh, M, G, nullptr, nullptr, nullptr, part,
                                g_fc1_b, nullptr, stream));
  PV2C_STEP(column_grads<true>(dy, M, D, x2, mu2, inv2, part, g_ln2_b,
                               g_ln2_s, stream));
  if (err == cudaSuccess) {
    ln_bwd_rows_kernel<<<rows_blocks, kStatsThreads, 0, stream>>>(
        dy, x2, mu2, inv2, ln2_s, g, dx2, M, D);
    err = cudaGetLastError();
  }
  // attention half: da = dx2
  PV2C_STEP((gemm_bwd<kNN, false, kSet>(
      BwdGemmArgs{dx2, proj_w, dy, M, D, D, nullptr, nullptr, nullptr,
                  nullptr, nullptr, 0},
      1, stream)));
  PV2C_STEP(weight_grad<false>(dx2, attn, D, D, M, nullptr, nullptr, nullptr,
                               nullptr, part, g_proj_w, sms, stream));
  PV2C_STEP(column_grads<false>(dx2, M, D, nullptr, nullptr, nullptr, part,
                                g_proj_b, nullptr, stream));
  if (err == cudaSuccess) {
    attention_bwd_kernel<<<n * H, kAttnThreads, 0, stream>>>(qkv, dy, dqkv, T,
                                                             D, H, scale);
    err = cudaGetLastError();
  }
  PV2C_STEP((gemm_bwd<kNN, false, kSet>(
      BwdGemmArgs{dqkv, qkv_w, dy, M, D, 3 * D, nullptr, nullptr, nullptr,
                  nullptr, nullptr, 0},
      1, stream)));
  PV2C_STEP(weight_grad<true>(dqkv, x, 3 * D, D, M, mu1, inv1, ln1_s, ln1_b,
                              part, g_qkv_w, sms, stream));
  PV2C_STEP(column_grads<false>(dqkv, M, 3 * D, nullptr, nullptr, nullptr,
                                part, g_qkv_b, nullptr, stream));
  PV2C_STEP(column_grads<true>(dy, M, D, x, mu1, inv1, part, g_ln1_b,
                               g_ln1_s, stream));
  if (err == cudaSuccess) {
    ln_bwd_rows_kernel<<<rows_blocks, kStatsThreads, 0, stream>>>(
        dy, x, mu1, inv1, ln1_s, dx2, dx, M, D);
    err = cudaGetLastError();
  }
#undef PV2C_STEP
  return static_cast<int>(err);
}

}  // extern "C"

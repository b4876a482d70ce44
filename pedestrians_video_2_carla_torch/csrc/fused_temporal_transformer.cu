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

}  // namespace

extern "C" {

// One block on x (n, T, D) -> out (n, T, D), float32 contiguous. Weights in
// nn.Linear layout: qkv_w (3D, D), proj_w (D, D), fc1_w (hidden, D), fc2_w
// (D, hidden). Scratch: stats (4 n T), qkv (n T, 3D), attn (n T, D), x2
// (n T, D), mlp (n T, hidden). Requires T <= 16, D and hidden multiples of
// 8, D / H <= 128 and 16-byte aligned pointers. Launches seven kernels on
// `stream`; returns the first CUDA error, or 0.
int pv2c_fused_temporal_block(
    const float* x, float* out, const float* ln1_s, const float* ln1_b,
    const float* qkv_w, const float* qkv_b, const float* proj_w,
    const float* proj_b, const float* ln2_s, const float* ln2_b,
    const float* fc1_w, const float* fc1_b, const float* fc2_w,
    const float* fc2_b, float* stats, float* qkv, float* attn, float* x2,
    float* mlp, int n, int T, int D, int H, int hidden, float scale,
    cudaStream_t stream) {
  const int M = n * T;
  if (M <= 0) return 0;
  if (T > kMaxT || D < 8 || D % 8 || hidden < 8 || hidden % 8 || H < 1 ||
      D % H || D / H > kMaxHd || (M + kBM - 1) / kBM > 65535)
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
                                   D, mu2, inv2, ln2_s, ln2_b},
                          stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm<false, kResidual>(GemmArgs{mlp, fc2_w, fc2_b, x2, out, M, D,
                                        hidden, nullptr, nullptr, nullptr,
                                        nullptr},
                               stream);
  return static_cast<int>(err);
}

}  // extern "C"

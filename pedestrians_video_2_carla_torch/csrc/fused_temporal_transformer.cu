// ONE pre-norm transformer block of PoseFormer's temporal stage (LayerNorm
// -> packed-qkv multi-head attention -> proj -> residual -> LayerNorm ->
// fc1 -> exact GELU -> fc2 -> residual) on (N, T, D) token-major windows,
// in float32: the products as 3xTF32 in the tensor cores.
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
// tokens x 11,105,536 FLOP = 204.7 GFLOP. The products run as 3xTF32 (three
// TF32 products for each fp32 one, at fp32's accuracy), so the bound is
// 204.7 GFLOP at 495 / 3 TFLOP/s, 1.24 ms (3.06 ms at the 67 TFLOP/s fp32
// peak of the CUDA cores), against 145 MB of activations in and out and
// weights (43 us at 3.35 TB/s), plus about 245 MB that the two LayerNorm
// passes read and write (about 73 us).
//
// Design. The intermediates do not fit on chip (one 64-row tile of the
// residual stream is 213 KB, its qkv 639 KB), so the entry is a fixed
// sequence of seven launches on the caller's stream, intermediates in
// buffers the wrapper allocates:
//   (a) y1 = LN1(x) and its row statistics (a warp a row), into `out`,
//       which is free until (g) writes it;
//   (b) qkv = y1 Wqkv^T + b;
//   (c) attention, one thread block per (window, head): T x T scores,
//       max-subtracted softmax, x V (the CUDA cores: 0.55 GFLOP a block);
//   (d) x2 = x + o Wp^T + b;
//   (e) y2 = LN2(x2) and its statistics, into `out` again (y1 is dead);
//   (f) mlp = GELU(y2 W1^T + b), and the pre-GELU h when training;
//   (g) out = x2 + mlp W2^T + b.
// The four products are one GEMM template, C = A W^T with W in nn.Linear
// layout (out, in): both operands K-contiguous, so both tiles are staged
// row-major (a tile row is one output row or column, kFBK floats of K, the
// row stride padded by 4 floats so that a warp's fragment reads hit 32
// banks), and the W tile is exactly the `col` B operand of
// mma.sync.m16n8k8.row.col. 128 x 128 output tiles, k-steps of kFBK
// through a kFStages-deep cp.async ring in shared memory (the loads of
// k-step s + kFStages - 1 fly while k-step s is multiplied, one barrier a
// k-step), warps of kFWM x kFWN tiles of m16n8k8 TF32 products. Each fp32
// operand is split into a TF32 value and a TF32 remainder and a b = a_small
// b_big + a_big b_small + a_big b_big: the three products of each 8-deep
// step are summed in the tensor cores (which round towards zero), then added
// to the running fp32 sum with round-to-nearest, so the tensor cores'
// rounding does not grow with K (fc2's K is 1664; mma_tf32.cuh). The
// epilogues: bias (qkv), bias + residual (proj, fc2), bias + exact GELU
// (erff), writing the pre-GELU h as well when given (fc1). LayerNorm uses
// flax's statistics, var = max(mean(x^2) - mean(x)^2, 0), eps 1e-5. Ragged
// M and N are masked. The TPU kernel's head-interleave permutation of the
// qkv columns is not carried over: it exists so that a (q, k) score tile is
// one (8, 128) vreg. The earlier design (the same seven launches with an
// fp32 128 x 128 x 8 GEMM on the CUDA cores, LayerNorm applied as A was
// loaded) took 5.85 ms a block at B=256.
//
// bf16 (the `_bf16` entries; every kernel but the products is a template
// on the storage type S, float or bf16): x, the weights, the output and
// every buffer between the launches are bf16 (y1, qkv, the attention
// output, x2, y2, GELU's output, and h when training), as the JAX kernels
// keep their slabs and residuals in the compute dtype; the LayerNorm
// statistics stay float32. The four products are the bf16 GEMM of
// wgmma_bf16.cuh: Hopper's bf16 tensor cores (wgmma, fp32 sums in
// registers) on tiles that TMA brings into a 128-byte-swizzled ring, the
// same epilogues in fp32; LayerNorm, softmax, GELU and the residual adds run
// in float32, as in the JAX kernel, and each stored value is rounded to
// bf16 to nearest even. Bound at B=256 (the same 204.7 GFLOP at bf16's
// dense 989 TFLOP/s): 0.207 ms. The earlier bf16 design (this file's TF32
// GEMM on bf16 tiles widened to TF32, one mma.sync pass a product) took
// 1.716 ms at B=256.
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"
#include "storage.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kBM = 128, kBN = 128;
constexpr int kGemmThreads = 256;
constexpr int kStatsThreads = 256;
constexpr int kMaxT = 81;     // tokens per window (T x T scores per block)
constexpr int kMaxHd = 128;   // head width
constexpr int kMaxSmem = 232448;  // shared memory of one thread block
constexpr int kAttnThreads = 128;
constexpr float kEps = 1e-5f;

// The forward GEMM's plan (mirrored in ops/fused_temporal_transformer.py,
// FORWARD_GEMM): thread-block tile, warp tile, k-step, ring depth, thread
// blocks an SM.
constexpr int kFBM = 128, kFBN = 128;
constexpr int kFWM = 64, kFWN = 64;
constexpr int kFBK = 32;
constexpr int kFStages = 3;
constexpr int kFMinBlocks = 2;
constexpr int kFWarps = (kFBM / kFWM) * (kFBN / kFWN);
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFLd = kFBK + 4;  // staged tile row stride
constexpr int kFStageFloats = (kFBM + kFBN) * kFLd;  // an A and a W tile
constexpr int kFSmemBytes = 4 * kFStages * kFStageFloats;

// Dynamic shared memory of one forward GEMM thread block: the fp32 plan's,
// or the bf16 GEMM's (wgmma_bf16.cuh, BF16_GEMM in the wrapper).
template <typename S>
constexpr int fwd_gemm_smem_bytes() {
  return IsBf16<S>::value ? wg::kSmemBytes : kFSmemBytes;
}
static_assert(kFBK % 8 == 0 && kFBM % kFWM == 0 && kFBN % kFWN == 0 &&
                  kFWM % 16 == 0 && kFWN % 16 == 0,
              "forward GEMM plan");

using wg::dgelu;  // exact GELU and its derivative, shared with the bf16 GEMM
using wg::gelu;

// (v - mu) inv s + b on four features of a row
__device__ __forceinline__ float4 ln_apply4(float4 v, float mu, float inv,
                                            float4 s, float4 b) {
  return make_float4((v.x - mu) * inv * s.x + b.x,
                     (v.y - mu) * inv * s.y + b.y,
                     (v.z - mu) * inv * s.z + b.z,
                     (v.w - mu) * inv * s.w + b.w);
}

// y = LN(x) over rows of D (a multiple of 4), one warp a row, with the
// row's mean and rsqrt(var + eps), var = max(mean(x^2) - mean^2, 0).
template <typename S>
__global__ void __launch_bounds__(kStatsThreads)
    ln_fwd_kernel(const S* __restrict__ x, const S* __restrict__ s,
                  const S* __restrict__ b, int M, int D,
                  float* __restrict__ mu, float* __restrict__ inv,
                  S* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kStatsThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const int d4 = D / 4;
  const size_t base = static_cast<size_t>(row) * D;
  const S* xr = x + base;
  float sum = 0.f, sq = 0.f;
  for (int k = lane; k < d4; k += 32) {
    const float4 v = ldg4(xr + 4 * k);
    sum += (v.x + v.y) + (v.z + v.w);
    sq += fmaf(v.x, v.x, v.y * v.y) + fmaf(v.z, v.z, v.w * v.w);
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float m = sum / D;
  const float iv = rsqrtf(fmaxf(sq / D - m * m, 0.f) + kEps);
  if (lane == 0) {
    mu[row] = m;
    inv[row] = iv;
  }
  S* yr = y + base;
  for (int k = lane; k < d4; k += 32)
    st4g(yr + 4 * k, ln_apply4(ldg4(xr + 4 * k), m, iv, ldg4(s + 4 * k),
                               ldg4(b + 4 * k)));
}

enum Epilogue { kBias, kGelu, kResidual };

template <typename S>
struct FwdGemm {
  const S* A;          // M x K, row-major
  const S* W;          // N x K (nn.Linear layout)
  const S* bias;       // N
  const S* R;          // M x N residual (kResidual)
  S* C;                // M x N
  S* H;                // kGelu: the pre-activation as well, if not null
  int M, N, K;
};

// C = epi(A W^T + bias). K a multiple of 8, N of 8, pointers 16-byte
// aligned.
template <int EPI>
__global__ void __launch_bounds__(kFThreads, kFMinBlocks)
    gemm_fwd_kernel(FwdGemm<float> g) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const int steps = (g.K + kFBK - 1) / kFBK;

  // one k-step's tiles into ring slot s: rows of kFBK floats in 16-byte
  // chunks, zeros past M, N or K
  auto load = [&](int s, int k0) {
    float* As = smem + s * kFStageFloats;
    float* Ws = As + kFBM * kFLd;
    constexpr int kChunks = kFBK / 4;
    for (int c = tid; c < (kFBM + kFBN) * kChunks; c += kFThreads) {
      const int r = c / kChunks, kc = (c % kChunks) * 4;
      const bool is_a = r < kFBM;
      const int row = is_a ? m0 + r : n0 + r - kFBM;
      const bool ok = row < (is_a ? g.M : g.N) && k0 + kc < g.K;
      const float* src = is_a ? g.A : g.W;
      cp_async16((is_a ? As + r * kFLd : Ws + (r - kFBM) * kFLd) + kc,
                 ok ? src + static_cast<size_t>(row) * g.K + k0 + kc : src,
                 ok);
    }
  };

  constexpr int kMT = kFWM / 16, kNT = kFWN / 8;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wm = (warp / (kFBN / kFWN)) * kFWM;
  const int wn = (warp % (kFBN / kFWN)) * kFWN;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < steps) load(s, s * kFBK);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // k-step `step` has landed; slot step - 1 is free
    const int next = step + kFStages - 1;
    if (next < steps) load(next % kFStages, next * kFBK);
    cp_async_commit();
    const float* As = smem + (step % kFStages) * kFStageFloats;
    const float* Ws = As + kFBM * kFLd;
#pragma unroll
    for (int ks = 0; ks < kFBK; ks += 8) {
      unsigned bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* w = Ws + (wn + j * 8 + gq) * kFLd + ks + tq;
        split_tf32(w[0], bb[j][0], bs[j][0]);
        split_tf32(w[4], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* a = As + (wm + i * 16 + gq) * kFLd + ks + tq;
        unsigned ab[4], as[4];
        split_tf32(a[0], ab[0], as[0]);
        split_tf32(a[8 * kFLd], ab[1], as[1]);
        split_tf32(a[4], ab[2], as[2]);
        split_tf32(a[8 * kFLd + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + gq + 8 * h;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + wn + j * 8 + 2 * tq;  // and n + 1 (N is even)
        if (n >= g.N) continue;
        const float2 bv = __ldg(reinterpret_cast<const float2*>(g.bias + n));
        float2 v = make_float2(acc[i][j][2 * h] + bv.x,
                               acc[i][j][2 * h + 1] + bv.y);
        const size_t at = static_cast<size_t>(m) * g.N + n;
        if (EPI == kGelu) {
          if (g.H != nullptr) *reinterpret_cast<float2*>(g.H + at) = v;
          v = make_float2(gelu(v.x), gelu(v.y));
        } else if (EPI == kResidual) {
          const float2 r = __ldg(reinterpret_cast<const float2*>(g.R + at));
          v = make_float2(r.x + v.x, r.y + v.y);
        }
        *reinterpret_cast<float2*>(g.C + at) = v;
      }
    }
}

template <int EPI, typename S>
cudaError_t gemm_fwd(const FwdGemm<S>& g, cudaStream_t stream) {
  if constexpr (IsBf16<S>::value) {
    constexpr int epi = EPI == kBias ? wg::kBias
                        : EPI == kGelu ? wg::kGelu
                                       : wg::kResidual;
    return wg::gemm<false, false, epi>(
        g.A, g.W,
        wg::Epi<bf16>{g.C, g.bias, g.R, g.H, nullptr, nullptr, g.M, g.N, g.K,
                      g.K},
        1, stream);
  } else {
    constexpr int bytes = fwd_gemm_smem_bytes<S>();
    cudaError_t err = cudaFuncSetAttribute(
        gemm_fwd_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((g.N + kFBN - 1) / kFBN, (g.M + kFBM - 1) / kFBM);
    gemm_fwd_kernel<EPI><<<grid, kFThreads, bytes, stream>>>(g);
    return cudaGetLastError();
  }
}

// One thread block per (window, head). qkv: (N*T) x 3D rows [q | k | v],
// heads in (head, dim) order -> o: (N*T) x D. Dynamic shared memory: q, k,
// v (T x hd each) and p (T x T), attn_fwd_bytes.
template <typename S>
__global__ void __launch_bounds__(kAttnThreads)
    attention_kernel(const S* __restrict__ qkv, S* __restrict__ o,
                     int T, int D, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = D / H;
  float *q = smem, *k = q + T * hd, *v = k + T * hd, *p = v + T * hd;
  const S* base = qkv + static_cast<size_t>(n) * T * 3 * D + h * hd;
  for (int idx = threadIdx.x; idx < T * hd; idx += kAttnThreads) {
    const int t = idx / hd, c = idx % hd;
    const S* row = base + static_cast<size_t>(t) * 3 * D + c;
    q[idx] = ldg1(row) * scale;
    k[idx] = ldg1(row + D);
    v[idx] = ldg1(row + 2 * D);
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
  S* dst = o + static_cast<size_t>(n) * T * D + h * hd;
  for (int idx = threadIdx.x; idx < T * hd; idx += kAttnThreads) {
    const int i = idx / hd, c = idx % hd;
    float acc = 0.f;
    for (int j = 0; j < T; ++j) acc = fmaf(p[i * T + j], v[j * hd + c], acc);
    put(dst + static_cast<size_t>(i) * D + c, acc);
  }
}

int attn_fwd_bytes(int T, int hd) {
  return static_cast<int>(sizeof(float) * (3 * T * hd + T * T));
}

int attn_bwd_bytes(int T, int hd) {
  return static_cast<int>(sizeof(float) * (4 * T * hd + 2 * T * T));
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
// block sees 73,728 tokens x 22,211,072 FLOP = 1,637.6 GFLOP. The products
// run in the tensor cores as 3xTF32 (below): three TF32 products for each
// fp32 one, so the bound is 1,637.6 GFLOP at 495 / 3 TFLOP/s, 9.92 ms (at
// the 67 TFLOP/s fp32 peak of the CUDA cores it would be 24.44 ms).
//
// Design. The forward keeps, when a gradient is needed, its LayerNorm row
// statistics, qkv, the attention output, x2, the pre-GELU hidden h and
// gelu(h) (about 2.2 GB a block at B=1024; the TPU kernel recomputes them
// from x and x2 in VMEM instead). The backward is a fixed sequence of 13
// launches on the caller's stream, in the TPU kernel's order (the MLP half,
// then the attention half):
//   y1 = LN1(x), y2 = LN2(x2) (one launch);
//   dh = (du W2) * GELU'(h), dW2 = du^T gelu(h), dy2 = dh W1,
//   dW1 = dh^T y2, dx2 = du + LN2'(dy2); do = dx2 Wp, dWp = dx2^T o,
//   attention backward -> dqkv, dy1 = dqkv Wqkv, dWqkv = dqkv^T y1,
//   dx = dx2 + LN1'(dy1); then one launch sums every split part.
// An earlier design (29 launches: an fp32 128 x 128 x 8 GEMM on the CUDA
// cores with a register prefetch and two barriers a k-step, split-K dW
// with separate column-sum and reduce launches) took 63.4 ms a block, 2.6x
// its fp32 bound; the same launches with the fp32 GEMM below took 46.7 ms.
// Here every product is one GEMM template: 128 x 128 output tiles, k-steps
// of 16 through a 3-stage cp.async ring in shared memory (54 KB: two
// thread blocks an SM), so that the loads of k-step s + 2 fly while k-step
// s is multiplied, with one barrier a k-step; 8 warps, each a 64 x 32 tile
// of mma.sync m16n8k8 TF32 products. Each fp32 operand is split into a TF32
// value and a TF32 remainder, and a b = a_small b_big + a_big b_small +
// a_big b_big (3xTF32), which keeps fp32's accuracy: the three products of
// each 8-deep step are summed in the tensor cores (which round towards
// zero) and then added to the running fp32 sum with round-to-nearest, so
// that the tensor cores' rounding does not grow with K. dX = dY W reads
// dY's tile row-major and W as stored; dW = dY^T X reads both k-major (rows
// padded by 8 floats: the fragment reads hit 32 banks). The bias gradients
// are the column sums of dY: the dW products multiply dY^T by X with a
// column of ones appended (written into the ring beside the copies), so the
// sums come out of the same tiles. GELU' is the dh product's epilogue; the
// LayerNorm backward launches carry the LayerNorm vectors' column sums (a
// warp per row, each warp's sums in its own row of shared memory). The dW
// products split the rows into the fewest parts that fill the card's waves
// to 90 % (two thread blocks an SM); each split writes its own part, and
// the last launch sums the parts in a fixed order. No atomics: two backward
// calls give the same bits. Attention backward, one thread block per
// (window, head): the probabilities recomputed from qkv, ds = p (dp - sum_j
// dp p), dq scaled by hd^-0.5; T x T scores in dynamic shared memory, T <=
// 81. In bf16 the eight products are the bf16 GEMM of wgmma_bf16.cuh
// instead: dX = dY W reads dY K-major and W (K x N) MN-major, dW = dY^T X
// reads both MN-major, from the same TMA tiles; the bias gradients are dY's
// column sums, taken from its tiles in shared memory by the first column
// tile's consumers (no column of ones); the dW parts are multiples of that
// GEMM's 64-row k-step. The earlier bf16 design (this file's GEMM on bf16
// tiles widened to TF32, one mma.sync pass a product) took 15.04 ms at
// B=1024.

constexpr int kBK2 = 16;               // k-step of the backward GEMM
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kLdRow = kBK2 + 4;       // row-major A tile: row stride
constexpr int kLdCol = kBN + 8;        // k-major tiles: row stride
constexpr int kLnThreads = 256;

enum BwdMode { kNN, kTN };
enum BwdEpilogue { kSet, kDGelu };

// S: the operands' storage type; O: C's (float32, or S for dh).
template <typename S, typename O>
struct Gemm {
  const S* A;      // kNN: M x K (row-major); kTN: K x M
  const S* B;      // K x N
  O* C;            // M x N; kTN: one M x N part per split
  float* bias;     // kTN: one part of M column sums of A per split, or null
  const S* aux;    // kDGelu: the pre-activation, M x N
  int M, N, K;
  int k_split;     // kTN: rows of K per split (blockIdx.z)
};

// Floats of a ring stage (an A and a B tile).
__host__ __device__ inline int gemm_stage_floats(int mode) {
  return (mode == kNN ? kBM * kLdRow : kBK2 * kLdCol) + kBK2 * kLdCol;
}

// kNN: C = epi(A B); kTN: C[split] = A^T B over the split's rows of K, and
// with bias, bias[split] = the column sums of A over them (B's column N
// read as ones). M, N multiples of 4, K (kNN) a multiple of 4, pointers
// 16-byte aligned. S = float: bf16 operands go to the bf16 GEMM
// (wgmma_bf16.cuh) instead.
template <int MODE, int EPI, typename S, typename O>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_bwd_kernel(Gemm<S, O> g) {
  extern __shared__ __align__(16) float smem_f[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = MODE == kTN ? blockIdx.z * g.k_split : 0;
  const int kend = MODE == kTN ? min(g.K, kbeg + g.k_split) : g.K;
  const int steps = (kend - kbeg + kBK2 - 1) / kBK2;
  const int a_floats = MODE == kNN ? kBM * kLdRow : kBK2 * kLdCol;
  const int stage = a_floats + kBK2 * kLdCol;
  const bool ones = MODE == kTN && g.bias != nullptr && n0 <= g.N &&
                    g.N < n0 + kBN;
  // one k-step's tiles into ring slot s: 512 16-byte chunks each of A and
  // B, 2 a thread
  auto load = [&](int s, int k0) {
    float* As = smem_f + s * stage;
    float* Bs = As + a_floats;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;
      if (MODE == kNN) {
        const int r = c >> 2, kc = (c & 3) * 4;
        const bool ok = m0 + r < g.M && k0 + kc < kend;
        cp_async16(As + r * kLdRow + kc,
                   reinterpret_cast<const float*>(
                       ok ? g.A + static_cast<size_t>(m0 + r) * g.K + k0 + kc
                          : g.A),
                   ok);
      } else {
        const int r = c >> 5, col = (c & 31) * 4;
        const bool ok = k0 + r < kend && m0 + col < g.M;
        cp_async16(As + r * kLdCol + col,
                   reinterpret_cast<const float*>(
                       ok ? g.A + static_cast<size_t>(k0 + r) * g.M + m0 + col
                          : g.A),
                   ok);
      }
      const int r = c >> 5, col = (c & 31) * 4;
      float* dst = Bs + r * kLdCol + col;
      if (ones && n0 + col == g.N) {
        dst[0] = k0 + r < kend ? 1.f : 0.f;
        dst[1] = dst[2] = dst[3] = 0.f;
      } else {
        const bool ok = k0 + r < kend && n0 + col < g.N;
        cp_async16(dst,
                   reinterpret_cast<const float*>(
                       ok ? g.B + static_cast<size_t>(k0 + r) * g.N + n0 + col
                          : g.B),
                   ok);
      }
    }
  };

  // 8 warps as 2 (rows) x 4 (columns), each a 64 x 32 tile of 4 x 4
  // mma tiles of 16 x 8
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, kbeg + s * kBK2);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // k-step `step` has landed; slot step - 1 is free
    const int next = step + kStages - 1;
    if (next < steps) load(next % kStages, kbeg + next * kBK2);
    cp_async_commit();
    const float* As = smem_f + (step % kStages) * stage;
    const float* Bs = As + a_floats;
#pragma unroll
    for (int ks = 0; ks < kBK2; ks += 8) {
      unsigned bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + gq;
        split_tf32(Bs[(ks + tq) * kLdCol + n], bb[j][0], bs[j][0]);
        split_tf32(Bs[(ks + tq + 4) * kLdCol + n], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + i * 16 + gq;
        float a[4];
        if (MODE == kNN) {
          a[0] = As[m * kLdRow + ks + tq];
          a[1] = As[(m + 8) * kLdRow + ks + tq];
          a[2] = As[m * kLdRow + ks + tq + 4];
          a[3] = As[(m + 8) * kLdRow + ks + tq + 4];
        } else {
          a[0] = As[(ks + tq) * kLdCol + m];
          a[1] = As[(ks + tq) * kLdCol + m + 8];
          a[2] = As[(ks + tq + 4) * kLdCol + m];
          a[3] = As[(ks + tq + 4) * kLdCol + m + 8];
        }
        unsigned ab[4], as[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(a[c], ab[c], as[c]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the three products of this k-step summed in the tensor cores
          // (the small ones first), then added to the running sum in fp32
          // with round-to-nearest: the tensor cores round their sums
          // towards zero, an error that would grow with K if the running
          // sum went through them
          mma_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  O* C = g.C;
  if (MODE == kTN) C += static_cast<size_t>(blockIdx.z) * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + gq + 8 * h;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * tq;  // and n + 1 (N is even)
        float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        if (n >= g.N) {
          if (ones && n == g.N)
            g.bias[static_cast<size_t>(blockIdx.z) * g.M + m] = v.x;
          continue;
        }
        const size_t at = static_cast<size_t>(m) * g.N + n;
        if (EPI == kDGelu) {
          const float2 p = ldg2(g.aux + at);
          v = make_float2(v.x * dgelu(p.x), v.y * dgelu(p.y));
        }
        st2g(C + at, v);
      }
    }
}

template <int MODE, int EPI, typename S, typename O>
cudaError_t gemm_bwd(const Gemm<S, O>& g, int splits, cudaStream_t stream) {
  if constexpr (IsBf16<S>::value) {
    // dX = dY W: dY K-major, W (K x N) MN-major; dW = dY^T X: both
    // MN-major, the bias gradients from dY's tiles
    return wg::gemm<MODE == kTN, true, EPI == kDGelu ? wg::kDGelu
                                                     : wg::kPlain>(
        g.A, g.B,
        wg::Epi<O>{g.C, nullptr, nullptr, nullptr, g.aux, g.bias, g.M, g.N,
                   g.K, MODE == kTN ? g.k_split : g.K},
        splits, stream);
  } else {
    const int bytes = static_cast<int>(sizeof(float) * kStages *
                                       gemm_stage_floats(MODE));
    cudaError_t err = cudaFuncSetAttribute(
        gemm_bwd_kernel<MODE, EPI, S, O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int cols = g.N + (MODE == kTN && g.bias != nullptr ? 1 : 0);
    const dim3 grid((cols + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, splits);
    gemm_bwd_kernel<MODE, EPI, S, O><<<grid, kGemmThreads, bytes, stream>>>(
        g);
    return cudaGetLastError();
  }
}

// y1 = LN1(x), y2 = LN2(x2) (blockIdx.y selects) with the forward's
// statistics; M x D each, D a multiple of 4.
template <typename S>
struct LnApply {
  const S* x;
  const float *mu, *inv;
  const S *s, *b;
  S* y;
};

template <typename S>
__global__ void ln_apply_kernel(LnApply<S> p0, LnApply<S> p1, int M, int D) {
  const LnApply<S>& p = blockIdx.y == 0 ? p0 : p1;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int d4 = D / 4;
  if (i >= static_cast<size_t>(M) * d4) return;
  const int r = static_cast<int>(i / d4), c = static_cast<int>(i % d4) * 4;
  const float4 v = ldg4(p.x + 4 * i);
  const float4 s = ldg4(p.s + c);
  const float4 b = ldg4(p.b + c);
  st4g(p.y + 4 * i, ln_apply4(v, p.mu[r], p.inv[r], s, b));
}

// LayerNorm backward, one warp per row (rows warp + k x (warps of the
// grid)); D a multiple of 4. With xh = (x - mu) inv and dxh = dy s,
// out = res + inv (dxh - mean(dxh) - xh mean(dxh xh)); the thread block's
// sums of dy xh and dy per column go to part[blockIdx.x] (2D floats), each
// warp gathering its rows' in its own row of shared memory (kWarps x 2D).
template <typename S>
__global__ void __launch_bounds__(kLnThreads)
    ln_bwd_rows_kernel(const float* __restrict__ dy,
                       const S* __restrict__ x,
                       const float* __restrict__ mu,
                       const float* __restrict__ inv,
                       const S* __restrict__ s,
                       const S* __restrict__ res, S* __restrict__ out,
                       float* __restrict__ part, int M, int D) {
  extern __shared__ __align__(16) float red[];
  constexpr int kWarps = kLnThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d4 = D / 4;
  float4* mine = reinterpret_cast<float4*>(red + warp * 2 * D);
  for (int c = lane; c < 2 * d4; c += 32)
    mine[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int row = blockIdx.x * kWarps + warp; row < M;
       row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * D;
    const float* dp = dy + base;
    const S* xp = x + base;
    const float m = mu[row], iv = inv[row];
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < d4; k += 32) {
      const float4 d = ldg4(dp + 4 * k), v = ldg4(xp + 4 * k),
                   sc = ldg4(s + 4 * k);
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
    const float m1 = s1 / D, m2 = s2 / D;
    const S* rp = res + base;
    S* op = out + base;
    for (int k = lane; k < d4; k += 32) {
      const float4 d = ldg4(dp + 4 * k), v = ldg4(xp + 4 * k),
                   sc = ldg4(s + 4 * k), r = ldg4(rp + 4 * k);
      const float4 xh = make_float4((v.x - m) * iv, (v.y - m) * iv,
                                    (v.z - m) * iv, (v.w - m) * iv);
      st4g(op + 4 * k,
           make_float4(r.x + iv * (d.x * sc.x - m1 - xh.x * m2),
                       r.y + iv * (d.y * sc.y - m1 - xh.y * m2),
                       r.z + iv * (d.z * sc.z - m1 - xh.z * m2),
                       r.w + iv * (d.w * sc.w - m1 - xh.w * m2)));
      float4 a = mine[k];
      mine[k] = make_float4(fmaf(d.x, xh.x, a.x), fmaf(d.y, xh.y, a.y),
                            fmaf(d.z, xh.z, a.z), fmaf(d.w, xh.w, a.w));
      a = mine[d4 + k];
      mine[d4 + k] = make_float4(a.x + d.x, a.y + d.y, a.z + d.z, a.w + d.w);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += kLnThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[w * 2 * D + c];
    part[static_cast<size_t>(blockIdx.x) * 2 * D + c] = v;
  }
}

// Attention backward, one thread block per (window, head): qkv rows [q | k
// | v] and do (N*T) x D -> dqkv (N*T) x 3D, the probabilities recomputed as
// attention_kernel computes them. Dynamic shared memory: q, k, v, do (T x
// hd each), p and ds (T x T), attn_bwd_bytes.
template <typename S>
__global__ void __launch_bounds__(kAttnThreads)
    attention_bwd_kernel(const S* __restrict__ qkv,
                         const float* __restrict__ dout,
                         S* __restrict__ dqkv, int T, int D, int H,
                         float scale) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = D / H;
  float *q = smem, *k = q + T * hd, *v = k + T * hd, *dov = v + T * hd,
        *p = dov + T * hd, *ds = p + T * T;
  const S* base = qkv + static_cast<size_t>(n) * T * 3 * D + h * hd;
  const float* dbase = dout + static_cast<size_t>(n) * T * D + h * hd;
  for (int idx = threadIdx.x; idx < T * hd; idx += kAttnThreads) {
    const int t = idx / hd, c = idx % hd;
    const S* row = base + static_cast<size_t>(t) * 3 * D + c;
    q[idx] = ldg1(row) * scale;
    k[idx] = ldg1(row + D);
    v[idx] = ldg1(row + 2 * D);
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
  S* dst = dqkv + static_cast<size_t>(n) * T * 3 * D + h * hd;
  for (int idx = threadIdx.x; idx < T * hd; idx += kAttnThreads) {
    const int i = idx / hd, c = idx % hd;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int j = 0; j < T; ++j) {
      dq = fmaf(ds[i * T + j], k[j * hd + c], dq);
      dk = fmaf(ds[j * T + i], q[j * hd + c], dk);
      dv = fmaf(p[j * T + i], dov[j * hd + c], dv);
    }
    S* row = dst + static_cast<size_t>(i) * 3 * D + c;
    put(row, dq * scale);
    put(row + D, dk);
    put(row + 2 * D, dv);
  }
}

// out[e] = sum over p < parts, in order, of part[p stride + e], e < len,
// for each segment (blockIdx.y).
template <typename S>
struct Segment {
  const float* part;
  S* out;
  int parts, len, stride;
};
constexpr int kMaxSegments = 12;
template <typename S>
struct Segments {
  Segment<S> s[kMaxSegments];
};

template <typename S>
__global__ void reduce_segments_kernel(Segments<S> segs) {
  const Segment<S>& sg = segs.s[blockIdx.y];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= sg.len) return;
  float v = 0.f;
  for (int p = 0; p < sg.parts; ++p)
    v += sg.part[static_cast<size_t>(p) * sg.stride + e];
  put(sg.out + e, v);
}

// How a weight gradient of rows x cols over K summed rows is split: the
// fewest parts (at least 1024 rows each) whose thread blocks fill the card's
// waves (two thread blocks an SM) to 90 % or more, else the count that
// fills them best, so that the last wave is not left mostly empty. float32:
// the tiles of rows x (cols + a bias column), parts a multiple of the
// k-step kBK2; bf16: the tiles of rows x cols (the bias from dY's tiles),
// parts a multiple of the bf16 GEMM's k-step, which TMA loads whole.
void split_k(int rows, int cols, int K, int sms, bool bf, int* splits,
             int* k_split) {
  const int tiles = ((rows + kBM - 1) / kBM) *
                    ((cols + (bf ? 0 : 1) + kBN - 1) / kBN);
  const int granule = bf ? wg::kBK : kBK2;
  const int slots = 2 * sms;
  const int most = K / (kBK2 * 64) > 1 ? K / (kBK2 * 64) : 1;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= most; ++s) {
    const int blocks = tiles * s;
    const double fill = static_cast<double>(blocks) /
                        (static_cast<double>((blocks + slots - 1) / slots) *
                         slots);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = s;
    }
    if (fill >= 0.9) break;
  }
  *k_split = (((K + best - 1) / best) + granule - 1) / granule * granule;
  *splits = (K + *k_split - 1) / *k_split;
}

// Thread blocks of the LayerNorm backward launches (their partial rows).
int ln_grid(int sms) { return 2 * sms; }

// The backward's `part` scratch for M rows, in floats: each weight
// gradient's split parts and bias parts, then the two LayerNorm launches'
// partial rows. shapes[i] = (rows, cols) of dW2, dW1, dWp, dWqkv.
int part_floats(int M, int D, int hidden, int sms, bool bf) {
  const int shapes[4][2] = {{D, hidden}, {hidden, D}, {D, D}, {3 * D, D}};
  long total = 2L * ln_grid(sms) * 2 * D;
  for (const auto& rc : shapes) {
    int splits, k_split;
    split_k(rc[0], rc[1], M, sms, bf, &splits, &k_split);
    total += static_cast<long>(splits) * rc[0] * (rc[1] + 1);
  }
  return static_cast<int>(total);
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

bool valid(int n, int T, int D, int H, int hidden) {
  return T >= 1 && T <= kMaxT && D >= 8 && D % 8 == 0 && hidden >= 8 &&
         hidden % 8 == 0 && H >= 1 && D % H == 0 && D / H <= kMaxHd &&
         attn_bwd_bytes(T, D / H) <= kMaxSmem &&
         (n * T + kBM - 1) / kBM <= 65535;
}

template <typename S>
int launch_block(const S* x, S* out, const S* ln1_s, const S* ln1_b,
                 const S* qkv_w, const S* qkv_b, const S* proj_w,
                 const S* proj_b, const S* ln2_s, const S* ln2_b,
                 const S* fc1_w, const S* fc1_b, const S* fc2_w,
                 const S* fc2_b, float* stats, S* qkv, S* attn, S* x2, S* mlp,
                 S* h, int n, int T, int D, int H, int hidden, float scale,
                 cudaStream_t stream) {
  const int M = n * T;
  if (M <= 0) return 0;
  if (!valid(n, T, D, H, hidden) || out == x)
    return static_cast<int>(cudaErrorInvalidValue);
  float *mu1 = stats, *inv1 = stats + M, *mu2 = stats + 2 * M,
        *inv2 = stats + 3 * M;
  S* y = out;  // y1, then y2: each dead before the next is written
  const int ln_blocks = (M + kStatsThreads / 32 - 1) / (kStatsThreads / 32);
  const int attn_bytes = attn_fwd_bytes(T, D / H);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      attn_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
#define PV2C_STEP(call) \
  if (err == cudaSuccess) err = (call)

  ln_fwd_kernel<S><<<ln_blocks, kStatsThreads, 0, stream>>>(
      x, ln1_s, ln1_b, M, D, mu1, inv1, y);
  err = cudaGetLastError();
  PV2C_STEP(gemm_fwd<kBias>(
      FwdGemm<S>{y, qkv_w, qkv_b, nullptr, qkv, nullptr, M, 3 * D, D},
      stream));
  if (err == cudaSuccess) {
    attention_kernel<S><<<n * H, kAttnThreads, attn_bytes, stream>>>(
        qkv, attn, T, D, H, scale);
    err = cudaGetLastError();
  }
  PV2C_STEP(gemm_fwd<kResidual>(
      FwdGemm<S>{attn, proj_w, proj_b, x, x2, nullptr, M, D, D}, stream));
  if (err == cudaSuccess) {
    ln_fwd_kernel<S><<<ln_blocks, kStatsThreads, 0, stream>>>(
        x2, ln2_s, ln2_b, M, D, mu2, inv2, y);
    err = cudaGetLastError();
  }
  PV2C_STEP(gemm_fwd<kGelu>(
      FwdGemm<S>{y, fc1_w, fc1_b, nullptr, mlp, h, M, hidden, D}, stream));
  PV2C_STEP(gemm_fwd<kResidual>(
      FwdGemm<S>{mlp, fc2_w, fc2_b, x2, out, nullptr, M, D, hidden},
      stream));
#undef PV2C_STEP
  return static_cast<int>(err);
}

template <typename S>
int launch_block_bwd(const S* x, const S* ln1_s, const S* ln1_b,
                     const S* qkv_w, const S* proj_w, const S* ln2_s,
                     const S* ln2_b, const S* fc1_w, const S* fc2_w,
                     const float* stats, const S* qkv, const S* attn,
                     const S* x2, const S* h, const S* mlp, const S* g, S* dx,
                     S* grads, S* dh, float* dy, S* dx2, S* dqkv, S* y1,
                     S* y2, float* part, int n, int T, int D, int H,
                     int hidden, float scale, cudaStream_t stream) {
  const int M = n * T, G = hidden;
  if (M <= 0) return 0;
  if (!valid(n, T, D, H, hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  const float *mu1 = stats, *inv1 = stats + M, *mu2 = stats + 2 * M,
              *inv2 = stats + 3 * M;
  // the gradients' offsets in grads, in the weights' order
  S* g_ln1_s = grads;
  S* g_ln1_b = g_ln1_s + D;
  S* g_qkv_w = g_ln1_b + D;
  S* g_qkv_b = g_qkv_w + 3 * D * D;
  S* g_proj_w = g_qkv_b + 3 * D;
  S* g_proj_b = g_proj_w + D * D;
  S* g_ln2_s = g_proj_b + D;
  S* g_ln2_b = g_ln2_s + D;
  S* g_fc1_w = g_ln2_b + D;
  S* g_fc1_b = g_fc1_w + G * D;
  S* g_fc2_w = g_fc1_b + G;
  S* g_fc2_b = g_fc2_w + D * G;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lg = ln_grid(sms);

  // part: each dW's split parts and bias parts, then the LayerNorm parts
  Segments<S> segs{};
  int nseg = 0;
  float* free_part = part;
  struct WGrad {
    float *w, *b;
    int splits, k_split;
  };
  auto wgrad = [&](int rows, int cols, S* out_w, S* out_b) {
    WGrad r;
    split_k(rows, cols, M, sms, IsBf16<S>::value, &r.splits,
            &r.k_split);
    r.w = free_part;
    r.b = r.w + static_cast<size_t>(r.splits) * rows * cols;
    free_part = r.b + static_cast<size_t>(r.splits) * rows;
    segs.s[nseg++] =
        Segment<S>{r.w, out_w, r.splits, rows * cols, rows * cols};
    segs.s[nseg++] = Segment<S>{r.b, out_b, r.splits, rows, rows};
    return r;
  };
  const WGrad w2 = wgrad(D, G, g_fc2_w, g_fc2_b);
  const WGrad w1 = wgrad(G, D, g_fc1_w, g_fc1_b);
  const WGrad wp = wgrad(D, D, g_proj_w, g_proj_b);
  const WGrad wq = wgrad(3 * D, D, g_qkv_w, g_qkv_b);
  float* ln2_part = free_part;
  float* ln1_part = ln2_part + static_cast<size_t>(lg) * 2 * D;
  segs.s[nseg++] = Segment<S>{ln2_part, g_ln2_s, lg, D, 2 * D};
  segs.s[nseg++] = Segment<S>{ln2_part + D, g_ln2_b, lg, D, 2 * D};
  segs.s[nseg++] = Segment<S>{ln1_part, g_ln1_s, lg, D, 2 * D};
  segs.s[nseg++] = Segment<S>{ln1_part + D, g_ln1_b, lg, D, 2 * D};

  const int ln_bytes = static_cast<int>(sizeof(float) * (kLnThreads / 32) *
                                        2 * D);
  const int abytes = attn_bwd_bytes(T, D / H);
  err = cudaFuncSetAttribute(ln_bwd_rows_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ln_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               abytes);
  if (err != cudaSuccess) return static_cast<int>(err);
#define PV2C_STEP(call) \
  if (err == cudaSuccess) err = (call)

  // the LayerNorms' outputs, the dW1 and dWqkv products' X
  const int apply_blocks = (M * (D / 4) + 255) / 256;
  if (err == cudaSuccess) {
    ln_apply_kernel<S><<<dim3(apply_blocks, 2), 256, 0, stream>>>(
        LnApply<S>{x, mu1, inv1, ln1_s, ln1_b, y1},
        LnApply<S>{x2, mu2, inv2, ln2_s, ln2_b, y2}, M, D);
    err = cudaGetLastError();
  }
  // MLP half: du = g
  PV2C_STEP((gemm_bwd<kNN, kDGelu>(
      Gemm<S, S>{g, fc2_w, dh, nullptr, h, M, G, D, 0}, 1, stream)));
  PV2C_STEP((gemm_bwd<kTN, kSet>(
      Gemm<S, float>{g, mlp, w2.w, w2.b, nullptr, D, G, M, w2.k_split},
      w2.splits, stream)));
  PV2C_STEP((gemm_bwd<kNN, kSet>(
      Gemm<S, float>{dh, fc1_w, dy, nullptr, nullptr, M, D, G, 0}, 1,
      stream)));
  PV2C_STEP((gemm_bwd<kTN, kSet>(
      Gemm<S, float>{dh, y2, w1.w, w1.b, nullptr, G, D, M, w1.k_split},
      w1.splits, stream)));
  if (err == cudaSuccess) {
    ln_bwd_rows_kernel<S><<<lg, kLnThreads, ln_bytes, stream>>>(
        dy, x2, mu2, inv2, ln2_s, g, dx2, ln2_part, M, D);
    err = cudaGetLastError();
  }
  // attention half: da = dx2
  PV2C_STEP((gemm_bwd<kNN, kSet>(
      Gemm<S, float>{dx2, proj_w, dy, nullptr, nullptr, M, D, D, 0}, 1,
      stream)));
  PV2C_STEP((gemm_bwd<kTN, kSet>(
      Gemm<S, float>{dx2, attn, wp.w, wp.b, nullptr, D, D, M, wp.k_split},
      wp.splits, stream)));
  if (err == cudaSuccess) {
    attention_bwd_kernel<S><<<n * H, kAttnThreads, abytes, stream>>>(
        qkv, dy, dqkv, T, D, H, scale);
    err = cudaGetLastError();
  }
  PV2C_STEP((gemm_bwd<kNN, kSet>(
      Gemm<S, float>{dqkv, qkv_w, dy, nullptr, nullptr, M, D, 3 * D, 0}, 1,
      stream)));
  PV2C_STEP((gemm_bwd<kTN, kSet>(
      Gemm<S, float>{dqkv, y1, wq.w, wq.b, nullptr, 3 * D, D, M, wq.k_split},
      wq.splits, stream)));
  if (err == cudaSuccess) {
    ln_bwd_rows_kernel<S><<<lg, kLnThreads, ln_bytes, stream>>>(
        dy, x, mu1, inv1, ln1_s, dx2, dx, ln1_part, M, D);
    err = cudaGetLastError();
  }
  // every part, summed in order
  int longest = 0;
  for (int i = 0; i < nseg; ++i)
    longest = segs.s[i].len > longest ? segs.s[i].len : longest;
  if (err == cudaSuccess) {
    reduce_segments_kernel<S><<<dim3((longest + 255) / 256, nseg), 256, 0,
                                stream>>>(segs);
    err = cudaGetLastError();
  }
#undef PV2C_STEP
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// One block on x (n, T, D) -> out (n, T, D), float32 contiguous, out not
// x. Weights in nn.Linear layout: qkv_w (3D, D), proj_w (D, D), fc1_w
// (hidden, D), fc2_w (D, hidden). Scratch: stats (4 n T), qkv (n T, 3D),
// attn (n T, D), x2 (n T, D), mlp (n T, hidden), and h (n T, hidden), the
// pre-GELU hidden, which only training keeps (nullptr: not written); out
// holds the LayerNorms' outputs until the last launch. Requires T <= 81, D
// and hidden multiples of 8, D / H <= 128, the attention backward's T x T
// and 4 T x D / H floats within one thread block's shared memory, and
// 16-byte aligned pointers. Launches seven kernels on `stream`; returns the
// first CUDA error, or 0.
int pv2c_fused_temporal_block(
    const float* x, float* out, const float* ln1_s, const float* ln1_b,
    const float* qkv_w, const float* qkv_b, const float* proj_w,
    const float* proj_b, const float* ln2_s, const float* ln2_b,
    const float* fc1_w, const float* fc1_b, const float* fc2_w,
    const float* fc2_b, float* stats, float* qkv, float* attn, float* x2,
    float* mlp, float* h, int n, int T, int D, int H, int hidden, float scale,
    cudaStream_t stream) {
  return launch_block<float>(x, out, ln1_s, ln1_b, qkv_w, qkv_b, proj_w,
                             proj_b, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w,
                             fc2_b, stats, qkv, attn, x2, mlp, h, n, T, D, H,
                             hidden, scale, stream);
}

// The same in bf16: x, out, the weights and the scratch but stats bf16;
// the products on the bf16 tensor cores (wgmma_bf16.cuh). Also requires a
// CUDA driver with cuTensorMapEncodeTiled (12.0 or later).
int pv2c_fused_temporal_block_bf16(
    const bf16* x, bf16* out, const bf16* ln1_s, const bf16* ln1_b,
    const bf16* qkv_w, const bf16* qkv_b, const bf16* proj_w,
    const bf16* proj_b, const bf16* ln2_s, const bf16* ln2_b,
    const bf16* fc1_w, const bf16* fc1_b, const bf16* fc2_w,
    const bf16* fc2_b, float* stats, bf16* qkv, bf16* attn, bf16* x2,
    bf16* mlp, bf16* h, int n, int T, int D, int H, int hidden, float scale,
    cudaStream_t stream) {
  return launch_block<bf16>(x, out, ln1_s, ln1_b, qkv_w, qkv_b, proj_w,
                            proj_b, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b,
                            stats, qkv, attn, x2, mlp, h, n, T, D, H, hidden,
                            scale, stream);
}

// Shared memory of one forward GEMM thread block, in bytes, for elements
// of element_size bytes (4: float32, 2: bf16); the wrapper's copy of the
// plan is checked against it.
int pv2c_temporal_fwd_gemm_smem_bytes(int element_size) {
  return element_size == 2 ? fwd_gemm_smem_bytes<bf16>()
                           : fwd_gemm_smem_bytes<float>();
}

// Floats of the backward's `part` scratch (below), on the current device,
// for elements of element_size bytes (4: float32, 2: bf16). Returns minus
// a CUDA error code on failure.
int pv2c_temporal_block_bwd_part_floats(int n, int T, int D, int hidden,
                                        int element_size) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return part_floats(n * T, D, hidden, sms, element_size == 2);
}

// The backward of pv2c_fused_temporal_block on its input x, its weights,
// the scratch it filled (stats, qkv, attn, x2, h, mlp; h written) and the
// output's cotangent g: dx (n, T, D) and grads, the 12 weight gradients
// flat, each in its weight's layout, in the weights' order. Scratch: dh
// (n T, hidden), dy, dx2, y1, y2 (n T, D each), dqkv (n T, 3D) and part
// (pv2c_temporal_block_bwd_part_floats). Requirements as the forward's.
// Launches 13 kernels on `stream`; returns the first CUDA error, or 0.
int pv2c_fused_temporal_block_bwd(
    const float* x, const float* ln1_s, const float* ln1_b,
    const float* qkv_w, const float* qkv_b, const float* proj_w,
    const float* proj_b, const float* ln2_s, const float* ln2_b,
    const float* fc1_w, const float* fc1_b, const float* fc2_w,
    const float* fc2_b, const float* stats, const float* qkv,
    const float* attn, const float* x2, const float* h, const float* mlp,
    const float* g, float* dx, float* grads, float* dh, float* dy,
    float* dx2, float* dqkv, float* y1, float* y2, float* part, int n, int T,
    int D, int H, int hidden, float scale, cudaStream_t stream) {
  (void)qkv_b;
  (void)proj_b;
  (void)fc1_b;
  (void)fc2_b;
  return launch_block_bwd<float>(
      x, ln1_s, ln1_b, qkv_w, proj_w, ln2_s, ln2_b, fc1_w, fc2_w, stats, qkv,
      attn, x2, h, mlp, g, dx, grads, dh, dy, dx2, dqkv, y1, y2, part, n, T,
      D, H, hidden, scale, stream);
}

// The same in bf16: every tensor bf16 but stats, dy and part (float32);
// the products on the bf16 tensor cores (wgmma_bf16.cuh).
int pv2c_fused_temporal_block_bwd_bf16(
    const bf16* x, const bf16* ln1_s, const bf16* ln1_b, const bf16* qkv_w,
    const bf16* qkv_b, const bf16* proj_w, const bf16* proj_b,
    const bf16* ln2_s, const bf16* ln2_b, const bf16* fc1_w,
    const bf16* fc1_b, const bf16* fc2_w, const bf16* fc2_b,
    const float* stats, const bf16* qkv, const bf16* attn, const bf16* x2,
    const bf16* h, const bf16* mlp, const bf16* g, bf16* dx, bf16* grads,
    bf16* dh, float* dy, bf16* dx2, bf16* dqkv, bf16* y1, bf16* y2,
    float* part, int n, int T, int D, int H, int hidden, float scale,
    cudaStream_t stream) {
  (void)qkv_b;
  (void)proj_b;
  (void)fc1_b;
  (void)fc2_b;
  return launch_block_bwd<bf16>(
      x, ln1_s, ln1_b, qkv_w, proj_w, ln2_s, ln2_b, fc1_w, fc2_w, stats, qkv,
      attn, x2, h, mlp, g, dx, grads, dh, dy, dx2, dqkv, y1, y2, part, n, T,
      D, H, hidden, scale, stream);
}

}  // extern "C"

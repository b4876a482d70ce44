// PoseFormer's spatial transformer stack: depth x pre-norm block (LayerNorm
// -> packed-qkv multi-head attention -> proj -> residual -> LayerNorm -> fc1
// -> exact GELU -> fc2 -> residual) and the final LayerNorm, forward in one
// launch and backward in 2 x depth + 2 launches, fp32 on the CUDA cores.
//
// Forward: replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/fused_spatial_transformer.py (`_fused_fwd_impl`, entry
// `fused_spatial_stack`).
//
// Bound on an H100 SXM: operations. At B=256, L=16 the stack sees N = 4096
// frames of J=26 tokens x E=32: 4 blocks of 19,712 FLOP per token are
// 8.40 GFLOP, 125 us at the 67 TFLOP/s fp32 peak, against about 27 MB of
// activations and weights in and out (8 us at 3.35 TB/s).
//
// Design. A thread block owns `frames` frames (4 at E=32: 104 token rows;
// the wrapper picks 4 down to 1 so that the layout fits 227 KB). Their
// residual stream, the LayerNorm output and the qkv / MLP-hidden scratch
// stay in shared memory through all depth blocks and the final LayerNorm,
// so the activations are read once and written once (the TPU kernel's
// design, without its transposed (E, J, N) slab and 128-lane blocks, which
// exist for the TPU's (8, 128) tiling). Each depth block's weights are
// staged into shared memory transposed, [in][out + 8]: the padding puts the
// staging stores of a warp (8 outputs x 4 inputs) on 32 distinct banks. The
// dense layers are register-tiled, 4 rows x 4 outputs per thread, with
// float4 shared loads (64 FMAs per 8 loads). Attention runs one thread per
// (frame, head, query) with the <= 32 scores in registers and a
// max-subtracted softmax; neighbouring threads take neighbouring heads, so
// that a warp's reads of a token row spread over the banks. The kernel is
// compiled twice: for head widths up to 4 with a head's columns in
// registers (PoseFormer's E=32 with 8 heads), and for any head width up to
// 32 with a loop over them.
// LayerNorm uses flax's statistics, var = max(mean(x^2) - mean(x)^2, 0), eps 1e-5; GELU is
// exact (erff). The ragged edge (N not a multiple of frames) is zero-filled
// on load and not stored. For training the forward also writes, per depth
// block, what the backward needs (see below).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJ = 32;    // tokens (joints) per frame
constexpr int kMaxHd = 32;   // head width
constexpr int kMaxE = 128;   // width (lanes of the LayerNorm backward)
constexpr int kWPad = 8;     // row padding of the staged weights, floats
constexpr float kEps = 1e-5f;
constexpr float kSqrtHalf = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

struct Weights {
  const float *ln1_s, *ln1_b, *qkv_w, *qkv_b, *proj_w, *proj_b;
  const float *ln2_s, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
  const float *lnf_s, *lnf_b;
};

// What the training forward keeps for the backward, per depth block b of M =
// n J rows: stats (depth, 4, M) = mu1, inv1, mu2, inv2; qkv (depth, M, 3E);
// o, the attention output (depth, M, E); x2, the residual after attention
// (depth, M, E); h, the pre-GELU hidden (depth, M, hidden); xs, the block's
// output (depth, M, E). All nullptr when serving.
struct Saved {
  float *stats, *qkv, *o, *x2, *h, *xs;
};

struct Dims {
  int n, J, E, H, hidden, depth;
  int frames;   // frames per thread block (a tile)
  int rows;     // rows per thread block: frames * J rounded up to 4, or the
                // MLP backward's row tile
  float scale;  // hd^-0.5
};

__host__ __device__ inline int pad4(int v) { return (v + 3) & ~3; }

// The attention code for head width hd: 4 (PoseFormer's 32 / 8) with the
// head's columns in registers, or 0, any width up to 32 in a loop.
__host__ __device__ inline int hd_class(int hd) { return hd <= 4 ? 4 : 0; }

// Offsets into dynamic shared memory, in floats; each a multiple of 4.
struct Layout {
  int x, y, z, wqkv, wproj, wfc1, wfc2, vec, st, total;
};

__host__ __device__ inline Layout layout_of(int rows, int E, int hidden) {
  Layout l;
  const int zw = 3 * E > hidden ? 3 * E : hidden;
  l.x = 0;                                        // residual stream
  l.y = l.x + rows * E;                           // LayerNorm / attention out
  l.z = l.y + rows * E;                           // qkv, then MLP hidden
  l.wqkv = l.z + rows * zw;
  l.wproj = l.wqkv + E * (3 * E + kWPad);
  l.wfc1 = l.wproj + E * (E + kWPad);
  l.wfc2 = l.wfc1 + E * (hidden + kWPad);
  l.vec = l.wfc2 + hidden * (E + kWPad);          // biases and LN vectors
  l.st = l.vec + pad4(9 * E + hidden);            // LayerNorm mean, inv
  l.total = l.st + 2 * rows;
  return l;
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * kSqrtHalf));
}

__device__ __forceinline__ float dgelu(float v) {
  return 0.5f * (1.0f + erff(v * kSqrtHalf)) + v * expf(-0.5f * v * v) *
                                                   kInvSqrt2Pi;
}

// w: [nout][k] (nn.Linear layout, global) -> wt: [k][nout + kWPad] (shared).
// A warp stores an 8 (out) x 4 (in) tile: with nout a multiple of 32 the
// row stride is 8 banks apart, so the 32 stores hit 32 banks.
__device__ void stage_transposed(const float* __restrict__ w, float* wt,
                                 int nout, int k) {
  const int ld = nout + kWPad;
  const int lane = threadIdx.x & 31;
  const int tiles_k = (k + 3) / 4;
  const int tiles = ((nout + 7) / 8) * tiles_k;
  for (int t = threadIdx.x >> 5; t < tiles; t += kWarps) {
    const int o = (t / tiles_k) * 8 + (lane >> 2);
    const int i = (t % tiles_k) * 4 + (lane & 3);
    if (o < nout && i < k) wt[i * ld + o] = __ldg(w + o * k + i);
  }
}

__device__ void stage(const float* __restrict__ src, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = __ldg(src + i);
}

// w: [rows][cols] (global) -> [rows][cols + kWPad] (shared), as is.
__device__ void stage_rows(const float* __restrict__ w, float* dst, int rows,
                           int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads)
    dst[(i / cols) * (cols + kWPad) + i % cols] = __ldg(w + i);
}

// dst[0, count) = src[0, count) with float4 copies (count a multiple of 4).
__device__ void copy4(const float* src, float* dst, int count) {
  for (int i = threadIdx.x; i < count / 4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
}

__device__ void copy1(const float* src, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

// One warp per row: out = (x - mean) * rsqrt(var + eps) * s + b; with mu
// and inv given, each row's mean and rsqrt(var + eps) as well.
__device__ void layer_norm_rows(const float* in, float* out, int rows, int E,
                                const float* s, const float* b,
                                float* mu = nullptr, float* inv = nullptr) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    const float* xr = in + r * E;
    float sum = 0.f, sq = 0.f;
    for (int k = lane; k < E; k += 32) {
      const float v = xr[k];
      sum += v;
      sq = fmaf(v, v, sq);
    }
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float m = sum / E;
    const float iv = rsqrtf(fmaxf(sq / E - m * m, 0.f) + kEps);
    if (mu != nullptr && lane == 0) {
      mu[r] = m;
      inv[r] = iv;
    }
    float* yr = out + r * E;
    for (int k = lane; k < E; k += 32) yr[k] = (xr[k] - m) * iv * s[k] + b[k];
  }
}

enum Epilogue { kStore, kGelu, kAdd, kDGelu };

// out[r][o] (row stride nout) = epi(sum_i in[r][i] wt[i][o] + bias[o]) for
// r < rows (a multiple of 4), bias nullptr for none; kAdd adds it to out
// (the residual), kDGelu multiplies it by GELU'(out) (out holds the
// pre-activation). With wt a weight w[out][in] staged as is, the product is
// the backward's dX = dY w. Thread `first` takes the first 4 x 4 task, so
// that a product can share a phase with work on the threads before it.
template <int EPI>
__device__ void dense(const float* in, int k, const float* wt, int nout,
                      const float* bias, float* out, int rows,
                      int first = 0) {
  const int ld = nout + kWPad;
  const int col_groups = nout >> 2;
  const int tasks = (rows >> 2) * col_groups;
  for (int task = (threadIdx.x + kThreads - first % kThreads) % kThreads;
       task < tasks; task += kThreads) {
    const int r0 = (task / col_groups) * 4, c0 = (task % col_groups) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < k; kk += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(in + (r0 + i) * k + kk);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w =
            *reinterpret_cast<const float4*>(wt + (kk + q) * ld + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i][q], w.x, acc[i][0]);
          acc[i][1] = fmaf(a[i][q], w.y, acc[i][1]);
          acc[i][2] = fmaf(a[i][q], w.z, acc[i][2]);
          acc[i][3] = fmaf(a[i][q], w.w, acc[i][3]);
        }
      }
    }
    const float4 bv = bias != nullptr
                          ? *reinterpret_cast<const float4*>(bias + c0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v = make_float4(acc[i][0] + bv.x, acc[i][1] + bv.y,
                             acc[i][2] + bv.z, acc[i][3] + bv.w);
      float4* dst = reinterpret_cast<float4*>(out + (r0 + i) * nout + c0);
      if (EPI == kGelu) {
        v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
      } else if (EPI == kAdd) {
        const float4 r = *dst;
        v = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);
      } else if (EPI == kDGelu) {
        const float4 h = *dst;
        v = make_float4(v.x * dgelu(h.x), v.y * dgelu(h.y), v.z * dgelu(h.z),
                        v.w * dgelu(h.w));
      }
      *dst = v;
    }
  }
}

// z: qkv rows [q | k | v] (row stride 3E, heads in (head, dim) order) of the
// block's d.frames frames -> o: attention output rows (row stride E). HD:
// the head width held in registers (4, E / H at most), or 0: any head
// width, the head's columns in a loop over shared memory.
template <int HD>
__device__ void attention(const float* z, float* o, const Dims& d) {
  const int E = d.E, J = d.J, hd = E / d.H, ldz = 3 * E;
  const int tasks = d.frames * d.H * J;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int f = task / (d.H * J), rem = task % (d.H * J);
    const int i = rem / d.H, h = rem % d.H;
    const float* frame = z + f * J * ldz + h * hd;
    const float* qi = frame + i * ldz;
    float q[HD > 0 ? HD : 1];
    if constexpr (HD > 0) {
#pragma unroll
      for (int c = 0; c < HD; ++c) q[c] = c < hd ? qi[c] * d.scale : 0.f;
    }
    float s[kMaxJ];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      s[j] = 0.f;
      if (j < J) {
        const float* kr = frame + j * ldz + E;
        float acc = 0.f;
        if constexpr (HD > 0) {
#pragma unroll
          for (int c = 0; c < HD; ++c)
            if (c < hd) acc = fmaf(q[c], kr[c], acc);
        } else {
          for (int c = 0; c < hd; ++c)
            acc = fmaf(qi[c] * d.scale, kr[c], acc);
        }
        s[j] = acc;
        m = fmaxf(m, acc);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < J) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < J) s[j] = s[j] / sum;
    float* dst = o + (f * J + i) * E + h * hd;
    for (int c = 0; c < hd; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < J) acc = fmaf(s[j], frame[j * ldz + 2 * E + c], acc);
      dst[c] = acc;
    }
  }
}

// Stage depth block b's weights: the four dense kernels transposed, the
// vectors at vec (ln1_s, ln1_b, qkv_b, proj_b, ln2_s, ln2_b, fc1_b, fc2_b at
// 0, E, 2E, 5E, 6E, 7E, 8E, 8E + hidden).
__device__ void stage_block(const Weights& w, int b, const Dims& d,
                            float* wqkv, float* wproj, float* wfc1,
                            float* wfc2, float* vec) {
  const int E = d.E, HID = d.hidden;
  stage_transposed(w.qkv_w + static_cast<size_t>(b) * 3 * E * E, wqkv, 3 * E,
                   E);
  stage_transposed(w.proj_w + static_cast<size_t>(b) * E * E, wproj, E, E);
  stage_transposed(w.fc1_w + static_cast<size_t>(b) * HID * E, wfc1, HID, E);
  stage_transposed(w.fc2_w + static_cast<size_t>(b) * E * HID, wfc2, E, HID);
  stage(w.ln1_s + b * E, vec, E);
  stage(w.ln1_b + b * E, vec + E, E);
  stage(w.qkv_b + b * 3 * E, vec + 2 * E, 3 * E);
  stage(w.proj_b + b * E, vec + 5 * E, E);
  stage(w.ln2_s + b * E, vec + 6 * E, E);
  stage(w.ln2_b + b * E, vec + 7 * E, E);
  stage(w.fc1_b + b * HID, vec + 8 * E, HID);
  stage(w.fc2_b + b * E, vec + 8 * E + HID, E);
}

// Where one tile's residuals of depth block b go (Saved, at row row0);
// qkv == nullptr when serving.
struct Keep {
  float *mu1, *inv1, *qkv, *o, *x2, *mu2, *inv2, *h, *xs;
  int real;  // the tile's real rows
};

__device__ Keep keep_of(const Saved& sv, int b, int row0, int real,
                        const Dims& d) {
  Keep k{};
  if (sv.qkv == nullptr) return k;
  const size_t M = static_cast<size_t>(d.n) * d.J;
  const size_t at = b * M + row0;
  float* st = sv.stats + 4 * b * M + row0;
  k.mu1 = st;
  k.inv1 = st + M;
  k.mu2 = st + 2 * M;
  k.inv2 = st + 3 * M;
  k.qkv = sv.qkv + at * 3 * d.E;
  k.o = sv.o + at * d.E;
  k.x2 = sv.x2 + at * d.E;
  k.h = sv.h + at * d.hidden;
  k.xs = sv.xs + at * d.E;
  k.real = real;
  return k;
}

// One pre-norm block on the residual rows X in place (HD: the compiled head
// width); Y (rows x E) and Z
// (rows x max(3E, hidden)) are scratch, mu / inv a row's LayerNorm
// statistics. Starts and ends without a barrier. With k.qkv given, each
// residual is copied out (real rows only) while the next step runs.
template <int HD>
__device__ void block_fwd(float* X, float* Y, float* Z, float* mu, float* inv,
                          const float* wqkv, const float* wproj,
                          const float* wfc1, const float* wfc2,
                          const float* vec, const Dims& d, const Keep& k) {
  const int E = d.E, HID = d.hidden;
  const bool keep = k.qkv != nullptr;
  layer_norm_rows(X, Y, d.rows, E, vec, vec + E, mu, inv);
  __syncthreads();
  if (keep) {
    copy1(mu, k.mu1, k.real);
    copy1(inv, k.inv1, k.real);
  }
  dense<kStore>(Y, E, wqkv, 3 * E, vec + 2 * E, Z, d.rows);
  __syncthreads();
  if (keep) copy4(Z, k.qkv, k.real * 3 * E);
  attention<HD>(Z, Y, d);
  __syncthreads();
  if (keep) copy4(Y, k.o, k.real * E);
  dense<kAdd>(Y, E, wproj, E, vec + 5 * E, X, d.rows);
  __syncthreads();
  if (keep) copy4(X, k.x2, k.real * E);
  layer_norm_rows(X, Y, d.rows, E, vec + 6 * E, vec + 7 * E, mu, inv);
  __syncthreads();
  if (keep) {
    copy1(mu, k.mu2, k.real);
    copy1(inv, k.inv2, k.real);
    dense<kStore>(Y, E, wfc1, HID, vec + 8 * E, Z, d.rows);
    __syncthreads();
    // the pre-GELU hidden out, then GELU in place (one thread per element)
    for (int i = threadIdx.x; i < d.rows * HID; i += kThreads) {
      const float v = Z[i];
      if (i < k.real * HID) k.h[i] = v;
      Z[i] = gelu(v);
    }
  } else {
    dense<kGelu>(Y, E, wfc1, HID, vec + 8 * E, Z, d.rows);
  }
  __syncthreads();
  dense<kAdd>(Z, HID, wfc2, E, vec + 8 * E + HID, X, d.rows);
  if (keep) {
    __syncthreads();
    copy4(X, k.xs, k.real * E);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    spatial_stack_kernel(const float* __restrict__ x, float* __restrict__ out,
                         Weights w, Saved sv, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout_of(d.rows, d.E, d.hidden);
  float* X = smem + l.x;
  float* Y = smem + l.y;
  const int E = d.E;
  const int f0 = blockIdx.x * d.frames;
  const int frames = min(d.frames, d.n - f0);
  const int real = frames * d.J * E;  // floats of this block's frames

  const float4* src =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(f0) * d.J * E);
  for (int i = threadIdx.x; i < d.rows * E / 4; i += kThreads)
    reinterpret_cast<float4*>(X)[i] =
        4 * i < real ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int b = 0; b < d.depth; ++b) {
    __syncthreads();  // the previous block is done with the staged weights
    stage_block(w, b, d, smem + l.wqkv, smem + l.wproj, smem + l.wfc1,
                smem + l.wfc2, smem + l.vec);
    __syncthreads();
    block_fwd<HD>(X, Y, smem + l.z, smem + l.st, smem + l.st + d.rows,
              smem + l.wqkv, smem + l.wproj, smem + l.wfc1, smem + l.wfc2,
              smem + l.vec, d, keep_of(sv, b, f0 * d.J, frames * d.J, d));
  }
  __syncthreads();
  layer_norm_rows(X, Y, frames * d.J, E, w.lnf_s, w.lnf_b);
  __syncthreads();
  float4* dst =
      reinterpret_cast<float4*>(out + static_cast<size_t>(f0) * d.J * E);
  for (int i = threadIdx.x; i < real / 4; i += kThreads)
    dst[i] = reinterpret_cast<const float4*>(Y)[i];
}

// ---------------------------------------------------------------------------
// Backward: dx and the 14 weight gradients.
//
// Replaces the TPU kernel `_bwd_kernel` of the JAX package's
// ops/pallas/fused_spatial_transformer.py (`_fused_bwd_impl`).
//
// Bound on an H100 SXM: operations. dx + dW are twice the forward's dense
// products and four attention products against the forward's two: 39,424
// FLOP per token and block, 67.18 GFLOP at B=1024, L=16 (16,384 frames),
// 1.00 ms at the 67 TFLOP/s fp32 peak, against about 2 GB in and out with
// the forward's saved residuals (0.6 ms at 3.35 TB/s).
//
// Design. The TPU kernel keeps every depth block's residuals of its 128
// frames in VMEM (about 25 MB); one H100 thread block has 227 KB. An
// earlier design here ran one persistent launch of one 159 KB thread block
// per SM that recomputed the forward twice (a sweep into a global scratch,
// then each block's residuals again) in 2-frame groups with 255 registers
// and a spill: 61.6 ms. Now the training forward keeps each block's
// residuals (`Saved`, 260 floats a row and block: 1.8 GB at B=1024, L=16),
// so nothing is recomputed but LayerNorm's normalisation on load and GELU,
// and the backward walks the depth blocks in reverse with two launches each:
//   the MLP half (rows independent, a tile of `rows` rows, 96 at E=32):
//     dW2 += du^T gelu(h), db2; dh = (du W2) GELU'(h); dW1 += dh^T LN2(x2),
//     db1; dy2 = dh W1; dx2 = du + LN2'(dy2), dln2;
//   the attention half (a tile of `frames` whole frames, 2 at E=32):
//     dWp += dx2^T o, dbp; do = dx2 Wp; attention backward -> dqkv (a
//     thread per (frame, head, query) recomputes its probabilities, writes
//     dq and keeps (max, sum, sum dp p); a thread per (frame, head, key)
//     then writes dk and dv); dWqkv += dqkv^T LN1(x), dbqkv; dy1 = dqkv
//     Wqkv; dx = dx2 + LN1'(dy1), dln1;
// after one launch for the final LayerNorm's backward. The running dx stays
// in one global buffer, updated in place tile by tile. Each launch stages
// its depth block's weights in shared memory once and keeps its tiles'
// activations there (about 110 KB at E=32, 256 threads of at most 128
// registers: two thread blocks per SM); the grid is persistent (two thread
// blocks per SM), each thread block walking tiles blockIdx.x + k gridDim.x.
// Weight gradients: a thread owns a 4 x 2 tile of a dW in shared memory and
// adds its rows' sums to it tile by tile, the bias sums with it; the
// LayerNorm vectors' sums stay in the lanes' registers. Each thread block
// writes its sums to its own row of `part`, and a last launch sums the rows
// in order. No atomics: two launches give the same bits. The dX products
// are the forward's `dense` on the weight staged as is (conflict-free
// weight reads), and each shares a barrier-free phase with the dW product
// that reads the same operands.

constexpr int kCols = kMaxE / 32;   // columns per lane, LayerNorm backward

// The 12 block weights' element counts, in the wrapper's order.
__host__ __device__ inline void block_sizes(int E, int hid, int* sz) {
  sz[0] = E;          // ln1_s
  sz[1] = E;          // ln1_b
  sz[2] = 3 * E * E;  // qkv_w
  sz[3] = 3 * E;      // qkv_b
  sz[4] = E * E;      // proj_w
  sz[5] = E;          // proj_b
  sz[6] = E;          // ln2_s
  sz[7] = E;          // ln2_b
  sz[8] = hid * E;    // fc1_w
  sz[9] = hid;        // fc1_b
  sz[10] = E * hid;   // fc2_w
  sz[11] = E;         // fc2_b
}

__host__ __device__ inline int block_total(int E, int hid) {
  return 4 * E * E + 2 * E * hid + 9 * E + hid;
}

// Where weight k of depth block b goes in a row of `part` (the flat
// gradient's layout: each weight stacked over depth, then lnf_s, lnf_b).
__device__ inline int grad_at(int k, int b, const Dims& d) {
  int sz[12];
  block_sizes(d.E, d.hidden, sz);
  int off = 0;
  for (int i = 0; i < k; ++i) off += sz[i];
  return d.depth * off + b * sz[k];
}

struct BwdArgs {
  const float *x, *g;  // the forward's input and the output's cotangent
  float* dx;           // the running gradient, in place
  Weights w;
  Saved sv;
  float* part;         // gridDim.x rows of `total` floats
  int total;
};

// MLP half: offsets into dynamic shared memory, in floats.
struct MlpLayout {
  int g, h, a, xh, inv, w2, w1, vec, acc, lnred, total;
};

__host__ __device__ inline MlpLayout mlp_layout(int R, int E, int hid) {
  MlpLayout l;
  l.g = 0;                          // du (the running gradient)
  l.h = l.g + R * E;                // pre-GELU h, then dh
  l.a = l.h + R * hid;              // gelu(h), then dy2
  l.xh = l.a + R * hid;             // x2 normalised
  l.inv = l.xh + R * E;             // LN2's rsqrt(var + eps)
  l.w2 = l.inv + pad4(R);           // fc2_w (E, hid) staged as is
  l.w1 = l.w2 + E * (hid + kWPad);  // fc1_w (hid, E)
  l.vec = l.w1 + hid * (E + kWPad);  // ln2_s, ln2_b
  l.acc = l.vec + 2 * E;            // dW2, db2, dW1, db1
  l.lnred = l.acc + pad4(2 * E * hid + E + hid);
  l.total = l.lnred + kWarps * 2 * E;
  return l;
}

// Attention half: offsets into dynamic shared memory, in floats.
struct AttnLayout {
  int dx2, o, dout, qkv, dqkv, xh, inv, att, wp, wq, vec, acc, lnred, total;
};

__host__ __device__ inline AttnLayout attn_layout(int R, int F, int E, int H,
                                                  int J) {
  AttnLayout l;
  l.dx2 = 0;                        // dx2 (the running gradient)
  l.o = l.dx2 + R * E;              // attention out, then dy1
  l.dout = l.o + R * E;             // do
  l.qkv = l.dout + R * E;
  l.dqkv = l.qkv + 3 * R * E;
  l.xh = l.dqkv + 3 * R * E;        // the block input normalised
  l.inv = l.xh + R * E;             // LN1's rsqrt(var + eps)
  l.att = l.inv + pad4(R);          // (max, sum, sum dp p) per query
  l.wp = l.att + pad4(3 * F * H * J);  // proj_w (E, E) staged as is
  l.wq = l.wp + E * (E + kWPad);        // qkv_w (3E, E)
  l.vec = l.wq + 3 * E * (E + kWPad);   // ln1_s, ln1_b
  l.acc = l.vec + 2 * E;            // dWqkv, dbqkv, dWp, dbp
  l.lnred = l.acc + pad4(4 * E * E + 4 * E);
  l.total = l.lnred + kWarps * 2 * E;
  return l;
}

// acc[o][i] (row stride nin) += sum_r dy[r][o] act(x[r][i]) over r < rows,
// act(v) = v s[i] + b[i] with LN (x holds normalised rows), else v; and
// bias[o] += sum_r dy[r][o]. A thread owns a 4 x 2 tile of acc (and, at i =
// 0, 4 entries of bias): every entry has one writer.
template <bool LN>
__device__ void dense_dw(const float* dy, int ldy, const float* x, int ldx,
                         float* acc, int nout, int nin, int rows, float* bias,
                         const float* s = nullptr, const float* b = nullptr) {
  const int col_groups = nin >> 1;
  const int tasks = (nout >> 2) * col_groups;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int o0 = (task / col_groups) * 4, i0 = (task % col_groups) * 2;
    float s0 = 1.f, s1 = 1.f, b0 = 0.f, b1 = 0.f;
    if (LN) {
      s0 = s[i0];
      s1 = s[i0 + 1];
      b0 = b[i0];
      b1 = b[i0 + 1];
    }
    float t[4][2], bs[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      t[p][0] = t[p][1] = 0.f;
      bs[p] = 0.f;
    }
    for (int r = 0; r < rows; ++r) {
      const float4 g = *reinterpret_cast<const float4*>(dy + r * ldy + o0);
      float2 v = *reinterpret_cast<const float2*>(x + r * ldx + i0);
      if (LN) {
        v.x = fmaf(v.x, s0, b0);
        v.y = fmaf(v.y, s1, b1);
      }
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        t[p][0] = fmaf(gv[p], v.x, t[p][0]);
        t[p][1] = fmaf(gv[p], v.y, t[p][1]);
        bs[p] += gv[p];
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float2* dst = reinterpret_cast<float2*>(acc + (o0 + p) * nin + i0);
      const float2 a = *dst;
      *dst = make_float2(a.x + t[p][0], a.y + t[p][1]);
    }
    if (i0 == 0)
#pragma unroll
      for (int p = 0; p < 4; ++p) bias[o0 + p] += bs[p];
  }
}

// LayerNorm backward, one warp per row r < real (rows warp, warp + kWarps,
// ...; the same rows of every tile): with dxh = dy s,
// out[r] = res[r] + inv[r] (dxh - mean(dxh) - xh mean(dxh xh)); ps and pb
// (this lane's columns lane + 32 j) gather sum dy xh and sum dy.
__device__ void ln_bwd_rows(const float* dy, const float* xh,
                            const float* inv, const float* s,
                            const float* res, float* out, int real, int E,
                            float* ps, float* pb) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < real; r += kWarps) {
    float dv[kCols], xv[kCols];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int k = lane + 32 * j;
      dv[j] = xv[j] = 0.f;
      if (k < E) {
        dv[j] = dy[r * E + k];
        xv[j] = xh[r * E + k];
        const float e = dv[j] * s[k];
        s1 += e;
        s2 = fmaf(e, xv[j], s2);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / E, m2 = s2 / E, iv = inv[r];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int k = lane + 32 * j;
      if (k < E) {
        out[r * E + k] = res[r * E + k] + iv * (dv[j] * s[k] - m1 - xv[j] * m2);
        ps[j] = fmaf(dv[j], xv[j], ps[j]);
        pb[j] += dv[j];
      }
    }
  }
}

// The lanes' LayerNorm sums -> dst_s[c], dst_b[c] (c < E), summed over the
// warps in order through red (kWarps x 2E floats of shared memory).
__device__ void write_ln_sums(float* red, const float* ps, const float* pb,
                              int E, float* dst_s, float* dst_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int k = lane + 32 * j;
    if (k < E) {
      red[warp * 2 * E + k] = ps[j];
      red[warp * 2 * E + E + k] = pb[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * E; c += kThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[w * 2 * E + c];
    if (c < E)
      dst_s[c] = v;
    else
      dst_b[c - E] = v;
  }
}

// rows [r0, r0 + R) of src (width w) -> dst, zeros past row `real`.
__device__ void load_tile(const float* src, float* dst, int R, int real,
                          int w) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < R * w / 4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] =
        4 * i < real * w ? s4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows of x (width E) normalised with the saved statistics -> xh, and each
// row's inv; zeros past row `real`.
__device__ void load_normalised(const float* x, const float* mu,
                                const float* inv_g, float* xh, float* inv,
                                int R, int real, int E) {
  for (int i = threadIdx.x; i < R * E; i += kThreads) {
    const int r = i / E;
    xh[i] = r < real ? (x[i] - mu[r]) * inv_g[r] : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads)
    inv[r] = r < real ? inv_g[r] : 0.f;
}

// Attention backward, first pass: a thread per (frame, head, query i)
// recomputes its softmax row from z (qkv rows), takes dp_ij = do_i . v_j and
// ds_ij = p_ij (dp_ij - sum_j dp_ij p_ij), writes dq_i = scale sum_j ds_ij
// k_j into dz's q columns and keeps (max, sum, sum_j dp_ij p_ij) in att.
template <int HD>
__device__ void attention_bwd_rows(const float* z, const float* dout,
                                   float* dz, float* att, const Dims& d) {
  const int E = d.E, J = d.J, hd = E / d.H, ldz = 3 * E;
  const int tasks = d.frames * d.H * J;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int f = task / (d.H * J), rem = task % (d.H * J);
    const int i = rem / d.H, h = rem % d.H;
    const float* frame = z + f * J * ldz + h * hd;
    const float* qi = frame + i * ldz;
    const float* dor = dout + (f * J + i) * E + h * hd;
    float q[HD > 0 ? HD : 1], dq[HD > 0 ? HD : 1];
    if constexpr (HD > 0) {
#pragma unroll
      for (int c = 0; c < HD; ++c) q[c] = c < hd ? qi[c] * d.scale : 0.f;
    }
    float s[kMaxJ], dp[kMaxJ];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      s[j] = 0.f;
      dp[j] = 0.f;
      if (j < J) {
        const float* kr = frame + j * ldz + E;
        const float* vr = frame + j * ldz + 2 * E;
        float acc = 0.f, dacc = 0.f;
        if constexpr (HD > 0) {
#pragma unroll
          for (int c = 0; c < HD; ++c)
            if (c < hd) {
              acc = fmaf(q[c], kr[c], acc);
              dacc = fmaf(dor[c], vr[c], dacc);
            }
        } else {
          for (int c = 0; c < hd; ++c) {
            acc = fmaf(qi[c] * d.scale, kr[c], acc);
            dacc = fmaf(dor[c], vr[c], dacc);
          }
        }
        s[j] = acc;
        dp[j] = dacc;
        m = fmaxf(m, acc);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < J) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
    float cdp = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < J) {
        s[j] = s[j] / sum;
        cdp = fmaf(dp[j], s[j], cdp);
      }
    float* dst = dz + (f * J + i) * ldz + h * hd;
    if constexpr (HD > 0) {
#pragma unroll
      for (int c = 0; c < HD; ++c) dq[c] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < J) {
          const float ds = s[j] * (dp[j] - cdp);
          const float* kr = frame + j * ldz + E;
#pragma unroll
          for (int c = 0; c < HD; ++c)
            if (c < hd) dq[c] = fmaf(ds, kr[c], dq[c]);
        }
#pragma unroll
      for (int c = 0; c < HD; ++c)
        if (c < hd) dst[c] = dq[c] * d.scale;
    } else {
      for (int c = 0; c < hd; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j)
          if (j < J)
            acc = fmaf(s[j] * (dp[j] - cdp), frame[j * ldz + E + c], acc);
        dst[c] = acc * d.scale;
      }
    }
    att[3 * task] = m;
    att[3 * task + 1] = sum;
    att[3 * task + 2] = cdp;
  }
}

// Second pass: a thread per (frame, head, key j) recomputes column j of the
// probabilities from att and writes dk_j = sum_i ds_ij (scale q_i) and dv_j
// = sum_i p_ij do_i into dz's k and v columns.
template <int HD>
__device__ void attention_bwd_cols(const float* z, const float* dout,
                                   float* dz, const float* att,
                                   const Dims& d) {
  const int E = d.E, J = d.J, hd = E / d.H, ldz = 3 * E;
  const int tasks = d.frames * d.H * J;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int f = task / (d.H * J), rem = task % (d.H * J);
    const int j = rem / d.H, h = rem % d.H;
    const float* frame = z + f * J * ldz + h * hd;
    const float* row_att = att + 3 * (f * J * d.H + h);  // query 0 of (f, h)
    float* dst = dz + (f * J + j) * ldz + h * hd;
    if constexpr (HD > 0) {
      float kj[HD], vj[HD], dk[HD], dv[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        kj[c] = c < hd ? frame[j * ldz + E + c] : 0.f;
        vj[c] = c < hd ? frame[j * ldz + 2 * E + c] : 0.f;
        dk[c] = 0.f;
        dv[c] = 0.f;
      }
      for (int i = 0; i < J; ++i) {
        const float* qr = frame + i * ldz;
        const float* dor = dout + (f * J + i) * E + h * hd;
        float acc = 0.f, dacc = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c)
          if (c < hd) {
            acc = fmaf(qr[c] * d.scale, kj[c], acc);
            dacc = fmaf(dor[c], vj[c], dacc);
          }
        const float* st = row_att + 3 * i * d.H;  // query i's statistics
        const float p = expf(acc - st[0]) / st[1];
        const float ds = p * (dacc - st[2]);
#pragma unroll
        for (int c = 0; c < HD; ++c)
          if (c < hd) {
            dk[c] = fmaf(ds, qr[c] * d.scale, dk[c]);
            dv[c] = fmaf(p, dor[c], dv[c]);
          }
      }
#pragma unroll
      for (int c = 0; c < HD; ++c)
        if (c < hd) {
          dst[E + c] = dk[c];
          dst[2 * E + c] = dv[c];
        }
    } else {
      const float* kj = frame + j * ldz + E;
      const float* vj = kj + E;
      float pv[kMaxJ], dsv[kMaxJ];
#pragma unroll
      for (int i = 0; i < kMaxJ; ++i) {
        pv[i] = dsv[i] = 0.f;
        if (i < J) {
          const float* qr = frame + i * ldz;
          const float* dor = dout + (f * J + i) * E + h * hd;
          float acc = 0.f, dacc = 0.f;
          for (int c = 0; c < hd; ++c) {
            acc = fmaf(qr[c] * d.scale, kj[c], acc);
            dacc = fmaf(dor[c], vj[c], dacc);
          }
          const float* st = row_att + 3 * i * d.H;
          pv[i] = expf(acc - st[0]) / st[1];
          dsv[i] = pv[i] * (dacc - st[2]);
        }
      }
      for (int c = 0; c < hd; ++c) {
        float dk = 0.f, dv = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxJ; ++i)
          if (i < J) {
            dk = fmaf(dsv[i], frame[i * ldz + c] * d.scale, dk);
            dv = fmaf(pv[i], dout[(f * J + i) * E + h * hd + c], dv);
          }
        dst[E + c] = dk;
        dst[2 * E + c] = dv;
      }
    }
  }
}

// The final LayerNorm's backward: dx = LN'(g) over all n J rows (a warp per
// row, rows warp + k x (warps of the grid)), its statistics recomputed from
// its input (the last block's output); lnf's sums to part.
__global__ void __launch_bounds__(kThreads)
    spatial_final_ln_bwd_kernel(BwdArgs a, Dims d) {
  __shared__ float red[kWarps * 2 * kMaxE];
  const int E = d.E, lane = threadIdx.x & 31;
  const size_t M = static_cast<size_t>(d.n) * d.J;
  const float* xf =
      d.depth > 0 ? a.sv.xs + static_cast<size_t>(d.depth - 1) * M * E : a.x;
  float ps[kCols], pb[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) ps[j] = pb[j] = 0.f;
  const size_t stride = static_cast<size_t>(gridDim.x) * kWarps;
  for (size_t r = static_cast<size_t>(blockIdx.x) * kWarps +
                  (threadIdx.x >> 5);
       r < M; r += stride) {
    float xv[kCols], gv[kCols];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int k = lane + 32 * j;
      xv[j] = gv[j] = 0.f;
      if (k < E) {
        xv[j] = xf[r * E + k];
        gv[j] = a.g[r * E + k];
        sum += xv[j];
        sq = fmaf(xv[j], xv[j], sq);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum / E;
    const float iv = rsqrtf(fmaxf(sq / E - mu * mu, 0.f) + kEps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int k = lane + 32 * j;
      xv[j] = (xv[j] - mu) * iv;  // xh
      if (k < E) {
        const float e = gv[j] * a.w.lnf_s[k];
        s1 += e;
        s2 = fmaf(e, xv[j], s2);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / E, m2 = s2 / E;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int k = lane + 32 * j;
      if (k < E) {
        a.dx[r * E + k] = iv * (gv[j] * a.w.lnf_s[k] - m1 - xv[j] * m2);
        ps[j] = fmaf(gv[j], xv[j], ps[j]);
        pb[j] += gv[j];
      }
    }
  }
  float* prow = a.part + static_cast<size_t>(blockIdx.x) * a.total;
  const int at = d.depth * block_total(E, d.hidden);
  write_ln_sums(red, ps, pb, E, prow + at, prow + at + E);
}

// The MLP half of depth block b (d.rows rows a tile).
__global__ void __launch_bounds__(kThreads, 2)
    spatial_mlp_bwd_kernel(BwdArgs a, Dims d, int b) {
  extern __shared__ __align__(16) float smem[];
  const int E = d.E, HID = d.hidden, R = d.rows;
  const MlpLayout l = mlp_layout(R, E, HID);
  float *G = smem + l.g, *Hs = smem + l.h, *A = smem + l.a, *XH = smem + l.xh,
        *inv = smem + l.inv, *w2 = smem + l.w2, *w1 = smem + l.w1,
        *vec = smem + l.vec, *acc = smem + l.acc;
  float *dW2 = acc, *db2 = dW2 + E * HID, *dW1 = db2 + E, *db1 = dW1 + HID * E;
  const size_t M = static_cast<size_t>(d.n) * d.J;
  stage_rows(a.w.fc2_w + static_cast<size_t>(b) * E * HID, w2, E, HID);
  stage_rows(a.w.fc1_w + static_cast<size_t>(b) * HID * E, w1, HID, E);
  stage(a.w.ln2_s + b * E, vec, E);
  stage(a.w.ln2_b + b * E, vec + E, E);
  for (int i = threadIdx.x; i < 2 * E * HID + E + HID; i += kThreads)
    acc[i] = 0.f;
  const float* h_b = a.sv.h + b * M * HID;
  const float* x2_b = a.sv.x2 + b * M * E;
  const float* mu2 = a.sv.stats + 4 * b * M + 2 * M;
  const float* inv2 = mu2 + M;
  float ps[kCols], pb[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) ps[j] = pb[j] = 0.f;

  const size_t tiles = (M + R - 1) / R;
  for (size_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const size_t r0 = t * R;
    const int real = static_cast<int>(M - r0 < static_cast<size_t>(R)
                                          ? M - r0 : R);
    __syncthreads();  // the previous tile (and the staging) is done
    load_tile(a.dx + r0 * E, G, R, real, E);
    load_tile(h_b + r0 * HID, Hs, R, real, HID);
    load_normalised(x2_b + r0 * E, mu2 + r0, inv2 + r0, XH, inv, R, real, E);
    __syncthreads();
    for (int i = threadIdx.x; i < R * HID; i += kThreads) A[i] = gelu(Hs[i]);
    __syncthreads();
    // dW2 reads gelu(h) in A while dh replaces h in Hs
    dense_dw<false>(G, E, A, HID, dW2, E, HID, R, db2);
    dense<kDGelu>(G, E, w2, HID, nullptr, Hs, R);  // dh
    __syncthreads();
    dense_dw<true>(Hs, HID, XH, E, dW1, HID, E, R, db1, vec, vec + E);
    dense<kStore>(Hs, HID, w1, E, nullptr, A, R);  // dy2
    __syncthreads();
    ln_bwd_rows(A, XH, inv, vec, G, a.dx + r0 * E, real, E, ps, pb);
  }
  __syncthreads();
  float* prow = a.part + static_cast<size_t>(blockIdx.x) * a.total;
  copy1(dW2, prow + grad_at(10, b, d), E * HID);
  copy1(db2, prow + grad_at(11, b, d), E);
  copy1(dW1, prow + grad_at(8, b, d), HID * E);
  copy1(db1, prow + grad_at(9, b, d), HID);
  write_ln_sums(smem + l.lnred, ps, pb, E, prow + grad_at(6, b, d),
                prow + grad_at(7, b, d));
}

// The attention half of depth block b (d.frames frames a tile).
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    spatial_attn_bwd_kernel(BwdArgs a, Dims d, int b) {
  extern __shared__ __align__(16) float smem[];
  const int E = d.E, R = d.rows, F = d.frames;
  const AttnLayout l = attn_layout(R, F, E, d.H, d.J);
  float *DX2 = smem + l.dx2, *O = smem + l.o, *DO = smem + l.dout,
        *QKV = smem + l.qkv,
        *DQKV = smem + l.dqkv, *XH = smem + l.xh, *inv = smem + l.inv,
        *att = smem + l.att, *wp = smem + l.wp, *wq = smem + l.wq,
        *vec = smem + l.vec, *acc = smem + l.acc;
  float *dWqkv = acc, *dbqkv = dWqkv + 3 * E * E, *dWp = dbqkv + 3 * E,
        *dbp = dWp + E * E;
  const size_t M = static_cast<size_t>(d.n) * d.J;
  stage_rows(a.w.proj_w + static_cast<size_t>(b) * E * E, wp, E, E);
  stage_rows(a.w.qkv_w + static_cast<size_t>(b) * 3 * E * E, wq, 3 * E, E);
  stage(a.w.ln1_s + b * E, vec, E);
  stage(a.w.ln1_b + b * E, vec + E, E);
  for (int i = threadIdx.x; i < 4 * E * E + 4 * E; i += kThreads) acc[i] = 0.f;
  // rows past the tile's frames, which the attention passes never write
  for (int i = F * d.J * 3 * E + threadIdx.x; i < R * 3 * E; i += kThreads)
    DQKV[i] = 0.f;
  const float* xin = b > 0 ? a.sv.xs + (b - 1) * M * E : a.x;
  const float* mu1 = a.sv.stats + 4 * b * M;
  const float* inv1 = mu1 + M;
  float ps[kCols], pb[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) ps[j] = pb[j] = 0.f;

  const int groups = (d.n + F - 1) / F;
  for (int t = blockIdx.x; t < groups; t += gridDim.x) {
    const size_t r0 = static_cast<size_t>(t) * F * d.J;
    const int real = min(F, d.n - t * F) * d.J;
    __syncthreads();  // the previous tile (and the staging) is done
    load_tile(a.dx + r0 * E, DX2, R, real, E);
    load_tile(a.sv.o + (b * M + r0) * E, O, R, real, E);
    load_tile(a.sv.qkv + (b * M + r0) * 3 * E, QKV, R, real, 3 * E);
    load_normalised(xin + r0 * E, mu1 + r0, inv1 + r0, XH, inv, R, real, E);
    __syncthreads();
    // dWp on the first 128 threads (E = 32), do on those after them
    dense_dw<false>(DX2, E, O, E, dWp, E, E, R, dbp);
    dense<kStore>(DX2, E, wp, E, nullptr, DO, R, E * E / 8);
    __syncthreads();
    attention_bwd_rows<HD>(QKV, DO, DQKV, att, d);
    __syncthreads();
    attention_bwd_cols<HD>(QKV, DO, DQKV, att, d);
    __syncthreads();
    dense_dw<true>(DQKV, 3 * E, XH, E, dWqkv, 3 * E, E, R, dbqkv, vec,
                   vec + E);
    dense<kStore>(DQKV, 3 * E, wq, E, nullptr, O, R, E * E / 8);  // dy1
    __syncthreads();
    ln_bwd_rows(O, XH, inv, vec, DX2, a.dx + r0 * E, real, E, ps, pb);
  }
  __syncthreads();
  float* prow = a.part + static_cast<size_t>(blockIdx.x) * a.total;
  copy1(dWqkv, prow + grad_at(2, b, d), 3 * E * E);
  copy1(dbqkv, prow + grad_at(3, b, d), 3 * E);
  copy1(dWp, prow + grad_at(4, b, d), E * E);
  copy1(dbp, prow + grad_at(5, b, d), E);
  write_ln_sums(smem + l.lnred, ps, pb, E, prow + grad_at(0, b, d),
                prow + grad_at(1, b, d));
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

bool valid(int J, int E, int H, int hidden, int depth) {
  return J >= 1 && J <= kMaxJ && E >= 4 && E % 4 == 0 && E <= kMaxE &&
         hidden >= 4 && hidden % 4 == 0 && H >= 1 && E % H == 0 &&
         E / H <= kMaxHd && depth >= 0;
}

int fwd_bytes(int J, int E, int hidden, int frames) {
  return static_cast<int>(sizeof(float) *
                          layout_of(pad4(frames * J), E, hidden).total);
}

int mlp_bytes(int E, int hidden, int rows) {
  return static_cast<int>(sizeof(float) * mlp_layout(rows, E, hidden).total);
}

int attn_bytes(int J, int E, int H, int frames) {
  return static_cast<int>(
      sizeof(float) * attn_layout(pad4(frames * J), frames, E, H, J).total);
}

cudaError_t set_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The kernels with attention, compiled twice (each its own register
// allocation): the instance for head width hd.
typedef void (*FwdKernel)(const float*, float*, Weights, Saved, Dims);
typedef void (*AttnBwdKernel)(BwdArgs, Dims, int);

FwdKernel fwd_kernel(int hd) {
  return hd_class(hd) == 4 ? spatial_stack_kernel<4> : spatial_stack_kernel<0>;
}

AttnBwdKernel attn_bwd_kernel(int hd) {
  return hd_class(hd) == 4 ? spatial_attn_bwd_kernel<4>
                           : spatial_attn_bwd_kernel<0>;
}

}  // namespace

extern "C" {

// Shared memory of one thread block, in bytes, of the forward at `frames`
// frames a thread block, and of the backward's MLP half at `rows` rows and
// attention half at `frames` frames (the wrapper picks the tiles with its
// copy of these layouts, and checks them against these).
int pv2c_spatial_stack_smem_bytes(int J, int E, int H, int hidden,
                                  int frames) {
  (void)H;
  return fwd_bytes(J, E, hidden, frames);
}

int pv2c_spatial_mlp_bwd_smem_bytes(int E, int hidden, int rows) {
  return mlp_bytes(E, hidden, rows);
}

int pv2c_spatial_attn_bwd_smem_bytes(int J, int E, int H, int frames) {
  return attn_bytes(J, E, H, frames);
}

// x, out: (n, J, E) float32 contiguous; the 12 block weights stacked over
// depth in nn.Linear layout (qkv_w (depth, 3E, E), proj_w (depth, E, E),
// fc1_w (depth, hidden, E), fc2_w (depth, E, hidden), vectors (depth, .));
// lnf_s, lnf_b (E,). stats, qkv, o, x2, h, xs: the residuals the backward
// takes (see Saved), or all nullptr. Requires J <= 32, E <= 128 and hidden
// multiples of 4, E / H <= 32, `frames` frames a thread block and 16-byte
// aligned pointers. Returns a CUDA error code.
int pv2c_fused_spatial_stack(
    const float* x, float* out, const float* ln1_s, const float* ln1_b,
    const float* qkv_w, const float* qkv_b, const float* proj_w,
    const float* proj_b, const float* ln2_s, const float* ln2_b,
    const float* fc1_w, const float* fc1_b, const float* fc2_w,
    const float* fc2_b, const float* lnf_s, const float* lnf_b, float* stats,
    float* qkv, float* o, float* x2, float* h, float* xs, int n, int J, int E,
    int H, int hidden, int depth, int frames, float scale,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!valid(J, E, H, hidden, depth) || frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n, J, E, H, hidden, depth, frames, pad4(frames * J), scale};
  const Weights w{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                  ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, lnf_s, lnf_b};
  const Saved sv{stats, qkv, o, x2, h, xs};
  const int bytes = fwd_bytes(J, E, hidden, frames);
  const FwdKernel kernel = fwd_kernel(E / H);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + frames - 1) / frames, kThreads, bytes, stream>>>(x, out, w,
                                                                 sv, d);
  return static_cast<int>(cudaGetLastError());
}

// The backward's grid on the current device: the SMs times the thread
// blocks of both halves that fit on one SM together (at least one). The
// wrapper sizes `part` with it. Returns minus a CUDA error code on failure.
int pv2c_spatial_stack_bwd_grid(int J, int E, int H, int hidden,
                                int mlp_rows, int attn_frames) {
  const int mb = mlp_bytes(E, hidden, mlp_rows);
  const int ab = attn_bytes(J, E, H, attn_frames);
  int device = 0, sms = 0, per_mlp = 0, per_attn = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(spatial_mlp_bwd_kernel), mb);
  const AttnBwdKernel attn = attn_bwd_kernel(E / H);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(attn), ab);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_mlp, spatial_mlp_bwd_kernel, kThreads, mb);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_attn, attn,
                                                        kThreads, ab);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int per = per_mlp < per_attn ? per_mlp : per_attn;
  return sms * (per > 0 ? per : 1);
}

// The backward of pv2c_fused_spatial_stack: x, g (the output's cotangent),
// dx (n, J, E); the 14 weights as the forward's; the residuals the forward
// kept (stats ... xs); part (grid, total) scratch; grads (total) receives
// the 14 weight gradients flat, each in its weight's layout, in the
// weights' order (total = depth x (4E^2 + 2E hidden + 9E + hidden) + 2E).
// grid from pv2c_spatial_stack_bwd_grid with the same tiles (mlp_rows, a
// multiple of 4; attn_frames). 2 depth + 2 launches. Returns a CUDA error
// code.
int pv2c_fused_spatial_stack_bwd(
    const float* x, const float* g, float* dx, const float* ln1_s,
    const float* ln1_b, const float* qkv_w, const float* qkv_b,
    const float* proj_w, const float* proj_b, const float* ln2_s,
    const float* ln2_b, const float* fc1_w, const float* fc1_b,
    const float* fc2_w, const float* fc2_b, const float* lnf_s,
    const float* lnf_b, float* stats, float* qkv, float* o, float* x2,
    float* h, float* xs, float* part, float* grads, int n, int J, int E,
    int H, int hidden, int depth, int grid, int mlp_rows, int attn_frames,
    float scale, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!valid(J, E, H, hidden, depth) || grid < 1 || mlp_rows < 4 ||
      mlp_rows % 4 || attn_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = depth * block_total(E, hidden) + 2 * E;
  const BwdArgs a{x, g, dx,
                  Weights{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                          ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, lnf_s, lnf_b},
                  Saved{stats, qkv, o, x2, h, xs}, part, total};
  const Dims dm{n, J, E, H, hidden, depth, 0, mlp_rows, scale};
  const Dims da{n, J, E, H, hidden, depth, attn_frames,
                pad4(attn_frames * J), scale};
  const int mb = mlp_bytes(E, hidden, mlp_rows);
  const int ab = attn_bytes(J, E, H, attn_frames);
  const AttnBwdKernel attn = attn_bwd_kernel(E / H);
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(spatial_mlp_bwd_kernel), mb);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(attn), ab);
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_final_ln_bwd_kernel<<<grid, kThreads, 0, stream>>>(a, dm);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int b = depth - 1; b >= 0; --b) {
    spatial_mlp_bwd_kernel<<<grid, kThreads, mb, stream>>>(a, dm, b);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    attn<<<grid, kThreads, ab, stream>>>(a, da, b);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      part, grid, total, grads);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

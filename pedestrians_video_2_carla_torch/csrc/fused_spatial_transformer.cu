// PoseFormer's spatial transformer stack in ONE launch: depth x pre-norm
// block (LayerNorm -> packed-qkv multi-head attention -> proj -> residual ->
// LayerNorm -> fc1 -> exact GELU -> fc2 -> residual) and the final
// LayerNorm, fp32 on the CUDA cores.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/fused_spatial_transformer.py (`_fused_fwd_impl`, entry
// `fused_spatial_stack`).
//
// Bound on an H100 SXM: operations. At B=256, L=16 the stack sees N = 4096
// frames of J=26 tokens x E=32: 4 blocks of 19,712 FLOP per token are
// 8.40 GFLOP, 125 us at the 67 TFLOP/s fp32 peak, against about 27 MB of
// activations and weights in and out (8 us at 3.35 TB/s).
//
// Design. A thread block owns kFrames frames (104 token rows at J=26).
// Their residual stream, the LayerNorm output and the qkv / MLP-hidden
// scratch stay in shared memory through all depth blocks and the final
// LayerNorm, so the activations are read once and written once (the TPU
// kernel's design, without its transposed (E, J, N) slab and 128-lane
// blocks, which exist for the TPU's (8, 128) tiling). Each depth block's
// weights are staged into shared memory transposed, [in][out + 8]: the
// padding puts the staging stores of a warp (8 outputs x 4 inputs) on 32
// distinct banks. The dense layers are register-tiled, 4 rows x 4 outputs
// per thread, with float4 shared loads (64 FMAs per 8 loads). Attention
// runs one thread per (frame, head, query) with the <= 32 scores in
// registers and a max-subtracted softmax. LayerNorm uses flax's statistics,
// var = max(mean(x^2) - mean(x)^2, 0), eps 1e-5; GELU is exact (erff). The
// ragged edge (N not a multiple of kFrames) is zero-filled on load and not
// stored.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;   // frames per thread block
constexpr int kMaxJ = 32;    // tokens (joints) per frame
constexpr int kMaxHd = 16;   // head width
constexpr int kWPad = 8;     // row padding of the staged weights, floats
constexpr float kEps = 1e-5f;
constexpr float kSqrtHalf = 0.70710678118654752440f;

struct Weights {
  const float *ln1_s, *ln1_b, *qkv_w, *qkv_b, *proj_w, *proj_b;
  const float *ln2_s, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
  const float *lnf_s, *lnf_b;
};

struct Dims {
  int n, J, E, H, hidden, depth;
  int frames;   // frames per thread block
  int rows;     // frames * J rounded up to a multiple of 4
  float scale;  // hd^-0.5
};

// Offsets into dynamic shared memory, in floats; each a multiple of 4.
struct Layout {
  int x, y, z, wqkv, wproj, wfc1, wfc2, vec, total;
};

__host__ __device__ inline Layout layout_of(const Dims& d) {
  Layout l;
  const int zw = 3 * d.E > d.hidden ? 3 * d.E : d.hidden;
  l.x = 0;                                        // residual stream
  l.y = l.x + d.rows * d.E;                       // LayerNorm / attention out
  l.z = l.y + d.rows * d.E;                       // qkv, then MLP hidden
  l.wqkv = l.z + d.rows * zw;
  l.wproj = l.wqkv + d.E * (3 * d.E + kWPad);
  l.wfc1 = l.wproj + d.E * (d.E + kWPad);
  l.wfc2 = l.wfc1 + d.E * (d.hidden + kWPad);
  l.vec = l.wfc2 + d.hidden * (d.E + kWPad);      // biases and LN vectors
  l.total = l.vec + 9 * d.E + d.hidden;
  return l;
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * kSqrtHalf));
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
  for (int t = threadIdx.x >> 5; t < tiles; t += kThreads / 32) {
    const int o = (t / tiles_k) * 8 + (lane >> 2);
    const int i = (t % tiles_k) * 4 + (lane & 3);
    if (o < nout && i < k) wt[i * ld + o] = __ldg(w + o * k + i);
  }
}

__device__ void stage(const float* __restrict__ src, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = __ldg(src + i);
}

// One warp per row: out = (x - mean) * rsqrt(var + eps) * s + b.
__device__ void layer_norm_rows(const float* in, float* out, int rows, int E,
                                const float* s, const float* b) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
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
    const float mu = sum / E;
    const float inv = rsqrtf(fmaxf(sq / E - mu * mu, 0.f) + kEps);
    float* yr = out + r * E;
    for (int k = lane; k < E; k += 32) yr[k] = (xr[k] - mu) * inv * s[k] + b[k];
  }
}

enum Epilogue { kStore, kGelu, kAdd };

// out[r][o] (row stride nout) = epi(sum_i in[r][i] wt[i][o] + bias[o]) for
// r < rows (a multiple of 4); kAdd adds it to out (the residual).
template <int EPI>
__device__ void dense(const float* in, int k, const float* wt, int nout,
                      const float* bias, float* out, int rows) {
  const int ld = nout + kWPad;
  const int col_groups = nout >> 2;
  const int tasks = (rows >> 2) * col_groups;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
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
    const float4 bv = *reinterpret_cast<const float4*>(bias + c0);
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
      }
      *dst = v;
    }
  }
}

// z: qkv rows [q | k | v] (row stride 3E, heads in (head, dim) order) of the
// block's d.frames frames -> o: attention output rows (row stride E).
__device__ void attention(const float* z, float* o, const Dims& d) {
  const int E = d.E, J = d.J, hd = E / d.H, ldz = 3 * E;
  const int tasks = d.frames * d.H * J;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int f = task / (d.H * J), rem = task % (d.H * J);
    const int h = rem / J, i = rem % J;
    const float* frame = z + f * J * ldz + h * hd;
    float q[kMaxHd];
#pragma unroll
    for (int c = 0; c < kMaxHd; ++c)
      q[c] = c < hd ? frame[i * ldz + c] * d.scale : 0.f;
    float s[kMaxJ];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      s[j] = 0.f;
      if (j < J) {
        const float* kr = frame + j * ldz + E;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxHd; ++c)
          if (c < hd) acc = fmaf(q[c], kr[c], acc);
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

// One pre-norm block on the residual rows X in place; Y (rows x E) and Z
// (rows x max(3E, hidden)) are scratch. Starts and ends without a barrier.
__device__ void block_fwd(float* X, float* Y, float* Z, const float* wqkv,
                          const float* wproj, const float* wfc1,
                          const float* wfc2, const float* vec,
                          const Dims& d) {
  const int E = d.E, HID = d.hidden;
  layer_norm_rows(X, Y, d.rows, E, vec, vec + E);
  __syncthreads();
  dense<kStore>(Y, E, wqkv, 3 * E, vec + 2 * E, Z, d.rows);
  __syncthreads();
  attention(Z, Y, d);
  __syncthreads();
  dense<kAdd>(Y, E, wproj, E, vec + 5 * E, X, d.rows);
  __syncthreads();
  layer_norm_rows(X, Y, d.rows, E, vec + 6 * E, vec + 7 * E);
  __syncthreads();
  dense<kGelu>(Y, E, wfc1, HID, vec + 8 * E, Z, d.rows);
  __syncthreads();
  dense<kAdd>(Z, HID, wfc2, E, vec + 8 * E + HID, X, d.rows);
}

__global__ void __launch_bounds__(kThreads)
    spatial_stack_kernel(const float* __restrict__ x, float* __restrict__ out,
                         Weights w, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout_of(d);
  float* X = smem + l.x;
  float* Y = smem + l.y;
  const int E = d.E;
  const int f0 = blockIdx.x * kFrames;
  const int frames = min(kFrames, d.n - f0);
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
    block_fwd(X, Y, smem + l.z, smem + l.wqkv, smem + l.wproj, smem + l.wfc1,
              smem + l.wfc2, smem + l.vec, d);
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
// Backward: dx and the 14 weight gradients, in one launch.
//
// Replaces the TPU kernel `_bwd_kernel` of the JAX package's
// ops/pallas/fused_spatial_transformer.py (`_fused_bwd_impl`).
//
// Bound on an H100 SXM: operations. dx + dW are twice the forward's dense
// products and four attention products against the forward's two: 39,424
// FLOP per token and block, 67.18 GFLOP at B=1024, L=16 (16,384 frames),
// 1.00 ms at the 67 TFLOP/s fp32 peak, against about 170 MB in and out.
//
// Design. The TPU kernel keeps every depth block's residuals of its 128
// frames in VMEM (about 25 MB); one H100 thread block has 227 KB. Here a
// persistent grid (one thread block per SM; 159 KB of shared memory each at
// J=26, E=32) owns frame groups of kBwdFrames frames, blockIdx.x +
// k * gridDim.x, in every sweep, so no sweep waits on another block:
//   (a) forward sweep, depth-outer: each block's output rows go to the
//       global scratch xs (depth x n x J x E; block b's input is x for b = 0,
//       else xs[b - 1]);
//   (b) the final LayerNorm's backward: dx = LN'(g) into dx;
//   (c) reverse sweep, depth-inner-to-outer: the group's block input and
//       running dx are loaded, the block's forward residuals recomputed in
//       shared memory (LayerNorm statistics, y1, qkv, o, x2, y2, pre-GELU h),
//       then the block's backward runs on them and dx is stored back.
// Weight gradients: the TPU sums across sequential grid steps; here each
// thread block sums its groups' contributions for the current depth block
// in shared memory (in a fixed order), writes them to its own slice of
// `part`, and a second launch sums the slices in block order. No atomics:
// two launches give the same bits. Products: dX = dY W reads the staged
// transposed weights row-wise (4 x 4 outputs per thread, float4 loads);
// dW = dY^T act runs 4 x 4 weight entries per thread over the group's rows.
// Attention backward is flash-style: a thread per (frame, head, query)
// recomputes its softmax row, writes dq and keeps (max, sum, sum dp p); a
// thread per (frame, head, key) then recomputes its column for dk and dv.
// LayerNorm backward: inv (dxh - mean(dxh) - xh mean(dxh xh)) with the
// forward's statistics.

constexpr int kBwdFrames = 2;  // frames per group in the backward
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

__device__ __forceinline__ float dgelu(float v) {
  return 0.5f * (1.0f + erff(v * kSqrtHalf)) + v * expf(-0.5f * v * v) *
                                                   kInvSqrt2Pi;
}

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

// Offsets into dynamic shared memory, in floats; each a multiple of 4.
struct BwdLayout {
  int x, g, y1, qkv, o, x2, y2, z;   // activations, d.rows rows each
  int wqkv, wproj, wfc1, wfc2, vec;  // one depth block's weights
  int acc, accf, stats, att, total;  // weight grads, statistics
};

__host__ __device__ inline BwdLayout bwd_layout_of(const Dims& d) {
  BwdLayout l;
  const int E = d.E, R = d.rows;
  const int zw = 3 * E > d.hidden ? 3 * E : d.hidden;
  l.x = 0;                            // block input
  l.g = l.x + R * E;                  // running dx
  l.y1 = l.g + R * E;                 // LN1 out
  l.qkv = l.y1 + R * E;
  l.o = l.qkv + R * 3 * E;            // attention out, then do, then dy1
  l.x2 = l.o + R * E;
  l.y2 = l.x2 + R * E;                // LN2 out, then dy2
  l.z = l.y2 + R * E;                 // pre-GELU h, then dh, then dqkv
  l.wqkv = l.z + R * zw;
  l.wproj = l.wqkv + E * (3 * E + kWPad);
  l.wfc1 = l.wproj + E * (E + kWPad);
  l.wfc2 = l.wfc1 + E * (d.hidden + kWPad);
  l.vec = l.wfc2 + d.hidden * (E + kWPad);
  l.acc = l.vec + ((9 * E + d.hidden + 3) & ~3);
  l.accf = l.acc + block_total(E, d.hidden);
  l.stats = l.accf + 2 * E;           // mu1, inv1, mu2, inv2 per row
  l.att = l.stats + 4 * R;            // (max, sum, sum dp p) per query
  l.total = l.att + ((3 * d.frames * d.H * d.J + 3) & ~3);
  return l;
}

// The rows of frames [f0, f0 + d.frames) of src (n, J, E) -> dst (d.rows x
// E), zeros past frame n. Plain loads: src may have been written earlier in
// this launch.
__device__ void load_rows(const float* src, float* dst, int f0,
                          const Dims& d) {
  const int real = max(0, min(d.frames, d.n - f0)) * d.J * d.E;
  const float4* s4 =
      reinterpret_cast<const float4*>(src + static_cast<size_t>(f0) * d.J * d.E);
  for (int i = threadIdx.x; i < d.rows * d.E / 4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] =
        4 * i < real ? s4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ void store_rows(const float* src, float* dst, int f0,
                           const Dims& d) {
  const int real = max(0, min(d.frames, d.n - f0)) * d.J * d.E;
  float4* d4 = reinterpret_cast<float4*>(dst + static_cast<size_t>(f0) * d.J * d.E);
  for (int i = threadIdx.x; i < real / 4; i += kThreads)
    d4[i] = reinterpret_cast<const float4*>(src)[i];
}

// layer_norm_rows that also keeps each row's mean and rsqrt(var + eps);
// out == nullptr keeps the statistics only.
__device__ void layer_norm_stats(const float* in, float* out, int rows,
                                 int E, const float* s, const float* b,
                                 float* mu, float* inv) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
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
    if (lane == 0) {
      mu[r] = m;
      inv[r] = iv;
    }
    if (out != nullptr) {
      float* yr = out + r * E;
      for (int k = lane; k < E; k += 32) yr[k] = (xr[k] - m) * iv * s[k] + b[k];
    }
  }
}

// One warp per row: with xh = (x - mu) inv and dxh = dy s,
// g = [g +] inv (dxh - mean(dxh) - xh mean(dxh xh)). g may alias dy.
template <bool ADD>
__device__ void layer_norm_bwd_rows(const float* dy, const float* x,
                                    const float* mu, const float* inv,
                                    const float* s, float* g, int rows,
                                    int E) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    const float* dr = dy + r * E;
    const float* xr = x + r * E;
    const float m = mu[r], iv = inv[r];
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < E; k += 32) {
      const float dxh = dr[k] * s[k];
      s1 += dxh;
      s2 = fmaf(dxh, (xr[k] - m) * iv, s2);
    }
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / E, m2 = s2 / E;
    float* gr = g + r * E;
    for (int k = lane; k < E; k += 32) {
      const float xh = (xr[k] - m) * iv;
      const float v = iv * (dr[k] * s[k] - m1 - xh * m2);
      gr[k] = ADD ? gr[k] + v : v;
    }
  }
}

// acc_b[c] += sum_r dy[r][c] (row stride ncol) over r < rows; with x given,
// acc_s[c] += sum_r dy[r][c] (x[r][c] - mu[r]) inv[r] as well.
__device__ void column_sums(const float* dy, int ncol, int rows, float* acc_b,
                            const float* x = nullptr,
                            const float* mu = nullptr,
                            const float* inv = nullptr,
                            float* acc_s = nullptr) {
  for (int c = threadIdx.x; c < ncol; c += kThreads) {
    float sb = 0.f, ss = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float v = dy[r * ncol + c];
      sb += v;
      if (x != nullptr) ss = fmaf(v, (x[r * ncol + c] - mu[r]) * inv[r], ss);
    }
    acc_b[c] += sb;
    if (x != nullptr) acc_s[c] += ss;
  }
}

enum BwdEpilogue { kSet, kDGelu };

// out[r][c] (row stride nout) = sum_kk a[r][kk] bt[c][kk] for r < rows (a
// multiple of 4), a of row stride k, bt of row stride ldb: the product with
// a weight staged transposed, wt[in][out], gives dX = dY W. kDGelu
// multiplies by GELU'(out[r][c]) in place (out holds the pre-activation).
template <int EPI>
__device__ void dense_nt(const float* a, int k, const float* bt, int ldb,
                         int nout, float* out, int rows) {
  const int col_groups = nout >> 2;
  const int tasks = (rows >> 2) * col_groups;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int r0 = (task / col_groups) * 4, c0 = (task % col_groups) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < k; kk += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a + (r0 + i) * k + kk);
        bv[i] = *reinterpret_cast<const float4*>(bt + (c0 + i) * ldb + kk);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = acc[i][j];
          t = fmaf(av[i].x, bv[j].x, t);
          t = fmaf(av[i].y, bv[j].y, t);
          t = fmaf(av[i].z, bv[j].z, t);
          t = fmaf(av[i].w, bv[j].w, t);
          acc[i][j] = t;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* dst = reinterpret_cast<float4*>(out + (r0 + i) * nout + c0);
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (EPI == kDGelu) {
        const float4 h = *dst;
        v = make_float4(v.x * dgelu(h.x), v.y * dgelu(h.y), v.z * dgelu(h.z),
                        v.w * dgelu(h.w));
      }
      *dst = v;
    }
  }
}

// acc[o][i] (row stride nin) += sum_r dy[r][o] act(x[r][i]) over r < rows,
// act = GELU when GELU_ACT: a weight gradient dW = dY^T act(X).
template <bool GELU_ACT>
__device__ void dense_dw(const float* dy, int ldy, const float* x, int ldx,
                         float* acc, int nout, int nin, int rows) {
  const int col_groups = nin >> 2;
  const int tasks = (nout >> 2) * col_groups;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int o0 = (task / col_groups) * 4, i0 = (task % col_groups) * 4;
    float s[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[p][q] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float4 g = *reinterpret_cast<const float4*>(dy + r * ldy + o0);
      float4 v = *reinterpret_cast<const float4*>(x + r * ldx + i0);
      if (GELU_ACT) v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        s[p][0] = fmaf(gv[p], v.x, s[p][0]);
        s[p][1] = fmaf(gv[p], v.y, s[p][1]);
        s[p][2] = fmaf(gv[p], v.z, s[p][2]);
        s[p][3] = fmaf(gv[p], v.w, s[p][3]);
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float4* dst = reinterpret_cast<float4*>(acc + (o0 + p) * nin + i0);
      const float4 a = *dst;
      *dst = make_float4(a.x + s[p][0], a.y + s[p][1], a.z + s[p][2],
                         a.w + s[p][3]);
    }
  }
}

// Attention backward, first pass: a thread per (frame, head, query i)
// recomputes its softmax row from z (qkv rows), takes dp_ij = do_i . v_j and
// ds_ij = p_ij (dp_ij - sum_j dp_ij p_ij), writes dq_i = scale sum_j ds_ij
// k_j into dz's q columns and keeps (max, sum, sum_j dp_ij p_ij) in att.
__device__ void attention_bwd_rows(const float* z, const float* dout,
                                   float* dz, float* att, const Dims& d) {
  const int E = d.E, J = d.J, hd = E / d.H, ldz = 3 * E;
  const int tasks = d.frames * d.H * J;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int f = task / (d.H * J), rem = task % (d.H * J);
    const int h = rem / J, i = rem % J;
    const float* frame = z + f * J * ldz + h * hd;
    const float* dor = dout + (f * J + i) * E + h * hd;
    float q[kMaxHd];
#pragma unroll
    for (int c = 0; c < kMaxHd; ++c)
      q[c] = c < hd ? frame[i * ldz + c] * d.scale : 0.f;
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
#pragma unroll
        for (int c = 0; c < kMaxHd; ++c)
          if (c < hd) {
            acc = fmaf(q[c], kr[c], acc);
            dacc = fmaf(dor[c], vr[c], dacc);
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
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < J) dp[j] = s[j] * (dp[j] - cdp);  // ds
    float* dst = dz + (f * J + i) * ldz + h * hd;
    for (int c = 0; c < hd; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < J) acc = fmaf(dp[j], frame[j * ldz + E + c], acc);
      dst[c] = acc * d.scale;
    }
    att[3 * task] = m;
    att[3 * task + 1] = sum;
    att[3 * task + 2] = cdp;
  }
}

// Second pass: a thread per (frame, head, key j) recomputes column j of the
// probabilities from att and writes dk_j = sum_i ds_ij (scale q_i) and dv_j
// = sum_i p_ij do_i into dz's k and v columns.
__device__ void attention_bwd_cols(const float* z, const float* dout,
                                   float* dz, const float* att,
                                   const Dims& d) {
  const int E = d.E, J = d.J, hd = E / d.H, ldz = 3 * E;
  const int tasks = d.frames * d.H * J;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int f = task / (d.H * J), rem = task % (d.H * J);
    const int h = rem / J, j = rem % J;
    const float* frame = z + f * J * ldz + h * hd;
    float kj[kMaxHd], vj[kMaxHd], dk[kMaxHd], dv[kMaxHd];
#pragma unroll
    for (int c = 0; c < kMaxHd; ++c) {
      kj[c] = c < hd ? frame[j * ldz + E + c] : 0.f;
      vj[c] = c < hd ? frame[j * ldz + 2 * E + c] : 0.f;
      dk[c] = 0.f;
      dv[c] = 0.f;
    }
    const float* row_att = att + 3 * (task - j);  // query 0 of (f, h)
    for (int i = 0; i < J; ++i) {
      const float* qr = frame + i * ldz;
      const float* dor = dout + (f * J + i) * E + h * hd;
      float acc = 0.f, dacc = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxHd; ++c)
        if (c < hd) {
          acc = fmaf(qr[c] * d.scale, kj[c], acc);
          dacc = fmaf(dor[c], vj[c], dacc);
        }
      const float p = expf(acc - row_att[3 * i]) / row_att[3 * i + 1];
      const float ds = p * (dacc - row_att[3 * i + 2]);
#pragma unroll
      for (int c = 0; c < kMaxHd; ++c)
        if (c < hd) {
          dk[c] = fmaf(ds, qr[c] * d.scale, dk[c]);
          dv[c] = fmaf(p, dor[c], dv[c]);
        }
    }
    float* dst = dz + (f * J + j) * ldz + h * hd;
    for (int c = 0; c < hd; ++c) {
      dst[E + c] = dk[c];
      dst[2 * E + c] = dv[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    spatial_stack_bwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ gout, float* dx,
                             float* xs, float* part, Weights w, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const BwdLayout l = bwd_layout_of(d);
  float *X = smem + l.x, *G = smem + l.g, *Y1 = smem + l.y1,
        *QKV = smem + l.qkv, *O = smem + l.o, *X2 = smem + l.x2,
        *Y2 = smem + l.y2, *Z = smem + l.z;
  float *wqkv = smem + l.wqkv, *wproj = smem + l.wproj,
        *wfc1 = smem + l.wfc1, *wfc2 = smem + l.wfc2, *vec = smem + l.vec;
  float *acc = smem + l.acc, *accf = smem + l.accf, *att = smem + l.att;
  float *mu1 = smem + l.stats, *inv1 = mu1 + d.rows, *mu2 = inv1 + d.rows,
        *inv2 = mu2 + d.rows;
  const int E = d.E, HID = d.hidden, R = d.rows;
  const int groups = (d.n + d.frames - 1) / d.frames;
  const size_t slab = static_cast<size_t>(d.n) * d.J * E;
  int sz[12], off[12];
  block_sizes(E, HID, sz);
  off[0] = 0;
  for (int k = 1; k < 12; ++k) off[k] = off[k - 1] + sz[k - 1];
  const int P = block_total(E, HID);
  float* my_part =
      part + static_cast<size_t>(blockIdx.x) * (d.depth * P + 2 * E);
  // block b's input rows: x for b = 0, else block b - 1's output in xs
  auto block_in = [&](int b) { return b == 0 ? x : xs + (b - 1) * slab; };

  // (a) forward sweep
  for (int b = 0; b < d.depth; ++b) {
    __syncthreads();
    stage_block(w, b, d, wqkv, wproj, wfc1, wfc2, vec);
    for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
      __syncthreads();
      load_rows(block_in(b), X, grp * d.frames, d);
      __syncthreads();
      block_fwd(X, Y1, Z, wqkv, wproj, wfc1, wfc2, vec, d);
      __syncthreads();
      store_rows(X, xs + b * slab, grp * d.frames, d);
    }
  }

  // (b) the final LayerNorm
  for (int i = threadIdx.x; i < 2 * E; i += kThreads) accf[i] = 0.f;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    __syncthreads();
    load_rows(block_in(d.depth), X, grp * d.frames, d);
    load_rows(gout, G, grp * d.frames, d);
    __syncthreads();
    layer_norm_stats(X, nullptr, R, E, nullptr, nullptr, mu1, inv1);
    __syncthreads();
    column_sums(G, E, R, accf + E, X, mu1, inv1, accf);
    __syncthreads();
    layer_norm_bwd_rows<false>(G, X, mu1, inv1, w.lnf_s, G, R, E);
    __syncthreads();
    store_rows(G, dx, grp * d.frames, d);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * E; i += kThreads)
    my_part[d.depth * P + i] = accf[i];

  // (c) reverse sweep
  for (int b = d.depth - 1; b >= 0; --b) {
    __syncthreads();
    stage_block(w, b, d, wqkv, wproj, wfc1, wfc2, vec);
    for (int i = threadIdx.x; i < P; i += kThreads) acc[i] = 0.f;
    for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
      const int f0 = grp * d.frames;
      __syncthreads();
      load_rows(block_in(b), X, f0, d);
      load_rows(dx, G, f0, d);
      __syncthreads();
      // the block's forward residuals
      layer_norm_stats(X, Y1, R, E, vec, vec + E, mu1, inv1);
      for (int i = threadIdx.x; i < R * E; i += kThreads) X2[i] = X[i];
      __syncthreads();
      dense<kStore>(Y1, E, wqkv, 3 * E, vec + 2 * E, QKV, R);
      __syncthreads();
      attention(QKV, O, d);
      __syncthreads();
      dense<kAdd>(O, E, wproj, E, vec + 5 * E, X2, R);
      __syncthreads();
      layer_norm_stats(X2, Y2, R, E, vec + 6 * E, vec + 7 * E, mu2, inv2);
      __syncthreads();
      dense<kStore>(Y2, E, wfc1, HID, vec + 8 * E, Z, R);  // pre-GELU h
      __syncthreads();
      // MLP half: du = G
      dense_dw<true>(G, E, Z, HID, acc + off[10], E, HID, R);
      column_sums(G, E, R, acc + off[11]);
      __syncthreads();
      dense_nt<kDGelu>(G, E, wfc2, E + kWPad, HID, Z, R);  // dh
      __syncthreads();
      dense_dw<false>(Z, HID, Y2, E, acc + off[8], HID, E, R);
      column_sums(Z, HID, R, acc + off[9]);
      __syncthreads();
      dense_nt<kSet>(Z, HID, wfc1, HID + kWPad, E, Y2, R);  // dy2
      __syncthreads();
      column_sums(Y2, E, R, acc + off[7], X2, mu2, inv2, acc + off[6]);
      layer_norm_bwd_rows<true>(Y2, X2, mu2, inv2, vec + 6 * E, G, R, E);
      __syncthreads();
      // attention half: da = G (dx2)
      dense_dw<false>(G, E, O, E, acc + off[4], E, E, R);
      column_sums(G, E, R, acc + off[5]);
      __syncthreads();
      dense_nt<kSet>(G, E, wproj, E + kWPad, E, O, R);  // do
      __syncthreads();
      attention_bwd_rows(QKV, O, Z, att, d);
      __syncthreads();
      attention_bwd_cols(QKV, O, Z, att, d);
      __syncthreads();
      dense_dw<false>(Z, 3 * E, Y1, E, acc + off[2], 3 * E, E, R);
      column_sums(Z, 3 * E, R, acc + off[3]);
      __syncthreads();
      dense_nt<kSet>(Z, 3 * E, wqkv, 3 * E + kWPad, E, O, R);  // dy1
      __syncthreads();
      column_sums(O, E, R, acc + off[1], X, mu1, inv1, acc + off[0]);
      layer_norm_bwd_rows<true>(O, X, mu1, inv1, vec, G, R, E);
      __syncthreads();
      store_rows(G, dx, f0, d);
    }
    __syncthreads();
    for (int k = 0; k < 12; ++k) {
      float* dst = my_part + d.depth * off[k] + b * sz[k];
      for (int i = threadIdx.x; i < sz[k]; i += kThreads)
        dst[i] = acc[off[k] + i];
    }
  }
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

Dims bwd_dims(int n, int J, int E, int H, int hidden, int depth,
              float scale) {
  return Dims{n, J, E, H, hidden, depth, kBwdFrames,
              (kBwdFrames * J + 3) & ~3, scale};
}

bool valid(int J, int E, int H, int hidden, int depth) {
  return J >= 1 && J <= kMaxJ && E >= 4 && E % 4 == 0 && hidden >= 4 &&
         hidden % 4 == 0 && H >= 1 && E % H == 0 && E / H <= kMaxHd &&
         depth >= 0;
}

}  // namespace

extern "C" {

// Shared memory one thread block needs, in bytes (the wrapper checks it
// against the card's limit before launching).
int pv2c_spatial_stack_smem_bytes(int J, int E, int H, int hidden) {
  Dims d{0, J, E, H, hidden, 0, kFrames, (kFrames * J + 3) & ~3, 0.f};
  return static_cast<int>(sizeof(float) * layout_of(d).total);
}

// x, out: (n, J, E) float32 contiguous; the 12 block weights stacked over
// depth in nn.Linear layout (qkv_w (depth, 3E, E), proj_w (depth, E, E),
// fc1_w (depth, hidden, E), fc2_w (depth, E, hidden), vectors (depth, .));
// lnf_s, lnf_b (E,). Requires J <= 32, E and hidden multiples of 4,
// E / H <= 16 and 16-byte aligned pointers. Returns a CUDA error code.
int pv2c_fused_spatial_stack(
    const float* x, float* out, const float* ln1_s, const float* ln1_b,
    const float* qkv_w, const float* qkv_b, const float* proj_w,
    const float* proj_b, const float* ln2_s, const float* ln2_b,
    const float* fc1_w, const float* fc1_b, const float* fc2_w,
    const float* fc2_b, const float* lnf_s, const float* lnf_b, int n, int J,
    int E, int H, int hidden, int depth, float scale, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!valid(J, E, H, hidden, depth))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n, J, E, H, hidden, depth, kFrames, (kFrames * J + 3) & ~3,
               scale};
  const Weights w{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                  ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, lnf_s, lnf_b};
  const int bytes = static_cast<int>(sizeof(float) * layout_of(d).total);
  cudaError_t err = cudaFuncSetAttribute(
      spatial_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_stack_kernel<<<(n + kFrames - 1) / kFrames, kThreads, bytes,
                         stream>>>(x, out, w, d);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one thread block of the backward needs, in bytes.
int pv2c_spatial_stack_bwd_smem_bytes(int J, int E, int H, int hidden) {
  return static_cast<int>(
      sizeof(float) * bwd_layout_of(bwd_dims(0, J, E, H, hidden, 0, 0.f)).total);
}

// The backward's grid on the current device for n frames: one persistent
// thread block per resident slot (at most one per frame group). The wrapper
// sizes `part` with it. Returns minus a CUDA error code on failure.
int pv2c_spatial_stack_bwd_grid(int n, int J, int E, int H, int hidden) {
  const int bytes = pv2c_spatial_stack_bwd_smem_bytes(J, E, H, hidden);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(spatial_stack_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spatial_stack_bwd_kernel, kThreads, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int groups = (n + kBwdFrames - 1) / kBwdFrames;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  return groups < slots ? (groups > 0 ? groups : 1) : slots;
}

// The backward of pv2c_fused_spatial_stack: x, g (the output's cotangent),
// dx (n, J, E); the 14 weights as the forward's; xs (depth, n, J, E) and
// part (grid, total) scratch; grads (total) receives the 14 weight gradients
// flat, each in its weight's layout, in the weights' order (total = depth x
// (4E^2 + 2E hidden + 9E + hidden) + 2E). grid from
// pv2c_spatial_stack_bwd_grid. Two launches (the sweeps, then the fixed-order
// sum of the per-block partial gradients). Returns a CUDA error code.
int pv2c_fused_spatial_stack_bwd(
    const float* x, const float* g, float* dx, const float* ln1_s,
    const float* ln1_b, const float* qkv_w, const float* qkv_b,
    const float* proj_w, const float* proj_b, const float* ln2_s,
    const float* ln2_b, const float* fc1_w, const float* fc1_b,
    const float* fc2_w, const float* fc2_b, const float* lnf_s,
    const float* lnf_b, float* xs, float* part, float* grads, int n, int J,
    int E, int H, int hidden, int depth, int grid, float scale,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!valid(J, E, H, hidden, depth) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = bwd_dims(n, J, E, H, hidden, depth, scale);
  const Weights w{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                  ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, lnf_s, lnf_b};
  const int bytes = static_cast<int>(sizeof(float) * bwd_layout_of(d).total);
  cudaError_t err = cudaFuncSetAttribute(
      spatial_stack_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_stack_bwd_kernel<<<grid, kThreads, bytes, stream>>>(x, g, dx, xs,
                                                              part, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int total = depth * block_total(E, hidden) + 2 * E;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      part, grid, total, grads);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

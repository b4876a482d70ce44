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
  int rows;     // kFrames * J rounded up to a multiple of 4
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
// block's kFrames frames -> o: attention output rows (row stride E).
__device__ void attention(const float* z, float* o, const Dims& d) {
  const int E = d.E, J = d.J, hd = E / d.H, ldz = 3 * E;
  const int tasks = kFrames * d.H * J;
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

__global__ void __launch_bounds__(kThreads)
    spatial_stack_kernel(const float* __restrict__ x, float* __restrict__ out,
                         Weights w, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout_of(d);
  float* X = smem + l.x;
  float* Y = smem + l.y;
  float* Z = smem + l.z;
  float* vec = smem + l.vec;
  const int E = d.E, HID = d.hidden;
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
    stage_transposed(w.qkv_w + static_cast<size_t>(b) * 3 * E * E,
                     smem + l.wqkv, 3 * E, E);
    stage_transposed(w.proj_w + static_cast<size_t>(b) * E * E,
                     smem + l.wproj, E, E);
    stage_transposed(w.fc1_w + static_cast<size_t>(b) * HID * E,
                     smem + l.wfc1, HID, E);
    stage_transposed(w.fc2_w + static_cast<size_t>(b) * E * HID,
                     smem + l.wfc2, E, HID);
    stage(w.ln1_s + b * E, vec, E);
    stage(w.ln1_b + b * E, vec + E, E);
    stage(w.qkv_b + b * 3 * E, vec + 2 * E, 3 * E);
    stage(w.proj_b + b * E, vec + 5 * E, E);
    stage(w.ln2_s + b * E, vec + 6 * E, E);
    stage(w.ln2_b + b * E, vec + 7 * E, E);
    stage(w.fc1_b + b * HID, vec + 8 * E, HID);
    stage(w.fc2_b + b * E, vec + 8 * E + HID, E);
    __syncthreads();
    layer_norm_rows(X, Y, d.rows, E, vec, vec + E);
    __syncthreads();
    dense<kStore>(Y, E, smem + l.wqkv, 3 * E, vec + 2 * E, Z, d.rows);
    __syncthreads();
    attention(Z, Y, d);
    __syncthreads();
    dense<kAdd>(Y, E, smem + l.wproj, E, vec + 5 * E, X, d.rows);
    __syncthreads();
    layer_norm_rows(X, Y, d.rows, E, vec + 6 * E, vec + 7 * E);
    __syncthreads();
    dense<kGelu>(Y, E, smem + l.wfc1, HID, vec + 8 * E, Z, d.rows);
    __syncthreads();
    dense<kAdd>(Z, HID, smem + l.wfc2, E, vec + 8 * E + HID, X, d.rows);
  }
  __syncthreads();
  layer_norm_rows(X, Y, frames * d.J, E, w.lnf_s, w.lnf_b);
  __syncthreads();
  float4* dst =
      reinterpret_cast<float4*>(out + static_cast<size_t>(f0) * d.J * E);
  for (int i = threadIdx.x; i < real / 4; i += kThreads)
    dst[i] = reinterpret_cast<const float4*>(Y)[i];
}

}  // namespace

extern "C" {

// Shared memory one thread block needs, in bytes (the wrapper checks it
// against the card's limit before launching).
int pv2c_spatial_stack_smem_bytes(int J, int E, int H, int hidden) {
  Dims d{0, J, E, H, hidden, 0, (kFrames * J + 3) & ~3, 0.f};
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
  if (J < 1 || J > kMaxJ || E < 4 || E % 4 || hidden < 4 || hidden % 4 ||
      H < 1 || E % H || E / H > kMaxHd || depth < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n, J, E, H, hidden, depth, (kFrames * J + 3) & ~3, scale};
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

}  // extern "C"

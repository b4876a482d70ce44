// PoseFormer's spatial transformer stack: depth x pre-norm block (LayerNorm
// -> packed-qkv multi-head attention -> proj -> residual -> LayerNorm -> fc1
// -> exact GELU -> fc2 -> residual) and the final LayerNorm. Forward in one
// launch, its dense products in 3xTF32 on the tensor cores; backward in
// 2 x depth + 2 launches, fp32 on the CUDA cores. bf16: see below.
//
// Forward: replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas/fused_spatial_transformer.py (`_fused_fwd_impl`, entry
// `fused_spatial_stack`).
//
// Bound on an H100 SXM: operations. At B=256, L=16 the stack sees N = 4096
// frames of J=26 tokens x E=32, 8.40 GFLOP in 4 blocks (6.98 of it the
// dense products, 1.42 attention): 51 us at 165 TFLOP/s, 3xTF32's rate on
// the tensor cores, the card's rate for fp32-accurate products (attention
// runs on the CUDA cores here, 21 us at their 67 TFLOP/s fp32 peak),
// against about 27 MB of activations and weights in and out (8 us at 3.35
// TB/s). Training also writes the backward's residuals, 260 floats a row
// and depth block (1.8 GB at B=1024: 0.53 ms).
//
// Design. A warp owns a frame: its J rows of the residual stream X, of Y
// (LayerNorm output, then attention output) and of Z (qkv, then the MLP
// hidden) stay in shared memory through all depth blocks and the final
// LayerNorm, so the activations are read once and written once, and the
// steps of a block need only __syncwarp(). LayerNorm runs a lane a row; the
// four products as m16n8k8 3xTF32 mma.sync tiles, the frame's rows as two
// m-tiles, A from the resident activations, B from the weights as
// nn.Linear stores them, bias, GELU and the residual add in the epilogue;
// attention a lane a (head, 2 queries) at head width 4, keys and values read
// as float4, scores in registers. A thread block of 4 frames (fewer where
// shared memory is short) stages each depth block's weights once for its
// warps with cp.async, two barriers a depth block, two thread blocks an SM.
// The kernel is compiled twice: head width 4, and any head width up to 32.
// The design before (a thread block of 4 frames, every product a CUDA-core
// 4 x 4 register tile between thread-block barriers, attention a thread a
// (head, query)) spent 45 % of its 0.99 ms in attention, 20 % in
// LayerNorms, 23 % in the products and 10 % staging weights
// (tools/spatial_fwd_split.py).
// LayerNorm uses flax's statistics, var = max(mean(x^2) - mean(x)^2, 0),
// eps 1e-5; GELU is exact (erff). For training the forward also writes,
// per depth block, what the backward needs (see below).
//
// bf16 (the `_bf16` entries): x, the weights, the output, g, dx and the
// weight gradients are bf16 in global memory, as the JAX kernels take and
// give them under bf16 AMP, and each entry has kernels of its own, below
// the float32 ones (sections "Forward, bf16" and "Backward, bf16"). The
// forward runs its four products as bf16 tensor-core tiles on bf16 operands,
// each activation operand rounded to bf16 where the JAX kernel's `_dense`
// casts it, with LayerNorm, attention, GELU, the residual stream and the
// residuals the training forward keeps in float32, as the JAX kernel's; its
// bound at B=256 is its 8.40 GFLOP at bf16's dense 989 TFLOP/s beside 27 MB
// (13.7 at 2 bytes an element). The backward (the JAX kernel's backward dots
// are float32) runs its eight products as fp32-accurate TF32 tensor-core
// tiles (3xTF32, or two passes where the operand is a bf16 weight), keeps
// its running dx in a float32 buffer through the depth blocks and writes dx
// and the gradients (summed in float32) in bf16; its bound at B=1024, L=16
// is its 1.85 GB of traffic (0.553 ms at 3.35 TB/s; 67.18 GFLOP at 3xTF32's
// 165 TFLOP/s take 0.407).
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"
#include "storage.cuh"

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

template <typename S>
struct Weights {
  const S *ln1_s, *ln1_b, *qkv_w, *qkv_b, *proj_w, *proj_b;
  const S *ln2_s, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
  const S *lnf_s, *lnf_b;
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

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * kSqrtHalf));
}

__device__ __forceinline__ float dgelu(float v) {
  return 0.5f * (1.0f + erff(v * kSqrtHalf)) + v * expf(-0.5f * v * v) *
                                                   kInvSqrt2Pi;
}

template <typename S>
__device__ void stage(const S* __restrict__ src, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = ldg1(src + i);
}

// w: [rows][cols] (global) -> [rows][cols + kWPad] (shared), as is.
template <typename S>
__device__ void stage_rows(const S* __restrict__ w, float* dst, int rows,
                           int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads)
    dst[(i / cols) * (cols + kWPad) + i % cols] = ldg1(w + i);
}

__device__ void copy1(const float* src, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

enum Epilogue { kStore, kDGelu };

// The backward's dX products: out[r][o] (row stride nout) = epi(sum_i
// in[r][i] wt[i][o]) for r < rows (a multiple of 4), wt a weight w[out][in]
// staged as is ([out][in + kWPad]), so that the product is dX = dY w;
// kDGelu multiplies it by GELU'(out) (out holds the pre-activation).
// Thread `first` takes the first 4 x 4 task, so that a product can share a
// phase with work on the threads before it.
template <int EPI>
__device__ void dense(const float* in, int k, const float* wt, int nout,
                      float* out, int rows, int first = 0) {
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      float4* dst = reinterpret_cast<float4*>(out + (r0 + i) * nout + c0);
      if (EPI == kDGelu) {
        const float4 h = *dst;
        v = make_float4(v.x * dgelu(h.x), v.y * dgelu(h.y), v.z * dgelu(h.z),
                        v.w * dgelu(h.w));
      }
      *dst = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one warp a frame, the dense products on 3xTF32 tensor cores.

constexpr int kFwdMaxWarps = 8;  // frames (warps) a thread block, at most
constexpr int kNC = 4;           // n-tiles (of 8 columns) a warp sums at once
constexpr int kQB = 2;           // queries a lane holds (head width 4)
constexpr int kKG = 4;           // keys a group (of kMaxJ)
constexpr float kLog2e = 1.44269504088896340736f;

// The forward's widths: the products run on 8-deep k-steps and 8-wide
// n-tiles, so E, 3E and hidden are rounded up to 8 (the weights staged with
// zero rows and columns there, the activations with zero columns); every
// row stride is 4 mod 8 floats, so that a warp's reads of an m16n8k8
// fragment (8 rows x 4 columns) and a lane's float4 reads of its own row
// (8 rows a quarter-warp) hit 32 distinct banks. A shape whose layout would
// not fit in shared memory so (only at the edge of the shapes the kernel
// takes, one frame a thread block) drops those 4 floats of each row, takes
// the bank conflicts, and keeps X and Y at stride E: a product's k-columns
// past E then read the next row's first columns (or, past Y's last row, Z's
// first, zeroed at the start), finite values that meet the weights' zero
// columns, and the residual stores stop at E.
struct FwdDims {
  int n, J, E, H, hidden, depth;
  int frames;    // frames (warps) a thread block
  int ke, kh;    // E and hidden rounded up to 8
  int nq;        // 3E rounded up to 8
  int ldx, ldz;  // row strides of X and Y (ke + 4, or E) and of Z
  int ky;        // columns of X and Y written: ke (zeros past E), or E
  int ldw;       // row stride of the staged qkv_w, proj_w, fc1_w (ke + 4)
  int ldh;       // row stride of the staged fc2_w (kh + 4)
  float qscale;  // hd^-0.5 log2(e): scores in the base-2 domain
};

__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }

constexpr int kMaxSmem = 232448;  // bytes a thread block, on an H100

__host__ __device__ inline int fwd_total(const FwdDims& d);

FwdDims fwd_dims(int n, int J, int E, int H, int hidden, int depth,
                 int frames, float scale) {
  FwdDims d;
  d.n = n;
  d.J = J;
  d.E = E;
  d.H = H;
  d.hidden = hidden;
  d.depth = depth;
  d.frames = frames;
  d.ke = round8(E);
  d.kh = round8(hidden);
  d.nq = round8(3 * E);
  d.qscale = scale * kLog2e;
  for (int pad = 4; pad >= 0; pad -= 4) {
    d.ldx = pad > 0 ? d.ke + pad : E;
    d.ky = pad > 0 ? d.ke : E;
    d.ldw = d.ke + pad;
    d.ldz = (d.nq > d.kh ? d.nq : d.kh) + pad;
    d.ldh = d.kh + pad;
    if (4 * fwd_total(d) <= kMaxSmem) break;
  }
  return d;
}

// Offsets into dynamic shared memory, in floats; each a multiple of 4. Per
// warp (frame) its J rows of X (the residual stream), Y (LayerNorm output,
// then attention output) and Z (qkv, then the MLP hidden); then the depth
// block's weights as nn.Linear stores them ([out][in], rows padded; of
// fc2_w only its E rows, before fc1_w, so that fc2's product columns past E
// read fc1_w's first rows and, like all residual columns past E, are not
// stored), and its vectors. A product reads kMaxJ rows of its A operand
// (two m-tiles),
// and attention kMaxJ rows of keys and values, J of them real: the rows
// past J read the buffer after them (past the last warp's Z, the weights),
// and give rows of the product that are never stored, and keys that are
// masked.
struct FwdLayout {
  int warp;                       // floats a warp
  int wqkv, wproj, wfc1, wfc2;    // the weights
  int vec;                        // ln1_s, ln1_b, qkv_b, proj_b, ln2_s,
                                  // ln2_b, fc1_b, fc2_b (vec_at)
  int total;
};

__host__ __device__ inline FwdLayout fwd_layout(const FwdDims& d) {
  FwdLayout l;
  l.warp = d.J * (2 * d.ldx + d.ldz);
  l.wqkv = d.frames * l.warp;
  l.wproj = l.wqkv + d.nq * d.ldw;
  l.wfc2 = l.wproj + d.ke * d.ldw;
  l.wfc1 = l.wfc2 + d.E * d.ldh;
  l.vec = l.wfc1 + d.kh * d.ldw;
  const int end = l.vec + 6 * d.ke + d.nq + d.kh;
  const int reach = l.wqkv + (kMaxJ - d.J) * d.ldz;
  l.total = end > reach ? end : reach;
  return l;
}

__host__ __device__ inline int fwd_total(const FwdDims& d) {
  return fwd_layout(d).total;
}

// Where each vector of a depth block starts at l.vec (k: 0 ln1_s, 1 ln1_b,
// 2 qkv_b, 3 proj_b, 4 ln2_s, 5 ln2_b, 6 fc1_b, 7 fc2_b).
__host__ __device__ inline int vec_at(const FwdDims& d, int k) {
  const int at[8] = {0, d.ke, 2 * d.ke, 2 * d.ke + d.nq, 3 * d.ke + d.nq,
                     4 * d.ke + d.nq, 5 * d.ke + d.nq,
                     5 * d.ke + d.nq + d.kh};
  return at[k];
}

// w: rows x cols (global, 16-byte aligned, cols a multiple of 4) -> dst
// [rows][ld] (shared), 16 bytes a cp.async; the thread's (row, column)
// stepped on without a division a copy.
__device__ void stage_async(const float* __restrict__ w, float* dst, int rows,
                            int cols, int ld) {
  const int per = cols / 4, step_r = blockDim.x / per,
            step_c = 4 * (blockDim.x % per);
  int r = threadIdx.x / per, c = 4 * (threadIdx.x % per);
  for (; r < rows; r += step_r, c += step_c) {
    if (c >= cols) {
      c -= cols;
      ++r;
      if (r >= rows) break;
    }
    cp_async16(dst + r * ld + c, w + r * cols + c, true);
  }
}

// Stage depth block b's weights and vectors by cp.async (the zero padding is
// set once, before the first block).
__device__ void stage_fwd(const Weights<float>& w, int b, const FwdDims& d,
                          const FwdLayout& l, float* smem) {
  const int E = d.E, HID = d.hidden;
  const size_t bE = static_cast<size_t>(b) * E;
  stage_async(w.qkv_w + bE * 3 * E, smem + l.wqkv, 3 * E, E, d.ldw);
  stage_async(w.proj_w + bE * E, smem + l.wproj, E, E, d.ldw);
  stage_async(w.fc1_w + bE * HID, smem + l.wfc1, HID, E, d.ldw);
  stage_async(w.fc2_w + bE * HID, smem + l.wfc2, E, HID, d.ldh);
  float* v = smem + l.vec;
  stage_async(w.ln1_s + bE, v + vec_at(d, 0), 1, E, 0);
  stage_async(w.ln1_b + bE, v + vec_at(d, 1), 1, E, 0);
  stage_async(w.qkv_b + 3 * bE, v + vec_at(d, 2), 1, 3 * E, 0);
  stage_async(w.proj_b + bE, v + vec_at(d, 3), 1, E, 0);
  stage_async(w.ln2_s + bE, v + vec_at(d, 4), 1, E, 0);
  stage_async(w.ln2_b + bE, v + vec_at(d, 5), 1, E, 0);
  stage_async(w.fc1_b + static_cast<size_t>(b) * HID, v + vec_at(d, 6), 1,
              HID, 0);
  stage_async(w.fc2_b + bE, v + vec_at(d, 7), 1, E, 0);
  cp_async_commit();
  cp_async_wait<0>();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// A lane a row: Y[r][c] = LayerNorm(X[r])[c] s[c] + b[c] for the frame's J
// rows and c < cols (ky in the blocks, where s and b are zero past E, so
// Y's padding stays zero); with mu given, each row's mean and rsqrt(var +
// eps) out as well.
__device__ void ln_lane_rows(const float* X, float* Y, const float* s,
                             const float* b, const FwdDims& d, int cols,
                             float* mu = nullptr, float* inv = nullptr) {
  const int r = threadIdx.x & 31;
  if (r >= d.J) return;
  const float* xr = X + r * d.ldx;
  float sum = 0.f, sq = 0.f;
#pragma unroll 4
  for (int c = 0; c < d.E; c += 4) {
    const float4 v = ld4(xr + c);
    sum += (v.x + v.y) + (v.z + v.w);
    sq = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, sq))));
  }
  const float m = sum / d.E;
  const float iv = rsqrtf(fmaxf(sq / d.E - m * m, 0.f) + kEps);
  if (mu != nullptr) {
    mu[r] = m;
    inv[r] = iv;
  }
  float* yr = Y + r * d.ldx;
#pragma unroll 4
  for (int c = 0; c < cols; c += 4) {
    const float4 v = ld4(xr + c), sc = ld4(s + c), bc = ld4(b + c);
    st4(yr + c, make_float4((v.x - m) * iv * sc.x + bc.x,
                            (v.y - m) * iv * sc.y + bc.y,
                            (v.z - m) * iv * sc.z + bc.z,
                            (v.w - m) * iv * sc.w + bc.w));
  }
}

enum FwdEpilogue { kQkv, kResidual, kHidden };

// The warp's product out[r][c] = epi(sum_k A[r][k] W[c][k] + bias[c]) over
// the frame's rows r < J and the N columns (N and K multiples of 8; W
// staged [N][ldw], A's rows of stride lda) in 3xTF32 on m16n8k8 tiles: the
// frame's two m-tiles and NC n-tiles of 8 columns at a time, branch-free
// inside the k-loop. kQkv stores, kHidden stores GELU of it, kResidual
// adds it to out's columns c < cols. With keep given, the stored value
// (kHidden: before GELU; kResidual: the sum) also goes to keep[r][c] (row
// stride and columns `cols`, the unpadded width).
template <int EPI, int NC>
__device__ void product_cols(const float* A, int lda, int K, const float* W,
                             int ldw, int n0, const float* bias, float* out,
                             int ldo, const FwdDims& d, float* keep,
                             int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[2][NC][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][j][c] = 0.f;
  const float* a = A + g * lda + t;
  const float* w = W + (n0 + g) * ldw + t;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    unsigned ab[2][4], as[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* am = a + 16 * m * lda + k0;
      split_tf32(am[0], ab[m][0], as[m][0]);
      split_tf32(am[8 * lda], ab[m][1], as[m][1]);
      split_tf32(am[4], ab[m][2], as[m][2]);
      split_tf32(am[8 * lda + 4], ab[m][3], as[m][3]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float* wj = w + 8 * j * ldw + k0;
      unsigned bb[2], bs[2];
      split_tf32(wj[0], bb[0], bs[0]);
      split_tf32(wj[4], bb[1], bs[1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma_3xtf32(acc[m][j], ab[m], as[m], bb, bs);
    }
  }
  // the epilogue's arithmetic on every row, its memory on rows < J (and
  // the residual's on columns < cols)
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * m + g + 8 * h;
        const bool real = r < d.J;
        const bool put = real && (EPI != kResidual || c < cols);
        float2 v = make_float2(acc[m][j][2 * h] + b0,
                               acc[m][j][2 * h + 1] + b1);
        float2* o = reinterpret_cast<float2*>(out + r * ldo + c);
        if (EPI == kResidual) {
          const float2 x = put ? *o : make_float2(0.f, 0.f);
          v = make_float2(x.x + v.x, x.y + v.y);
        }
        if (keep != nullptr && c < cols && real)
          *reinterpret_cast<float2*>(keep + r * cols + c) = v;
        if (EPI == kHidden) v = make_float2(gelu(v.x), gelu(v.y));
        if (put) *o = v;
      }
    }
  }
}

// product_cols over all N columns: kNC n-tiles at a time, then one.
template <int EPI>
__device__ void warp_product(const float* A, int lda, int K, const float* W,
                             int ldw, int N, const float* bias, float* out,
                             int ldo, const FwdDims& d, float* keep,
                             int cols) {
  int n0 = 0;
  for (; n0 + 8 * kNC <= N; n0 += 8 * kNC)
    product_cols<EPI, kNC>(A, lda, K, W, ldw, n0, bias, out, ldo, d, keep,
                           cols);
  for (; n0 < N; n0 += 8)
    product_cols<EPI, 1>(A, lda, K, W, ldw, n0, bias, out, ldo, d, keep,
                         cols);
}

__device__ __forceinline__ void st_y(float* p, float4 v) { st4(p, v); }
__device__ __forceinline__ void st_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_y(bf16* p, float4 v) { st4g(p, v); }
__device__ __forceinline__ void st_y(bf16* p, float v) { put(p, v); }

// Attention over one frame: Z holds its rows [q | k | v] (row stride ldz,
// heads in (head, dim) order), the output goes to Y (row stride ldx, or
// ldy where given: the bf16 forward's Y, the output rounded to bf16) and,
// with keep given, to keep (row stride E). HD = 4: a lane takes one head
// and kQB queries, so that each key's and value's float4 serves kQB of
// them, with their scores in registers; HD = 0: any head width, a lane per
// (head, query) and the head's columns in a loop. Scores are taken in the
// base-2 domain (q scaled by hd^-0.5 log2 e) and the softmax's sum divides
// the output.
template <int HD, typename YT = float>
__device__ void attention_warp(const float* Z, YT* Y, const FwdDims& d,
                               float* keep, int ldy = -1) {
  const int lane = threadIdx.x & 31;
  const int ly = ldy < 0 ? d.ldx : ldy;
  const int E = d.E, J = d.J, H = d.H, ldz = d.ldz;
  if constexpr (HD == 4) {
    const int groups = (J + kQB - 1) / kQB;
    for (int task = lane; task < H * groups; task += 32) {
      const int h = task % H, i0 = (task / H) * kQB;
      float4 q[kQB];
#pragma unroll
      for (int u = 0; u < kQB; ++u) {
        const float4 v = i0 + u < J ? ld4(Z + (i0 + u) * ldz + 4 * h)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        q[u] = make_float4(v.x * d.qscale, v.y * d.qscale, v.z * d.qscale,
                           v.w * d.qscale);
      }
      // keys in groups of kKG, the groups past J skipped (a branch the
      // whole warp takes), within a group branch-free: keys past J masked
      // (score -inf, value 0), their rows read from the buffer after Z
      float s[kQB][kMaxJ], m[kQB], sum[kQB];
#pragma unroll
      for (int u = 0; u < kQB; ++u) m[u] = -INFINITY;
#pragma unroll
      for (int j0 = 0; j0 < kMaxJ; j0 += kKG) {
        if (j0 >= J) break;
#pragma unroll
        for (int j = j0; j < j0 + kKG; ++j) {
          const float4 k = ld4(Z + j * ldz + E + 4 * h);
#pragma unroll
          for (int u = 0; u < kQB; ++u) {
            const float sc = fmaf(q[u].x, k.x, fmaf(q[u].y, k.y,
                                  fmaf(q[u].z, k.z, q[u].w * k.w)));
            s[u][j] = j < J ? sc : -INFINITY;
            m[u] = fmaxf(m[u], s[u][j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kQB; ++u) sum[u] = 0.f;
      float4 o[kQB];
#pragma unroll
      for (int u = 0; u < kQB; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j0 = 0; j0 < kMaxJ; j0 += kKG) {
        if (j0 >= J) break;
#pragma unroll
        for (int j = j0; j < j0 + kKG; ++j) {
          float4 v = ld4(Z + j * ldz + 2 * E + 4 * h);
          if (j >= J) v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < kQB; ++u) {
            const float p = exp2f(s[u][j] - m[u]);
            sum[u] += p;
            o[u].x = fmaf(p, v.x, o[u].x);
            o[u].y = fmaf(p, v.y, o[u].y);
            o[u].z = fmaf(p, v.z, o[u].z);
            o[u].w = fmaf(p, v.w, o[u].w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kQB; ++u) {
        const int i = i0 + u;
        if (i >= J) continue;
        const float r = 1.f / sum[u];
        const float4 v = make_float4(o[u].x * r, o[u].y * r, o[u].z * r,
                                     o[u].w * r);
        st_y(Y + i * ly + 4 * h, v);
        if (keep != nullptr) st4(keep + i * E + 4 * h, v);
      }
    }
  } else {
    const int hd = E / H;
    for (int task = lane; task < H * J; task += 32) {
      const int h = task % H, i = task / H;
      const float* qi = Z + i * ldz + h * hd;
      float s[kMaxJ];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        s[j] = 0.f;
        if (j < J) {
          const float* kr = Z + j * ldz + E + h * hd;
          float acc = 0.f;
          for (int c = 0; c < hd; ++c)
            acc = fmaf(qi[c] * d.qscale, kr[c], acc);
          s[j] = acc;
          m = fmaxf(m, acc);
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < J) {
          s[j] = exp2f(s[j] - m);
          sum += s[j];
        }
      const float r = 1.f / sum;
      for (int c = 0; c < hd; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j)
          if (j < J) acc = fmaf(s[j], Z[j * ldz + 2 * E + h * hd + c], acc);
        st_y(Y + i * ly + h * hd + c, acc * r);
        if (keep != nullptr) keep[i * E + h * hd + c] = acc * r;
      }
    }
  }
}

// Where frame f's residuals of depth block b go (Saved, at row f J), or
// all nullptr when serving.
struct FwdKeep {
  float *mu1, *inv1, *qkv, *o, *x2, *mu2, *inv2, *h, *xs;
};

__device__ FwdKeep fwd_keep(const Saved& sv, int b, int f, const FwdDims& d) {
  FwdKeep k{};
  if (sv.qkv == nullptr) return k;
  const size_t M = static_cast<size_t>(d.n) * d.J;
  const size_t at = b * M + static_cast<size_t>(f) * d.J;
  float* st = sv.stats + 4 * b * M + static_cast<size_t>(f) * d.J;
  k.mu1 = st;
  k.inv1 = st + M;
  k.mu2 = st + 2 * M;
  k.inv2 = st + 3 * M;
  k.qkv = sv.qkv + at * 3 * d.E;
  k.o = sv.o + at * d.E;
  k.x2 = sv.x2 + at * d.E;
  k.h = sv.h + at * d.hidden;
  k.xs = sv.xs + at * d.E;
  return k;
}

// One pre-norm block on the warp's frame (X in place; Y, Z scratch), its
// residuals out when keeping; only __syncwarp between the steps.
template <int HD>
__device__ void block_fwd(float* X, float* Y, float* Z, const float* smem,
                          const FwdLayout& l, const FwdDims& d,
                          const FwdKeep& k) {
  const float* v = smem + l.vec;
  ln_lane_rows(X, Y, v + vec_at(d, 0), v + vec_at(d, 1), d, d.ky, k.mu1,
               k.inv1);
  __syncwarp();
  warp_product<kQkv>(Y, d.ldx, d.ke, smem + l.wqkv, d.ldw, d.nq,
                     v + vec_at(d, 2), Z, d.ldz, d, k.qkv, 3 * d.E);
  __syncwarp();
  attention_warp<HD>(Z, Y, d, k.o);
  __syncwarp();
  warp_product<kResidual>(Y, d.ldx, d.ke, smem + l.wproj, d.ldw, d.ke,
                          v + vec_at(d, 3), X, d.ldx, d, k.x2, d.E);
  __syncwarp();
  ln_lane_rows(X, Y, v + vec_at(d, 4), v + vec_at(d, 5), d, d.ky, k.mu2,
               k.inv2);
  __syncwarp();
  warp_product<kHidden>(Y, d.ldx, d.ke, smem + l.wfc1, d.ldw, d.kh,
                        v + vec_at(d, 6), Z, d.ldz, d, k.h, d.hidden);
  __syncwarp();
  warp_product<kResidual>(Z, d.ldz, d.kh, smem + l.wfc2, d.ldh, d.ke,
                          v + vec_at(d, 7), X, d.ldx, d, k.xs, d.E);
  __syncwarp();
}

// A thread block of d.frames warps, a frame each; the depth blocks' weights
// staged in turn, shared by the warps.
template <int HD>
__global__ void __launch_bounds__(kFwdMaxWarps * 32)
    spatial_stack_kernel(const float* __restrict__ x, float* __restrict__ out,
                         Weights<float> w, Saved sv, FwdDims d) {
  extern __shared__ __align__(16) float smem[];
  const FwdLayout l = fwd_layout(d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * d.frames + warp;
  const bool live = f < d.n;
  float* X = smem + warp * l.warp;
  float* Y = X + d.J * d.ldx;
  float* Z = Y + d.J * d.ldx;
  const int E = d.E, J = d.J, per = d.ky / 4;

  // the weights' and vectors' zero padding, once
  for (int i = l.wqkv + threadIdx.x; i < l.total; i += blockDim.x)
    smem[i] = 0.f;
  if (lane < d.ke - d.ky) Z[lane] = 0.f;  // read past Y's last row
  if (live) {
    const float* src = x + static_cast<size_t>(f) * J * E;
    for (int i = lane; i < J * per; i += 32) {
      const int r = i / per, c = 4 * (i % per);
      st4(X + r * d.ldx + c,
          c < E ? ldg4(src + r * E + c) : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
  __syncwarp();

  for (int b = 0; b < d.depth; ++b) {
    __syncthreads();  // every warp is done with the previous weights
    stage_fwd(w, b, d, l, smem);
    __syncthreads();
    if (live) block_fwd<HD>(X, Y, Z, smem, l, d, fwd_keep(sv, b, f, d));
  }
  // the final LayerNorm to Y (its vectors read from global memory), then
  // out coalesced
  if (!live) return;
  ln_lane_rows(X, Y, w.lnf_s, w.lnf_b, d, E);
  __syncwarp();
  float* dst = out + static_cast<size_t>(f) * J * E;
  for (int i = lane; i < J * (E / 4); i += 32) {
    const int r = i / (E / 4), c = 4 * (i % (E / 4));
    st4g(dst + r * E + c, ld4(Y + r * d.ldx + c));
  }
}

// ---------------------------------------------------------------------------
// Forward, bf16: the `_bf16` entry's kernel. A warp a frame, as the float32
// forward, but its four products are bf16 mma.sync m16n8k16 tiles: bf16
// operands, fp32 sums in the tensor cores, which is the JAX kernel's `_dense`
// on bf16 operands up to the order of the sums. Each product's operands are
// bf16 in shared memory: the weights as the caller gives them (copied by
// cp.async, not widened), and the activation operands rounded to bf16 where
// `_dense` casts them, once, as they are stored (LN1's and LN2's outputs and
// the attention output in Y, GELU's output in G over Z's qkv once attention
// is done). The residual stream X, qkv, h, the LayerNorm statistics and the
// attention stay float32, as in the JAX kernel's `_block_fwd`, and so do the
// residuals the training forward keeps. At PoseFormer's widths a frame takes
// 16.2 KB (17.9 in the float32 layout) and a depth block's weights 20 KB
// (36): five frames a thread block, two thread blocks an SM (registers
// capped to keep two), where the float32 layout fits four. The frame's 26
// rows still fill two m-tiles of 16: 6 of 32 rows of each product are not
// stored.
//
// Widths: the k-steps are 16 deep, so E and hidden are rounded up to 16 (ke,
// kh; the weights' and activations' extra columns zero) and 3E to 8 (nq).
// Row strides: bf16 rows of ke + 8 and kh + 8 elements (20 and 36 words at
// PoseFormer's widths, so that a fragment's eight rows of four words hit 32
// banks), float32 rows of ke + 4 (X) and of nq + 4 or more (Z).

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Frames (warps) a thread block, at most: two thread blocks of 5 warps an SM
// keep 204 registers a thread.
constexpr int kBfMaxFrames = 5;

struct BfDims : FwdDims {
  int ldy;  // Y's row stride, bf16 elements (ke + 8)
  int ldg;  // G's row stride (GELU's output, over Z), bf16 elements (kh + 8)
};

BfDims bf_dims(int n, int J, int E, int H, int hidden, int depth, int frames,
               float scale) {
  BfDims d;
  d.n = n;
  d.J = J;
  d.E = E;
  d.H = H;
  d.hidden = hidden;
  d.depth = depth;
  d.frames = frames;
  d.ke = round16(E);
  d.kh = round16(hidden);
  d.nq = round8(3 * E);
  d.ky = d.ke;
  d.ldx = d.ke + 4;
  d.ldy = d.ke + 8;
  d.ldg = d.kh + 8;
  d.ldz = d.nq + 4 > d.ldg / 2 ? d.nq + 4 : d.ldg / 2;
  d.ldw = d.ke + 8;  // qkv_w, proj_w, fc1_w rows, bf16 elements
  d.ldh = d.kh + 8;  // fc2_w rows, bf16 elements
  d.qscale = scale * kLog2e;
  return d;
}

// Offsets into dynamic shared memory, in floats (bf16 regions take half a
// float an element), each a multiple of 4. Per warp (frame) its J rows of X,
// Y and Z; then the depth block's weights as nn.Linear stores them, rows
// padded, and its vectors in float32 (vec_at). A product reads kMaxJ rows of
// its A operand and attention kMaxJ rows of keys and values, J of them real:
// the rows past J read the buffer after them (past the last warp's Z, the
// weights), and give rows of the product that are never stored, and keys
// that are masked.
struct BfLayout {
  int y, z, warp;                // a warp's Y and Z after its X, its size
  int wqkv, wproj, wfc1, wfc2;   // the weights
  int vec;
  int total;
};

__host__ __device__ inline BfLayout bf_layout(const BfDims& d) {
  BfLayout l;
  l.y = d.J * d.ldx;
  l.z = l.y + d.J * d.ldy / 2;
  l.warp = l.z + d.J * d.ldz;
  l.wqkv = d.frames * l.warp;
  l.wproj = l.wqkv + d.nq * d.ldw / 2;
  l.wfc1 = l.wproj + d.ke * d.ldw / 2;
  l.wfc2 = l.wfc1 + d.kh * d.ldw / 2;
  l.vec = l.wfc2 + d.ke * d.ldh / 2;
  const int end = l.vec + 6 * d.ke + d.nq + d.kh;
  const int reach = l.wqkv + (kMaxJ - d.J) * d.ldz;
  l.total = end > reach ? end : reach;
  return l;
}

// w: rows x cols bf16 (global, cols a multiple of 4) -> dst [rows][ld]
// (shared), 8 bytes a cp.async.
__device__ void stage_bf(const bf16* __restrict__ w, bf16* dst, int rows,
                         int cols, int ld) {
  const int per = cols / 4;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = 4 * (i % per);
    cp_async8(dst + r * ld + c, w + r * cols + c, true);
  }
}

__device__ void stage_widen1(const bf16* __restrict__ v, float* dst,
                             int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = ldg1(v + i);
}

// Stage depth block b's weights (bf16, as they are) and vectors (widened).
__device__ void stage_fwd_bf16(const Weights<bf16>& w, int b, const BfDims& d,
                               const BfLayout& l, float* smem) {
  const int E = d.E, HID = d.hidden;
  const size_t bE = static_cast<size_t>(b) * E;
  bf16* s = reinterpret_cast<bf16*>(smem);
  stage_bf(w.qkv_w + bE * 3 * E, s + 2 * l.wqkv, 3 * E, E, d.ldw);
  stage_bf(w.proj_w + bE * E, s + 2 * l.wproj, E, E, d.ldw);
  stage_bf(w.fc1_w + bE * HID, s + 2 * l.wfc1, HID, E, d.ldw);
  stage_bf(w.fc2_w + bE * HID, s + 2 * l.wfc2, E, HID, d.ldh);
  cp_async_commit();
  float* v = smem + l.vec;
  stage_widen1(w.ln1_s + bE, v + vec_at(d, 0), E);
  stage_widen1(w.ln1_b + bE, v + vec_at(d, 1), E);
  stage_widen1(w.qkv_b + 3 * bE, v + vec_at(d, 2), 3 * E);
  stage_widen1(w.proj_b + bE, v + vec_at(d, 3), E);
  stage_widen1(w.ln2_s + bE, v + vec_at(d, 4), E);
  stage_widen1(w.ln2_b + bE, v + vec_at(d, 5), E);
  stage_widen1(w.fc1_b + static_cast<size_t>(b) * HID, v + vec_at(d, 6), HID);
  stage_widen1(w.fc2_b + bE, v + vec_at(d, 7), E);
  cp_async_wait<0>();
}

__device__ __forceinline__ float4 vec4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 vec4(const bf16* p) { return ldg4(p); }

// A lane a row: Y[r][c] (bf16) = LayerNorm(X[r])[c] s[c] + b[c] for the
// frame's J rows and c < cols, rounded to bf16; s and b staged (float32,
// zero past E, so that Y's extra columns stay zero) or the final
// LayerNorm's in global memory (bf16); with mu given, each row's mean and
// rsqrt(var + eps) out as well.
template <typename V>
__device__ void ln_rows_bf16(const float* X, bf16* Y, const V* s, const V* b,
                             const BfDims& d, int cols, float* mu = nullptr,
                             float* inv = nullptr) {
  const int r = threadIdx.x & 31;
  if (r >= d.J) return;
  const float* xr = X + r * d.ldx;
  float sum = 0.f, sq = 0.f;
#pragma unroll 4
  for (int c = 0; c < d.E; c += 4) {
    const float4 v = ld4(xr + c);
    sum += (v.x + v.y) + (v.z + v.w);
    sq = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, sq))));
  }
  const float m = sum / d.E;
  const float iv = rsqrtf(fmaxf(sq / d.E - m * m, 0.f) + kEps);
  if (mu != nullptr) {
    mu[r] = m;
    inv[r] = iv;
  }
  bf16* yr = Y + r * d.ldy;
#pragma unroll 4
  for (int c = 0; c < cols; c += 4) {
    const float4 v = ld4(xr + c), sc = vec4(s + c), bc = vec4(b + c);
    st4g(yr + c, make_float4((v.x - m) * iv * sc.x + bc.x,
                             (v.y - m) * iv * sc.y + bc.y,
                             (v.z - m) * iv * sc.z + bc.z,
                             (v.w - m) * iv * sc.w + bc.w));
  }
}

enum BfEpilogue { kBfStore, kBfResidual, kBfGelu };

// The warp's product out[r][c] = epi(sum_k A[r][k] W[c][k] + bias[c]) over
// the frame's rows r < J and the columns of NC n-tiles from n0 (N and K
// multiples of 8 and 16; A and W bf16, rows of lda and ldw elements, W as
// nn.Linear stores it), in bf16 m16n8k16 tiles: the frame's two m-tiles.
// kBfStore stores into the float32 out (row stride ldo), kBfResidual adds
// into it at columns c < cols, kBfGelu stores GELU of it into the bf16 out,
// rounded. With keep given, the value before GELU (kBfResidual: the sum)
// also goes to keep[r][c] (row stride and columns `cols`).
template <int EPI, int NC>
__device__ void product_bf16(const bf16* A, int lda, int K, const bf16* W,
                             int ldw, int n0, const float* bias, void* out,
                             int ldo, const FwdDims& d, float* keep,
                             int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[2][NC][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][j][c] = 0.f;
  const int la = lda / 2, lw = ldw / 2;  // row strides in words
  const unsigned* a =
      reinterpret_cast<const unsigned*>(A) + g * la + t;
  const unsigned* w =
      reinterpret_cast<const unsigned*>(W) + (n0 + g) * lw + t;
#pragma unroll 2
  for (int k0 = 0; k0 < K / 2; k0 += 8) {  // 16 elements, 8 words a step
    unsigned ab[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const unsigned* am = a + 16 * m * la + k0;
      ab[m][0] = am[0];
      ab[m][1] = am[8 * la];
      ab[m][2] = am[4];
      ab[m][3] = am[8 * la + 4];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const unsigned* wj = w + 8 * j * lw + k0;
      const unsigned bb[2] = {wj[0], wj[4]};
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[m][j], ab[m], bb);
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * m + g + 8 * h;
        const bool real = r < d.J;
        const bool put = real && (EPI != kBfResidual || c < cols);
        float2 v = make_float2(acc[m][j][2 * h] + b0,
                               acc[m][j][2 * h + 1] + b1);
        if (EPI == kBfResidual) {
          const float2 x = put ? *reinterpret_cast<const float2*>(
                                     static_cast<float*>(out) + r * ldo + c)
                               : make_float2(0.f, 0.f);
          v = make_float2(x.x + v.x, x.y + v.y);
        }
        if (keep != nullptr && c < cols && real)
          *reinterpret_cast<float2*>(keep + r * cols + c) = v;
        if (!put) continue;
        if (EPI == kBfGelu)
          *reinterpret_cast<unsigned*>(static_cast<bf16*>(out) + r * ldo +
                                       c) = pack2(gelu(v.x), gelu(v.y));
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + r * ldo +
                                     c) = v;
      }
    }
  }
}

// product_bf16 over all N columns: kNC n-tiles at a time, then one.
template <int EPI>
__device__ void warp_product_bf16(const bf16* A, int lda, int K,
                                  const bf16* W, int ldw, int N,
                                  const float* bias, void* out, int ldo,
                                  const FwdDims& d, float* keep, int cols) {
  int n0 = 0;
  for (; n0 + 8 * kNC <= N; n0 += 8 * kNC)
    product_bf16<EPI, kNC>(A, lda, K, W, ldw, n0, bias, out, ldo, d, keep,
                           cols);
  for (; n0 < N; n0 += 8)
    product_bf16<EPI, 1>(A, lda, K, W, ldw, n0, bias, out, ldo, d, keep,
                         cols);
}

// One pre-norm block on the warp's frame (X in place; Y, Z and G over Z
// scratch), its residuals out when keeping; only __syncwarp between the
// steps.
template <int HD>
__device__ void block_fwd_bf16(float* X, bf16* Y, float* Z, const float* smem,
                               const BfLayout& l, const BfDims& d,
                               const FwdKeep& k) {
  const float* v = smem + l.vec;
  const bf16* w = reinterpret_cast<const bf16*>(smem);
  bf16* G = reinterpret_cast<bf16*>(Z);
  ln_rows_bf16(X, Y, v + vec_at(d, 0), v + vec_at(d, 1), d, d.ke, k.mu1,
               k.inv1);
  __syncwarp();
  warp_product_bf16<kBfStore>(Y, d.ldy, d.ke, w + 2 * l.wqkv, d.ldw, d.nq,
                              v + vec_at(d, 2), Z, d.ldz, d, k.qkv, 3 * d.E);
  __syncwarp();
  attention_warp<HD>(Z, Y, d, k.o, d.ldy);
  __syncwarp();
  warp_product_bf16<kBfResidual>(Y, d.ldy, d.ke, w + 2 * l.wproj, d.ldw,
                                 d.ke, v + vec_at(d, 3), X, d.ldx, d, k.x2,
                                 d.E);
  __syncwarp();
  ln_rows_bf16(X, Y, v + vec_at(d, 4), v + vec_at(d, 5), d, d.ke, k.mu2,
               k.inv2);
  __syncwarp();
  warp_product_bf16<kBfGelu>(Y, d.ldy, d.ke, w + 2 * l.wfc1, d.ldw, d.kh,
                             v + vec_at(d, 6), G, d.ldg, d, k.h, d.hidden);
  __syncwarp();
  warp_product_bf16<kBfResidual>(G, d.ldg, d.kh, w + 2 * l.wfc2, d.ldh, d.ke,
                                 v + vec_at(d, 7), X, d.ldx, d, k.xs, d.E);
  __syncwarp();
}

// A thread block of d.frames warps, a frame each; the depth blocks' weights
// staged in turn, shared by the warps; the final LayerNorm's vectors read
// from global memory.
template <int HD>
__global__ void __launch_bounds__(kBfMaxFrames * 32, 2)
    spatial_stack_bf16_kernel(const bf16* __restrict__ x,
                              bf16* __restrict__ out, Weights<bf16> w,
                              Saved sv, BfDims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const BfLayout l = bf_layout(d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * d.frames + warp;
  const bool live = f < d.n;
  float* X = smem + warp * l.warp;
  bf16* Y = reinterpret_cast<bf16*>(X + l.y);
  float* Z = X + l.z;
  const int E = d.E, J = d.J, per = d.ke / 4;

  // the weights' and vectors' zero padding, once
  for (int i = l.wqkv + threadIdx.x; i < l.total; i += blockDim.x)
    smem[i] = 0.f;
  if (live) {
    const bf16* src = x + static_cast<size_t>(f) * J * E;
    for (int i = lane; i < J * per; i += 32) {
      const int r = i / per, c = 4 * (i % per);
      st4(X + r * d.ldx + c,
          c < E ? ldg4(src + r * E + c) : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
  __syncwarp();

  for (int b = 0; b < d.depth; ++b) {
    __syncthreads();  // every warp is done with the previous weights
    stage_fwd_bf16(w, b, d, l, smem);
    __syncthreads();
    if (live) block_fwd_bf16<HD>(X, Y, Z, smem, l, d, fwd_keep(sv, b, f, d));
  }
  if (!live) return;
  ln_rows_bf16(X, Y, w.lnf_s, w.lnf_b, d, E);
  __syncwarp();
  bf16* dst = out + static_cast<size_t>(f) * J * E;
  for (int i = lane; i < J * (E / 4); i += 32) {
    const int r = i / (E / 4), c = 4 * (i % (E / 4));
    *reinterpret_cast<uint2*>(dst + r * E + c) =
        *reinterpret_cast<const uint2*>(Y + r * d.ldy + c);
  }
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

template <typename S>
struct BwdArgs {
  const S *x, *g;      // the forward's input and the output's cotangent
  float* dx;           // the running gradient, in place (float32)
  Weights<S> w;
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
template <typename T>
__device__ void load_normalised(const T* x, const float* mu,
                                const float* inv_g, float* xh, float* inv,
                                int R, int real, int E) {
  for (int i = threadIdx.x; i < R * E; i += kThreads) {
    const int r = i / E;
    xh[i] = r < real ? (to_f(x[i]) - mu[r]) * inv_g[r] : 0.f;
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
template <typename S>
__global__ void __launch_bounds__(kThreads)
    spatial_final_ln_bwd_kernel(BwdArgs<S> a, Dims d) {
  __shared__ float red[kWarps * 2 * kMaxE];
  const int E = d.E, lane = threadIdx.x & 31;
  const size_t M = static_cast<size_t>(d.n) * d.J;
  // the stack's last residual stream: the last block's output (float32),
  // or x at depth 0
  const float* xs_last =
      d.depth > 0 ? a.sv.xs + static_cast<size_t>(d.depth - 1) * M * E
                  : nullptr;
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
        xv[j] = xs_last != nullptr ? xs_last[r * E + k] : to_f(a.x[r * E + k]);
        gv[j] = to_f(a.g[r * E + k]);
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
        const float e = gv[j] * to_f(a.w.lnf_s[k]);
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
        a.dx[r * E + k] =
            iv * (gv[j] * to_f(a.w.lnf_s[k]) - m1 - xv[j] * m2);
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
    spatial_mlp_bwd_kernel(BwdArgs<float> a, Dims d, int b) {
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
    dense<kDGelu>(G, E, w2, HID, Hs, R);  // dh
    __syncthreads();
    dense_dw<true>(Hs, HID, XH, E, dW1, HID, E, R, db1, vec, vec + E);
    dense<kStore>(Hs, HID, w1, E, A, R);  // dy2
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
    spatial_attn_bwd_kernel(BwdArgs<float> a, Dims d, int b) {
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
  // the block's input: the previous block's output (float32), or x
  const float* xin = b > 0 ? a.sv.xs + (b - 1) * M * E : nullptr;
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
    if (xin != nullptr)
      load_normalised(xin + r0 * E, mu1 + r0, inv1 + r0, XH, inv, R, real, E);
    else
      load_normalised(a.x + r0 * E, mu1 + r0, inv1 + r0, XH, inv, R, real,
                      E);
    __syncthreads();
    // dWp on the first 128 threads (E = 32), do on those after them
    dense_dw<false>(DX2, E, O, E, dWp, E, E, R, dbp);
    dense<kStore>(DX2, E, wp, E, DO, R, E * E / 8);
    __syncthreads();
    attention_bwd_rows<HD>(QKV, DO, DQKV, att, d);
    __syncthreads();
    attention_bwd_cols<HD>(QKV, DO, DQKV, att, d);
    __syncthreads();
    dense_dw<true>(DQKV, 3 * E, XH, E, dWqkv, 3 * E, E, R, dbqkv, vec,
                   vec + E);
    dense<kStore>(DQKV, 3 * E, wq, E, O, R, E * E / 8);  // dy1
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
template <typename S>
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       int parts, int len,
                                       S* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[static_cast<size_t>(p) * len + e];
  put(out + e, s);
}

// ---------------------------------------------------------------------------
// Backward, bf16: the `_bf16` entry's kernels. The launches, tiles and
// arithmetic of the float32 backward above, with its eight products a
// depth block on the tensor cores, fp32-accurate as the JAX kernel's
// backward dots are (fp32 x fp32; no product here has a bf16 operand):
//   the dW products (dW2, dW1, dWp, dWqkv: dW = dY^T act, summed over the
//   tile's rows) in 3xTF32, both float32 operands split into a TF32 big
//   part and a TF32 remainder (mma_tf32.cuh);
//   the dX products (dh = du W2, dy2 = dh W1, do = dx2 Wp, dy1 = dqkv
//   Wqkv) in two TF32 passes: the weight is bf16, exact in TF32, so only
//   the float32 activation is split.
// Both are mma.sync m16n8k8 tiles whose fragments are read from shared
// memory in the order the product needs: a dW product reduces over the
// tile's rows, so both its operands are MN-major (TF32 wgmma takes only
// K-major operands), and mma.sync's fragments take dY^T and act from their
// row-major tiles as they are, with no transpose. A warp takes a task: a
// 16-row m-tile and up to kTcNc n-tiles of 8 columns of one product, over
// the whole reduced dimension: the big parts' product and each small-part
// product (the tiny fourth term of a full split, small x small, dropped as
// 3xTF32 drops it) summed over the tile in independent chains of
// tensor-core sums, which lose about K x 2^-24 of their magnitude (K the
// tile's 112 rows or a width), then added in fp32. The dW product and the dX
// product that read the same operands share a barrier-free phase, their
// tasks dealt to the warps in turn. A dW task adds its sums to the thread
// block's own row of `part` (in L2: one owner an element, in tile order;
// its bias sums from its A fragments' float32 values, its first n-group's
// warp), which the last launch sums in a fixed order as in the float32
// backward: no atomics, the same bits on every launch. The attention
// backward and the LayerNorm backwards stay on the CUDA cores.
//
// Layouts: the products' activations have rows of their width rounded up
// to 8, plus 4 floats (36 at E=32: an m16n8k8 A fragment read row-major
// hits 32 banks, read as dY^T two lanes a bank), zero past the width; the
// weights stay bf16 (read as B[k][n], n contiguous, in rows of 8 mod 16
// elements), zero past their width and height. So the widest shapes the
// float32 backward takes fit at a tile of 16 rows, and PoseFormer's MLP
// half takes 112 rows, its attention half 2 frames (52 rows in 64), two
// thread blocks an SM. The MLP half's tile is a multiple of 16 rows; the
// attention half's frames are padded to a multiple of 16 rows with zero
// rows. The attention passes read qkv and do at the float32 backward's
// strides (3E, E); at head width 4 (PoseFormer's) they are this file's own
// (a thread per pair of queries or keys, float4 reads) and write dqkv at
// the products' stride, else they are the float32 backward's and dqkv is
// copied to qkv's place at the products' stride.

constexpr int kTcNc = 2;  // n-tiles a task

__host__ __device__ inline int act_ld(int w) { return round8(w) + 4; }

// A staged weight's row stride in bf16 elements: its width rounded up to
// 8, and to 8 mod 16.
__host__ __device__ inline int wt_ld(int n) {
  const int r = round8(n);
  return r % 16 == 0 ? r + 8 : r;
}

// MLP half, tensor cores: offsets into dynamic shared memory, in floats.
struct MlpTcLayout {
  int g, h, a, xh, mu, inv, w2, w1, vec, lnred, total;
};

__host__ __device__ inline MlpTcLayout mlp_tc_layout(int R, int E, int hid) {
  MlpTcLayout l;
  const int le = act_ld(E), lh = act_ld(hid);
  l.g = 0;                             // du, R x le
  l.h = l.g + R * le;                  // h, then dh, R x lh
  l.a = l.h + R * lh;                  // gelu(h) (lh), then dy2 (le)
  l.xh = l.a + R * (lh > le ? lh : le);  // x2, then normalised, R x le
  l.mu = l.xh + R * le;                // LN2's mean and rsqrt(var + eps)
  l.inv = l.mu + pad4(R);
  l.w2 = l.inv + pad4(R);              // fc2_w as B[e][j], bf16
  l.w1 = l.w2 + round8(E) * wt_ld(hid) / 2;  // fc1_w as B[j][e], bf16
  l.vec = l.w1 + round8(hid) * wt_ld(E) / 2;  // ln2_s, ln2_b
  l.lnred = l.vec + 2 * round8(E);
  l.total = l.lnred + kWarps * 2 * E;
  return l;
}

// Attention half, tensor cores: offsets into dynamic shared memory, in
// floats; R = F J rounded up to 16.
struct AttnTcLayout {
  int dx2, o, dout, qkv, dqkv, xh, mu, inv, att, wp, wq, vec, lnred, total;
};

__host__ __device__ inline AttnTcLayout attn_tc_layout(int R, int F, int E,
                                                       int H, int J) {
  AttnTcLayout l;
  const int le = act_ld(E), lq = act_ld(3 * E);
  l.dx2 = 0;                           // dx2, R x le
  l.o = l.dx2 + R * le;                // attention out, R x le
  l.dout = l.o + R * le;               // do, then dy1, R x E
  l.qkv = l.dout + R * E;              // qkv (3E), then dqkv (lq)
  l.dqkv = l.qkv + R * lq;             // dqkv, R x lq (3E at HD 0)
  l.xh = l.dqkv + R * lq;              // the block input, normalised
  l.mu = l.xh + R * le;                // LN1's mean and rsqrt(var + eps)
  l.inv = l.mu + pad4(R);
  l.att = l.inv + pad4(R);
  l.wp = l.att + pad4(3 * F * H * J);  // proj_w as B[o][i], bf16
  l.wq = l.wp + round8(E) * wt_ld(E) / 2;  // qkv_w as B[c][i], bf16
  l.vec = l.wq + round8(3 * E) * wt_ld(E) / 2;  // ln1_s, ln1_b
  l.lnred = l.vec + 2 * round8(E);
  l.total = l.lnred + kWarps * 2 * E;
  return l;
}

// w: rows x cols bf16 (global, cols a multiple of 4) -> dst [rows][ld]
// (shared, bf16), 8 bytes a cp.async, committed; the padding around it is
// zero already.
__device__ void stage_bf16_rows(const bf16* __restrict__ w, bf16* dst,
                                int rows, int cols, int ld) {
  const int per = cols / 4;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = 4 * (i % per);
    cp_async8(dst + r * ld + c, w + r * cols + c, true);
  }
  cp_async_commit();
}

// rows of src (width w, float32) -> dst [R][ld], zeros past column w and
// past row `real`; 16-byte cp.async, committed.
__device__ void load_rows_async(const float* src, float* dst, int R,
                                int real, int w, int ld) {
  const int per = ld / 4;
  for (int i = threadIdx.x; i < R * per; i += kThreads) {
    const int r = i / per, c = 4 * (i % per);
    const bool ok = r < real && c < w;
    cp_async16(dst + r * ld + c, ok ? src + r * w + c : src, ok);
  }
  cp_async_commit();
}

// rows of x (width E, float32) -> xh [R][ld] and their saved statistics
// -> mu, inv by cp.async, zeros past column E and row `real`, committed;
// normalise_rows then normalises xh in place.
__device__ void load_stats_rows_async(const float* x, const float* mu_g,
                                      const float* inv_g, float* xh,
                                      float* mu, float* inv, int R, int real,
                                      int E, int ld) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    cp_async4(mu + r, r < real ? mu_g + r : mu_g, r < real);
    cp_async4(inv + r, r < real ? inv_g + r : inv_g, r < real);
  }
  load_rows_async(x, xh, R, real, E, ld);
}

// xh[r][c] = (xh[r][c] - mu[r]) inv[r] for c < E: a warp a row.
__device__ void normalise_rows(float* xh, const float* mu, const float* inv,
                               int R, int E, int ld) {
  for (int r = threadIdx.x >> 5; r < R; r += kWarps)
    for (int c = threadIdx.x & 31; c < E; c += 32)
      xh[r * ld + c] = (xh[r * ld + c] - mu[r]) * inv[r];
}

// rows of x (width E) normalised with the saved statistics -> xh [R][ld],
// zeros past column E and row `real`, and each row's inv.
template <typename T>
__device__ void load_normalised_ld(const T* x, const float* mu,
                                   const float* inv_g, float* xh, float* inv,
                                   int R, int real, int E, int ld) {
  for (int i = threadIdx.x; i < R * ld; i += kThreads) {
    const int r = i / ld, c = i % ld;
    xh[i] = r < real && c < E ? (to_f(x[r * E + c]) - mu[r]) * inv_g[r]
                              : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads)
    inv[r] = r < real ? inv_g[r] : 0.f;
}

// ln_bwd_rows with the rows of dy at stride ldy and of xh and res at
// stride ld (out, global, at stride E), two rows a warp at a time (rows
// warp + 2 kWarps i and warp + 2 kWarps i + kWarps), so that their
// shuffles overlap.
__device__ void ln_bwd_rows_ld(const float* dy, int ldy, const float* xh,
                               const float* inv, const float* s,
                               const float* res, int ld, float* out,
                               int real, int E, float* ps, float* pb) {
  const int lane = threadIdx.x & 31;
  for (int r0 = threadIdx.x >> 5; r0 < real; r0 += 2 * kWarps) {
    float dv[2][kCols], xv[2][kCols], s1[2], s2[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * kWarps;
      s1[u] = s2[u] = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k = lane + 32 * j;
        dv[u][j] = xv[u][j] = 0.f;
        if (k < E && r < real) {
          dv[u][j] = dy[r * ldy + k];
          xv[u][j] = xh[r * ld + k];
          const float e = dv[u][j] * s[k];
          s1[u] += e;
          s2[u] = fmaf(e, xv[u][j], s2[u]);
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s1[u] += __shfl_xor_sync(0xffffffffu, s1[u], o);
        s2[u] += __shfl_xor_sync(0xffffffffu, s2[u], o);
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * kWarps;
      if (r >= real) continue;
      const float m1 = s1[u] / E, m2 = s2[u] / E, iv = inv[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k = lane + 32 * j;
        if (k < E) {
          out[r * E + k] = res[r * ld + k] +
                           iv * (dv[u][j] * s[k] - m1 - xv[u][j] * m2);
          ps[j] = fmaf(dv[u][j], xv[u][j], ps[j]);
          pb[j] += dv[u][j];
        }
      }
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// Attention backward at head width 4, first pass (attention_bwd_rows'):
// a thread per (frame, head, pair of queries), keys and values read as
// float4, each serving both queries, the scores in the base-2 domain (q
// scaled by hd^-0.5 log2 e, as the forward takes them) and recomputed in
// each sweep over the keys rather than kept (registers); dq into dz's q
// columns (row stride ldd), (max, 1 / sum, sum dp p) per query into att.
__device__ void attention_bwd_rows4(const float* z, const float* dout,
                                    float* dz, int ldd, float* att,
                                    const Dims& d) {
  const int E = d.E, J = d.J, H = d.H, ldz = 3 * E;
  const int pairs = (J + 1) / 2;
  for (int task = threadIdx.x; task < d.frames * H * pairs;
       task += kThreads) {
    const int f = task / (H * pairs), rem = task % (H * pairs);
    const int i0 = 2 * (rem / H), h = rem % H;
    const float* frame = z + f * J * ldz + 4 * h;
    const float qs = d.scale * kLog2e;
    float4 q[2], o[2], dq[2];
    float m[2], rs[2], cdp[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool real = i0 + u < J;
      const float4 v = real ? ld4(frame + (i0 + u) * ldz)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      q[u] = make_float4(v.x * qs, v.y * qs, v.z * qs, v.w * qs);
      o[u] = real ? ld4(dout + (f * J + i0 + u) * E + 4 * h)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      m[u] = -INFINITY;
      rs[u] = cdp[u] = 0.f;
      dq[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int j = 0; j < J; ++j) {
      const float4 k = ld4(frame + j * ldz + E);
#pragma unroll
      for (int u = 0; u < 2; ++u) m[u] = fmaxf(m[u], dot4(q[u], k));
    }
    for (int j = 0; j < J; ++j) {
      const float4 k = ld4(frame + j * ldz + E);
#pragma unroll
      for (int u = 0; u < 2; ++u) rs[u] += exp2f(dot4(q[u], k) - m[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) rs[u] = 1.f / rs[u];
    for (int j = 0; j < J; ++j) {
      const float4 k = ld4(frame + j * ldz + E);
      const float4 v = ld4(frame + j * ldz + 2 * E);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        cdp[u] = fmaf(dot4(o[u], v), exp2f(dot4(q[u], k) - m[u]) * rs[u],
                      cdp[u]);
    }
    for (int j = 0; j < J; ++j) {
      const float4 k = ld4(frame + j * ldz + E);
      const float4 v = ld4(frame + j * ldz + 2 * E);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = exp2f(dot4(q[u], k) - m[u]) * rs[u];
        dq[u] = axpy4(p * (dot4(o[u], v) - cdp[u]), k, dq[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u;
      if (i >= J) continue;
      st4(dz + (f * J + i) * ldd + 4 * h,
          make_float4(dq[u].x * d.scale, dq[u].y * d.scale,
                      dq[u].z * d.scale, dq[u].w * d.scale));
      float* a = att + 3 * ((f * J + i) * H + h);
      a[0] = m[u];   // the base-2 scores' max
      a[1] = rs[u];  // 1 / the softmax's sum
      a[2] = cdp[u];
    }
  }
}

// Second pass at head width 4: a thread per (frame, head, pair of keys),
// queries and dout rows read as float4, each serving both keys; dk and dv
// into dz's k and v columns (row stride ldd).
__device__ void attention_bwd_cols4(const float* z, const float* dout,
                                    float* dz, int ldd, const float* att,
                                    const Dims& d) {
  const int E = d.E, J = d.J, H = d.H, ldz = 3 * E;
  const int pairs = (J + 1) / 2;
  for (int task = threadIdx.x; task < d.frames * H * pairs;
       task += kThreads) {
    const int f = task / (H * pairs), rem = task % (H * pairs);
    const int j0 = 2 * (rem / H), h = rem % H;
    const float* frame = z + f * J * ldz + 4 * h;
    float4 k[2], v[2], dk[2], dv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool real = j0 + u < J;
      k[u] = real ? ld4(frame + (j0 + u) * ldz + E)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      v[u] = real ? ld4(frame + (j0 + u) * ldz + 2 * E)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      dk[u] = dv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float qs = d.scale * kLog2e;
    for (int i = 0; i < J; ++i) {
      const float4 qr = ld4(frame + i * ldz);
      const float4 q = make_float4(qr.x * d.scale, qr.y * d.scale,
                                   qr.z * d.scale, qr.w * d.scale);
      const float4 q2 = make_float4(qr.x * qs, qr.y * qs, qr.z * qs,
                                    qr.w * qs);
      const float4 o = ld4(dout + (f * J + i) * E + 4 * h);
      const float* st = att + 3 * ((f * J + i) * H + h);
      const float mi = st[0], ri = st[1], ci = st[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = exp2f(dot4(q2, k[u]) - mi) * ri;
        dk[u] = axpy4(p * (dot4(o, v[u]) - ci), q, dk[u]);
        dv[u] = axpy4(p, o, dv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (j0 + u >= J) continue;
      float* dst = dz + (f * J + j0 + u) * ldd + 4 * h;
      st4(dst + E, dk[u]);
      st4(dst + 2 * E, dv[u]);
    }
  }
}

// A dW product: acc[o][i] (row stride nin; the block's row of `part`) +=
// sum_r dY[r][o] act(X[r][i]) over the tile's rows, act(v) = v s[i] + b[i]
// with LN (X holds normalised rows), else v; bias[o] += sum_r dY[r][o].
struct DwJob {
  const float* dy;
  int ldy;
  const float* x;
  int ldx;
  float* acc;
  int nout, nin;
  float* bias;
  const float *s, *b;
};

// A dX product: out[r][c] = epi(sum_k A[r][k] W[k][c]) for c < N (out's
// row stride ldo), W bf16 staged [K][ldw] (B[k][n]; zero rows past the real
// K, which A's zero columns meet); kDGelu multiplies by GELU'(out).
struct DxJob {
  const float* a;
  int lda, K;
  const bf16* w;
  int ldw;
  float* out;
  int ldo, N;
};

// One warp's dW task: the m-tile of 16 o from m0 and nc n-tiles of 8 i from
// n0, over R rows (a multiple of 8), in 3xTF32; the bias from the A
// fragments' float32 values where `bias` (the first n-group's task). Rows
// o past nout and columns i past nin (A's reads run into the next row) are
// computed and not stored.
template <bool LN>
__device__ void tc_dw_task(const DwJob& p, int R, int m0, int n0, int nc,
                           bool bias) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the big parts' product and the two small-part products, three chains
  float d[kTcNc][4], e[kTcNc][4], f[kTcNc][4];
  float sc[kTcNc], sh[kTcNc];
#pragma unroll
  for (int j = 0; j < kTcNc; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) d[j][c] = e[j][c] = f[j][c] = 0.f;
    sc[j] = LN ? p.s[n0 + 8 * j + g] : 1.f;
    sh[j] = LN ? p.b[n0 + 8 * j + g] : 0.f;
  }
  // the block's sums so far, loaded ahead of the k-loop that they wait
  // behind
  float2 old[kTcNc][2];
  bool own[kTcNc][2];
#pragma unroll
  for (int j = 0; j < kTcNc; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = n0 + 8 * j + 2 * t, o = m0 + g + 8 * h;
      own[j][h] = j < nc && i < p.nin && o < p.nout;
      old[j][h] = own[j][h] ? *reinterpret_cast<const float2*>(
                                  p.acc + o * p.nin + i)
                            : make_float2(0.f, 0.f);
    }
  const bool b0 = bias && t == 0 && m0 + g < p.nout,
             b1 = bias && t == 0 && m0 + g + 8 < p.nout;
  const float ob0 = b0 ? p.bias[m0 + g] : 0.f,
              ob1 = b1 ? p.bias[m0 + g + 8] : 0.f;
  float bs0 = 0.f, bs1 = 0.f;
  const float* y = p.dy + t * p.ldy + m0 + g;
  const float* x = p.x + t * p.ldx + n0 + g;
#pragma unroll 2
  for (int k0 = 0; k0 < R; k0 += 8) {
    const float* yk = y + k0 * p.ldy;
    const float v0 = yk[0], v1 = yk[8], v2 = yk[4 * p.ldy],
                v3 = yk[4 * p.ldy + 8];
    bs0 += v0 + v2;
    bs1 += v1 + v3;
    unsigned ab[4], as[4];
    split_tf32(v0, ab[0], as[0]);
    split_tf32(v1, ab[1], as[1]);
    split_tf32(v2, ab[2], as[2]);
    split_tf32(v3, ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < kTcNc; ++j) {
      if (j < nc) {
        const float* xk = x + k0 * p.ldx + 8 * j;
        float u0 = xk[0], u1 = xk[4 * p.ldx];
        if (LN) {
          u0 = fmaf(u0, sc[j], sh[j]);
          u1 = fmaf(u1, sc[j], sh[j]);
        }
        unsigned bb[2], bsm[2];
        split_tf32(u0, bb[0], bsm[0]);
        split_tf32(u1, bb[1], bsm[1]);
        mma_tf32(e[j], as, bb);
        mma_tf32(f[j], ab, bsm);
        mma_tf32(d[j], ab, bb);
      }
    }
  }
  if (bias) {
    for (int o = 1; o < 4; o <<= 1) {
      bs0 += __shfl_xor_sync(0xffffffffu, bs0, o);
      bs1 += __shfl_xor_sync(0xffffffffu, bs1, o);
    }
  }
#pragma unroll
  for (int j = 0; j < kTcNc; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (own[j][h])
        *reinterpret_cast<float2*>(p.acc + (m0 + g + 8 * h) * p.nin + n0 +
                                   8 * j + 2 * t) =
            make_float2(old[j][h].x + (d[j][2 * h] + (e[j][2 * h] +
                                                      f[j][2 * h])),
                        old[j][h].y + (d[j][2 * h + 1] + (e[j][2 * h + 1] +
                                                          f[j][2 * h + 1])));
  if (b0) p.bias[m0 + g] = ob0 + bs0;
  if (b1) p.bias[m0 + g + 8] = ob1 + bs1;
}

// A bf16 weight's element as the TF32 operand it is exactly.
__device__ __forceinline__ unsigned tf32_bits(const bf16* p) {
  return static_cast<unsigned>(__bfloat16_as_ushort(*p)) << 16;
}

// One warp's dX task: rows r0..r0 + 15 and nc n-tiles of 8 columns from
// n0, over K (a multiple of 8), in two TF32 passes: A split, W whole.
template <int EPI>
__device__ void tc_dx_task(const DxJob& p, int r0, int n0, int nc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[kTcNc][4], e[kTcNc][4];  // the big part's product, the small's
#pragma unroll
  for (int j = 0; j < kTcNc; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = e[j][c] = 0.f;
  const float* a = p.a + (r0 + g) * p.lda + t;
  const bf16* w = p.w + t * p.ldw + n0 + g;
#pragma unroll 2
  for (int k0 = 0; k0 < p.K; k0 += 8) {
    unsigned ab[4], as[4];
    split_tf32(a[k0], ab[0], as[0]);
    split_tf32(a[k0 + 8 * p.lda], ab[1], as[1]);
    split_tf32(a[k0 + 4], ab[2], as[2]);
    split_tf32(a[k0 + 8 * p.lda + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < kTcNc; ++j) {
      if (j < nc) {
        const bf16* wj = w + k0 * p.ldw + 8 * j;
        const unsigned bb[2] = {tf32_bits(wj), tf32_bits(wj + 4 * p.ldw)};
        mma_tf32(e[j], as, bb);
        mma_tf32(acc[j], ab, bb);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTcNc; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    if (j >= nc || c >= p.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* dst =
          reinterpret_cast<float2*>(p.out + (r0 + g + 8 * h) * p.ldo + c);
      float2 v = make_float2(acc[j][2 * h] + e[j][2 * h],
                             acc[j][2 * h + 1] + e[j][2 * h + 1]);
      if (EPI == kDGelu) {
        const float2 hv = *dst;
        v = make_float2(v.x * dgelu(hv.x), v.y * dgelu(hv.y));
      }
      *dst = v;
    }
  }
}

// A dW product and a dX product in one phase: the dW's tasks, then the
// dX's, dealt to the warps in turn (the same warp for a task on every
// tile).
template <bool LN, int EPI>
__device__ void tc_phase(const DwJob& dw, const DxJob& dx, int R) {
  const int dw_tiles = round8(dw.nin) / 8, dx_tiles = round8(dx.N) / 8;
  const int dw_groups = (dw_tiles + kTcNc - 1) / kTcNc;
  const int dx_groups = (dx_tiles + kTcNc - 1) / kTcNc;
  const int n_dw = ((dw.nout + 15) / 16) * dw_groups;
  const int n_all = n_dw + (R / 16) * dx_groups;
  for (int task = threadIdx.x >> 5; task < n_all; task += kWarps) {
    if (task < n_dw) {
      const int ng = task % dw_groups;
      tc_dw_task<LN>(dw, R, 16 * (task / dw_groups), 8 * kTcNc * ng,
                     min(kTcNc, dw_tiles - kTcNc * ng), ng == 0);
    } else {
      const int u = task - n_dw, ng = u % dx_groups;
      tc_dx_task<EPI>(dx, 16 * (u / dx_groups), 8 * kTcNc * ng,
                      min(kTcNc, dx_tiles - kTcNc * ng));
    }
  }
}

// The entries [at, at + count) of the block's row of `part`, zeroed.
__device__ void zero_part(float* prow, int at, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) prow[at + i] = 0.f;
}

// The MLP half of depth block b on the tensor cores (d.rows rows a tile, a
// multiple of 16).
__global__ void __launch_bounds__(kThreads, 2)
    spatial_mlp_bwd_tc_kernel(BwdArgs<bf16> a, Dims d, int b) {
  extern __shared__ __align__(16) float smem[];
  const int E = d.E, HID = d.hidden, R = d.rows;
  const int le = act_ld(E), lh = act_ld(HID);
  const MlpTcLayout l = mlp_tc_layout(R, E, HID);
  float *G = smem + l.g, *Hs = smem + l.h, *A = smem + l.a, *XH = smem + l.xh,
        *mu = smem + l.mu, *inv = smem + l.inv, *vec = smem + l.vec;
  bf16 *w2 = reinterpret_cast<bf16*>(smem + l.w2),
       *w1 = reinterpret_cast<bf16*>(smem + l.w1);
  float* prow = a.part + static_cast<size_t>(blockIdx.x) * a.total;
  const size_t M = static_cast<size_t>(d.n) * d.J;
  for (int i = l.w2 + threadIdx.x; i < l.lnred; i += kThreads) smem[i] = 0.f;
  zero_part(prow, grad_at(10, b, d), E * HID);
  zero_part(prow, grad_at(11, b, d), E);
  zero_part(prow, grad_at(8, b, d), HID * E);
  zero_part(prow, grad_at(9, b, d), HID);
  __syncthreads();
  stage_bf16_rows(a.w.fc2_w + static_cast<size_t>(b) * E * HID, w2, E, HID,
                  wt_ld(HID));
  stage_bf16_rows(a.w.fc1_w + static_cast<size_t>(b) * HID * E, w1, HID, E,
                  wt_ld(E));
  for (int i = threadIdx.x; i < E; i += kThreads) {
    vec[i] = ldg1(a.w.ln2_s + b * E + i);
    vec[round8(E) + i] = ldg1(a.w.ln2_b + b * E + i);
  }
  const float* h_b = a.sv.h + b * M * HID;
  const float* x2_b = a.sv.x2 + b * M * E;
  const float* mu2 = a.sv.stats + 4 * b * M + 2 * M;
  const float* inv2 = mu2 + M;
  float ps[kCols], pb[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) ps[j] = pb[j] = 0.f;
  const DwJob w2job{G, le, A, lh, prow + grad_at(10, b, d), E, HID,
                    prow + grad_at(11, b, d), nullptr, nullptr};
  const DxJob dhjob{G, le, round8(E), w2, wt_ld(HID), Hs, lh, HID};
  const DwJob w1job{Hs, lh, XH, le, prow + grad_at(8, b, d), HID, E,
                    prow + grad_at(9, b, d), vec, vec + round8(E)};
  const DxJob dy2job{Hs, lh, round8(HID), w1, wt_ld(E), A, le, E};

  const size_t tiles = (M + R - 1) / R;
  const auto rows = [&](size_t t) {
    return static_cast<int>(M - t * R < static_cast<size_t>(R) ? M - t * R
                                                                : R);
  };
  if (blockIdx.x < tiles)  // the first tile's h; each tile fetches the next's
    load_rows_async(h_b + blockIdx.x * R * HID, Hs, R, rows(blockIdx.x), HID,
                    lh);
  for (size_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const size_t r0 = t * R;
    const int real = rows(t);
    __syncthreads();  // the previous tile (and the staging) is done
    load_rows_async(a.dx + r0 * E, G, R, real, E, le);
    load_stats_rows_async(x2_b + r0 * E, mu2 + r0, inv2 + r0, XH, mu, inv, R,
                          real, E, le);
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < R * lh; i += kThreads) A[i] = gelu(Hs[i]);
    normalise_rows(XH, mu, inv, R, E, le);
    __syncthreads();
    // dW2 reads gelu(h) in A while dh replaces h in Hs
    tc_phase<false, kDGelu>(w2job, dhjob, R);
    __syncthreads();
    // dW1 reads dh and LN2(x2); dy2 replaces gelu(h) in A
    tc_phase<true, kStore>(w1job, dy2job, R);
    __syncthreads();
    if (t + gridDim.x < tiles)  // the next tile's h, into dh's place
      load_rows_async(h_b + (t + gridDim.x) * R * HID, Hs, R,
                      rows(t + gridDim.x), HID, lh);
    ln_bwd_rows_ld(A, le, XH, inv, vec, G, le, a.dx + r0 * E, real, E, ps,
                   pb);
  }
  __syncthreads();
  write_ln_sums(smem + l.lnred, ps, pb, E, prow + grad_at(6, b, d),
                prow + grad_at(7, b, d));
}

// The attention half of depth block b on the tensor cores (d.frames frames
// a tile, d.rows = their rows rounded up to 16).
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    spatial_attn_bwd_tc_kernel(BwdArgs<bf16> a, Dims d, int b) {
  extern __shared__ __align__(16) float smem[];
  const int E = d.E, R = d.rows, F = d.frames;
  const int le = act_ld(E), lq = act_ld(3 * E);
  const AttnTcLayout l = attn_tc_layout(R, F, E, d.H, d.J);
  float *DX2 = smem + l.dx2, *O = smem + l.o, *DO = smem + l.dout,
        *QKV = smem + l.qkv, *DQKV = smem + l.dqkv, *XH = smem + l.xh,
        *mu = smem + l.mu, *inv = smem + l.inv, *att = smem + l.att,
        *vec = smem + l.vec;
  bf16 *wp = reinterpret_cast<bf16*>(smem + l.wp),
       *wq = reinterpret_cast<bf16*>(smem + l.wq);
  float* prow = a.part + static_cast<size_t>(blockIdx.x) * a.total;
  const size_t M = static_cast<size_t>(d.n) * d.J;
  for (int i = l.wp + threadIdx.x; i < l.lnred; i += kThreads) smem[i] = 0.f;
  // dqkv's rows past the tile's frames and (HD 4: dqkv at the products'
  // stride) columns past 3E, which the attention passes never write
  for (int i = threadIdx.x; i < R * lq; i += kThreads)
    DQKV[i] = 0.f;
  zero_part(prow, grad_at(2, b, d), 3 * E * E);
  zero_part(prow, grad_at(3, b, d), 3 * E);
  zero_part(prow, grad_at(4, b, d), E * E);
  zero_part(prow, grad_at(5, b, d), E);
  __syncthreads();
  stage_bf16_rows(a.w.proj_w + static_cast<size_t>(b) * E * E, wp, E, E,
                  wt_ld(E));
  stage_bf16_rows(a.w.qkv_w + static_cast<size_t>(b) * 3 * E * E, wq, 3 * E,
                  E, wt_ld(E));
  for (int i = threadIdx.x; i < E; i += kThreads) {
    vec[i] = ldg1(a.w.ln1_s + b * E + i);
    vec[round8(E) + i] = ldg1(a.w.ln1_b + b * E + i);
  }
  // the block's input: the previous block's output (float32), or x
  const float* xin = b > 0 ? a.sv.xs + (b - 1) * M * E : nullptr;
  const float* mu1 = a.sv.stats + 4 * b * M;
  const float* inv1 = mu1 + M;
  float ps[kCols], pb[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) ps[j] = pb[j] = 0.f;
  const DwJob wpjob{DX2, le, O, le, prow + grad_at(4, b, d), E, E,
                    prow + grad_at(5, b, d), nullptr, nullptr};
  const DxJob dojob{DX2, le, round8(E), wp, wt_ld(E), DO, E, E};
  // dqkv at the products' stride: written so by the width-4 passes, else
  // copied to qkv's place
  float* DQ = HD == 4 ? DQKV : QKV;
  const DwJob wqjob{DQ, lq, XH, le, prow + grad_at(2, b, d), 3 * E, E,
                    prow + grad_at(3, b, d), vec, vec + round8(E)};
  const DxJob dy1job{DQ, lq, round8(3 * E), wq, wt_ld(E), DO, E, E};

  const int groups = (d.n + F - 1) / F;
  const auto rows = [&](int t) { return min(F, d.n - t * F) * d.J; };
  const auto load_o = [&](int t) {
    load_rows_async(a.sv.o + (b * M + static_cast<size_t>(t) * F * d.J) * E,
                    O, R, rows(t), E, le);
  };
  const auto load_qkv = [&](int t) {
    load_rows_async(
        a.sv.qkv + (b * M + static_cast<size_t>(t) * F * d.J) * 3 * E, QKV,
        R, rows(t), 3 * E, 3 * E);
  };
  if (blockIdx.x < groups) {  // the first tile's; each tile fetches the next's
    load_o(blockIdx.x);
    if (HD == 4) load_qkv(blockIdx.x);
  }
  for (int t = blockIdx.x; t < groups; t += gridDim.x) {
    const size_t r0 = static_cast<size_t>(t) * F * d.J;
    const int real = rows(t);
    const bool next = t + gridDim.x < groups;
    __syncthreads();  // the previous tile (and the staging) is done
    load_rows_async(a.dx + r0 * E, DX2, R, real, E, le);
    if (HD != 4) load_qkv(t);
    if (xin != nullptr)  // normalised below
      load_stats_rows_async(xin + r0 * E, mu1 + r0, inv1 + r0, XH, mu, inv,
                            R, real, E, le);
    else  // x, bf16: normalised as it is loaded
      load_normalised_ld(a.x + r0 * E, mu1 + r0, inv1 + r0, XH, inv, R, real,
                         E, le);
    cp_async_wait<0>();
    __syncthreads();
    tc_phase<false, kStore>(wpjob, dojob, R);  // dWp, do
    __syncthreads();
    if (next) load_o(t + gridDim.x);  // into o's place, free now
    if constexpr (HD == 4) {
      attention_bwd_rows4(QKV, DO, DQKV, lq, att, d);
      __syncthreads();
      attention_bwd_cols4(QKV, DO, DQKV, lq, att, d);
      if (xin != nullptr) normalise_rows(XH, mu, inv, R, E, le);
      __syncthreads();
      if (next) load_qkv(t + gridDim.x);  // into qkv's place, free now
    } else {
      attention_bwd_rows<HD>(QKV, DO, DQKV, att, d);
      __syncthreads();
      attention_bwd_cols<HD>(QKV, DO, DQKV, att, d);
      __syncthreads();
      // dqkv to qkv's place at the products' stride, zero past 3E
      for (int i = threadIdx.x; i < R * lq; i += kThreads) {
        const int r = i / lq, c = i % lq;
        QKV[i] = c < 3 * E ? DQKV[r * 3 * E + c] : 0.f;
      }
      if (xin != nullptr) normalise_rows(XH, mu, inv, R, E, le);
      __syncthreads();
    }
    tc_phase<true, kStore>(wqjob, dy1job, R);  // dWqkv, dy1 (into do)
    __syncthreads();
    ln_bwd_rows_ld(DO, E, XH, inv, vec, DX2, le, a.dx + r0 * E, real, E, ps,
                   pb);
  }
  __syncthreads();
  write_ln_sums(smem + l.lnred, ps, pb, E, prow + grad_at(0, b, d),
                prow + grad_at(1, b, d));
}

bool valid(int J, int E, int H, int hidden, int depth) {
  return J >= 1 && J <= kMaxJ && E >= 4 && E % 4 == 0 && E <= kMaxE &&
         hidden >= 4 && hidden % 4 == 0 && H >= 1 && E % H == 0 &&
         E / H <= kMaxHd && depth >= 0;
}

int fwd_bytes(int J, int E, int hidden, int frames) {
  return static_cast<int>(
      sizeof(float) * fwd_layout(fwd_dims(0, J, E, 1, hidden, 0, frames, 0.f))
                          .total);
}

int mlp_bytes(int E, int hidden, int rows) {
  return static_cast<int>(sizeof(float) * mlp_layout(rows, E, hidden).total);
}

int attn_bytes(int J, int E, int H, int frames) {
  return static_cast<int>(
      sizeof(float) * attn_layout(pad4(frames * J), frames, E, H, J).total);
}

int bf16_fwd_bytes(int J, int E, int hidden, int frames) {
  return static_cast<int>(
      sizeof(float) *
      bf_layout(bf_dims(0, J, E, 1, hidden, 0, frames, 0.f)).total);
}

int mlp_tc_bytes(int E, int hidden, int rows) {
  return static_cast<int>(sizeof(float) * mlp_tc_layout(rows, E, hidden).total);
}

int attn_tc_bytes(int J, int E, int H, int frames) {
  return static_cast<int>(
      sizeof(float) *
      attn_tc_layout(round16(frames * J), frames, E, H, J).total);
}

cudaError_t set_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The kernels with attention, compiled twice (each its own register
// allocation): the instance for head width hd.
using FwdKernel = void (*)(const float*, float*, Weights<float>, Saved,
                           FwdDims);
using AttnBwdKernel = void (*)(BwdArgs<float>, Dims, int);

FwdKernel fwd_kernel(int hd) {
  return hd == 4 ? spatial_stack_kernel<4> : spatial_stack_kernel<0>;
}

AttnBwdKernel attn_bwd_kernel(int hd) {
  return hd_class(hd) == 4 ? spatial_attn_bwd_kernel<4>
                           : spatial_attn_bwd_kernel<0>;
}

int launch_fwd(const float* x, float* out, const Weights<float>& w,
               const Saved& sv, int n, int J, int E, int H, int hidden,
               int depth, int frames, float scale, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!valid(J, E, H, hidden, depth) || frames < 1 || frames > kFwdMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdDims d = fwd_dims(n, J, E, H, hidden, depth, frames, scale);
  const int bytes = fwd_bytes(J, E, hidden, frames);
  const FwdKernel kernel = fwd_kernel(E / H);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + frames - 1) / frames, 32 * frames, bytes, stream>>>(
      x, out, w, sv, d);
  return static_cast<int>(cudaGetLastError());
}

// The float32 backward's launches.
int launch_bwd(const BwdArgs<float>& a, float* grads, int n, int J, int E,
               int H, int hidden, int depth, int grid, int mlp_rows,
               int attn_frames, float scale, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!valid(J, E, H, hidden, depth) || grid < 1 || mlp_rows < 4 ||
      mlp_rows % 4 || attn_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm{n, J, E, H, hidden, depth, 0, mlp_rows, scale};
  const Dims da{n, J, E, H, hidden, depth, attn_frames,
                pad4(attn_frames * J), scale};
  const int mb = mlp_bytes(E, hidden, mlp_rows);
  const int ab = attn_bytes(J, E, H, attn_frames);
  const AttnBwdKernel attn = attn_bwd_kernel(E / H);
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(spatial_mlp_bwd_kernel), mb);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(attn), ab);
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_final_ln_bwd_kernel<float><<<grid, kThreads, 0, stream>>>(a, dm);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int b = depth - 1; b >= 0; --b) {
    spatial_mlp_bwd_kernel<<<grid, kThreads, mb, stream>>>(a, dm, b);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    attn<<<grid, kThreads, ab, stream>>>(a, da, b);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  reduce_partials_kernel<float><<<(a.total + 255) / 256, 256, 0, stream>>>(
      a.part, grid, a.total, grads);
  return static_cast<int>(cudaGetLastError());
}

using FwdBf16Kernel = void (*)(const bf16*, bf16*, Weights<bf16>, Saved,
                               BfDims);
using AttnTcKernel = void (*)(BwdArgs<bf16>, Dims, int);

AttnTcKernel attn_tc_kernel(int hd) {
  return hd_class(hd) == 4 ? spatial_attn_bwd_tc_kernel<4>
                           : spatial_attn_bwd_tc_kernel<0>;
}

int launch_fwd_bf16(const bf16* x, bf16* out, const Weights<bf16>& w,
                    const Saved& sv, int n, int J, int E, int H, int hidden,
                    int depth, int frames, float scale, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!valid(J, E, H, hidden, depth) || frames < 1 || frames > kBfMaxFrames)
    return static_cast<int>(cudaErrorInvalidValue);
  const BfDims d = bf_dims(n, J, E, H, hidden, depth, frames, scale);
  const int bytes = bf16_fwd_bytes(J, E, hidden, frames);
  const FwdBf16Kernel kernel = E / H == 4 ? spatial_stack_bf16_kernel<4>
                                          : spatial_stack_bf16_kernel<0>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + frames - 1) / frames, 32 * frames, bytes, stream>>>(
      x, out, w, sv, d);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward's launches: as launch_bwd's, the halves on the tensor
// cores (mlp_rows a multiple of 16), then dx to its storage.
int launch_bwd_bf16(const BwdArgs<bf16>& a, bf16* grads, bf16* dx_out, int n,
                    int J, int E, int H, int hidden, int depth, int grid,
                    int mlp_rows, int attn_frames, float scale,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!valid(J, E, H, hidden, depth) || grid < 1 || mlp_rows < 16 ||
      mlp_rows % 16 || attn_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm{n, J, E, H, hidden, depth, 0, mlp_rows, scale};
  const Dims da{n, J, E, H, hidden, depth, attn_frames,
                round16(attn_frames * J), scale};
  const int mb = mlp_tc_bytes(E, hidden, mlp_rows);
  const int ab = attn_tc_bytes(J, E, H, attn_frames);
  const AttnTcKernel attn = attn_tc_kernel(E / H);
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(spatial_mlp_bwd_tc_kernel), mb);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(attn), ab);
  if (err != cudaSuccess) return static_cast<int>(err);
  spatial_final_ln_bwd_kernel<bf16><<<grid, kThreads, 0, stream>>>(a, dm);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int b = depth - 1; b >= 0; --b) {
    spatial_mlp_bwd_tc_kernel<<<grid, kThreads, mb, stream>>>(a, dm, b);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    attn<<<grid, kThreads, ab, stream>>>(a, da, b);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  reduce_partials_kernel<bf16><<<(a.total + 255) / 256, 256, 0, stream>>>(
      a.part, grid, a.total, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t count = static_cast<size_t>(n) * J * E;
  to_storage_kernel<bf16><<<static_cast<unsigned>((count + 255) / 256), 256,
                            0, stream>>>(a.dx, dx_out, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one thread block, in bytes, of the forward at `frames`
// frames a thread block, and of the backward's MLP half at `rows` rows and
// attention half at `frames` frames (the wrapper picks the tiles with its
// copy of these layouts, and checks them against these), for the float32
// kernels.
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

// The same for the bf16 kernels' layouts: the forward's (bf16 operands),
// and the backward's tensor-core halves' (`rows` a multiple of 16; the
// attention half's frames padded to a multiple of 16 rows).
int pv2c_spatial_stack_bf16_smem_bytes(int J, int E, int H, int hidden,
                                       int frames) {
  (void)H;
  return bf16_fwd_bytes(J, E, hidden, frames);
}

int pv2c_spatial_mlp_bwd_bf16_smem_bytes(int E, int hidden, int rows) {
  return mlp_tc_bytes(E, hidden, rows);
}

int pv2c_spatial_attn_bwd_bf16_smem_bytes(int J, int E, int H, int frames) {
  return attn_tc_bytes(J, E, H, frames);
}

// x, out: (n, J, E) float32 contiguous; the 12 block weights stacked over
// depth in nn.Linear layout (qkv_w (depth, 3E, E), proj_w (depth, E, E),
// fc1_w (depth, hidden, E), fc2_w (depth, E, hidden), vectors (depth, .));
// lnf_s, lnf_b (E,). stats, qkv, o, x2, h, xs: the residuals the backward
// takes (see Saved), or all nullptr. Requires J <= 32,
// E <= 128 and hidden multiples of 4, E / H <= 32, 1 to 8 frames a thread
// block and 16-byte aligned pointers. Returns a CUDA error code.
int pv2c_fused_spatial_stack(
    const float* x, float* out, const float* ln1_s, const float* ln1_b,
    const float* qkv_w, const float* qkv_b, const float* proj_w,
    const float* proj_b, const float* ln2_s, const float* ln2_b,
    const float* fc1_w, const float* fc1_b, const float* fc2_w,
    const float* fc2_b, const float* lnf_s, const float* lnf_b, float* stats,
    float* qkv, float* o, float* x2, float* h, float* xs, int n, int J, int E,
    int H, int hidden, int depth, int frames, float scale,
    cudaStream_t stream) {
  return launch_fwd(
      x, out,
      Weights<float>{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                     ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, lnf_s, lnf_b},
      Saved{stats, qkv, o, x2, h, xs}, n, J, E, H, hidden, depth, frames,
      scale, stream);
}

// The same with x, out and the weights in bf16 (the residuals float32), on
// the bf16 kernel (`frames` as pv2c_spatial_stack_bf16_smem_bytes counts).
int pv2c_fused_spatial_stack_bf16(
    const bf16* x, bf16* out, const bf16* ln1_s, const bf16* ln1_b,
    const bf16* qkv_w, const bf16* qkv_b, const bf16* proj_w,
    const bf16* proj_b, const bf16* ln2_s, const bf16* ln2_b,
    const bf16* fc1_w, const bf16* fc1_b, const bf16* fc2_w,
    const bf16* fc2_b, const bf16* lnf_s, const bf16* lnf_b, float* stats,
    float* qkv, float* o, float* x2, float* h, float* xs, int n, int J, int E,
    int H, int hidden, int depth, int frames, float scale,
    cudaStream_t stream) {
  return launch_fwd_bf16(
      x, out,
      Weights<bf16>{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                    ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, lnf_s, lnf_b},
      Saved{stats, qkv, o, x2, h, xs}, n, J, E, H, hidden, depth, frames,
      scale, stream);
}

// The backward's grid on the current device: the SMs times the thread
// blocks of both halves that fit on one SM together (at least one), for
// the float32 kernels. The wrapper sizes `part` with it. Returns minus a CUDA error code on failure.
int pv2c_spatial_stack_bwd_grid(int J, int E, int H, int hidden,
                                int mlp_rows, int attn_frames) {
  const int mb = mlp_bytes(E, hidden, mlp_rows);
  const int ab = attn_bytes(J, E, H, attn_frames);
  int device = 0, sms = 0, per_mlp = 0, per_attn = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = set_smem(
        reinterpret_cast<const void*>(spatial_mlp_bwd_kernel), mb);
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

// The same for the bf16 backward's tensor-core kernels.
int pv2c_spatial_stack_bwd_grid_bf16(int J, int E, int H, int hidden,
                                     int mlp_rows, int attn_frames) {
  const int mb = mlp_tc_bytes(E, hidden, mlp_rows);
  const int ab = attn_tc_bytes(J, E, H, attn_frames);
  int device = 0, sms = 0, per_mlp = 0, per_attn = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = set_smem(
        reinterpret_cast<const void*>(spatial_mlp_bwd_tc_kernel), mb);
  const AttnTcKernel attn = attn_tc_kernel(E / H);
  if (err == cudaSuccess)
    err = set_smem(reinterpret_cast<const void*>(attn), ab);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_mlp, spatial_mlp_bwd_tc_kernel, kThreads, mb);
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
  const int total = depth * block_total(E, hidden) + 2 * E;
  const BwdArgs<float> a{
      x, g, dx,
      Weights<float>{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                     ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, lnf_s, lnf_b},
      Saved{stats, qkv, o, x2, h, xs}, part, total};
  return launch_bwd(a, grads, n, J, E, H, hidden, depth,
                           grid, mlp_rows, attn_frames, scale, stream);
}

// The same with x, g, dx, the weights and grads in bf16 (the residuals
// float32), on the tensor-core kernels (grid from
// pv2c_spatial_stack_bwd_grid_bf16, mlp_rows a multiple of 16); dx_work
// (n, J, E) float32 scratch holds the running dx. One launch more: dx_work
// to dx.
int pv2c_fused_spatial_stack_bwd_bf16(
    const bf16* x, const bf16* g, bf16* dx, float* dx_work,
    const bf16* ln1_s, const bf16* ln1_b, const bf16* qkv_w,
    const bf16* qkv_b, const bf16* proj_w, const bf16* proj_b,
    const bf16* ln2_s, const bf16* ln2_b, const bf16* fc1_w,
    const bf16* fc1_b, const bf16* fc2_w, const bf16* fc2_b,
    const bf16* lnf_s, const bf16* lnf_b, float* stats, float* qkv, float* o,
    float* x2, float* h, float* xs, float* part, bf16* grads, int n, int J,
    int E, int H, int hidden, int depth, int grid, int mlp_rows,
    int attn_frames, float scale, cudaStream_t stream) {
  const int total = depth * block_total(E, hidden) + 2 * E;
  const BwdArgs<bf16> a{
      x, g, dx_work,
      Weights<bf16>{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                    ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, lnf_s, lnf_b},
      Saved{stats, qkv, o, x2, h, xs}, part, total};
  return launch_bwd_bf16(a, grads, dx, n, J, E, H, hidden, depth, grid,
                         mlp_rows, attn_frames, scale, stream);
}

}  // extern "C"

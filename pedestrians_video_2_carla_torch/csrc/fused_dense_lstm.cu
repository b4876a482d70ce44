// The dense LSTM frame scan, forward and backward, for sm_90a, float32 or
// bf16 (see "bf16" below): the graph LSTM's case k = 1, which has no graph
// term, so the B J rows are independent.
//
// Replaces the TPU kernels _lstm_fwd_kernel and _lstm_bwd_kernel of the JAX
// package's ops/pallas/fused_graph_gru.py (the bodies of _lstm_scan_fwd and
// _lstm_scan_bwd) at k = 1 and H <= 64. fused_graph_gru.cu keeps the graph
// form (k >= 2) and the wider H (see "Launch plans").
//
// Per frame, with carry h, c (zeros before frame 0):
//   a = xg[t] + h W;  i, f, o = sigmoid, g = tanh (of a's four column blocks)
//   c' = f c + i g;  h' = o tanh(c')
// W is (H, 4H), columns gate-major i|f|g|o; the kernels read it as the
// caller holds it, or as its transpose (4H, H) row-major (the stacked
// nn.Linear weight of a hoisted LSTM layer) where wt is set.
//
// What bounds it on an H100: the serial chain of 16 frames, not operations
// or bytes (at B=256, L=16, H=64 the forward is 0.134 GFLOP, 2 us at the
// fp32 peak). A frame's time is what its instructions wait for: the
// tensor-core rate of the 3xTF32 products on the few SMs that hold the
// rows, the gating's arithmetic chain, shared memory, global loads. The
// design:
// - The products transposed: a^T = W^T h^T forward, dh^T = W da^T backward.
//   W is the m16 (A) operand and the batch rows are the n8 (B) operand, so
//   that a thread block holds 8 rows (32 thread blocks at B J = 256, where
//   16-row tiles gave 16) and does half the mma work a frame.
// - W resident in registers: each warp loads its part of W once per launch
//   (staged through shared memory by coalesced cp.async copies), split into
//   its TF32 parts (3xTF32, mma_tf32.cuh), as mma.sync m16n8k8 A fragments:
//   128 registers a thread at H = 64, which sets the route's width
//   (H <= 64). No frame reads W again.
// - Forward: warp w owns the 8 units 8 (w % (Hp/8)) .. + 7 (Hp = H rounded
//   up to 8); its m16 tile j holds gates 2j and 2j + 1 of them, so a
//   thread's accumulators hold all four gates of its unit for its two batch
//   rows: the gating runs on them, c stays in registers. The carry h is
//   stored already split (hi and lo planes), double-buffered: one barrier a
//   frame. More rows a thread block (n8 tiles a warp) only where B J covers
//   the SMs.
// - Backward: dh is K = 4 Hp deep; warp w takes the k-steps w, w + 8, .. for
//   all units, so that each warp reads an eighth of da; the 8 partial sums
//   meet in shared memory and are summed in a fixed order; the gating
//   backward then runs a thread per 2 units of a row, dc carried in
//   registers, da stored split for the next frame's product (one buffer:
//   two barriers a frame) and written to dxg. It reads the forward's kept
//   gates, so nothing of the forward is recomputed.
// - xg, and the backward's gates, cs, dys, dcs, are staged two frames
//   ahead into shared memory by coalesced cp.async copies (a copy's latency
//   from a cold L2, about 1.5 us, is longer than a frame).
// - dW = sum over frames t >= 1 of ys[t-1]^T da[t] (frame 0's operand is
//   the zero start): one 3xTF32 split-K launch over ys and dxg in place and
//   a fixed-order sum of its splits (dw_tf32.cuh). The backward is three
//   launches; no float atomics; the same bits on every launch.
// Rows past B J in the last thread block and units past H (Hp = H rounded
// up to 8) compute on zeros (zero-filled copies, zero-padded W) and are
// never stored.
//
// Numerics: the products in 3xTF32 (fp32 accuracy: each 8-deep step's three
// products summed in the tensor cores, then added to fp32 sums outside
// them); sigmoid(v) = 1 / (1 + 2^(-v log2 e)) with the hardware exp2 and an
// approximate division (__expf, __fdividef; v clamped to +-80, where it is
// 0 or 1 to 1.8e-35), tanh(v) = 2 sigmoid(2v) - 1: within 1e-6 of the
// accurate functions, against the port's bar of 1e-5, in fewer
// instructions on the gating's serial chain.
//
// bf16 (the _bf16 entries; the kernels templated on the storage type St of
// xg, w, ys, cs, dys, dcs, dxg and dw), as the JAX kernel runs on bf16
// inputs: the products' operands are bf16 values (W; the carry h and the
// backward's da, rounded as they are stored for the next frame's product),
// so that the register-resident W keeps only its big TF32 part, the carry
// and da planes are one plane each, and every product is one exact TF32
// product with fp32 sums; c, dh, dc and the gating stay fp32; the gates are
// kept in fp32. W is staged by ordinary loads (once a launch), xg and the
// backward's cs, dys, dcs stay bf16 in shared memory (cp.async copies
// bytes: 16 bytes where H is even (xg) or a multiple of 8, 4 where it is
// even, ordinary loads where it is odd) and are widened as they are read.
// The launch plans are the fp32 ones (the bf16 buffers use part of their
// bytes).
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>

#include "dw_tf32.cuh"
#include "mma_tf32.cuh"
#include "storage.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxUnits = 64;  // Hp at most: the fragments' registers
constexpr int kMaxKS = kMaxUnits / 8;  // the forward's k-steps
constexpr int kTilesWarp = 4;  // the forward's n8 tiles of rows a warp, at most
constexpr int kBwdSteps = 4 * kMaxUnits / 8 / kWarps;  // backward k-steps a warp
constexpr int kDwMinRows = 64;  // rows a split of the dW launch, at least
constexpr int kRing = 3;        // frames of staged inputs: two in flight

__host__ __device__ inline int pad8(int H) { return (H + 7) / 8 * 8; }

// The row stride of the backward's partial sums of dh: its m16 tiles of
// units cover H rounded up to 16.
__host__ __device__ inline int part_ld(int H) { return (H + 15) / 16 * 16 + 4; }

__device__ __forceinline__ float sigmoid(float v) {
  v = fminf(fmaxf(v, -80.f), 80.f);
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ float tanh_fast(float v) {
  return 2.f * sigmoid(2.f * v) - 1.f;
}

// The weight as the caller holds it, copied into shared memory (row stride
// its width + 4, so that the fragment reads meet 32 banks): H rows of 4H,
// or, with wt, 4H rows of H (W^T).
struct StagedW {
  const float* s;
  bool wt;
  int H;
  __device__ __forceinline__ float operator()(int k, int col) const {
    return wt ? s[col * (H + 4) + k] : s[k * (4 * H + 4) + col];
  }
};

__host__ __device__ inline int staged_w_floats(int H) {
  return 4 * H * (H + 4) > H * (4 * H + 4) ? 4 * H * (H + 4)
                                             : H * (4 * H + 4);
}

// An m16k8 A fragment of resident weights, split: hi and lo.
struct AFrag {
  uint4 hi, lo;
};

// BF: a0..a3 are bf16 values, TF32 values already: hi alone (lo unused).
template <bool BF>
__device__ __forceinline__ AFrag split_a(float a0, float a1, float a2,
                                         float a3) {
  AFrag f;
  if (BF) {
    f.hi = make_uint4(__float_as_uint(a0), __float_as_uint(a1),
                      __float_as_uint(a2), __float_as_uint(a3));
    f.lo = make_uint4(0u, 0u, 0u, 0u);
    return f;
  }
  split_tf32(a0, f.hi.x, f.lo.x);
  split_tf32(a1, f.hi.y, f.lo.y);
  split_tf32(a2, f.hi.z, f.lo.z);
  split_tf32(a3, f.hi.w, f.lo.w);
  return f;
}

// d += a b in 3xTF32: a resident A fragment, b a split B fragment (BF: one
// TF32 product of exact values; bs unused).
template <bool BF>
__device__ __forceinline__ void mma_a(float* d, const AFrag& a,
                                      const unsigned* bb, const unsigned* bs) {
  const unsigned ab[4] = {a.hi.x, a.hi.y, a.hi.z, a.hi.w};
  if (BF) {
    mma_tf32(d, ab, bb);
    return;
  }
  const unsigned as[4] = {a.lo.x, a.lo.y, a.lo.z, a.lo.w};
  mma_3xtf32(d, ab, as, bb, bs);
}

// The k8 x n8 B fragment of a split operand stored n-major (row n holds the
// depth k; at = (n0 + g) ld + k0 + t4): X[n][k], X[n][k + 4] (BF: the hi
// plane alone).
template <bool BF>
__device__ __forceinline__ void load_b(const unsigned* hi, const unsigned* lo,
                                       int at, unsigned* bb, unsigned* bs) {
  bb[0] = hi[at];
  bb[1] = hi[at + 4];
  if (BF) return;
  bs[0] = lo[at];
  bs[1] = lo[at + 4];
}

// A copy into shared memory of `bytes` (16 or 4 by cp.async, in flight
// until the caller waits; 2: one bf16 value by an ordinary load) from src,
// zeros where !ok (src is then not read).
template <typename St>
__device__ __forceinline__ void stage_copy(St* dst, const St* src, bool ok,
                                           int bytes) {
  if (bytes == 16)
    cp_async16(reinterpret_cast<float*>(dst),
               reinterpret_cast<const float*>(src), ok);
  else if (bytes == 4)
    cp_async4(reinterpret_cast<float*>(dst),
              reinterpret_cast<const float*>(src), ok);
  else
    put(dst, ok ? ldg1(src) : 0.f);
}

// dst[r][c] <- src[r width + c] for r < R, c < width (row stride ld), in
// copies of `bytes` (stage_copy; width, ld and src multiples of them);
// zeros for rows >= live or without src. fallback: any valid address (not
// read).
template <typename St>
__device__ __forceinline__ void stage_rows(St* dst, int ld, const St* src,
                                           int R, int live, int width,
                                           int bytes, const St* fallback) {
  const int step = bytes / static_cast<int>(sizeof(St)), n = R * width;
  for (int i = threadIdx.x * step; i < n; i += kThreads * step) {
    const int r = i / width, c = i - r * width;
    const bool ok = src != nullptr && r < live;
    stage_copy(dst + r * ld + c, ok ? src + i : fallback, ok, bytes);
  }
}

// dst[i] <- src[i] for i < n in copies of `bytes` (stage_copy; n, valid
// and src multiples of them), zeros for i >= valid or without src.
template <typename St>
__device__ __forceinline__ void stage_flat(St* dst, const St* src, int n,
                                           int valid, int bytes,
                                           const St* fallback) {
  const int step = bytes / static_cast<int>(sizeof(St));
  for (int i = threadIdx.x * step; i < n; i += kThreads * step) {
    const bool ok = src != nullptr && i < valid;
    stage_copy(dst + i, ok ? src + i : fallback, ok, bytes);
  }
}

// W into shared memory at ws (see StagedW), float32 in either storage
// type: cp.async copies in flight until the caller waits (vec: the rows
// are 16-byte multiples and w 16-byte aligned), bf16 widened by ordinary
// loads.
template <typename St>
__device__ __forceinline__ StagedW stage_w(float* ws, const St* w, bool wt,
                                           int H, bool vec) {
  const int width = wt ? H : 4 * H, R = wt ? 4 * H : H;
  if constexpr (IsBf16<St>::value) {
    for (int i = threadIdx.x; i < R * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      ws[r * (width + 4) + c] = ldg1(w + i);
    }
  } else {
    stage_rows(ws, width + 4, w, R, R, width, vec ? 16 : 4, w);
  }
  return {ws, wt, H};
}

// ---------------------------------------------------------------------------
// Launch plans.
//
// Shared memory. Forward: two buffers of h (hi and lo planes, 8 NT rows,
// row stride Hp + 4, so that the fragment reads meet 32 banks), kRing
// frames of xg (8 NT rows of 4H, stride 4H + 4) and the staged W, read once
// into the fragments. Backward: da (hi and lo, 8 rows, stride 4 Hp + 4),
// the warps' partial sums of dh (8 x 8 rows, stride part_ld) and kRing
// frames of the staged gates, cs, cs[t-1], dys, dcs (8 rows of 4H + 4 H);
// the staged W takes the same space before the frames.
size_t fwd_smem_bytes(int H, int NT) {
  const size_t M = 8 * NT;
  return 4 * (4 * M * (pad8(H) + 4) + kRing * M * (4 * H + 4) +
              staged_w_floats(H));
}

size_t bwd_smem_bytes(int H) {
  const size_t Hp = pad8(H);
  const size_t frames = 2 * 8 * (4 * Hp + 4) + kWarps * 8 * part_ld(H) +
                        kRing * 8 * 8 * static_cast<size_t>(H);
  return 4 * std::max(frames, static_cast<size_t>(staged_w_floats(H)));
}

// The route: the dense kernels take k = 1 and H <= kMaxUnits (the
// fragments' registers), so that a training forward and its backward always
// take the same route.
bool dense_route(int H, int k) { return k == 1 && pad8(H) <= kMaxUnits; }

struct Plan {
  int NT;  // n8 tiles of rows a thread block
  size_t bytes;
  int blocks;
};

// The forward's n8 tiles of rows a thread block: enough thread blocks to
// cover the SMs first; at most kTilesWarp a warp (the warps of a unit group
// share the tiles) and the rows' tiles.
Plan plan_fwd(int rows, int H, int sms) {
  const int tiles = (rows + 7) / 8;
  const int per_group = kWarps / (pad8(H) / 8);  // warps of a unit group
  const int NT = std::max(1, std::min({(tiles + sms - 1) / sms, tiles,
                                       per_group * kTilesWarp}));
  return {NT, fwd_smem_bytes(H, NT), (tiles + NT - 1) / NT};
}

Plan plan_bwd(int rows, int H) {
  return {1, bwd_smem_bytes(H), (rows + 7) / 8};
}

// ---------------------------------------------------------------------------
// The forward, as the transposed product a^T = W^T h^T: the m16 rows are
// gate columns of W, the n8 columns are rows of the batch. Warp w owns the
// units u = 8 ug .. 8 ug + 7 (ug = w % UG): its m16 tile j holds gates 2j
// (rows g: unit 8 ug + g) and 2j + 1 (rows g + 8) of them, so a thread's
// accumulators hold all four gates of its unit for its two batch rows and
// the gating runs on them. The warp's n8 tiles are w / UG, w / UG + 8 / UG,
// .. (warps past 8 / UG groups idle). FULL: H = kMaxUnits, so that no
// k-step, warp or unit is masked. bf16 (St): the xg frames stay bf16 in
// their slots (row stride 4H + 8), copies of xbytes; h one plane.
template <bool KEEP, bool FULL, typename St>
__global__ void __launch_bounds__(kThreads, 1)
dense_lstm_fwd_kernel(const St* __restrict__ xg, const St* __restrict__ w,
                      bool wt, St* __restrict__ ys, St* __restrict__ cs,
                      float* __restrict__ gates, int L, int rows, int H,
                      int NT, int xbytes, bool wvec) {
  constexpr bool kBf = IsBf16<St>::value;
  extern __shared__ __align__(16) float smem[];
  const int Hp = pad8(H), UG = Hp / 8, KS = Hp / 8, M = 8 * NT;
  const int lda = Hp + 4, G4 = 4 * H, ldx = G4 + 4;
  const int lds = kBf ? G4 + 8 : ldx;  // a staged row's stride, elements
  unsigned* hbuf = reinterpret_cast<unsigned*>(smem);  // [2][hi, lo][M][lda]
  float* xs = smem + 4 * M * lda;                      // [kRing][M][ldx]
  St* xring = reinterpret_cast<St*>(xs);               // [kRing][M][lds]
  const StagedW weight = stage_w(xs + kRing * M * ldx, w, wt, H, wvec);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * M, live = min(M, rows - row0);
  const int per_group = kWarps / UG, ug = warp % UG, nt0 = warp / UG;
  const bool active = FULL || warp < UG * per_group;
  const int u = ug * 8 + g;  // this thread's unit
  const bool uok = FULL || u < H;

  // xg[t] into ring slot t % kRing
  const auto stage = [&](int t) {
    stage_rows(xring + (t % kRing) * M * lds, lds,
               xg + (static_cast<size_t>(t) * rows + row0) * G4, M, live, G4,
               xbytes, xg);
  };
  cp_async_commit();
  stage(0);
  cp_async_commit();
  if (L > 1) stage(1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();  // W has landed
  // this warp's A fragments: tile j, k-step ks: W[k][gate 2j or 2j+1, u]
  AFrag af[2][kMaxKS];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int ks = 0; ks < kMaxKS; ++ks) {
      const int k0 = ks * 8 + t4, c0 = 2 * j * H + u, c1 = c0 + H;
      const bool ok = FULL || (active && ks < KS && u < H);
      const bool ok0 = ok && (FULL || k0 < H), ok4 = ok && (FULL || k0 + 4 < H);
      af[j][ks] = split_a<kBf>(ok0 ? weight(k0, c0) : 0.f,
                               ok0 ? weight(k0, c1) : 0.f,
                               ok4 ? weight(k0 + 4, c0) : 0.f,
                               ok4 ? weight(k0 + 4, c1) : 0.f);
    }
  for (int i = tid; i < 2 * M * lda; i += kThreads) hbuf[i] = 0u;  // h = 0

  float c[kTilesWarp][2];  // the cell state of this thread's unit, two rows
#pragma unroll
  for (int j = 0; j < kTilesWarp; ++j) c[j][0] = c[j][1] = 0.f;

  for (int t = 0; t < L; ++t) {
    cp_async_wait<1>();
    __syncthreads();  // xg[t] has landed, h[t-1] is complete, frame t-1's
                      // reads are done
    if (t + 2 < L) stage(t + 2);  // into frame t-1's slot
    cp_async_commit();
    const St* x = xring + (t % kRing) * M * lds;
    const unsigned* Hh = hbuf + (t & 1) * 2 * M * lda;
    const unsigned* Hl = Hh + M * lda;
    unsigned* Nh = hbuf + ((t + 1) & 1) * 2 * M * lda;
    unsigned* Nl = Nh + M * lda;
    const size_t frame = static_cast<size_t>(t) * rows + row0;
#pragma unroll
    for (int j = 0; j < kTilesWarp; ++j) {
      const int nt = nt0 + j * per_group;
      if (active && nt < NT) {
        const int ra = nt * 8 + 2 * t4;  // this thread's rows ra, ra + 1
        // acc[jj]: gate 2jj at rows ra, ra + 1, then gate 2jj + 1
        float acc[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[jj][e] =
                uok ? to_f(x[(ra + (e & 1)) * lds + (2 * jj + (e >> 1)) * H + u])
                    : 0.f;
        if (t > 0) {  // (frame 0's h is zero)
          const int b0 = (nt * 8 + g) * lda + t4;
#pragma unroll
          for (int ks = 0; ks < kMaxKS; ++ks) {
            if (FULL || ks < KS) {
              unsigned bb[2], bs[2];
              load_b<kBf>(Hh, Hl, b0 + ks * 8, bb, bs);
              mma_a<kBf>(acc[0], af[0][ks], bb, bs);
              mma_a<kBf>(acc[1], af[1][ks], bb, bs);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = ra + e;
          const float i = sigmoid(acc[0][e]), f = sigmoid(acc[0][2 + e]),
                      gg = tanh_fast(acc[1][e]), o = sigmoid(acc[1][2 + e]);
          const float cn = f * c[j][e] + i * gg;
          const float h = o * tanh_fast(cn);
          c[j][e] = cn;
          if (kBf)
            Nh[r * lda + u] = tf32_of_bf16(h);
          else
            split_tf32(h, Nh[r * lda + u], Nl[r * lda + u]);
          if (r < live && uok) {
            const size_t at = frame + r;
            put(ys + at * H + u, h);
            put(cs + at * H + u, cn);
            if (KEEP) {
              float* gp = gates + at * G4 + u;
              gp[0] = i;
              gp[H] = f;
              gp[2 * H] = gg;
              gp[3 * H] = o;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The reverse scan, from the training forward's gates and cell states, 8
// rows a thread block, as the transposed product dh^T = W da^T: the m16
// rows are units, the n8 columns the batch rows, the depth the 4 Hp columns
// of da (gate-major, each gate's block Hp wide, so a k-step lies inside one
// gate). Warp w takes the k-steps w, w + 8, .. for all units; the 8 partial
// sums meet in shared memory and are summed in a fixed order; then the
// gating backward runs a thread per 2 units of a row. FULL as in the
// forward. bf16 (St): cs, cs[t-1], dys and dcs stay bf16 in their slots,
// copies of hbytes (the gates: gbytes); da one plane, rounded.
template <bool FULL, typename St>
__global__ void __launch_bounds__(kThreads, 1)
dense_lstm_bwd_kernel(const St* __restrict__ w, bool wt,
                      const float* __restrict__ gates,
                      const St* __restrict__ cs, const St* __restrict__ dys,
                      const St* __restrict__ dcs, St* __restrict__ dxg, int L,
                      int rows, int H, int gbytes, int hbytes, bool wvec) {
  constexpr bool kBf = IsBf16<St>::value;
  extern __shared__ __align__(16) float smem[];
  const int Hp = pad8(H), KS = Hp / 2, MU = (Hp + 15) / 16, G4 = 4 * H;
  const int lda = 4 * Hp + 4, ldp = part_ld(H);
  const int stage_floats = 8 * 8 * H;  // gates, cs, cs[t-1], dys, dcs
  unsigned* dah = reinterpret_cast<unsigned*>(smem);  // [8][lda]
  unsigned* dal = dah + 8 * lda;
  float* part = smem + 2 * 8 * lda;         // [warp][8][ldp]
  float* ring = part + kWarps * 8 * ldp;    // [kRing][stage_floats]
  const StagedW weight = stage_w(smem, w, wt, H, wvec);  // before the frames
  cp_async_commit();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * 8, live = min(8, rows - row0);
  const bool pair = H % 2 == 0;  // two units as one 8-byte access

  // frame t's residuals into ring slot t % kRing: gates [8][4H] (float),
  // then cs, cs[t-1], dys, dcs [8][H] each (St; zeros where absent)
  const auto stage = [&](int t) {
    float* s = ring + (t % kRing) * stage_floats;
    St* sh = reinterpret_cast<St*>(s + 8 * G4);
    const size_t at = static_cast<size_t>(t) * rows + row0;
    stage_flat(s, gates + at * G4, 8 * G4, live * G4, gbytes, gates);
    stage_flat(sh, cs + at * H, 8 * H, live * H, hbytes, cs);
    stage_flat(sh + 8 * H, t > 0 ? cs + (at - rows) * H : nullptr, 8 * H,
               live * H, hbytes, cs);
    stage_flat(sh + 16 * H, dys + at * H, 8 * H, live * H, hbytes, dys);
    stage_flat(sh + 24 * H, dcs ? dcs + at * H : nullptr, 8 * H, live * H,
               hbytes, dys);
  };
  cp_async_wait<0>();
  __syncthreads();  // W has landed

  // this warp's A fragments of W: k-step ks = warp + 8 j (depth q = 8 ks +
  // t4: unit q % Hp of gate q / Hp), m16 tile mi (units 16 mi + g, + 8)
  AFrag af[kBwdSteps][kMaxUnits / 16];
#pragma unroll
  for (int j = 0; j < kBwdSteps; ++j)
#pragma unroll
    for (int mi = 0; mi < kMaxUnits / 16; ++mi) {
      const int ks = warp + kWarps * j, q = ks * 8 + t4;
      const int gate = q / Hp, uq = q - gate * Hp, n0 = mi * 16 + g;
      const int c0 = gate * H + uq;
      const bool ok = FULL || (ks < KS && mi < MU);
      const bool k0 = ok && (FULL || uq < H), k4 = ok && (FULL || uq + 4 < H);
      const bool n0ok = FULL || n0 < H, n8ok = FULL || n0 + 8 < H;
      af[j][mi] = split_a<kBf>(k0 && n0ok ? weight(n0, c0) : 0.f,
                               k0 && n8ok ? weight(n0 + 8, c0) : 0.f,
                               k4 && n0ok ? weight(n0, c0 + 4) : 0.f,
                               k4 && n8ok ? weight(n0 + 8, c0 + 4) : 0.f);
    }
  __syncthreads();  // W is read: its space is free
  stage(L - 1);
  cp_async_commit();
  if (L > 1) stage(L - 2);
  cp_async_commit();

  // the gating backward's thread: row er, units u0, u0 + 1
  const int pairs = Hp / 2, er = tid / pairs, u0 = (tid % pairs) * 2;
  const bool gating = tid < 8 * pairs;
  float dc[2] = {0.f, 0.f};

  for (int t = L - 1; t >= 0; --t) {
    cp_async_wait<1>();
    __syncthreads();  // frame t's residuals have landed, da[t+1] is
                      // complete, frame t+1's reads are done
    if (t > 1) stage(t - 2);  // into frame t+1's slot
    cp_async_commit();
    if (t + 1 < L) {  // the warp's partial dh^T = W da[t+1]^T, its k-steps
      float acc[kMaxUnits / 16][4];
#pragma unroll
      for (int mi = 0; mi < kMaxUnits / 16; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kBwdSteps; ++j) {
        const int ks = warp + kWarps * j;
        if (FULL || ks < KS) {
          unsigned bb[2], bs[2];
          load_b<kBf>(dah, dal, g * lda + ks * 8 + t4, bb, bs);
#pragma unroll
          for (int mi = 0; mi < kMaxUnits / 16; ++mi)
            if (FULL || mi < MU) mma_a<kBf>(acc[mi], af[j][mi], bb, bs);
        }
      }
      // acc[mi]: units 16 mi + g (then + 8) at rows 2 t4, 2 t4 + 1
      float* p = part + warp * 8 * ldp;
#pragma unroll
      for (int mi = 0; mi < kMaxUnits / 16; ++mi) {
        if (FULL || mi < MU) {
          const int n0 = mi * 16 + g, r = 2 * t4;
          p[r * ldp + n0] = acc[mi][0];
          p[(r + 1) * ldp + n0] = acc[mi][1];
          p[r * ldp + n0 + 8] = acc[mi][2];
          p[(r + 1) * ldp + n0 + 8] = acc[mi][3];
        }
      }
    }
    __syncthreads();  // the partial sums are complete; da[t+1] is read
    if (gating) {
      const float* s = ring + (t % kRing) * stage_floats;
      const float* sg = s + er * G4;
      const St* scs = reinterpret_cast<const St*>(s + 8 * G4) + er * H;
      const St* scp = scs + 8 * H;
      const St* sdy = scp + 8 * H;
      const St* sdc = sdy + 8 * H;
      // a pair of values of the units u0, u0 + 1 (zeros past H)
      const auto two = [&](const float* p) {
        if (pair)
          return u0 < H ? *reinterpret_cast<const float2*>(p + u0)
                        : make_float2(0.f, 0.f);
        return make_float2(u0 < H ? p[u0] : 0.f,
                           u0 + 1 < H ? p[u0 + 1] : 0.f);
      };
      const auto two_st = [&](const St* p) {
        if constexpr (kBf)
          return make_float2(u0 < H ? to_f(p[u0]) : 0.f,
                             u0 + 1 < H ? to_f(p[u0 + 1]) : 0.f);
        else
          return two(p);
      };
      float2 dh = make_float2(0.f, 0.f);
      if (t + 1 < L) {
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {  // in a fixed order
          const float2 pk =
              *reinterpret_cast<const float2*>(part + (k * 8 + er) * ldp + u0);
          dh.x += pk.x;
          dh.y += pk.y;
        }
      }
      const float2 p_i = two(sg), p_f = two(sg + H), p_g = two(sg + 2 * H),
                   p_o = two(sg + 3 * H), p_c = two_st(scs),
                   p_cp = two_st(scp), p_dy = two_st(sdy),
                   p_dc = two_st(sdc);
      float d[4][2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const auto at2 = [v](const float2& a) { return v == 0 ? a.x : a.y; };
        const float i = at2(p_i), f = at2(p_f), gg = at2(p_g), o = at2(p_o);
        const float dhv = at2(dh) + at2(p_dy);
        const float tc = tanh_fast(at2(p_c));
        const float dcv = dhv * o * (1.f - tc * tc) + dc[v] + at2(p_dc);
        d[0][v] = dcv * gg * i * (1.f - i);
        d[1][v] = dcv * at2(p_cp) * f * (1.f - f);
        d[2][v] = dcv * i * (1.f - gg * gg);
        d[3][v] = dhv * tc * o * (1.f - o);
        dc[v] = dcv * f;
        if (kBf) {  // the product's operand and dxg: bf16 values
#pragma unroll
          for (int q = 0; q < 4; ++q) d[q][v] = round_bf(d[q][v]);
        }
      }
      const size_t at = (static_cast<size_t>(t) * rows + row0 + er) * G4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (kBf) {
          *reinterpret_cast<uint2*>(dah + er * lda + q * Hp + u0) =
              make_uint2(__float_as_uint(d[q][0]), __float_as_uint(d[q][1]));
        } else {
          uint2 hi, lo;
          split_tf32(d[q][0], hi.x, lo.x);
          split_tf32(d[q][1], hi.y, lo.y);
          *reinterpret_cast<uint2*>(dah + er * lda + q * Hp + u0) = hi;
          *reinterpret_cast<uint2*>(dal + er * lda + q * Hp + u0) = lo;
        }
        if (er < live) {
          St* dst = dxg + at + q * H + u0;
          if (pair) {
            if (u0 < H) st2g(dst, make_float2(d[q][0], d[q][1]));
          } else {
            if (u0 < H) put(dst, d[q][0]);
            if (u0 + 1 < H) put(dst + 1, d[q][1]);
          }
        }
      }
    }
  }
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

bool valid(int L, int B, int J, int H) {
  return L >= 1 && B >= 1 && J >= 1 && H >= 1;
}

// The weight gradient's split-K launch: frames 1 .. L-1 of ys and dxg.
int dw_splits_for(int L, int rows, int H, int sms) {
  return dw_tf32_splits((L - 1) * rows, dw_tiles(H, 4 * H), sms, kDwMinRows);
}

bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

// The launches behind the entries below, for either storage type.
template <typename St>
int dense_scan_fwd(const St* xg, const St* w, int wt, St* ys, St* cs,
                   float* gates, int L, int B, int J, int H,
                   cudaStream_t stream) {
  if (!valid(L, B, J, H) || !dense_route(H, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * J;
  const Plan plan = plan_fwd(rows, H, sms);
  // float32: rows of 4H floats, 16-byte multiples; bf16: 4H values, 16-byte
  // multiples where H is even, pairs of 4 bytes always
  const int xbytes = !IsBf16<St>::value
                         ? (aligned16(xg) ? 16 : 4)
                         : (aligned16(xg) && H % 2 == 0 ? 16
                            : aligned4(xg)              ? 4
                                                        : 2);
  const bool wvec = aligned16(w) && (wt == 0 || H % 4 == 0);
  const bool full = H == kMaxUnits;
  auto kernel = gates ? (full ? dense_lstm_fwd_kernel<true, true, St>
                              : dense_lstm_fwd_kernel<true, false, St>)
                      : (full ? dense_lstm_fwd_kernel<false, true, St>
                              : dense_lstm_fwd_kernel<false, false, St>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<plan.blocks, kThreads, plan.bytes, stream>>>(
      xg, w, wt != 0, ys, cs, gates, L, rows, H, plan.NT, xbytes, wvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename St>
int dense_scan_bwd(const St* w, int wt, const float* gates, const St* ys,
                   const St* cs, const St* dys, const St* dcs, St* dxg,
                   float* part, St* dw, int L, int B, int J, int H,
                   cudaStream_t stream) {
  constexpr bool kBf = IsBf16<St>::value;
  if (!valid(L, B, J, H) || !dense_route(H, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * J;
  const Plan plan = plan_bwd(rows, H);
  const bool vec = H % 4 == 0 && aligned16(gates) && aligned16(cs) &&
                   aligned16(dys) && (!dcs || aligned16(dcs)) &&
                   aligned16(dxg) && aligned16(ys);
  // bf16: a frame's [8][H] runs start at t B J H values
  const bool hvec = aligned16(cs) && aligned16(dys) && (!dcs || aligned16(dcs));
  const bool h4 = aligned4(cs) && aligned4(dys) && (!dcs || aligned4(dcs));
  const int gbytes = kBf ? (aligned16(gates) ? 16 : 4) : (vec ? 16 : 4);
  const int hbytes = !kBf ? (vec ? 16 : 4)
                     : H % 8 == 0 && hvec ? 16
                     : H % 2 == 0 && h4   ? 4
                                          : 2;
  const bool dvec =
      kBf ? H % 4 == 0 && aligned16(ys) && aligned16(dxg) : vec;
  const bool wvec = aligned16(w) && (wt == 0 || H % 4 == 0);
  auto scan = H == kMaxUnits ? dense_lstm_bwd_kernel<true, St>
                             : dense_lstm_bwd_kernel<false, St>;
  err = cudaFuncSetAttribute(scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan<<<plan.blocks, kThreads, plan.bytes, stream>>>(
      w, wt != 0, gates, cs, dys, dcs, dxg, L, rows, H, gbytes, hbytes, wvec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (L < 2)
    return static_cast<int>(cudaMemsetAsync(
        dw, 0, sizeof(St) * H * 4 * H, stream));

  const int n = (L - 1) * rows, splits = dw_splits_for(L, rows, H, sms);
  const int chunk = ((n + splits - 1) / splits + kDwKT - 1) / kDwKT * kDwKT;
  const int tiles = dw_tiles(H, 4 * H);
  const St* da = dxg + static_cast<size_t>(rows) * 4 * H;  // frames 1 ..
  const DwProblem<St, St> p{ys, da, part, H, H, 4 * H, 4 * H};
  auto kernel = dvec ? dw_tf32_kernel<true, St, St>
                     : dw_tf32_kernel<false, St, St>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDwSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, splits), kDwThreads, kDwSmemBytes, stream>>>(
      p, p, tiles, n, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int count = H * 4 * H;
  reduce_two_kernel<St><<<(count + 255) / 256, 256, 0, stream>>>(
      part, count, dw, part, 0, dw, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// How the dense scan is launched on the current device at this shape:
// plan[0..2] the forward's rows a thread block, shared memory bytes and
// thread blocks, plan[3..5] the backward's; all zeros where the dense route
// does not take the shape (k != 1 or H > 64; fused_graph_gru.cu runs it
// then). Returns a CUDA error, or 0.
int pv2c_dense_lstm_plan(int B, int J, int H, int k, int* plan) {
  if (!valid(1, B, J, H) || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool take = dense_route(H, k);
  const Plan p[2] = {plan_fwd(B * J, H, sms), plan_bwd(B * J, H)};
  for (int bwd = 0; bwd < 2; ++bwd) {
    plan[3 * bwd] = take ? 8 * p[bwd].NT : 0;
    plan[3 * bwd + 1] = take ? static_cast<int>(p[bwd].bytes) : 0;
    plan[3 * bwd + 2] = take ? p[bwd].blocks : 0;
  }
  return 0;
}

// The dense LSTM scan: xg (L, B, J, 4H) gate pre-activations i|f|g|o, w the
// (H, 4H) hidden-side weight (wt = 0) or its transpose (4H, H) (wt = 1) ->
// ys and cs (L, B, J, H); with gates (KEEP) also the activated gates (L, B,
// J, 4H). float32, contiguous. One launch on `stream`; returns the first
// CUDA error, or 0.
int pv2c_dense_lstm_scan_fwd(const float* xg, const float* w, int wt,
                             float* ys, float* cs, float* gates, int L, int B,
                             int J, int H, cudaStream_t stream) {
  return dense_scan_fwd<float>(xg, w, wt, ys, cs, gates, L, B, J, H, stream);
}

// The same in bf16 (every tensor but gates, which stays float32).
int pv2c_dense_lstm_scan_fwd_bf16(const bf16* xg, const bf16* w, int wt,
                                  bf16* ys, bf16* cs, float* gates, int L,
                                  int B, int J, int H, cudaStream_t stream) {
  return dense_scan_fwd<bf16>(xg, w, wt, ys, cs, gates, L, B, J, H, stream);
}

// Floats of the backward's `part` scratch on the current device (0 for one
// frame; float32 in both storage types). Returns minus a CUDA error code on
// failure.
int pv2c_dense_lstm_part_floats(int L, int B, int J, int H) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (L < 2) return 0;
  const size_t floats =
      static_cast<size_t>(dw_splits_for(L, B * J, H, sms)) * H * 4 * H;
  if (floats > 0x7fffffff) return -static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(floats);
}

// The dense scan's backward from the KEEP forward's gates, ys and cs, the
// cotangent dys and, unless nullptr, the cell states' cotangent dcs: dxg
// (L, B, J, 4H) and dw (H, 4H) (in that layout whatever wt says). Scratch:
// part (pv2c_dense_lstm_part_floats). Three launches on `stream` (the
// reverse scan, the weight gradient's splits, their sum; one frame: the
// reverse scan and a zero fill); returns the first CUDA error, or 0.
int pv2c_dense_lstm_scan_bwd(const float* w, int wt, const float* gates,
                             const float* ys, const float* cs,
                             const float* dys, const float* dcs, float* dxg,
                             float* part, float* dw, int L, int B, int J,
                             int H, cudaStream_t stream) {
  return dense_scan_bwd<float>(w, wt, gates, ys, cs, dys, dcs, dxg, part, dw,
                               L, B, J, H, stream);
}

// The same in bf16 (gates and part float32).
int pv2c_dense_lstm_scan_bwd_bf16(const bf16* w, int wt, const float* gates,
                                  const bf16* ys, const bf16* cs,
                                  const bf16* dys, const bf16* dcs, bf16* dxg,
                                  float* part, bf16* dw, int L, int B, int J,
                                  int H, cudaStream_t stream) {
  return dense_scan_bwd<bf16>(w, wt, gates, ys, cs, dys, dcs, dxg, part, dw,
                              L, B, J, H, stream);
}

}  // extern "C"

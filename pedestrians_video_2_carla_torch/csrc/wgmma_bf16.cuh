// The bf16 matrix product of the temporal block's bf16 entries (rows 8 and
// 9 in bf16), on Hopper's bf16 tensor cores: C = epilogue(A B), A M x K
// and B K x N in bf16, the sum in fp32.
//
// Replaces, as the products of rows 8 and 9 in bf16, the bf16 `dot_general`s
// with float32 sums (`_dots`) of the TPU kernels `_fwd_kernel_tl` and
// `_bwd_mlp_kernel_tl` / `_bwd_attn_kernel_tl` of the JAX package's
// ops/pallas/fused_temporal_transformer.py.
//
// Bound on an H100 SXM: operations, at bf16's dense 989 TFLOP/s (the
// forward's four products at B=256 are 204.1 GFLOP, 0.21 ms; the
// backward's eight at B=1024 about 1,630 GFLOP, 1.65 ms).
//
// Design. A thread block computes a 128 x 128 tile of C: two consumer
// warpgroups, each 64 rows, issue wgmma.mma_async m64n128k16 (bf16 in, fp32
// sum in registers) on tiles in shared memory, and one producer warp brings
// the tiles there with TMA (cp.async.bulk.tensor), k-steps of 64 elements
// (128 bytes, the width of the 128-byte swizzle) through a ring of kStages
// stages, each an A and a B tile of 16 KB, with a `full` and an `empty`
// mbarrier a stage. A thread block a tile, two an SM (kMinBlocks), so
// that one block's epilogue overlaps the other's products (on the card,
// persistent blocks walking over tiles, and a 4-deep ring at one block an
// SM, were no faster: PERF.md). Either operand is read K-major (its rows
// along K, as the forward's A and nn.Linear weight are) or MN-major (its
// rows along K, its columns along M or N, as the backward's dY W and dY^T
// X read them): wgmma's transpose bits take both from the same TMA tiles,
// so no operand is copied. A K-major tile is one
// TMA box of 64 K x 128 rows; an MN-major tile two boxes of 64 columns x
// 64 K. Tensor maps are encoded on the host for every call (they hold the
// pointers), through the runtime's driver entry point, and passed as
// __grid_constant__ parameters. TMA fills what lies past M, N or K with
// zeros; the epilogue masks its stores. The epilogue goes through shared
// memory: the fp32 tile into the (then idle) ring, read back a row a warp,
// so that the loads of bias, residual or pre-activation and the stores of
// C are whole rows (256 bytes of bf16). Epilogues in fp32 on the
// accumulator, each stored bf16 value rounded to nearest even: bias; bias
// + exact GELU, with the pre-GELU value as well when asked (training);
// bias + residual; dGELU (the pre-activation read back); plain (fp32 or
// bf16). The weight gradients' split-K parts (blockIdx.z) are written each
// to its own fp32 part; with `colsum`, the consumers of the first column
// tile also sum the MN-major A tile's columns (the bias gradient: dY's
// column sums) from shared memory, in a fixed order, while the products
// run. No atomics: the same inputs give the same bits.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder: encoder())
#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace wg {

// The plan (mirrored in ops/fused_temporal_transformer.py, BF16_GEMM)
constexpr int kBM = 128, kBN = 128;  // a thread block's tile of C
constexpr int kBK = 64;              // k-step: 128 bytes of bf16
constexpr int kStages = 3;           // TMA ring depth
constexpr int kMinBlocks = 2;        // thread blocks an SM
constexpr int kConsumers = 2;        // warpgroups of 64 rows
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kTileBytes = kBM * kBK * 2;        // A's and B's (kBN = kBM)
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kAlign = 1024;  // the 128-byte swizzle's period
constexpr int kBarrierBytes = 2 * kStages * 8;
constexpr int kColsumBytes = kConsumers * 4 * 64 * 4;  // a row a warp
constexpr int kSmemBytes =
    kStages * kStageBytes + kAlign + kBarrierBytes + kColsumBytes;
constexpr int kLdC = kBN + 4;  // the epilogue's fp32 tile rows, in the ring
static_assert(kBN == kBM && kBK * 2 == 128, "bf16 GEMM plan");
static_assert(kBM * kLdC * 4 <= kStages * kStageBytes, "epilogue tile");

enum Epilogue { kBias, kGelu, kResidual, kDGelu, kPlain };

constexpr float kSqrtHalf = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

template <typename O>
struct Epi {
  O* C;                // M x N; with splits, one M x N part per split
  const bf16* bias;    // kBias, kGelu, kResidual: N
  const bf16* R;       // kResidual: M x N
  bf16* H;             // kGelu: the pre-activation as well, if not null
  const bf16* aux;     // kDGelu: the pre-activation, M x N
  float* colsum;       // MN-major A: one part of M column sums a split
  int M, N, K;
  int k_split;         // rows of K a split (blockIdx.z), a multiple of kBK
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2D box of the tensor map at (inner, outer) into shared memory, counted
// on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int inner, int outer, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer), "r"(bar)
      : "memory");
}

// The shared-memory matrix descriptor of a 128-byte-swizzled tile at
// `addr` (1024-byte aligned but for a K-major tile's 32-byte k offsets):
// 8-row groups 1024 bytes apart (SBO); an MN-major tile's 64-column atoms
// 8 KB apart (LBO, one TMA box each).
template <bool MN>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(MN ? 8192 >> 4 : 1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// Keeps the compiler from moving the accumulators' registers across the
// asynchronous products (which it does not see).
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define PV2C_ACC8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A B on a 64 x 128 x 16 tile of the warpgroup, A and B from shared
// memory (TA / TB: MN-major), d in the accumulator layout of the PTX ISA's
// wgmma .m64nNk16 (warp w, lane l: rows 16 w + l / 4 and + 8, columns
// 8 j + 2 (l % 4) and + 1, at d[4 j .. 4 j + 3]).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : PV2C_ACC8(0), PV2C_ACC8(8), PV2C_ACC8(16), PV2C_ACC8(24),
        PV2C_ACC8(32), PV2C_ACC8(40), PV2C_ACC8(48), PV2C_ACC8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
#undef PV2C_ACC8

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * kSqrtHalf));
}

__device__ __forceinline__ float dgelu(float v) {
  return 0.5f * (1.0f + erff(v * kSqrtHalf)) +
         v * expf(-0.5f * v * v) * kInvSqrt2Pi;
}

// AT: A is stored K x M (MN-major), else M x K; BT: B is stored K x N,
// else N x K (nn.Linear's layout of a weight for C = A W^T). A thread
// block a tile: blockIdx.x the column tile, .y the row tile, .z the split
// of K.
template <bool AT, bool BT, int EPI, typename O>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    wgmma_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb, Epi<O> e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t bars = ring + kStages * kStageBytes;  // full, then empty
  float* colsum_rows = reinterpret_cast<float*>(
      smem_raw + (bars + kBarrierBytes - raw));
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * e.k_split;
  const int steps = (min(e.K, kbeg + e.k_split) - kbeg + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                         // the producer
      mbar_init(bars + 8 * (kStages + s), 4 * kConsumers);  // a warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer warp
    if (threadIdx.x != 128 * kConsumers) return;
    for (int s = 0; s < steps; ++s) {
      const int slot = s % kStages;
      const uint32_t full = bars + 8 * slot;
      mbar_wait(bars + 8 * (kStages + slot), ((s / kStages) & 1) ^ 1);
      mbar_expect_tx(full, kStageBytes);
      const uint32_t a = ring + slot * kStageBytes, b = a + kTileBytes;
      const int k0 = kbeg + s * kBK;
      if (AT) {
        tma_load(a, &ta, m0, k0, full);
        tma_load(a + kTileBytes / 2, &ta, m0 + 64, k0, full);
      } else {
        tma_load(a, &ta, k0, m0, full);
      }
      if (BT) {
        tma_load(b, &tb, n0, k0, full);
        tma_load(b + kTileBytes / 2, &tb, n0 + 64, k0, full);
      } else {
        tma_load(b, &tb, k0, n0, full);
      }
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 wgi ...
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const bool sums = AT && e.colsum != nullptr && blockIdx.x == 0;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  float cs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cs[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kStages;
    mbar_wait(bars + 8 * slot, (s / kStages) & 1);
    // the warpgroup's 64 rows of A: the second half of a K-major tile's
    // rows, or an MN-major tile's second box, both 8 KB on
    const uint32_t a = ring + slot * kStageBytes + wgi * (kTileBytes / 2);
    const uint32_t b = ring + slot * kStageBytes + kTileBytes;
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128<AT, BT>(
          d, descriptor<AT>(a + (AT ? kk * 2048 : kk * 32)),
          descriptor<BT>(b + (BT ? kk * 2048 : kk * 32)));
    wgmma_commit();
    if (sums) {
      // 16-byte chunk c (columns 8 c ..) of K rows r, r + 16, ...: in the
      // 128-byte swizzle, chunk c of row r lies at chunk c ^ (r % 8)
      const int c = t & 7;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (t >> 3) + 16 * i;
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(a + r * 128 + ((c ^ (r & 7)) << 4)));
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cs[2 * q] += __uint_as_float(w[q] << 16);
          cs[2 * q + 1] += __uint_as_float(w[q] & 0xffff0000u);
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(d);
    // each warp releases the stage once its products and its reads of
    // the tile are done (a warpgroup's warps do not wait for each other)
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + slot));
  }

  if (sums) {
    // the 16 threads of a chunk: lanes c, c + 8, c + 16, c + 24 of each
    // warp, then the 4 warps' rows in order
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 8);
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 16);
    }
    float* rows = colsum_rows + wgi * 4 * 64;
    if (lane < 8)
#pragma unroll
      for (int i = 0; i < 8; ++i) rows[warp * 64 + 8 * lane + i] = cs[i];
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
    const int m = m0 + 64 * wgi + t;
    if (t < 64 && m < e.M)
      e.colsum[static_cast<size_t>(blockIdx.z) * e.M + m] =
          ((rows[t] + rows[64 + t]) + rows[128 + t]) + rows[192 + t];
  }

  // the epilogue through shared memory: both warpgroups' products are
  // done (so is every TMA load), the ring holds the 128 x 128 fp32 tile
  // (rows padded to kLdC floats), and each warp then reads whole rows back
  // for coalesced loads of bias / R / aux and stores of C and H
  asm volatile("bar.sync 3, %0;\n" ::"n"(128 * kConsumers) : "memory");
  float* tile = reinterpret_cast<float*>(smem_raw + (ring - raw));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wgi + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(tile + r * kLdC + 8 * j + 2 * (lane % 4)) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
  O* C = e.C + static_cast<size_t>(blockIdx.z) * e.M * e.N;
  const int n = n0 + 4 * lane;  // and n + 1 .. n + 3 (N a multiple of 8)
  if (n >= e.N) return;
  constexpr bool kBiased = EPI == kBias || EPI == kGelu || EPI == kResidual;
  const float4 bv =
      kBiased ? ldg4(e.bias + n) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < 16; ++i) {
    const int r = 64 * wgi + 16 * warp + i, m = m0 + r;
    if (m >= e.M) break;
    float4 v = *reinterpret_cast<const float4*>(tile + r * kLdC + 4 * lane);
    if (kBiased)
      v = make_float4(v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w);
    const size_t at = static_cast<size_t>(m) * e.N + n;
    if (EPI == kGelu) {
      if (e.H != nullptr) st4g(e.H + at, v);
      v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
    } else if (EPI == kResidual) {
      const float4 q = ldg4(e.R + at);
      v = make_float4(q.x + v.x, q.y + v.y, q.z + v.z, q.w + v.w);
    } else if (EPI == kDGelu) {
      const float4 p = ldg4(e.aux + at);
      v = make_float4(v.x * dgelu(p.x), v.y * dgelu(p.y), v.z * dgelu(p.z),
                      v.w * dgelu(p.w));
    }
    st4g(C + at, v);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (no link to the driver
// library), fetched once.
inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A row-major bf16 matrix of `outer` rows of `inner` elements (a multiple
// of 8: 16-byte row strides, 16-byte aligned base), read in 128-byte-
// swizzled boxes of 64 x box_outer.
inline cudaError_t tensor_map(CUtensorMap* map, const bf16* ptr, int inner,
                              int outer, int box_outer) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(static_cast<const void*>(ptr)), dims, strides, box,
      steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C = epilogue(A B) over `splits` parts of K (each e.k_split rows, a
// multiple of kBK; e.k_split = K for one) on `stream`.
template <bool AT, bool BT, int EPI, typename O>
cudaError_t gemm(const bf16* A, const bf16* B, const Epi<O>& e, int splits,
                 cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = AT ? tensor_map(&ta, A, e.M, e.K, 64)
                       : tensor_map(&ta, A, e.K, e.M, kBM);
  if (err == cudaSuccess)
    err = BT ? tensor_map(&tb, B, e.N, e.K, 64)
             : tensor_map(&tb, B, e.K, e.N, kBN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wgmma_bf16_kernel<AT, BT, EPI, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((e.N + kBN - 1) / kBN, (e.M + kBM - 1) / kBM, splits);
  wgmma_bf16_kernel<AT, BT, EPI, O><<<grid, kThreads, kSmemBytes, stream>>>(
      ta, tb, e);
  return cudaGetLastError();
}

}  // namespace wg

// CPU stand-in of the CUDA runtime for rehearsing kernels: a thread block
// is blockDim OS threads, blocks run one after another (a cluster's blocks
// together, cudaLaunchKernelEx).
#pragma once
#include <barrier>
#include <cmath>
#include <math.h>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#include <algorithm>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
// a kernel's static shared array: one per kernel, which the threads of a
// block share (blocks run one after another)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

struct StandinBlock {
  std::barrier<>* bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<float> smem;
  // mma exchange: per warp, 32 lanes x (4 a + 2 b); shuffle exchange: per
  // warp, 32 lanes; ldmatrix exchange: per warp, 32 row addresses
  std::vector<unsigned> xa, xb;
  std::vector<float> xf;
  std::vector<const void*> xp;
  // the cluster: this block's rank, a barrier of all its threads, each
  // block's shared memory by rank
  unsigned rank = 0;
  std::barrier<>* cluster_bar = nullptr;
  std::vector<float*>* cluster_smem = nullptr;
};
inline thread_local StandinBlock* standin_block = nullptr;
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline void __syncthreads() { standin_block->bar->arrive_and_wait(); }
inline void __syncwarp() {
  standin_block->warps[threadIdx.x / 32]->arrive_and_wait();
}
inline float* standin_smem() { return standin_block->smem.data(); }

inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __expf(float x) { return std::exp(x); }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  float* x = &standin_block->xf[(threadIdx.x / 32) * 32];
  const unsigned lane = threadIdx.x % 32;
  x[lane] = v;
  __syncwarp();
  const float r = x[lane ^ mask];
  __syncwarp();
  return r;
}
inline float __fdividef(float a, float b) { return a / b; }
using std::min;
using std::max;
using std::fminf;
using std::fmaxf;

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  const char* e = std::getenv("STANDIN_SMS");
  *v = e ? std::atoi(e) : 4;
  return cudaSuccess;
}
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
  *n = 2;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

inline void standin_setup(StandinBlock& blk, std::barrier<>& bar, unsigned n,
                         size_t smem) {
  blk.bar = &bar;
  for (unsigned w = 0; w < (n + 31) / 32; ++w)
    blk.warps.emplace_back(new std::barrier<>(std::min(32u, n - 32 * w)));
  blk.smem.assign(smem / 4 + 16, std::nanf(""));
  blk.xa.assign(((n + 31) / 32) * 32 * 4, 0);
  blk.xb.assign(((n + 31) / 32) * 32 * 2, 0);
  blk.xf.assign(((n + 31) / 32) * 32, 0.f);
  blk.xp.assign(((n + 31) / 32) * 32, nullptr);
}

// Clusters of ns blocks along x, one cluster after another, the threads of
// a cluster's blocks together.
template <class K, class... A>
inline void standin_launch_cluster(dim3 grid, dim3 block, size_t smem,
                                   unsigned ns, K kernel, A... args) {
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned c0 = 0; c0 < grid.x; c0 += ns) {
        std::barrier<> cbar(n * ns);
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        std::vector<std::unique_ptr<StandinBlock>> blks;
        std::vector<float*> smems;
        for (unsigned r = 0; r < ns; ++r) {
          bars.emplace_back(new std::barrier<>(n));
          blks.emplace_back(new StandinBlock);
          standin_setup(*blks[r], *bars[r], n, smem);
          blks[r]->rank = r;
          blks[r]->cluster_bar = &cbar;
          smems.push_back(blks[r]->smem.data());
        }
        for (auto& b : blks) b->cluster_smem = &smems;
        std::vector<std::thread> ts;
        for (unsigned r = 0; r < ns; ++r)
          for (unsigned t = 0; t < n; ++t)
            ts.emplace_back([&, r, t] {
              standin_block = blks[r].get();
              threadIdx = dim3(t % block.x, t / block.x, 0);
              blockIdx = dim3(c0 + r, by, bz);
              blockDim = block;
              gridDim = grid;
              kernel(args...);
            });
        for (auto& th : ts) th.join();
      }
}

template <class K, class... A>
inline void standin_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                           K kernel, A... args) {
  standin_launch_cluster(grid, block, smem, 1, kernel, args...);
}

// cudaLaunchKernelEx with a cluster dimension (along x) as its only
// attribute that the stand-in reads.
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline unsigned standin_cluster(const cudaLaunchConfig_t* cfg) {
  unsigned ns = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      ns = cfg->attrs[i].val.clusterDim.x;
  return ns;
}
template <class... E, class... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                      void (*kernel)(E...), A&&... args) {
  standin_launch_cluster(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes,
                         standin_cluster(cfg), kernel, E(args)...);
  return cudaSuccess;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveClusters(
    int* n, K, const cudaLaunchConfig_t* cfg) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  *n = sms / static_cast<int>(standin_cluster(cfg));
  return cudaSuccess;
}

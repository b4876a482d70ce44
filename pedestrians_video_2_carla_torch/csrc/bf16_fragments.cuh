// bf16 tensor-core fragments from shared memory (ldmatrix), the thread
// block cluster's barrier and shared-memory map, and L2 prefetches, for the
// graph-form LSTM scans' bf16 kernels (fused_graph_gru.cu).
//
// ldmatrix: each lane names one 16-byte row of an 8 x 8 matrix of 16-bit
// values (lanes 8m .. 8m + 7 the rows of matrix m); lane l receives, of
// matrix m, the pair of row l / 4 at columns 2 (l % 4), + 1 (.trans: the
// pair of column l / 4 at rows 2 (l % 4), + 1), the lower one in the low
// half: mma.m16n8k16's A fragment from a row-major (m, k) tile, its B
// fragment from an (n, k) tile, or, transposed, from a (k, n) tile.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices (lanes 0-31 name their rows).
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// Two 8 x 8 matrices, transposed (lanes 0-15 name their rows).
__device__ __forceinline__ void ldsm_x2_t(unsigned* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row))
      : "memory");
}

// Asks L2 for the bytes [p, p + bytes), a 128-byte line a thread at a
// time over the thread block; returns at once.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = static_cast<size_t>(threadIdx.x) * 128; off < bytes;
       off += static_cast<size_t>(blockDim.x) * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + off));
}

// The calling thread block's rank in its cluster.
__device__ __forceinline__ unsigned cluster_rank() {
  return cooperative_groups::this_cluster().block_rank();
}

// A barrier of all threads of the cluster; the shared-memory writes before
// it, to any block of the cluster, are seen after it.
__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}

// p (in this block's shared memory) at the same offset in block `rank`'s.
template <class T>
__device__ __forceinline__ T* cluster_peer(T* p, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

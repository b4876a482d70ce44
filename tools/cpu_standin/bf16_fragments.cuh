// Stand-in of csrc/bf16_fragments.cuh: ldmatrix as a per-warp exchange of
// the lanes' row addresses; the cluster's rank, barrier and shared-memory
// map from the stand-in's cluster launch (cudaLaunchKernelEx); no L2
// prefetch.
#pragma once
#include "cuda_runtime.h"

inline void standin_ldsm(unsigned* r, const void* row, int mats, bool trans) {
  StandinBlock* blk = standin_block;
  const unsigned lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const void** xp = &blk->xp[w * 32];
  xp[lane] = row;
  __syncwarp();
  for (int m = 0; m < mats; ++m) {
    const unsigned short *e0, *e1;
    if (trans) {
      e0 = static_cast<const unsigned short*>(xp[8 * m + 2 * (lane % 4)]) +
           lane / 4;
      e1 = static_cast<const unsigned short*>(
               xp[8 * m + 2 * (lane % 4) + 1]) + lane / 4;
    } else {
      e0 = static_cast<const unsigned short*>(xp[8 * m + lane / 4]) +
           2 * (lane % 4);
      e1 = e0 + 1;
    }
    r[m] = static_cast<unsigned>(*e0) | (static_cast<unsigned>(*e1) << 16);
  }
  __syncwarp();
}

inline void ldsm_x4(unsigned* r, const void* row) {
  standin_ldsm(r, row, 4, false);
}
inline void ldsm_x4_t(unsigned* r, const void* row) {
  standin_ldsm(r, row, 4, true);
}
inline void ldsm_x2_t(unsigned* r, const void* row) {
  standin_ldsm(r, row, 2, true);
}

inline void prefetch_l2(const void*, size_t) {}

inline unsigned cluster_rank() { return standin_block->rank; }
inline void cluster_sync() { standin_block->cluster_bar->arrive_and_wait(); }
template <class T>
inline T* cluster_peer(T* p, unsigned rank) {
  char* mine = reinterpret_cast<char*>(standin_block->smem.data());
  char* theirs = reinterpret_cast<char*>((*standin_block->cluster_smem)[rank]);
  return reinterpret_cast<T*>(theirs + (reinterpret_cast<char*>(p) - mine));
}

// The forward of the fused pose-changes -> forward kinematics -> camera
// projection, shared by the serving kernel (fused_projection.cu) and the
// training forward (fused_projection_train.cu): one kernel template,
// fk_forward_kernel<TRAIN>.
//
// Per clip: carry the relative rotations across frames (S_t = C_t @ S_{t-1},
// row-vector, S_{-1} = rel_rot), run the bone-tree FK, swap P3D pose axes to
// world axes (x, y, z) -> (y, -x, z), apply the camera's view transform and
// the pinhole:
//   changes (B, L, J, 3, 3), rel_loc (B, J, 3), rel_rot (B, J, 3, 3)
//   -> proj (B, L, J, 3) = (x_screen, y_screen, depth);
//   TRAIN also: abs_loc (B, L, J, 3), the absolute pose locations (P3D pose
//   space), and states (B, L, J, 9) = S_t, the backward's residuals.
// All float32 and contiguous.
//
// Bound on an H100: memory. At B=1024, L=16 the serving forward moves
// 21.7 MB (6.5 us at 3.35 TB/s), the training forward 42.2 MB (12.6 us).
//
// Design. The only dependence across frames is the carry S_t, per (clip,
// bone); once S_t is known, each frame's FK and projection stand alone. A
// thread block owns whole clips and walks them in chunks of (clip, frame)
// units (plan()): a clip of at most kUnits frames is one chunk, and the
// clips that fit beside it (at most kMaxClips) share the thread block; a
// longer clip has a thread block to itself and runs in chunks of
// kLongFrames frames, the carry passed from one to the next in registers.
// A chunk is one contiguous range of each tensor. Per chunk:
//   1. staging: its pose changes are copied to shared memory with 16-byte
//      cp.async, as are the clips' rel_loc and rel_rot with the first
//      chunk; the next chunk of a long clip is staged into a second buffer
//      while this one computes;
//   2. the carry, a thread a (clip, bone): S_t = C_t @ S_{t-1} over the
//      chunk's frames, each written over C_t (the same products, in the
//      same order, as the level-by-level warp-a-clip kernel this replaces);
//   3. the FK, level by level, a thread a (unit, bone) of a level and a
//      __syncthreads() between levels: abs_rot[b] = S[b] @ abs_rot[parent]
//      written over S[b] (no other bone reads S[b]) and abs_loc[b] =
//      loc[b] @ abs_rot[parent] + abs_loc[parent], each thread reading all
//      of its inputs before it writes; then the projection of every
//      (unit, bone) (vx = wx*r00 + wy*r10 + wz*r20 + t0, inv_z = 1/vz,
//      fx*vx*inv_z);
//   4. copy out, coalesced, 16 bytes a thread where the range allows:
//      proj, and for TRAIN abs_loc and (before the FK writes over them)
//      the states.
// A level-synchronous walk does each composition once (25 a frame on
// CARLA's tree). A walk in which each (unit, bone) builds its own
// absolute rotation down its ancestor path, with no barrier between
// levels, repeats them (86 compositions and 111 location steps a frame)
// and measured slower on the H100 (PERF.md, tools/projection_fwd_variants.py).
// The batch is not padded: the last thread block takes the clips left.
// The tree (its levels, each bone packed with its parent) and the camera
// are arguments, copied to shared memory while the first chunk is in
// flight (their first reads would otherwise miss the caches on the FK's
// critical path).
//
// nvcc contracts multiply-adds into FMAs, so results differ from the plain
// PyTorch version in the last bits only. Built without --use_fast_math: the
// pinhole divides by depth, and 1/vz must be IEEE.
//
// With PV2C_FK_SPLIT defined (an instrumented copy, chip_smoke.py), thread
// 0 of each thread block adds each phase's clock64() cycles to a counter
// (g_fk_split: staging, carry, FK and projection, copy out).
#pragma once

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace fk {

constexpr int kMaxBones = 32;
constexpr int kUnits = 32;     // (clip, frame) units a chunk, at most
constexpr int kLongFrames = 16;  // frames a chunk of a clip longer than that
constexpr int kMaxClips = 8;   // clips a thread block, at most
constexpr int kThreads = 256;  // threads a thread block
// thread blocks an SM at least (registers: at most 64 a thread)
constexpr int kMinBlocks = 1024 / kThreads;

struct Camera {
  float r[9];  // world->view rotation, row-major (row-vector convention)
  float t[3];
  float fx, fy, px, py, w, h;
};

inline Camera make_camera(const float* camera) {
  Camera cam;
  for (int i = 0; i < 9; ++i) cam.r[i] = camera[i];
  for (int i = 0; i < 3; ++i) cam.t[i] = camera[9 + i];
  cam.fx = camera[12];
  cam.fy = camera[13];
  cam.px = camera[14];
  cam.py = camera[15];
  cam.w = camera[16];
  cam.h = camera[17];
  return cam;
}

// The tree by levels: the bones by depth, then index, each packed with its
// parent as bone | (parent + 1) << 8; level d is entry[level_start[d] ..
// level_start[d + 1]), and inv[d] is 1 / its width.
struct Tree {
  int entry[kMaxBones];
  int level_start[kMaxBones + 1];
  float inv[kMaxBones];
  int num_bones;
  int num_levels;
};

// The tree and the camera in shared memory, copied there whole (words).
constexpr int kTreeWords = sizeof(Tree) / 4;
constexpr int kConstWords = kTreeWords + sizeof(Camera) / 4;

// Checks the tree (a parent's index is below its child's, depths follow the
// parents) and fills the levels. Returns 0 or cudaErrorInvalidValue.
inline int make_tree(const int* parents, const int* depths, int num_bones,
                     Tree* tree) {
  if (num_bones < 1 || num_bones > kMaxBones) return (int)cudaErrorInvalidValue;
  int num_levels = 0;
  for (int j = 0; j < kMaxBones; ++j) tree->entry[j] = 0;
  for (int j = 0; j < num_bones; ++j) {
    if (parents[j] >= j || depths[j] < 0) return (int)cudaErrorInvalidValue;
    if (parents[j] < 0 ? depths[j] != 0 : depths[j] != depths[parents[j]] + 1)
      return (int)cudaErrorInvalidValue;
    if (depths[j] + 1 > num_levels) num_levels = depths[j] + 1;
  }
  int k = 0;
  for (int d = 0; d < num_levels; ++d) {
    tree->level_start[d] = k;
    for (int j = 0; j < num_bones; ++j)
      if (depths[j] == d) tree->entry[k++] = j | ((parents[j] + 1) << 8);
  }
  for (int d = num_levels; d <= kMaxBones; ++d) tree->level_start[d] = k;
  for (int d = 0; d < kMaxBones; ++d)
    tree->inv[d] = d < num_levels
        ? 1.0f / (tree->level_start[d + 1] - tree->level_start[d]) : 0.f;
  tree->num_bones = num_bones;
  tree->num_levels = num_levels;
  return 0;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

struct Plan {
  int clips;   // clips a thread block
  int frames;  // frames a chunk (of each clip)
};

// A clip of at most kUnits frames is one chunk, and the clips that fit
// beside it share the thread block; a longer clip has a thread block to
// itself and runs in chunks of kLongFrames frames (small chunks leave room
// for more such thread blocks on an SM, whose carries then run side by
// side).
__host__ __device__ inline Plan plan(int clip_length) {
  Plan p;
  if (clip_length <= kUnits) {
    p.frames = clip_length;
    p.clips = kUnits / clip_length < kMaxClips ? kUnits / clip_length
                                               : kMaxClips;
  } else {
    p.frames = kLongFrames;
    p.clips = 1;
  }
  return p;
}

// Offsets into dynamic shared memory, in floats (each a multiple of 4): the
// chunk buffers (a second one where a clip has more than one chunk), the
// staged rel_loc and rel_rot (4 floats of slack each way for the
// alignment), proj and abs_loc (TRAIN: before their copy out), the tree
// and the camera.
struct Layout {
  int buf0, buf1, loc, rot, proj, abs, tree, total;
};

__host__ __device__ inline Layout layout(Plan p, int J, bool two_buffers) {
  Layout l;
  const int units = p.clips * p.frames;
  const int r9 = round4(units * J * 9 + 8), r3 = round4(units * J * 3 + 8);
  l.buf0 = 0;
  l.buf1 = r9;
  l.loc = l.buf1 + (two_buffers ? r9 : 0);
  l.rot = l.loc + round4(p.clips * J * 3 + 8);
  l.proj = l.rot + round4(p.clips * J * 9 + 8);
  l.abs = l.proj + r3;
  l.tree = l.abs + r3;
  l.total = l.tree + round4(kConstWords);
  return l;
}

// Stage floats [a, a + count) of src (total floats in all, 16-byte aligned)
// into dst with 16-byte copies from the 16-byte boundary at or below a,
// reading nothing past total; returns where element a landed in dst.
__device__ inline int stage_range(float* dst, const float* __restrict__ src,
                                  long long a, int count, long long total) {
  const long long a0 = a & ~3LL;
  const int off = static_cast<int>(a - a0);
  const int vecs = (off + count + 3) / 4;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const long long e = a0 + 4LL * i;
    const long long left = total - e;
    cp_async16_part(dst + 4 * i, src + e,
                    left >= 4 ? 16 : (left > 0 ? 4 * static_cast<int>(left)
                                               : 0));
  }
  return off;
}

// The converse: floats [a, a + count) of dst (16-byte aligned) from src,
// 16-byte aligned shared memory holding element a at src[a & 3]; 16-byte
// stores where the whole vector is in the range, floats at its two ends.
__device__ inline void store_range(float* __restrict__ dst, const float* src,
                                   long long a, int count) {
  const long long a0 = a & ~3LL;
  const int off = static_cast<int>(a - a0);
  const int vecs = (off + count + 3) / 4;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const int e = 4 * i;
    if (e >= off && e + 4 <= off + count) {
      *reinterpret_cast<float4*>(dst + a0 + e) =
          *reinterpret_cast<const float4*>(src + e);
    } else {
      for (int k = e; k < e + 4; ++k)
        if (k >= off && k < off + count) dst[a0 + k] = src[k];
    }
  }
}

#ifdef PV2C_FK_SPLIT
__device__ unsigned long long* g_fk_split = nullptr;
#define FK_SPLIT_START long long fk_last = clock64();
#define FK_STAMP(k)                                                      \
  if (threadIdx.x == 0 && g_fk_split != nullptr) {                       \
    const long long now = clock64();                                     \
    atomicAdd(g_fk_split + (k), static_cast<unsigned long long>(now - fk_last)); \
    fk_last = now;                                                       \
  }
#define FK_SPLIT_SYNC __syncthreads();
#else
#define FK_SPLIT_START
#define FK_STAMP(k)
#define FK_SPLIT_SYNC
#endif

// i / n for 0 <= i < 2^20 and n >= 1, from inv = 1 / n: (i + 0.5) / n is
// at least 1 / 2n from an integer, and float rounds inv and the product by
// under (i + 0.5) / n x 2^-22, which is less.
__device__ __forceinline__ int quot(int i, float inv) {
  return static_cast<int>((i + 0.5f) * inv);
}

template <bool TRAIN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fk_forward_kernel(const float* __restrict__ changes,
                  const float* __restrict__ rel_loc,
                  const float* __restrict__ rel_rot,
                  float* __restrict__ proj, float* __restrict__ abs_loc,
                  float* __restrict__ states, int batch, int clip_length,
                  const __grid_constant__ Tree tree,
                  const __grid_constant__ Camera cam) {
  extern __shared__ __align__(16) float smem[];
  FK_SPLIT_START
  const int J = tree.num_bones, L = clip_length;
  const Plan pl = plan(L);
  const Layout lay = layout(pl, J, pl.frames < L);
  const long long clip0 = static_cast<long long>(blockIdx.x) * pl.clips;
  const int nc = static_cast<int>(
      min(static_cast<long long>(pl.clips), batch - clip0));
  const long long rows_all = static_cast<long long>(batch) * L * J;

  // the clips' constants and the first chunk: one cp.async group
  const float* LOC = smem + lay.loc +
      stage_range(smem + lay.loc, rel_loc, clip0 * J * 3, nc * J * 3,
                  static_cast<long long>(batch) * J * 3);
  const float* ROT = smem + lay.rot +
      stage_range(smem + lay.rot, rel_rot, clip0 * J * 9, nc * J * 9,
                  static_cast<long long>(batch) * J * 9);
  int off = stage_range(smem + lay.buf0, changes, clip0 * L * J * 9,
                        nc * pl.frames * J * 9, rows_all * 9);
  cp_async_commit();
  // the tree and the camera, while they are in flight (their first reads
  // miss the caches, and would otherwise stall the FK)
  int* s_const = reinterpret_cast<int*>(smem + lay.tree);
  for (int i = threadIdx.x; i < kConstWords; i += blockDim.x)
    s_const[i] = i < kTreeWords
        ? reinterpret_cast<const int*>(&tree)[i]
        : reinterpret_cast<const int*>(&cam)[i - kTreeWords];
  const Tree& tr = *reinterpret_cast<const Tree*>(s_const);
  const Camera& cm = *reinterpret_cast<const Camera*>(s_const + kTreeWords);

  float carry[9];  // the carry of a (clip, bone) from chunk to chunk
  for (int t0 = 0, k = 0; t0 < L; t0 += pl.frames, ++k) {
    const int F = min(pl.frames, L - t0);  // all L where nc > 1
    const int units = nc * F;
    // the chunk is rows [row0, row0 + units J) of the (B L J) rows
    const long long row0 = (clip0 * L + t0) * J;
    float* buf = smem + ((k & 1) ? lay.buf1 : lay.buf0);
    float* Cm = buf + off;
    int next_off = 0;
    if (t0 + pl.frames < L) {
      // the next chunk of the clip (nc == 1 here) into the other buffer
      next_off = stage_range(smem + ((k & 1) ? lay.buf0 : lay.buf1), changes,
                             (row0 + F * J) * 9,
                             min(pl.frames, L - t0 - F) * J * 9,
                             rows_all * 9);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    FK_STAMP(0)

    // ---- the carry: a thread a (clip, bone), over the chunk's frames;
    // each frame's change read before the previous frame's product ----
    for (int p = threadIdx.x; p < nc * J; p += blockDim.x) {
      const int c = p / J, b = p - c * J;
      float s[9], cn[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) s[i] = t0 == 0 ? ROT[p * 9 + i] : carry[i];
      float* cp = Cm + (c * F * J + b) * 9;
#pragma unroll
      for (int i = 0; i < 9; ++i) cn[i] = cp[i];
      for (int f = 0; f < F; ++f) {
        float cc[9], ns[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) cc[i] = cn[i];
        if (f + 1 < F) {
#pragma unroll
          for (int i = 0; i < 9; ++i) cn[i] = cp[(f + 1) * J * 9 + i];
        }
        // S_t = C_t @ S_{t-1} (row-vector composition)
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            ns[i * 3 + j] = cc[i * 3 + 0] * s[0 + j]
                          + cc[i * 3 + 1] * s[3 + j]
                          + cc[i * 3 + 2] * s[6 + j];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          cp[f * J * 9 + i] = ns[i];
          s[i] = ns[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) carry[i] = s[i];
    }
    __syncthreads();
    FK_STAMP(1)

    // ---- the FK, level by level: a thread a (unit, bone) of a level; a
    // bone's absolute rotation overwrites its S_t (no other bone reads
    // S_t), its absolute location goes to A ----
    if (TRAIN) store_range(states, buf, row0 * 9, units * J * 9);
    float* P = smem + lay.proj;
    float* A = smem + lay.abs;
    const int po = static_cast<int>((row0 * 3) & 3);
    const float inv_F = 1.0f / F;
    for (int d = 0; d < tr.num_levels; ++d) {
      const int first = tr.level_start[d];
      const int nb = tr.level_start[d + 1] - first;
      const float inv = tr.inv[d];
      for (int i = threadIdx.x; i < units * nb; i += blockDim.x) {
        const int u = quot(i, inv), e = tr.entry[first + i - u * nb];
        const int b = e & 255, p = (e >> 8) - 1;
        const float* l = LOC + (quot(u, inv_F) * J + b) * 3;
        float* ar = Cm + (u * J + b) * 9;
        float* al = A + po + (u * J + b) * 3;
        // every input read before any output is written (they share shared
        // memory, so a store would make the compiler read them again)
        float lv[3], wl[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) lv[m] = l[m];
        if (p < 0) {
          // a root: abs_rot = S_t, abs_loc = rel_loc
#pragma unroll
          for (int m = 0; m < 3; ++m) al[m] = lv[m];
          continue;
        }
        const float* pr = Cm + (u * J + p) * 9;
        const float* pl = A + po + (u * J + p) * 3;
        float s[9], r[9], nr[9];
#pragma unroll
        for (int m = 0; m < 9; ++m) {
          s[m] = ar[m];
          r[m] = pr[m];
        }
#pragma unroll
        for (int m = 0; m < 3; ++m) wl[m] = pl[m];
        // abs_loc = loc @ abs_rot[parent] + abs_loc[parent],
        // abs_rot = S @ abs_rot[parent]
#pragma unroll
        for (int j = 0; j < 3; ++j)
          wl[j] = lv[0] * r[j] + lv[1] * r[3 + j] + lv[2] * r[6 + j] + wl[j];
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            nr[m * 3 + j] = s[m * 3 + 0] * r[0 + j]
                          + s[m * 3 + 1] * r[3 + j]
                          + s[m * 3 + 2] * r[6 + j];
#pragma unroll
        for (int m = 0; m < 3; ++m) al[m] = wl[m];
#pragma unroll
        for (int m = 0; m < 9; ++m) ar[m] = nr[m];
      }
      __syncthreads();
    }
    // ---- the projection, every (unit, bone) at once ----
    const Camera c = cm;
    for (int i = threadIdx.x; i < units * J; i += blockDim.x) {
      const float* al = A + po + i * 3;
      // P3D pose -> world axes: (x, y, z) -> (y, -x, z); view + pinhole
      const float wx = al[1], wy = -al[0], wz = al[2];
      const float vx = wx * c.r[0] + wy * c.r[3] + wz * c.r[6] + c.t[0];
      const float vy = wx * c.r[1] + wy * c.r[4] + wz * c.r[7] + c.t[1];
      const float vz = wx * c.r[2] + wy * c.r[5] + wz * c.r[8] + c.t[2];
      const float inv_z = 1.0f / vz;
      float* o = P + po + i * 3;
      o[0] = c.w - (c.fx * vx * inv_z + c.px);
      o[1] = c.h - (c.fy * vy * inv_z + c.py);
      o[2] = vz;
    }
    __syncthreads();
    FK_STAMP(2)

    // ---- copy out ----
    store_range(proj, P, row0 * 3, units * J * 3);
    if (TRAIN) store_range(abs_loc, A, row0 * 3, units * J * 3);
    FK_SPLIT_SYNC
    FK_STAMP(3)
    off = next_off;
  }
}

// Checks the tree, fills the kernel's arguments and launches it on
// `stream`. Returns cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue; launches nothing for an empty batch or clip.
template <bool TRAIN>
int launch_forward(const float* changes, const float* rel_loc,
                   const float* rel_rot, float* proj, float* abs_loc,
                   float* states, int batch, int clip_length,
                   const int* parents, const int* depths, int num_bones,
                   const float* camera, void* stream) {
  Tree tree;
  const int err = make_tree(parents, depths, num_bones, &tree);
  if (err != 0) return err;
  if (batch < 0 || clip_length < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || clip_length == 0) return 0;
  const Plan p = plan(clip_length);
  const int bytes = static_cast<int>(
      sizeof(float) *
      layout(p, num_bones, p.frames < clip_length).total);
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fk_forward_kernel<TRAIN>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (batch + p.clips - 1) / p.clips;
  fk_forward_kernel<TRAIN><<<blocks, kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      changes, rel_loc, rel_rot, proj, abs_loc, states, batch, clip_length,
      tree, make_camera(camera));
  return (int)cudaGetLastError();
}

}  // namespace fk

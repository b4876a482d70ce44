// Trainable fused pose-changes -> forward kinematics -> camera projection:
// a forward and a hand-written backward kernel.
//
// Replace the TPU kernels of the JAX package's
// ops/pallas/fused_projection.py reached through `fused_projection_train`:
//   * fk_forward_kernel<true> (fk_forward.cuh) replaces `_fwd_train_kernel`
//     (`pl.pallas_call` in `_train_fwd_slabs`);
//   * fused_projection_train_bwd_kernel replaces `_bwd_train_kernel`
//     (`pl.pallas_call` in `_train_bwd`).
//
// Forward, per clip: carry the relative rotations across frames
// (S_t = C_t @ S_{t-1}, row-vector, S_{-1} = rel_rot), run the bone-tree FK,
// swap P3D pose axes to world axes (x, y, z) -> (y, -x, z), apply the
// camera's view transform and the pinhole:
//   changes (B, L, J, 3, 3), rel_loc (B, J, 3), rel_rot (B, J, 3, 3)
//   -> proj (B, L, J, 3) = (x_screen, y_screen, depth),
//      abs_loc (B, L, J, 3) absolute pose locations (P3D pose space),
//      states (B, L, J, 9) = S_t, the backward's residuals.
// Backward: the transpose of the forward, given the cotangents
// g_proj (B, L, J, 3) and g_abs (B, L, J, 3)
//   -> d_changes (B, L, J, 3, 3), d_rel_loc (B, J, 3), d_rel_rot (B, J, 3, 3).
// All float32 and contiguous.
//
// Bound on an H100: memory. At B=1024, L=16 the forward reads 16.6 MB and
// writes 25.6 MB (42.2 MB, 12.6 us at 3.35 TB/s); the backward reads
// 42.2 MB and writes 16.6 MB (58.8 MB, 17.5 us). Their arithmetic (about
// 64 and 163 MFLOP) takes 1 and 2.4 us at the float32 peak.
//
// Forward: fk_forward_kernel<true> of fk_forward.cuh, the serving kernel's
// template, which also writes abs_loc and the states (chunks of clips
// staged by cp.async, the carry a thread a (clip, bone), then the FK level
// by level, a thread a (frame, bone) of a level; the design is described
// there).
// The backward's design (frames in parallel, then the carry) is described
// at its kernel. Its tree walks add a bone's children in a fixed order
// (descending bone index, as the JAX kernel's reversed loop does) and it
// uses no atomics: every run gives the same bits, the same as the earlier
// warp-a-clip backward's.
// The backward's tree (parents, depths, children) is an argument built from
// the skeleton's structure.json; the camera is 18 float constants.
//
// The order of operations follows the TPU kernels. nvcc contracts
// multiply-adds into FMAs, so results differ from the plain PyTorch version
// in the last bits only. Built without --use_fast_math: the pinhole divides
// by depth, and 1/vz must be IEEE.

#include <cuda_runtime.h>

// fk_forward.cuh includes mma_tf32.cuh; it stands here too because the
// build hashes (ops/cuda_build.py) the headers a source names itself.
#include "mma_tf32.cuh"
#include "fk_forward.cuh"

namespace {

constexpr int kMaxBones = 32;

struct Tree {
  int parent[kMaxBones];
  int depth[kMaxBones];
  int child_start[kMaxBones];  // children of bone j: children[child_start[j]
  int child_count[kMaxBones];  //   .. child_start[j] + child_count[j]),
  int children[kMaxBones];     //   in descending bone index
  int by_level[kMaxBones];     // the bones by depth, then index: level d is
  int level_start[kMaxBones + 1];  // by_level[level_start[d] .. [d + 1])
  int num_bones;
  int num_levels;
  int widest;                  // the most bones on one level
};

using fk::Camera;
using fk::round4;
using fk::stage_range;

// The backward: frame-parallel tree terms, then the rotation carry.
//
// The only dependence across frames is the carried rotation: with dS_t the
// cotangent of S_t,
//   dS_t = T_t + carry_t,  d_changes_t = dS_t S_{t-1}^T,
//   carry_{t-1} = C_t^T dS_t,  d_rel_rot = carry_{-1},
// where T_t, the tree term (9 floats a bone), and frame t's share of
// d_rel_loc (3 floats a bone) need only S_t, rel_loc and the cotangents of
// frame t. A thread block owns whole clips and walks their frames in
// chunks of at most kUnits (clip, frame) units, last chunk first:
//   1. the chunk's states, changes, g_proj and g_abs are staged into shared
//      memory (each a contiguous range of the tensors: 16-byte cp.async
//      copies from the 16-byte boundary below it);
//   2. phase 1, the tree terms: a warp walks the trees of up to
//      kFramesWarp frames at once, level by level (root first for the FK
//      replay, deepest first for the transpose), a lane a (frame, bone) of
//      the level (a per-level table in shared memory), __syncwarp()
//      between levels; in between, every (frame, bone) transposes its
//      projection at once. A lane a bone (the forward's walk) leaves most
//      lanes idle on every level: 26 bones on 8 levels of at most 6. Each
//      (frame, bone) keeps 12 floats in the warp's scratch: its absolute
//      rotation and location from the FK, then, once its own transpose has
//      read them, its cotangents to its parent. A level's own inputs are
//      read before the previous level's barrier. T_t and the d_rel_loc
//      share go to shared memory;
//   3. phase 2, a thread a (clip, bone): the carry over the chunk's frames
//      in reverse, each frame's inputs read before the previous frame's
//      products, d_changes written over the staged changes, the d_rel_loc
//      shares summed in frame order (the last frame first);
//   4. d_changes copied out, coalesced.
// A level still costs hundreds of cycles of dependent shared-memory
// traffic, so phase 1 stays the largest part of the kernel (PERF.md).
// The carry and the sums stay in the phase-2 thread's registers from one
// chunk to the next. A clip of L <= kUnits frames is one chunk, and
// kUnits / L clips (at most one a phase-2 thread) share a thread block. No
// atomics: every run gives the same bits.

constexpr int kBwdWarps = 2;
constexpr int kFramesWarp = 5;                    // frames a warp walks
constexpr int kUnits = kBwdWarps * kFramesWarp;   // (clip, frame) a chunk

struct BwdPlan {
  int clips;   // clips a thread block
  int frames;  // frames a chunk (of each clip)
};

__host__ __device__ inline BwdPlan bwd_plan(int clip_length, int num_bones) {
  BwdPlan p;
  p.frames = clip_length < kUnits ? clip_length : kUnits;
  const int by_units = kUnits / p.frames;
  const int by_threads = kBwdWarps * 32 / num_bones;
  p.clips = by_units < by_threads ? by_units : by_threads;
  if (p.clips < 1) p.clips = 1;
  return p;
}

// Offsets into dynamic shared memory, in floats (each a multiple of 4):
// the staged ranges (4 floats of slack each way for the alignment: states,
// changes, g_proj, g_abs, rel_loc), the tree terms and d_rel_loc shares,
// each warp's [kFramesWarp][J][12] scratch of the tree walks, and the
// tree's arrays.
struct BwdLayout {
  int s, c, gp, ga, loc, ds, dl, scratch, tree, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int units, int clips, int J) {
  BwdLayout l;
  const int r9 = round4(units * J * 9 + 8), r3 = round4(units * J * 3 + 8);
  l.s = 0;
  l.c = l.s + r9;
  l.gp = l.c + r9;
  l.ga = l.gp + r3;
  l.loc = l.ga + r3;
  l.ds = l.loc + round4(clips * J * 3 + 8);
  l.dl = l.ds + round4(units * J * 9);
  l.scratch = l.dl + round4(units * J * 3);
  l.tree = l.scratch + kBwdWarps * kFramesWarp * J * 12;
  l.total = l.tree + kMaxBones + 32 * kMaxBones;
  return l;
}

// Lane `lane` of level d in phase 1: frame lane / n of the warp's frames
// and the level's bone lane % n (n bones on the level), packed with the
// bone's parent and children: frame (6 bits), bone (5), parent + 1 (6),
// children (6), their first index in `children` (5).
__device__ int level_entry(const Tree& tree, int d, int lane) {
  const int first = tree.level_start[d];
  const int n = tree.level_start[d + 1] - first;
  const int b = tree.by_level[first + lane % n];
  return (lane / n) | (b << 6) | ((tree.parent[b] + 1) << 11) |
         (tree.child_count[b] << 17) | (tree.child_start[b] << 23);
}

// One lane's (frame, bone) on a level of phase 1, with the bone's own
// inputs: S_t and rel_loc.
struct Lane {
  bool on;
  int f, b, p, nc, c0;  // frame, bone, parent (-1: root), children, first
  float s[9], loc[3];
};

__device__ __forceinline__ Lane lane_at(const int* t_level, int d, int lane,
                                        int fw, int u0, int units, int J,
                                        int F, const float* S,
                                        const float* LOC) {
  Lane x;
  const int e = t_level[d * 32 + lane];
  x.f = e & 63;
  x.b = (e >> 6) & 31;
  x.p = ((e >> 11) & 63) - 1;
  x.nc = (e >> 17) & 63;
  x.c0 = (e >> 23) & 31;
  x.on = x.f < fw && u0 + x.f < units;
  if (x.on) {
    const int u = u0 + x.f;
    const float* st = S + (u * J + x.b) * 9;
    const float* loc = LOC + ((u / F) * J + x.b) * 3;
#pragma unroll
    for (int i = 0; i < 9; ++i) x.s[i] = st[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) x.loc[i] = loc[i];
  }
  return x;
}

// Phase 2's inputs of the frame f of a chunk (at: its offset in the tree
// terms and the staged changes): T_t, C_t and S_{t-1} (staged, or the
// frame before the chunk from global memory, or rel_rot).
__device__ __forceinline__ void carry_inputs(
    const float* DS, const float* Cm, const float* S, int at, int f, int t0,
    long long clip, int L, int J, int j, const float* __restrict__ states,
    const float* __restrict__ rel_rot, float* tn, float* cn, float* sn) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    tn[i] = DS[at + i];
    cn[i] = Cm[at + i];
  }
  if (f > 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) sn[i] = S[at - J * 9 + i];
  } else {
    const float* prev = t0 > 0 ? states + ((clip * L + t0 - 1) * J + j) * 9
                               : rel_rot + (clip * J + j) * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) sn[i] = prev[i];
  }
}

__global__ void __launch_bounds__(kBwdWarps * 32)
fused_projection_train_bwd_kernel(const float* __restrict__ changes,
                                  const float* __restrict__ rel_loc,
                                  const float* __restrict__ rel_rot,
                                  const float* __restrict__ states,
                                  const float* __restrict__ g_proj,
                                  const float* __restrict__ g_abs,
                                  float* __restrict__ d_changes,
                                  float* __restrict__ d_rel_loc,
                                  float* __restrict__ d_rel_rot,
                                  int batch, int clip_length,
                                  const __grid_constant__ Tree tree,
                                  const __grid_constant__ Camera cam) {
  extern __shared__ __align__(16) float smem[];
  const int J = tree.num_bones, L = clip_length;
  const BwdPlan plan = bwd_plan(L, J);
  const BwdLayout lay = bwd_layout(plan.clips * plan.frames, plan.clips, J);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long clip0 = static_cast<long long>(blockIdx.x) * plan.clips;
  const int clips = static_cast<int>(
      min(static_cast<long long>(plan.clips), batch - clip0));
  const long long frames_all = static_cast<long long>(batch) * L * J;

  // the tree in shared memory: the children lists, and each level's
  // (frame, bone) of each lane (level_entry)
  int* t_children = reinterpret_cast<int*>(smem + lay.tree);
  int* t_level = t_children + kMaxBones;
  if (threadIdx.x < J) t_children[threadIdx.x] = tree.children[threadIdx.x];
  for (int i = threadIdx.x; i < tree.num_levels * 32; i += blockDim.x)
    t_level[i] = level_entry(tree, i / 32, i % 32);
  const int lo = stage_range(smem + lay.loc, rel_loc, clip0 * J * 3,
                             clips * J * 3, static_cast<long long>(batch) *
                                                J * 3);
  const float* LOC = smem + lay.loc + lo;
  float* scratch = smem + lay.scratch + warp * kFramesWarp * J * 12;
  const int fw_max = min(kFramesWarp, 32 / tree.widest);

  // phase 2's thread: (clip c2, bone j2)
  const int c2 = threadIdx.x / J, j2 = threadIdx.x % J;
  const bool carrier = c2 < clips;
  const long long clip2 = clip0 + c2;
  float carry[9], dloc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 9; ++i) carry[i] = 0.f;

  for (int t1 = L; t1 > 0; t1 -= plan.frames) {
    const int t0 = t1 > plan.frames ? t1 - plan.frames : 0;
    const int F = t1 - t0;  // frames of this chunk (all L when clips > 1)
    const int units = clips * F;
    // the chunk is rows [row0, row0 + units J) of the (B L J) rows
    const long long row0 = (clip0 * L + t0) * J;
    __syncthreads();  // the previous chunk is out of shared memory
    const int so = stage_range(smem + lay.s, states, row0 * 9, units * J * 9,
                               frames_all * 9);
    const int co = stage_range(smem + lay.c, changes, row0 * 9,
                               units * J * 9, frames_all * 9);
    const int po = stage_range(smem + lay.gp, g_proj, row0 * 3,
                               units * J * 3, frames_all * 3);
    const int ao = stage_range(smem + lay.ga, g_abs, row0 * 3, units * J * 3,
                               frames_all * 3);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* S = smem + lay.s + so;
    float* Cm = smem + lay.c + co;
    const float* GP = smem + lay.gp + po;
    const float* GA = smem + lay.ga + ao;
    float* DS = smem + lay.ds;
    float* DL = smem + lay.dl;

    // ---- phase 1: the tree terms, fw frames a warp at a time ----
    const int fw = min(fw_max, (units + kBwdWarps - 1) / kBwdWarps);
    const int nl = tree.num_levels;
    for (int u0 = warp * fw; u0 < units; u0 += kBwdWarps * fw) {
      // the FK replay, root first: scratch[f][b] = abs_rot (9), abs_loc
      // (3); a level's own inputs (the lane's entry, S, rel_loc) are read
      // before the previous level's barrier
      Lane cur = lane_at(t_level, 0, lane, fw, u0, units, J, F, S, LOC);
      for (int d = 0; d < nl; ++d) {
        const Lane nxt = d + 1 < nl ? lane_at(t_level, d + 1, lane, fw, u0,
                                               units, J, F, S, LOC)
                                    : cur;
        if (cur.on) {
          float* me = scratch + (cur.f * J + cur.b) * 12;
          if (cur.p < 0) {
#pragma unroll
            for (int i = 0; i < 9; ++i) me[i] = cur.s[i];
#pragma unroll
            for (int i = 0; i < 3; ++i) me[9 + i] = cur.loc[i];
          } else {
            const float* pa = scratch + (cur.f * J + cur.p) * 12;
            float pr[12];
#pragma unroll
            for (int i = 0; i < 12; ++i) pr[i] = pa[i];
            // abs_rot = S @ abs_rot[parent], abs_loc = loc @ abs_rot[parent]
            // + abs_loc[parent]
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int j = 0; j < 3; ++j)
                me[i * 3 + j] = cur.s[i * 3 + 0] * pr[0 + j]
                              + cur.s[i * 3 + 1] * pr[3 + j]
                              + cur.s[i * 3 + 2] * pr[6 + j];
#pragma unroll
            for (int j = 0; j < 3; ++j)
              me[9 + j] = cur.loc[0] * pr[j] + cur.loc[1] * pr[3 + j]
                        + cur.loc[2] * pr[6 + j] + pr[9 + j];
          }
        }
        __syncwarp();
        cur = nxt;
      }
      // the projection transposed, every (frame, bone) at once: frame
      // u's share of d_abs_loc, kept in DL until the transpose reads it
      for (int i = lane; i < fw * J; i += 32) {
        const int f = i / J, b = i % J, u = u0 + f;
        if (u >= units) continue;
        const float* me = scratch + (f * J + b) * 12;
        const float wx = me[10], wy = -me[9], wz = me[11];
        const float vx = wx * cam.r[0] + wy * cam.r[3] + wz * cam.r[6] + cam.t[0];
        const float vy = wx * cam.r[1] + wy * cam.r[4] + wz * cam.r[7] + cam.t[1];
        const float vz = wx * cam.r[2] + wy * cam.r[5] + wz * cam.r[8] + cam.t[2];
        const float inv_z = 1.0f / vz;
        const float* gp = GP + (u * J + b) * 3;
        const float* ga = GA + (u * J + b) * 3;
        const float dvx = -(cam.fx * inv_z) * gp[0];
        const float dvy = -(cam.fy * inv_z) * gp[1];
        const float dvz = gp[2] + (cam.fx * vx * gp[0] + cam.fy * vy * gp[1])
                                * (inv_z * inv_z);
        const float dwx = cam.r[0] * dvx + cam.r[1] * dvy + cam.r[2] * dvz;
        const float dwy = cam.r[3] * dvx + cam.r[4] * dvy + cam.r[5] * dvz;
        const float dwz = cam.r[6] * dvx + cam.r[7] * dvy + cam.r[8] * dvz;
        // (wx, wy, wz) = (ay, -ax, az) => da = (-dwy, dwx, dwz) + g_abs
        float* dl = DL + (u * J + b) * 3;
        dl[0] = ga[0] - dwy;
        dl[1] = ga[1] + dwx;
        dl[2] = ga[2] + dwz;
      }
      __syncwarp();
      // the transpose, deepest level first: a (frame, bone) reads its
      // children's cotangents and its parent's rotation, then overwrites
      // its own slot with its cotangents to its parent
      cur = lane_at(t_level, nl - 1, lane, fw, u0, units, J, F, S, LOC);
      for (int d = nl - 1; d >= 0; --d) {
        const Lane nxt = d > 0 ? lane_at(t_level, d - 1, lane, fw, u0, units,
                                         J, F, S, LOC)
                               : cur;
        if (cur.on) {
          const int u = u0 + cur.f;
          float* me = scratch + (cur.f * J + cur.b) * 12;
          float* dl = DL + (u * J + cur.b) * 3;
          float* ds = DS + (u * J + cur.b) * 9;
          float dal[3] = {dl[0], dl[1], dl[2]};
          float dar[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) dar[i] = 0.f;
          // the children (one level down) wrote their slots before the
          // last barrier, in descending bone index
          for (int k = 0; k < cur.nc; ++k) {
            const float* g = scratch + (cur.f * J + t_children[cur.c0 + k]) * 12;
#pragma unroll
            for (int i = 0; i < 3; ++i) dal[i] += g[i];
#pragma unroll
            for (int i = 0; i < 9; ++i) dar[i] += g[3 + i];
          }
          if (cur.p < 0) {
            // root: abs_rot = S_t, abs_loc = rel_loc
#pragma unroll
            for (int i = 0; i < 9; ++i) ds[i] = dar[i];
#pragma unroll
            for (int i = 0; i < 3; ++i) dl[i] = dal[i];
          } else {
            const float* pa = scratch + (cur.f * J + cur.p) * 12;
            float pr[9];
#pragma unroll
            for (int i = 0; i < 9; ++i) pr[i] = pa[i];
            // abs_loc[j] = sum_k loc[k] pr[k, j] + pl[j]
#pragma unroll
            for (int k = 0; k < 3; ++k)
              dl[k] = pr[k * 3 + 0] * dal[0] + pr[k * 3 + 1] * dal[1]
                    + pr[k * 3 + 2] * dal[2];
            // abs_rot[i, j] = sum_k S[i, k] pr[k, j]
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int k = 0; k < 3; ++k)
                ds[i * 3 + k] = dar[i * 3 + 0] * pr[k * 3 + 0]
                              + dar[i * 3 + 1] * pr[k * 3 + 1]
                              + dar[i * 3 + 2] * pr[k * 3 + 2];
#pragma unroll
            for (int i = 0; i < 3; ++i) me[i] = dal[i];
#pragma unroll
            for (int k = 0; k < 3; ++k)
#pragma unroll
              for (int j = 0; j < 3; ++j)
                me[3 + k * 3 + j] = cur.loc[k] * dal[j]
                                  + (cur.s[0 * 3 + k] * dar[0 * 3 + j]
                                     + cur.s[1 * 3 + k] * dar[1 * 3 + j]
                                     + cur.s[2 * 3 + k] * dar[2 * 3 + j]);
          }
        }
        __syncwarp();
        cur = nxt;
      }
    }
    __syncthreads();

    // ---- phase 2: a thread a (clip, bone), the carry in reverse; each
    // frame's inputs read before the previous frame's products ----
    if (carrier) {
      const int top = (c2 * F + F - 1) * J * 9 + j2 * 9;
      float tn[9], cn[9], sn[9];
      carry_inputs(DS, Cm, S, top, F - 1, t0, clip2, L, J, j2, states,
                   rel_rot, tn, cn, sn);
      for (int f = F - 1; f >= 0; --f) {
        const int at = top - (F - 1 - f) * J * 9;
        float ds[9], c[9], sp[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          ds[i] = tn[i] + carry[i];
          c[i] = cn[i];
          sp[i] = sn[i];
        }
        if (f > 0)
          carry_inputs(DS, Cm, S, at - J * 9, f - 1, t0, clip2, L, J, j2,
                       states, rel_rot, tn, cn, sn);
        // dC[i, k] = sum_j dS[i, j] S_prev[k, j]
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            Cm[at + i * 3 + k] = ds[i * 3 + 0] * sp[k * 3 + 0]
                               + ds[i * 3 + 1] * sp[k * 3 + 1]
                               + ds[i * 3 + 2] * sp[k * 3 + 2];
        // dS_prev[k, j] = sum_i C[i, k] dS[i, j]: the carry into frame t-1
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            carry[k * 3 + j] = c[0 * 3 + k] * ds[0 * 3 + j]
                             + c[1 * 3 + k] * ds[1 * 3 + j]
                             + c[2 * 3 + k] * ds[2 * 3 + j];
        const float* dl = DL + (at / 9) * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) dloc[i] += dl[i];
      }
    }
    __syncthreads();
    // d_changes out, a float a thread, coalesced
    for (int i = threadIdx.x; i < units * J * 9; i += blockDim.x)
      d_changes[row0 * 9 + i] = Cm[i];
  }

  if (carrier) {
#pragma unroll
    for (int i = 0; i < 3; ++i) d_rel_loc[(clip2 * J + j2) * 3 + i] = dloc[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) d_rel_rot[(clip2 * J + j2) * 9 + i] = carry[i];
  }
}

// Checks the tree and fills the kernels' arguments. Returns 0 or
// cudaErrorInvalidValue.
int make_tree(const int* parents, const int* depths, int num_bones,
              Tree* tree) {
  if (num_bones < 1 || num_bones > kMaxBones) return (int)cudaErrorInvalidValue;
  int num_levels = 0;
  for (int j = 0; j < kMaxBones; ++j) {
    tree->parent[j] = 0;
    tree->depth[j] = -1;
    tree->child_start[j] = 0;
    tree->child_count[j] = 0;
    tree->children[j] = 0;
    tree->by_level[j] = 0;
    tree->level_start[j] = 0;
  }
  tree->level_start[kMaxBones] = 0;
  for (int j = 0; j < num_bones; ++j) {
    if (parents[j] >= j || depths[j] < 0) return (int)cudaErrorInvalidValue;
    if (parents[j] < 0 ? depths[j] != 0 : depths[j] != depths[parents[j]] + 1)
      return (int)cudaErrorInvalidValue;
    tree->parent[j] = parents[j];
    tree->depth[j] = depths[j];
    if (parents[j] >= 0) ++tree->child_count[parents[j]];
    if (depths[j] + 1 > num_levels) num_levels = depths[j] + 1;
  }
  int start = 0;
  for (int j = 0; j < num_bones; ++j) {
    tree->child_start[j] = start;
    int n = 0;
    for (int c = num_bones - 1; c > j; --c)
      if (parents[c] == j) tree->children[start + n++] = c;
    start += n;
  }
  int k = 0;
  tree->widest = 0;
  for (int d = 0; d < num_levels; ++d) {
    tree->level_start[d] = k;
    for (int j = 0; j < num_bones; ++j)
      if (depths[j] == d) tree->by_level[k++] = j;
    if (k - tree->level_start[d] > tree->widest)
      tree->widest = k - tree->level_start[d];
  }
  tree->level_start[num_levels] = k;
  tree->num_bones = num_bones;
  tree->num_levels = num_levels;
  return 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers to device memory for the
// tensors; `parents`, `depths` and `camera` point to host memory and are
// copied into the kernels' parameters. Each returns cudaGetLastError() after
// its launch (0 on success) and launches nothing for an empty batch or clip.
extern "C" int pv2c_fused_projection_train_fwd(
    const float* changes, const float* rel_loc, const float* rel_rot,
    float* proj, float* abs_loc, float* states, int batch, int clip_length,
    const int* parents, const int* depths, int num_bones,
    const float* camera, void* stream) {
  return fk::launch_forward<true>(changes, rel_loc, rel_rot, proj, abs_loc,
                                  states, batch, clip_length, parents, depths,
                                  num_bones, camera, stream);
}

extern "C" int pv2c_fused_projection_train_bwd(
    const float* changes, const float* rel_loc, const float* rel_rot,
    const float* states, const float* g_proj, const float* g_abs,
    float* d_changes, float* d_rel_loc, float* d_rel_rot,
    int batch, int clip_length,
    const int* parents, const int* depths, int num_bones,
    const float* camera, void* stream) {
  Tree tree;
  const int err = make_tree(parents, depths, num_bones, &tree);
  if (err != 0) return err;
  if (batch < 0 || clip_length < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || clip_length == 0) return 0;
  const BwdPlan plan = bwd_plan(clip_length, num_bones);
  const int bytes = static_cast<int>(
      sizeof(float) *
      bwd_layout(plan.clips * plan.frames, plan.clips, num_bones).total);
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fused_projection_train_bwd_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (batch + plan.clips - 1) / plan.clips;
  fused_projection_train_bwd_kernel<<<blocks, kBwdWarps * 32, bytes,
                                      static_cast<cudaStream_t>(stream)>>>(
      changes, rel_loc, rel_rot, states, g_proj, g_abs, d_changes, d_rel_loc,
      d_rel_rot, batch, clip_length, tree, fk::make_camera(camera));
  return (int)cudaGetLastError();
}

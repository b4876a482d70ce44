// Trainable fused pose-changes -> forward kinematics -> camera projection:
// a forward and a hand-written backward kernel.
//
// Replace the TPU kernels of the JAX package's
// ops/pallas/fused_projection.py reached through `fused_projection_train`:
//   * fused_projection_train_fwd_kernel replaces `_fwd_train_kernel`
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
// Design: the serving kernel's layout. One warp per clip; lane j < J owns
// bone j for the whole clip and carries 9 rotation floats in registers.
//   * The TPU kernels grid over (batch block, frame) and carry the rotation
//     recurrence (forward) or its cotangent (backward) in VMEM from one grid
//     step to the next; grid steps run in order there. CUDA blocks run in no
//     order, so each warp loops over its clip's frames itself, forward in
//     the forward kernel and in reverse in the backward, with the carry in
//     registers.
//   * The FK walks the tree level by level through shared memory, with
//     __syncwarp() between levels (a clip never leaves its warp). The
//     backward replays it per frame from the stored S_t and keeps each
//     lane's parent absolute rotation for the transpose.
//   * The transposed tree walk runs deepest level first. A bone's cotangent
//     contributions to its parent (3 location + 9 rotation floats) go to
//     the bone's own 12-float slot in shared memory; after the level's
//     __syncwarp() the parent lane adds its children's slots in a fixed
//     order (descending bone index, as the JAX kernel's reversed loop does).
//     No atomics: every run gives the same bits.
//   * d_rel_loc sums over frames in registers and is written once; the
//     rotation cotangent carried across frames ends as d_rel_rot.
//   * The batch is not padded: a warp past the batch returns at once, and
//     lanes >= J only take part in the warp barriers.
// The tree (parents, depths, children) is an argument built from the
// skeleton's structure.json; the camera is 18 float constants.
//
// The order of operations follows the TPU kernels. nvcc contracts
// multiply-adds into FMAs, so results differ from the plain PyTorch version
// in the last bits only. Built without --use_fast_math: the pinhole divides
// by depth, and 1/vz must be IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBones = 32;
constexpr int kWarpsPerBlock = 4;

struct Tree {
  int parent[kMaxBones];
  int depth[kMaxBones];
  int child_start[kMaxBones];  // children of bone j: children[child_start[j]
  int child_count[kMaxBones];  //   .. child_start[j] + child_count[j]),
  int children[kMaxBones];     //   in descending bone index
  int num_bones;
  int num_levels;
};

struct Camera {
  float r[9];  // world->view rotation, row-major (row-vector convention)
  float t[3];
  float fx, fy, px, py, w, h;
};

// One frame's FK for the calling lane's bone, level by level:
//   abs_rot[b] = state[b] @ abs_rot[parent],
//   abs_loc[b] = loc[b] @ abs_rot[parent] + abs_loc[parent].
// Every lane of the warp calls it (the barriers are warp-wide). Returns the
// bone's absolute location in `al` and its parent's absolute rotation in
// `pr` (left unset for the root).
__device__ __forceinline__ void fk_frame(const Tree& tree, int lane,
                                         int depth, int parent,
                                         const float (&state)[9],
                                         const float (&loc)[3],
                                         float (*s_rot)[9], float (*s_loc)[3],
                                         float (&al)[3], float (&pr)[9]) {
  for (int d = 0; d < tree.num_levels; ++d) {
    if (depth == d) {
      float ar[9];
      if (d == 0) {
#pragma unroll
        for (int i = 0; i < 9; ++i) ar[i] = state[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) al[i] = loc[i];
      } else {
        float pl[3];
#pragma unroll
        for (int i = 0; i < 9; ++i) pr[i] = s_rot[parent][i];
#pragma unroll
        for (int i = 0; i < 3; ++i) pl[i] = s_loc[parent][i];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            ar[i * 3 + j] = state[i * 3 + 0] * pr[0 + j]
                          + state[i * 3 + 1] * pr[3 + j]
                          + state[i * 3 + 2] * pr[6 + j];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          al[j] = loc[0] * pr[j] + loc[1] * pr[3 + j] + loc[2] * pr[6 + j]
                + pl[j];
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) s_rot[lane][i] = ar[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) s_loc[lane][i] = al[i];
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_projection_train_fwd_kernel(const float* __restrict__ changes,
                                  const float* __restrict__ rel_loc,
                                  const float* __restrict__ rel_rot,
                                  float* __restrict__ proj,
                                  float* __restrict__ abs_loc,
                                  float* __restrict__ states,
                                  int batch, int clip_length,
                                  const __grid_constant__ Tree tree,
                                  const __grid_constant__ Camera cam) {
  __shared__ float s_rot[kWarpsPerBlock][kMaxBones][9];
  __shared__ float s_loc[kWarpsPerBlock][kMaxBones][3];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long clip = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (clip >= batch) return;  // uniform over the warp

  const int J = tree.num_bones;
  const bool active = lane < J;
  const int parent = active ? tree.parent[lane] : 0;
  const int depth = active ? tree.depth[lane] : -1;

  float loc[3], state[9], next[9];
  const long long frame0 = (clip * clip_length * J + lane);  // (clip, 0, lane)
  if (active) {
#pragma unroll
    for (int i = 0; i < 3; ++i) loc[i] = rel_loc[(clip * J + lane) * 3 + i];
#pragma unroll
    for (int i = 0; i < 9; ++i) state[i] = rel_rot[(clip * J + lane) * 9 + i];
#pragma unroll
    for (int i = 0; i < 9; ++i) next[i] = changes[frame0 * 9 + i];
  }

  for (int t = 0; t < clip_length; ++t) {
    const long long row = frame0 + (long long)t * J;  // (clip, t, lane)
    float c[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) c[i] = next[i];
    if (active && t + 1 < clip_length) {
#pragma unroll
      for (int i = 0; i < 9; ++i) next[i] = changes[(row + J) * 9 + i];
    }

    // S_t = C_t @ S_{t-1} (row-vector composition)
    if (active) {
      float s[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          s[i * 3 + j] = c[i * 3 + 0] * state[0 + j]
                       + c[i * 3 + 1] * state[3 + j]
                       + c[i * 3 + 2] * state[6 + j];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        state[i] = s[i];
        states[row * 9 + i] = s[i];
      }
    }

    float al[3], pr[9];
    fk_frame(tree, lane, depth, parent, state, loc, s_rot[warp], s_loc[warp],
             al, pr);

    if (active) {
#pragma unroll
      for (int i = 0; i < 3; ++i) abs_loc[row * 3 + i] = al[i];
      // P3D pose -> world axes: (x, y, z) -> (y, -x, z); view + pinhole
      const float wx = al[1], wy = -al[0], wz = al[2];
      const float vx = wx * cam.r[0] + wy * cam.r[3] + wz * cam.r[6] + cam.t[0];
      const float vy = wx * cam.r[1] + wy * cam.r[4] + wz * cam.r[7] + cam.t[1];
      const float vz = wx * cam.r[2] + wy * cam.r[5] + wz * cam.r[8] + cam.t[2];
      const float inv_z = 1.0f / vz;
      proj[row * 3 + 0] = cam.w - (cam.fx * vx * inv_z + cam.px);
      proj[row * 3 + 1] = cam.h - (cam.fy * vy * inv_z + cam.py);
      proj[row * 3 + 2] = vz;
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
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
  __shared__ float s_rot[kWarpsPerBlock][kMaxBones][9];
  __shared__ float s_loc[kWarpsPerBlock][kMaxBones][3];
  // per bone: its cotangent contributions to its parent (3 loc + 9 rot)
  __shared__ float s_grad[kWarpsPerBlock][kMaxBones][12];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long clip = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (clip >= batch) return;  // uniform over the warp

  const int J = tree.num_bones;
  const bool active = lane < J;
  const int parent = active ? tree.parent[lane] : 0;
  const int depth = active ? tree.depth[lane] : -1;
  const int child_start = active ? tree.child_start[lane] : 0;
  const int child_count = active ? tree.child_count[lane] : 0;

  float loc[3], state[9];
  float dloc[3] = {0.f, 0.f, 0.f};
  float carry[9];  // d S_t carried from frame t+1; zero at frame L-1
#pragma unroll
  for (int i = 0; i < 9; ++i) carry[i] = 0.f;
  const long long frame0 = (clip * clip_length * J + lane);  // (clip, 0, lane)
  if (active) {
#pragma unroll
    for (int i = 0; i < 3; ++i) loc[i] = rel_loc[(clip * J + lane) * 3 + i];
    const long long last = frame0 + (long long)(clip_length - 1) * J;
#pragma unroll
    for (int i = 0; i < 9; ++i) state[i] = states[last * 9 + i];
  }

  for (int t = clip_length - 1; t >= 0; --t) {
    const long long row = frame0 + (long long)t * J;  // (clip, t, lane)
    // S_{t-1}: the stored state of frame t-1, or rel_rot at frame 0
    float s_prev[9];
    if (active) {
      const float* src = t > 0 ? states + (row - J) * 9
                               : rel_rot + (clip * J + lane) * 9;
#pragma unroll
      for (int i = 0; i < 9; ++i) s_prev[i] = src[i];
    }

    // ---- FK replay from S_t ----
    float al[3], pr[9];
    fk_frame(tree, lane, depth, parent, state, loc, s_rot[warp], s_loc[warp],
             al, pr);

    // ---- transpose of axis swap + view transform + pinhole ----
    float dal[3], dar[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) dar[i] = 0.f;
    if (active) {
      const float wx = al[1], wy = -al[0], wz = al[2];
      const float vx = wx * cam.r[0] + wy * cam.r[3] + wz * cam.r[6] + cam.t[0];
      const float vy = wx * cam.r[1] + wy * cam.r[4] + wz * cam.r[7] + cam.t[1];
      const float vz = wx * cam.r[2] + wy * cam.r[5] + wz * cam.r[8] + cam.t[2];
      const float inv_z = 1.0f / vz;
      const float gx = g_proj[row * 3 + 0];
      const float gy = g_proj[row * 3 + 1];
      const float gz = g_proj[row * 3 + 2];
      const float dvx = -(cam.fx * inv_z) * gx;
      const float dvy = -(cam.fy * inv_z) * gy;
      const float dvz = gz + (cam.fx * vx * gx + cam.fy * vy * gy)
                           * (inv_z * inv_z);
      const float dwx = cam.r[0] * dvx + cam.r[1] * dvy + cam.r[2] * dvz;
      const float dwy = cam.r[3] * dvx + cam.r[4] * dvy + cam.r[5] * dvz;
      const float dwz = cam.r[6] * dvx + cam.r[7] * dvy + cam.r[8] * dvz;
      // (wx, wy, wz) = (ay, -ax, az) => da = (-dwy, dwx, dwz) + g_abs
      dal[0] = g_abs[row * 3 + 0] - dwy;
      dal[1] = g_abs[row * 3 + 1] + dwx;
      dal[2] = g_abs[row * 3 + 2] + dwz;
    }

    // ---- transpose of the FK tree, deepest level first ----
    float ds[9];  // d S_t of this bone: the tree term, then + carry
    for (int d = tree.num_levels - 1; d >= 0; --d) {
      if (depth == d) {
        // the children (one level down) wrote their slots before the last
        // barrier
        for (int k = 0; k < child_count; ++k) {
          const float* g = s_grad[warp][tree.children[child_start + k]];
#pragma unroll
          for (int i = 0; i < 3; ++i) dal[i] += g[i];
#pragma unroll
          for (int i = 0; i < 9; ++i) dar[i] += g[3 + i];
        }
        if (d == 0) {
          // root: abs_rot = S_t, abs_loc = rel_loc
#pragma unroll
          for (int i = 0; i < 9; ++i) ds[i] = dar[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) dloc[i] += dal[i];
        } else {
          // abs_loc[j] = sum_k loc[k] pr[k, j] + pl[j]
#pragma unroll
          for (int k = 0; k < 3; ++k)
            dloc[k] += pr[k * 3 + 0] * dal[0] + pr[k * 3 + 1] * dal[1]
                     + pr[k * 3 + 2] * dal[2];
          // abs_rot[i, j] = sum_k S[i, k] pr[k, j]
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int k = 0; k < 3; ++k)
              ds[i * 3 + k] = dar[i * 3 + 0] * pr[k * 3 + 0]
                            + dar[i * 3 + 1] * pr[k * 3 + 1]
                            + dar[i * 3 + 2] * pr[k * 3 + 2];
          float* g = s_grad[warp][lane];
#pragma unroll
          for (int i = 0; i < 3; ++i) g[i] = dal[i];
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              g[3 + k * 3 + j] = loc[k] * dal[j]
                               + (state[0 * 3 + k] * dar[0 * 3 + j]
                                  + state[1 * 3 + k] * dar[1 * 3 + j]
                                  + state[2 * 3 + k] * dar[2 * 3 + j]);
        }
      }
      __syncwarp();
    }

    // ---- transpose of S_t = C_t @ S_{t-1} ----
    if (active) {
      float c[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        c[i] = changes[row * 9 + i];
        ds[i] += carry[i];
      }
      // dC[i, k] = sum_j dS[i, j] S_prev[k, j]
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          d_changes[row * 9 + i * 3 + k] = ds[i * 3 + 0] * s_prev[k * 3 + 0]
                                         + ds[i * 3 + 1] * s_prev[k * 3 + 1]
                                         + ds[i * 3 + 2] * s_prev[k * 3 + 2];
      // dS_prev[k, j] = sum_i C[i, k] dS[i, j]: the next (earlier) frame's
      // carry; after frame 0 it is d rel_rot
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          carry[k * 3 + j] = c[0 * 3 + k] * ds[0 * 3 + j]
                           + c[1 * 3 + k] * ds[1 * 3 + j]
                           + c[2 * 3 + k] * ds[2 * 3 + j];
#pragma unroll
      for (int i = 0; i < 9; ++i) state[i] = s_prev[i];
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < 3; ++i) d_rel_loc[(clip * J + lane) * 3 + i] = dloc[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) d_rel_rot[(clip * J + lane) * 9 + i] = carry[i];
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
  }
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
  tree->num_bones = num_bones;
  tree->num_levels = num_levels;
  return 0;
}

Camera make_camera(const float* camera) {
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
  Tree tree;
  const int err = make_tree(parents, depths, num_bones, &tree);
  if (err != 0) return err;
  if (batch < 0 || clip_length < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || clip_length == 0) return 0;
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_projection_train_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      changes, rel_loc, rel_rot, proj, abs_loc, states, batch, clip_length,
      tree, make_camera(camera));
  return (int)cudaGetLastError();
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
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_projection_train_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      changes, rel_loc, rel_rot, states, g_proj, g_abs, d_changes, d_rel_loc,
      d_rel_rot, batch, clip_length, tree, make_camera(camera));
  return (int)cudaGetLastError();
}

// Fused pose-changes -> forward kinematics -> camera projection, forward only.
//
// Replaces the TPU kernel `_kernel` of the JAX package's
// ops/pallas/fused_projection.py (`fused_projection_pallas`, reached
// through `fused_projection`).
//
// Per clip it carries the relative rotations across frames
// (R_t = C_t @ R_{t-1}, row-vector), runs the bone-tree FK, swaps P3D pose
// axes to world axes (x, y, z) -> (y, -x, z), applies the camera's view
// transform and the pinhole:
//   pose_changes (B, L, J, 3, 3), rel_loc (B, J, 3), rel_rot (B, J, 3, 3)
//   -> out (B, L, J, 3) = (x_screen, y_screen, depth), all float32.
//
// Bound on an H100: memory. At B=1024, L=16 it reads 15.3 MB of pose
// changes and 1.3 MB of reference pose and writes 5.1 MB: about 21.7 MB,
// 6.5 us at 3.35 TB/s (SXM). The arithmetic is about 1.9k FMAs per
// (clip, frame), 62 MFLOP in all, which is nothing for the card.
//
// Design: one warp per clip; lane j < J owns bone j for the whole clip.
//   * One thread per clip would carry 26 x 9 rotation floats, 234 registers
//     before anything else, and spill; a lane per bone carries 9.
//   * Each lane composes its bone's carried rotation C_t @ R_{t-1} in
//     registers, and loads frame t+1's change while frame t computes, so a
//     load is in flight behind every frame's dependency chain.
//   * The FK walks the tree level by level (8 levels for CARLA). A lane at
//     depth d reads its parent's absolute rotation and location from shared
//     memory, writes its own, and the warp meets at __syncwarp() between
//     levels. No block-level barrier is needed: a clip never leaves its warp.
//   * Each lane projects its own joint and writes its 3 outputs; a warp
//     writes J * 12 contiguous bytes per frame.
//   * The batch is not padded: a warp whose clip index is past the batch
//     returns at once (the whole warp, so no __syncwarp waits on it), and
//     lanes >= J only take part in the warp barriers.
// The tree (parents and depths) is an argument, built by the caller from
// the skeleton's structure.json; the camera is 18 float constants.
//
// The order of operations follows the TPU kernel (compose, FK, then
// vx = wx*r00 + wy*r10 + wz*r20 + t0, inv_z = 1/vz, fx*vx*inv_z). nvcc
// contracts multiply-adds into FMAs, so results differ from the plain
// PyTorch version in the last bits only. Built without --use_fast_math:
// the pinhole divides by depth, and 1/vz must be IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBones = 32;
constexpr int kWarpsPerBlock = 4;

struct Tree {
  int parent[kMaxBones];
  int depth[kMaxBones];
  int num_bones;
  int num_levels;
};

struct Camera {
  float r[9];  // world->view rotation, row-major (row-vector convention)
  float t[3];
  float fx, fy, px, py, w, h;
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_projection_kernel(const float* __restrict__ changes,
                        const float* __restrict__ rel_loc,
                        const float* __restrict__ rel_rot,
                        float* __restrict__ out,
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
  const float* frame0 = changes + clip * clip_length * J * 9 + lane * 9;
  if (active) {
#pragma unroll
    for (int i = 0; i < 3; ++i) loc[i] = rel_loc[(clip * J + lane) * 3 + i];
#pragma unroll
    for (int i = 0; i < 9; ++i) state[i] = rel_rot[(clip * J + lane) * 9 + i];
#pragma unroll
    for (int i = 0; i < 9; ++i) next[i] = frame0[i];
  }

  for (int t = 0; t < clip_length; ++t) {
    float c[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) c[i] = next[i];
    if (active && t + 1 < clip_length) {
      const float* f = frame0 + (long long)(t + 1) * J * 9;
#pragma unroll
      for (int i = 0; i < 9; ++i) next[i] = f[i];
    }

    // state = C_t @ state (row-vector composition)
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
      for (int i = 0; i < 9; ++i) state[i] = s[i];
    }

    // FK, level by level:
    //   abs_rot[b] = state[b] @ abs_rot[parent]
    //   abs_loc[b] = loc[b] @ abs_rot[parent] + abs_loc[parent]
    float al[3] = {0.f, 0.f, 0.f};
    for (int d = 0; d < tree.num_levels; ++d) {
      if (depth == d) {
        float ar[9];
        if (d == 0) {
#pragma unroll
          for (int i = 0; i < 9; ++i) ar[i] = state[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) al[i] = loc[i];
        } else {
          float pr[9], pl[3];
#pragma unroll
          for (int i = 0; i < 9; ++i) pr[i] = s_rot[warp][parent][i];
#pragma unroll
          for (int i = 0; i < 3; ++i) pl[i] = s_loc[warp][parent][i];
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
        for (int i = 0; i < 9; ++i) s_rot[warp][lane][i] = ar[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) s_loc[warp][lane][i] = al[i];
      }
      __syncwarp();
    }

    if (active) {
      // P3D pose -> world axes: (x, y, z) -> (y, -x, z); view + pinhole
      const float wx = al[1], wy = -al[0], wz = al[2];
      const float vx = wx * cam.r[0] + wy * cam.r[3] + wz * cam.r[6] + cam.t[0];
      const float vy = wx * cam.r[1] + wy * cam.r[4] + wz * cam.r[7] + cam.t[1];
      const float vz = wx * cam.r[2] + wy * cam.r[5] + wz * cam.r[8] + cam.t[2];
      const float inv_z = 1.0f / vz;
      float* o = out + ((clip * clip_length + t) * J + lane) * 3;
      o[0] = cam.w - (cam.fx * vx * inv_z + cam.px);
      o[1] = cam.h - (cam.fy * vy * inv_z + cam.py);
      o[2] = vz;
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers to device memory for the
// tensors; `parents`, `depths` and `camera` point to host memory and are
// copied into the kernel's parameters. Returns cudaGetLastError() after the
// launch (0 on success); launches nothing for an empty batch or clip.
extern "C" int pv2c_fused_projection(const float* changes,
                                     const float* rel_loc,
                                     const float* rel_rot,
                                     float* out,
                                     int batch, int clip_length,
                                     const int* parents, const int* depths,
                                     int num_bones,
                                     const float* camera,
                                     void* stream) {
  if (num_bones < 1 || num_bones > kMaxBones || batch < 0 || clip_length < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || clip_length == 0) return 0;

  Tree tree;
  int num_levels = 0;
  for (int j = 0; j < num_bones; ++j) {
    if (parents[j] >= j || depths[j] < 0) return (int)cudaErrorInvalidValue;
    if (parents[j] < 0 ? depths[j] != 0 : depths[j] != depths[parents[j]] + 1)
      return (int)cudaErrorInvalidValue;
    tree.parent[j] = parents[j];
    tree.depth[j] = depths[j];
    if (depths[j] + 1 > num_levels) num_levels = depths[j] + 1;
  }
  for (int j = num_bones; j < kMaxBones; ++j) {
    tree.parent[j] = 0;
    tree.depth[j] = -1;
  }
  tree.num_bones = num_bones;
  tree.num_levels = num_levels;

  Camera cam;
  for (int i = 0; i < 9; ++i) cam.r[i] = camera[i];
  for (int i = 0; i < 3; ++i) cam.t[i] = camera[9 + i];
  cam.fx = camera[12];
  cam.fy = camera[13];
  cam.px = camera[14];
  cam.py = camera[15];
  cam.w = camera[16];
  cam.h = camera[17];

  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_projection_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      changes, rel_loc, rel_rot, out, batch, clip_length, tree, cam);
  return (int)cudaGetLastError();
}

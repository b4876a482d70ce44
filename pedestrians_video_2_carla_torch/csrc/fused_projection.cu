// Fused pose-changes -> forward kinematics -> camera projection, forward only.
//
// Replaces the TPU kernel `_kernel` of the JAX package's
// ops/pallas/fused_projection.py (`fused_projection_pallas`, reached
// through `fused_projection`).
//
//   pose_changes (B, L, J, 3, 3), rel_loc (B, J, 3), rel_rot (B, J, 3, 3)
//   -> out (B, L, J, 3) = (x_screen, y_screen, depth), all float32.
//
// Bound on an H100: memory. At B=1024, L=16 it reads 15.3 MB of pose
// changes and 1.3 MB of reference pose and writes 5.1 MB: about 21.7 MB,
// 6.5 us at 3.35 TB/s (SXM). The arithmetic the function needs is about
// 1.9k FMAs per (clip, frame), 62 MFLOP in all, which is nothing for the
// card.
//
// The kernel is fk_forward_kernel<false> of fk_forward.cuh, which the
// training forward shares: chunks of clips staged by cp.async, the carry a
// thread a (clip, bone), then the FK level by level, a thread a (frame,
// bone) of a level, and the projection of every joint at once (the design
// is described there).

#include <cuda_runtime.h>

// fk_forward.cuh includes mma_tf32.cuh; it stands here too because the
// build hashes (ops/cuda_build.py) the headers a source names itself.
#include "mma_tf32.cuh"
#include "fk_forward.cuh"

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
  return fk::launch_forward<false>(changes, rel_loc, rel_rot, out, nullptr,
                                   nullptr, batch, clip_length, parents,
                                   depths, num_bones, camera, stream);
}

#ifdef PV2C_FK_SPLIT
// The instrumented copy's counter of cycles by phase (4 of them), or null
// to stop counting.
extern "C" int pv2c_fk_split_set(unsigned long long* cycles) {
  return static_cast<int>(
      cudaMemcpyToSymbol(fk::g_fk_split, &cycles, sizeof(cycles)));
}
#endif

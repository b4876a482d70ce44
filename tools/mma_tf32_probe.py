"""Measures the rate of the tensor cores' TF32 ``mma.sync`` (m16n8k8, the
instruction of csrc/mma_tf32.cuh that the port's 3xTF32 products use) on
the card: each warp issues 16 independent tiles a loop iteration, on
registers only (no memory traffic), at 4 to 64 warps an SM.

    python3 tools/mma_tf32_probe.py

Modes: ``chain1`` one product a tile and iteration, accumulated in the
tensor cores (the instruction's own rate); ``chain3`` the three products
of 3xTF32 a tile and iteration, chained into one accumulator (the products
3xTF32 needs, without the split, the loads or the fp32 sum outside). One
JSON line a measurement: TF32 TFLOP/s and, for ``chain3``, the fp32
products a second that rate is worth (a third of it). Needs one CUDA card.
"""
import ctypes
import json
import os
import shutil
import sys

import torch

sys.path.insert(0, os.getcwd())
from pedestrians_video_2_carla_torch.ops import cuda_build  # noqa: E402

SOURCE = r'''
#include <cuda_runtime.h>
#include "mma_tf32.cuh"

template <int CHAIN>
__global__ void probe(float* out, int iters) {
  unsigned a[4], as[4], b[2], bs[2];
  for (int c = 0; c < 4; ++c) {
    a[c] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + c);
    as[c] = __float_as_uint(1e-4f * c);
  }
  for (int c = 0; c < 2; ++c) {
    b[c] = __float_as_uint(0.5f + c);
    bs[c] = __float_as_uint(1e-5f * c);
  }
  float d[16][4];
  for (int j = 0; j < 16; ++j)
    for (int c = 0; c < 4; ++c) d[j][c] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (CHAIN == 3) {
        mma_tf32(d[j], as, b);
        mma_tf32(d[j], a, bs);
      }
      mma_tf32(d[j], a, b);
    }
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j)
    for (int c = 0; c < 4; ++c) s += d[j][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(float* out, int blocks, int threads, int iters, int chain,
                   cudaStream_t stream) {
  if (chain == 3)
    probe<3><<<blocks, threads, 0, stream>>>(out, iters);
  else
    probe<1><<<blocks, threads, 0, stream>>>(out, iters);
  return cudaGetLastError();
}
'''
#: (thread blocks an SM, threads a thread block)
OCCUPANCY = ((1, 128), (2, 128), (4, 128), (4, 256), (8, 256))
ITERS = 2000


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    d = cuda_build.BUILD_DIR.parent / "mma_probe"
    d.mkdir(parents=True, exist_ok=True)
    source = d / "mma_tf32_probe.cu"
    source.write_text(SOURCE)
    shutil.copy(cuda_build.CSRC / "mma_tf32.cuh", d / "mma_tf32.cuh")
    lib = ctypes.CDLL(str(cuda_build.build_library(source)))
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for chain in (1, 3):
        for per_sm, threads in OCCUPANCY:
            blocks = sms * per_sm
            for _ in range(2):
                if lib.run(out.data_ptr(), blocks, threads, ITERS, chain,
                           stream):
                    sys.exit("launch failed")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run(out.data_ptr(), blocks, threads, ITERS, chain, stream)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            mmas = blocks * threads // 32 * ITERS * 16 * chain
            tflops = mmas * 2 * 16 * 8 * 8 / ms / 1e9
            print(json.dumps({
                "card": torch.cuda.get_device_name(0),
                "mode": f"chain{chain}", "warps_per_sm": per_sm * threads // 32,
                "ms": ms, "tf32_tflops": tflops,
                "fp32_products_tflops": tflops / chain}), flush=True)


if __name__ == "__main__":
    main()

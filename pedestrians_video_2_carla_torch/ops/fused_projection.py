"""Fused pose-changes -> FK -> camera projection: the CUDA kernel of
``csrc/fused_projection.cu``, its plain PyTorch version, and the autograd
wrapper around both.

The kernel replaces the TPU kernel ``_kernel`` of the JAX package's
``ops/pallas/fused_projection.py`` (``fused_projection_pallas``). On an H100
it is bound by memory: about 21.7 MB at B=1024, L=16, 6.5 us at 3.35 TB/s.
Its design (one warp per clip, a lane per bone, the FK walked level by level
through shared memory) is described in the source.

``fused_projection`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback from one to the other. Its
backward re-runs the plain version under autograd, exactly as the JAX
package's custom VJP does.

The library is built with ``nvcc`` at first use, from the checkout's own
source, into ``build/torch_kernels/`` beside the package, keyed by a hash of
the source and the flags (an edited ``.cu`` rebuilds).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..skeletons.carla import BONE_DEPTHS, PARENTS
from . import camera as C
from . import kinematics as K

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_projection.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the tree, as the kernel's C interface takes it
_PARENTS = np.ascontiguousarray(PARENTS, dtype=np.int32)
_DEPTHS = np.ascontiguousarray(BONE_DEPTHS, dtype=np.int32)

_lib = None


def _nvcc() -> str:
    """nvcc of $CUDA_HOME (or $CUDA_PATH), else of $PATH, else of the
    toolkit's default install prefix."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/fused_projection.cu")
    return path


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"fused_projection-{digest[:16]}.so"


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside it as ``.log``. Raises on any failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.pv2c_fused_projection
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_inputs(pose_changes, rel_loc, rel_rot):
    if pose_changes.ndim != 5 or pose_changes.shape[-2:] != (3, 3):
        raise ValueError("pose_changes must be (B, L, J, 3, 3), got "
                         f"{tuple(pose_changes.shape)}")
    B, _, J = pose_changes.shape[:3]
    if J != len(PARENTS):
        raise ValueError(f"pose_changes has {J} bones, the skeleton "
                         f"{len(PARENTS)}")
    if tuple(rel_loc.shape) != (B, J, 3):
        raise ValueError(f"rel_loc must be {(B, J, 3)}, got "
                         f"{tuple(rel_loc.shape)}")
    if tuple(rel_rot.shape) != (B, J, 3, 3):
        raise ValueError(f"rel_rot must be {(B, J, 3, 3)}, got "
                         f"{tuple(rel_rot.shape)}")
    for name, t in (("pose_changes", pose_changes), ("rel_loc", rel_loc),
                    ("rel_rot", rel_rot)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != pose_changes.device:
            raise ValueError(f"{name} is on {t.device}, pose_changes on "
                             f"{pose_changes.device}")


def fused_projection_cuda(pose_changes: torch.Tensor, rel_loc: torch.Tensor,
                          rel_rot: torch.Tensor,
                          camera: C.PinholeCamera) -> torch.Tensor:
    """Launch the CUDA kernel: (B, L, J, 3, 3), (B, J, 3), (B, J, 3, 3)
    float32 contiguous CUDA tensors -> (B, L, J, 3). Adds one to
    ``fused_projection_cuda.launches`` per launch."""
    _check_inputs(pose_changes, rel_loc, rel_rot)
    if pose_changes.device.type != "cuda":
        raise ValueError("fused_projection_cuda needs CUDA tensors, got "
                         f"{pose_changes.device}")
    for name, t in (("pose_changes", pose_changes), ("rel_loc", rel_loc),
                    ("rel_rot", rel_rot)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, L, J = pose_changes.shape[:3]
    out = torch.empty((B, L, J, 3), dtype=torch.float32,
                      device=pose_changes.device)
    if out.numel() == 0:
        return out
    lib = _library()
    consts = (ctypes.c_float * 18)(*camera.constants())
    with torch.cuda.device(pose_changes.device):
        stream = torch.cuda.current_stream(pose_changes.device).cuda_stream
        err = lib.pv2c_fused_projection(
            pose_changes.data_ptr(), rel_loc.data_ptr(), rel_rot.data_ptr(),
            out.data_ptr(), B, L,
            _PARENTS.ctypes.data, _DEPTHS.ctypes.data, J,
            ctypes.cast(consts, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"fused_projection kernel launch failed: CUDA "
                           f"error {err}")
    fused_projection_cuda.launches += 1
    return out


fused_projection_cuda.launches = 0


def fused_projection_reference(pose_changes, rel_loc, rel_rot,
                               camera: C.PinholeCamera) -> torch.Tensor:
    """The plain PyTorch version: numerical reference and backward."""
    _, abs_loc, _ = K.relative_pose_over_clip(pose_changes, rel_loc, rel_rot)
    return C.project_pose(camera, abs_loc)


class FusedProjection(torch.autograd.Function):
    """Kernel forward (CUDA) or plain forward (CPU); the backward is autograd
    of the plain version, as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, pose_changes, rel_loc, rel_rot, camera):
        _check_inputs(pose_changes, rel_loc, rel_rot)
        ctx.camera = camera
        ctx.save_for_backward(pose_changes, rel_loc, rel_rot)
        if pose_changes.device.type == "cuda":
            return fused_projection_cuda(pose_changes, rel_loc, rel_rot,
                                         camera)
        if pose_changes.device.type != "cpu":
            raise ValueError(
                f"fused_projection runs on cuda or cpu, not "
                f"{pose_changes.device}")
        return fused_projection_reference(pose_changes, rel_loc, rel_rot,
                                          camera)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = fused_projection_reference(*inputs, ctx.camera)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None)


def fused_projection(pose_changes: torch.Tensor, rel_loc: torch.Tensor,
                     rel_rot: torch.Tensor,
                     camera: C.PinholeCamera) -> torch.Tensor:
    """(B, L, 26, 3, 3), (B, 26, 3), (B, 26, 3, 3) float32 -> projections
    (B, L, 26, 3) = (x_screen, y_screen, depth)."""
    return FusedProjection.apply(pose_changes, rel_loc, rel_rot, camera)

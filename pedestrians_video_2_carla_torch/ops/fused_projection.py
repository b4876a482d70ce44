"""Fused pose-changes -> FK -> camera projection: the CUDA kernels of
``csrc/fused_projection.cu`` (forward only, for serving) and
``csrc/fused_projection_train.cu`` (a forward and a hand-written backward,
for training), their plain PyTorch versions, and the autograd wrappers.

The kernels replace the TPU kernels of the JAX package's
``ops/pallas/fused_projection.py``:
  * ``fused_projection_cuda`` replaces ``_kernel`` (``fused_projection_pallas``);
  * ``fused_projection_train_cuda_fwd`` replaces ``_fwd_train_kernel``
    (``_train_fwd_slabs``);
  * ``fused_projection_train_cuda_bwd`` replaces ``_bwd_train_kernel``
    (``_train_bwd``).
On an H100 memory bounds all three: at B=1024, L=16 they move about 21.7,
42.2 and 58.8 MB (6.5, 12.6 and 17.5 us at 3.35 TB/s). Their designs are
described in the sources. The two forwards are one template
(``csrc/fk_forward.cuh``): chunks of clips staged by ``cp.async``, the
rotation carry a thread a (clip, bone), then the FK level by level, a thread
a (frame, bone) of a level (``fused_projection_fwd_algorithm`` is that
algorithm in plain PyTorch, ``fwd_plan`` its chunk plan). The backward computes the frames' tree terms
in parallel, then the carry (``fused_projection_train_bwd_reference``).

``fused_projection`` and ``fused_projection_train`` launch the kernels for
CUDA tensors and run the plain versions for CPU tensors; there is no
fallback from one to the other. Their forwards are the ``torch.library``
ops ``pv2c::fused_projection`` and ``pv2c::fused_projection_train_fwd``
(the kernel on the card, the plain version on the CPU, the output shapes
alone for fake tensors), so ``torch.export`` records each as one node of
a serving program. ``fused_projection``'s backward re-runs the
plain version under autograd, as the JAX package's custom VJP does;
``fused_projection_train``'s backward is the backward kernel on the card and
autograd of the plain version on the CPU.

Each library is built with ``nvcc`` at first use, from the checkout's own
source (``ops/cuda_build.py``).
"""
import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..skeletons.carla import BONE_DEPTHS, PARENTS
from . import camera as C
from . import cuda_build
from . import kinematics as K
from .cuda_build import INT as _INT, PTR as _PTR

_SOURCE = cuda_build.CSRC / "fused_projection.cu"
_TRAIN_SOURCE = cuda_build.CSRC / "fused_projection_train.cu"
BUILD_DIR = cuda_build.BUILD_DIR

#: the tree, as the kernels' C interface takes it
_PARENTS = np.ascontiguousarray(PARENTS, dtype=np.int32)
_DEPTHS = np.ascontiguousarray(BONE_DEPTHS, dtype=np.int32)


def library_path(source: Optional[Path] = None) -> Path:
    """Where the library for ``source`` (default: the serving kernel's) and
    the current flags lives."""
    return cuda_build.library_path(_SOURCE if source is None else source)


#: each library's C functions and their argument types
_SIGNATURES = {
    "serve": {
        "pv2c_fused_projection":
            [_PTR] * 4 + [_INT] * 2 + [_PTR] * 2 + [_INT] + [_PTR] * 2},
    "train": {
        "pv2c_fused_projection_train_fwd":
            [_PTR] * 6 + [_INT] * 2 + [_PTR] * 2 + [_INT] + [_PTR] * 2,
        "pv2c_fused_projection_train_bwd":
            [_PTR] * 9 + [_INT] * 2 + [_PTR] * 2 + [_INT] + [_PTR] * 2},
}


def _library(which: str):
    """The loaded library of the serving (``"serve"``) or the training
    (``"train"``) kernels, built at first use."""
    source = {"serve": _SOURCE, "train": _TRAIN_SOURCE}[which]
    return cuda_build.load_library(source, _SIGNATURES[which])


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary (a view into a larger tensor): the kernels stage their inputs
    with 16-byte copies from such boundaries."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, device: torch.device, *args) -> None:
    """Call a C launcher on the current stream of ``device``: tensor
    arguments go as device pointers, then the tree and the camera."""
    *tensors, B, L, camera = args
    consts = (ctypes.c_float * 18)(*camera.constants())
    with torch.cuda.device(device):
        err = fn(*(t.data_ptr() for t in tensors), B, L,
                 _PARENTS.ctypes.data, _DEPTHS.ctypes.data, len(_PARENTS),
                 ctypes.cast(consts, ctypes.c_void_p),
                 torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check_launch(err, fn.__name__)


def fused_projection_cuda(pose_changes: torch.Tensor, rel_loc: torch.Tensor,
                          rel_rot: torch.Tensor,
                          camera: C.PinholeCamera) -> torch.Tensor:
    """Launch the serving kernel: (B, L, J, 3, 3), (B, J, 3), (B, J, 3, 3)
    float32 contiguous CUDA tensors -> (B, L, J, 3). Adds one to
    ``fused_projection_cuda.launches`` per launch."""
    _check_inputs(pose_changes, rel_loc, rel_rot)
    cuda_build.check_cuda_tensors("fused_projection_cuda",
                                  pose_changes=pose_changes, rel_loc=rel_loc,
                                  rel_rot=rel_rot)
    B, L, J = pose_changes.shape[:3]
    out = torch.empty((B, L, J, 3), dtype=torch.float32,
                      device=pose_changes.device)
    if out.numel() == 0:
        return out
    _launch(_library("serve").pv2c_fused_projection, pose_changes.device,
            *map(_aligned, (pose_changes, rel_loc, rel_rot)), out, B, L,
            camera)
    fused_projection_cuda.launches += 1
    return out


cuda_build.counted("fused_projection", fused_projection_cuda)


def fused_projection_reference(pose_changes, rel_loc, rel_rot,
                               camera: C.PinholeCamera) -> torch.Tensor:
    """The plain PyTorch version: numerical reference and backward."""
    _, abs_loc, _ = K.relative_pose_over_clip(pose_changes, rel_loc, rel_rot)
    return C.project_pose(camera, abs_loc)


#: the forward kernels' chunk plan (``csrc/fk_forward.cuh``: kUnits,
#: kLongFrames, kMaxClips, kThreads): at most FWD_UNITS (clip, frame) units
#: a chunk, FWD_LONG_FRAMES frames a chunk of a longer clip, FWD_MAX_CLIPS
#: clips in a thread block of FWD_THREADS threads
FWD_UNITS, FWD_LONG_FRAMES, FWD_MAX_CLIPS, FWD_THREADS = 32, 16, 8, 256


def fwd_plan(clip_length: int) -> Tuple[int, int]:
    """The forward kernels' ``(clips a thread block, frames a chunk)`` at
    ``clip_length`` >= 1 (``fk::plan``): a clip of at most FWD_UNITS frames
    is one chunk, shared with the clips that fit beside it; a longer one
    has a thread block to itself and runs in chunks of FWD_LONG_FRAMES
    frames, the carry passed from one to the next."""
    if clip_length <= FWD_UNITS:
        return min(FWD_UNITS // clip_length, FWD_MAX_CLIPS), clip_length
    return 1, FWD_LONG_FRAMES


def tree_levels(parents=PARENTS) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """The bones level by level (by depth, then index), each with its
    parent (-1 for a root): the forward kernels' tree (``fk::make_tree``)."""
    depth = []
    for p in (int(p) for p in parents):
        depth.append(depth[p] + 1 if p >= 0 else 0)
    return tuple(tuple((j, int(parents[j])) for j in range(len(depth))
                       if depth[j] == d) for d in range(max(depth) + 1))


def fused_projection_fwd_algorithm(pose_changes, rel_loc, rel_rot,
                                   camera: C.PinholeCamera,
                                   train: bool = False):
    """The forward kernels' algorithm in plain PyTorch, with the inputs and
    outputs of ``fused_projection_cuda`` (``train=False``) or of
    ``fused_projection_train_cuda_fwd`` (``train=True``: ``(proj, abs_loc,
    states)``). First the rotation carry, S_t = C_t @ S_{t-1} (S_{-1} =
    rel_rot), in the chunks of ``fwd_plan``, the carry passed from one to
    the next. Then the FK of every frame at once, level by level
    (``tree_levels``): abs_loc[b] = loc[b] @ abs_rot[parent] +
    abs_loc[parent] and abs_rot[b] = S[b] @ abs_rot[parent]; then the
    projection of abs_loc."""
    B, L, J = pose_changes.shape[:3]
    _, frames = fwd_plan(max(L, 1))
    states = torch.empty_like(pose_changes)
    carry = rel_rot
    for t0 in range(0, L, frames):
        for t in range(t0, min(t0 + frames, L)):
            carry = pose_changes[:, t] @ carry
            states[:, t] = carry
    loc = rel_loc[:, None].expand(B, L, J, 3)
    abs_rot, abs_loc = [None] * J, [None] * J
    for level in tree_levels():
        for b, p in level:
            if p < 0:
                abs_rot[b], abs_loc[b] = states[:, :, b], loc[:, :, b]
                continue
            abs_loc[b] = (loc[:, :, b, None] @ abs_rot[p])[..., 0, :] \
                + abs_loc[p]
            abs_rot[b] = states[:, :, b] @ abs_rot[p]
    abs_loc = torch.stack(abs_loc, 2)
    proj = C.project_pose(camera, abs_loc)
    if train:
        return proj, abs_loc, states.reshape(B, L, J, 9)
    return proj


# The forwards as ``torch.library`` ops, so that ``torch.export`` records
# each as one node of the graph (a ctypes launch cannot be traced): the CUDA
# kernel for CUDA tensors, the plain version for CPU tensors, and for fake
# tensors the output shapes alone. The camera goes as its 18 constants.

@torch.library.custom_op("pv2c::fused_projection", mutates_args=(),
                         device_types="cpu")
def fused_projection_op(pose_changes: torch.Tensor, rel_loc: torch.Tensor,
                        rel_rot: torch.Tensor,
                        camera: List[float]) -> torch.Tensor:
    """Row 1's entry: ``fused_projection_cuda`` on the card, the plain
    version on the CPU."""
    return fused_projection_reference(
        pose_changes, rel_loc, rel_rot, C.camera_from_constants(tuple(camera)))


@fused_projection_op.register_kernel("cuda")
def _(pose_changes, rel_loc, rel_rot, camera):
    return fused_projection_cuda(pose_changes, rel_loc, rel_rot,
                                 C.camera_from_constants(tuple(camera)))


@fused_projection_op.register_fake
def _(pose_changes, rel_loc, rel_rot, camera):
    _check_inputs(pose_changes, rel_loc, rel_rot)
    return pose_changes.new_empty(pose_changes.shape[:3] + (3,))


class FusedProjection(torch.autograd.Function):
    """Kernel forward (CUDA) or plain forward (CPU), through
    ``pv2c::fused_projection``; the backward is autograd of the plain
    version, as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, pose_changes, rel_loc, rel_rot, camera):
        _check_inputs(pose_changes, rel_loc, rel_rot)
        ctx.camera = camera
        ctx.save_for_backward(pose_changes, rel_loc, rel_rot)
        return fused_projection_op(pose_changes, rel_loc, rel_rot,
                                   list(camera.constants()))

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


# ---------------------------------------------------------------------------
# Training: kernel forward AND kernel backward.
#
# The forward also writes the absolute pose locations (so the 3D losses need
# no other FK) and the carried relative rotation of every frame (the
# backward's residuals). The backward is the hand-written transpose: each
# frame's tree terms (FK replayed from the stored state, the tree walked
# deepest level first), frames in parallel, then the rotation cotangent
# carried over the frames in reverse.
# ---------------------------------------------------------------------------

def fused_projection_train_reference(pose_changes, rel_loc, rel_rot,
                                     camera: C.PinholeCamera
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``(proj, abs_loc)``, each (B, L, J, 3).
    Its backward is plain autograd."""
    _, abs_loc, _ = K.relative_pose_over_clip(pose_changes, rel_loc, rel_rot)
    return C.project_pose(camera, abs_loc), abs_loc


#: (clip, frame) units a chunk of the backward kernel
#: (``csrc/fused_projection_train.cu``, kUnits): a longer clip runs in
#: chunks, the rotation carry passed from one to the next
TRAIN_BWD_UNITS = 10


def fused_projection_train_bwd_reference(pose_changes, rel_loc, rel_rot,
                                         states, g_proj, g_abs,
                                         camera: C.PinholeCamera
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """The backward kernel's algorithm in plain PyTorch: the same inputs
    and outputs as ``fused_projection_train_cuda_bwd``. First each frame's
    tree terms, frames independent of each other: the FK replayed from the
    forward's ``states`` S_t, the projection transposed, the tree walked
    from the last bone to the root, giving T_t (the cotangent of S_t from
    frame t, (B, J, 3, 3)) and frame t's share of d_rel_loc. Then the
    rotation carry over the frames in reverse: dS_t = T_t + carry,
    d_pose_changes_t = dS_t S_{t-1}^T, carry = C_t^T dS_t (S_{-1} =
    rel_rot), d_rel_rot the last carry, d_rel_loc the shares summed from
    the last frame to the first."""
    B, L, J = pose_changes.shape[:3]
    S = states.reshape(B, L, J, 3, 3)
    loc = rel_loc[:, None].expand(B, L, J, 3)
    r = camera.R.to(S)
    fx, fy = camera.focal
    # the FK replay, parents first (a parent's index is below its child's)
    abs_rot, abs_loc = [None] * J, [None] * J
    for j in range(J):
        p = int(PARENTS[j])
        if p < 0:
            abs_rot[j], abs_loc[j] = S[:, :, j], loc[:, :, j]
        else:
            abs_rot[j] = S[:, :, j] @ abs_rot[p]
            abs_loc[j] = (loc[:, :, j, None] @ abs_rot[p])[..., 0, :] \
                + abs_loc[p]
    al = torch.stack(abs_loc, 2)
    # the projection transposed: pose axes (x, y, z) -> world (y, -x, z),
    # view v = w R + T, pinhole
    w = torch.stack((al[..., 1], -al[..., 0], al[..., 2]), -1)
    v = w @ r + camera.T.to(S)
    inv_z = 1.0 / v[..., 2]
    dv = torch.stack((-(fx * inv_z) * g_proj[..., 0],
                      -(fy * inv_z) * g_proj[..., 1],
                      g_proj[..., 2] + (fx * v[..., 0] * g_proj[..., 0]
                                        + fy * v[..., 1] * g_proj[..., 1])
                      * (inv_z * inv_z)), -1)
    dw = dv @ r.transpose(0, 1)
    dal = list((g_abs + torch.stack((-dw[..., 1], dw[..., 0], dw[..., 2]),
                                    -1)).unbind(2))
    # the tree transposed, children (higher indices) before their parents
    dar = [torch.zeros_like(S[:, :, 0]) for _ in range(J)]
    tree, share = [None] * J, [None] * J
    for j in reversed(range(J)):
        p = int(PARENTS[j])
        if p < 0:
            tree[j], share[j] = dar[j], dal[j]
            continue
        pr = abs_rot[p]
        share[j] = (pr @ dal[j][..., None])[..., 0]
        tree[j] = dar[j] @ pr.transpose(-1, -2)
        dal[p] = dal[p] + dal[j]
        dar[p] = dar[p] + (loc[:, :, j, :, None] * dal[j][..., None, :]
                           + S[:, :, j].transpose(-1, -2) @ dar[j])
    tree, share = torch.stack(tree, 2), torch.stack(share, 2)
    # the carry, last frame first
    d_changes = torch.empty_like(S)
    carry = torch.zeros_like(rel_rot)
    d_rel_loc = torch.zeros_like(rel_loc)
    for t in reversed(range(L)):
        ds = tree[:, t] + carry
        prev = S[:, t - 1] if t > 0 else rel_rot
        d_changes[:, t] = ds @ prev.transpose(-1, -2)
        carry = pose_changes[:, t].transpose(-1, -2) @ ds
        d_rel_loc = d_rel_loc + share[:, t]
    return d_changes, d_rel_loc, carry


def fused_projection_train_cuda_fwd(pose_changes: torch.Tensor,
                                    rel_loc: torch.Tensor,
                                    rel_rot: torch.Tensor,
                                    camera: C.PinholeCamera
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Launch the training forward kernel: (B, L, J, 3, 3), (B, J, 3),
    (B, J, 3, 3) float32 contiguous CUDA tensors -> ``(proj (B, L, J, 3),
    abs_loc (B, L, J, 3), states (B, L, J, 9))``. Adds one to
    ``fused_projection_train_cuda_fwd.launches`` per launch."""
    _check_inputs(pose_changes, rel_loc, rel_rot)
    cuda_build.check_cuda_tensors("fused_projection_train_cuda_fwd",
                                  pose_changes=pose_changes, rel_loc=rel_loc,
                                  rel_rot=rel_rot)
    B, L, J = pose_changes.shape[:3]
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=pose_changes.device)
    proj, abs_loc, states = empty((B, L, J, 3)), empty((B, L, J, 3)), \
        empty((B, L, J, 9))
    if proj.numel() == 0:
        return proj, abs_loc, states
    _launch(_library("train").pv2c_fused_projection_train_fwd,
            pose_changes.device,
            *map(_aligned, (pose_changes, rel_loc, rel_rot)),
            proj, abs_loc, states, B, L, camera)
    fused_projection_train_cuda_fwd.launches += 1
    return proj, abs_loc, states


cuda_build.counted("fused_projection_train_fwd",
                   fused_projection_train_cuda_fwd)


def fused_projection_train_cuda_bwd(pose_changes: torch.Tensor,
                                    rel_loc: torch.Tensor,
                                    rel_rot: torch.Tensor,
                                    states: torch.Tensor,
                                    g_proj: torch.Tensor,
                                    g_abs: torch.Tensor,
                                    camera: C.PinholeCamera
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Launch the training backward kernel on the forward's inputs, its
    ``states`` and the cotangents of ``proj`` and ``abs_loc`` (all float32
    contiguous CUDA tensors) -> ``(d_pose_changes (B, L, J, 3, 3),
    d_rel_loc (B, J, 3), d_rel_rot (B, J, 3, 3))``. Adds one to
    ``fused_projection_train_cuda_bwd.launches`` per launch."""
    _check_inputs(pose_changes, rel_loc, rel_rot)
    B, L, J = pose_changes.shape[:3]
    for name, t, shape in (("states", states, (B, L, J, 9)),
                           ("g_proj", g_proj, (B, L, J, 3)),
                           ("g_abs", g_abs, (B, L, J, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    cuda_build.check_cuda_tensors("fused_projection_train_cuda_bwd",
                                  pose_changes=pose_changes, rel_loc=rel_loc,
                                  rel_rot=rel_rot, states=states,
                                  g_proj=g_proj, g_abs=g_abs)
    d_changes = torch.empty_like(pose_changes)
    if d_changes.numel() == 0:
        return d_changes, torch.zeros_like(rel_loc), torch.zeros_like(rel_rot)
    d_rel_loc, d_rel_rot = torch.empty_like(rel_loc), torch.empty_like(rel_rot)
    _launch(_library("train").pv2c_fused_projection_train_bwd,
            pose_changes.device,
            *map(_aligned, (pose_changes, rel_loc, rel_rot, states, g_proj,
                            g_abs)),
            d_changes, d_rel_loc, d_rel_rot, B, L, camera)
    fused_projection_train_cuda_bwd.launches += 1
    return d_changes, d_rel_loc, d_rel_rot


cuda_build.counted("fused_projection_train_bwd",
                   fused_projection_train_cuda_bwd)


@torch.library.custom_op("pv2c::fused_projection_train_fwd", mutates_args=(),
                         device_types="cpu")
def fused_projection_train_fwd_op(pose_changes: torch.Tensor,
                                  rel_loc: torch.Tensor,
                                  rel_rot: torch.Tensor, camera: List[float]
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Row 2's entry: ``fused_projection_train_cuda_fwd`` on the card; on
    the CPU the plain version, with the carried rotations as ``states``."""
    states, abs_loc, _ = K.relative_pose_over_clip(pose_changes, rel_loc,
                                                   rel_rot)
    proj = C.project_pose(C.camera_from_constants(tuple(camera)), abs_loc)
    return proj, abs_loc, states.reshape(abs_loc.shape[:3] + (9,))


@fused_projection_train_fwd_op.register_kernel("cuda")
def _(pose_changes, rel_loc, rel_rot, camera):
    return fused_projection_train_cuda_fwd(
        pose_changes, rel_loc, rel_rot, C.camera_from_constants(tuple(camera)))


@fused_projection_train_fwd_op.register_fake
def _(pose_changes, rel_loc, rel_rot, camera):
    _check_inputs(pose_changes, rel_loc, rel_rot)
    shape = pose_changes.shape[:3]
    return (pose_changes.new_empty(shape + (3,)),
            pose_changes.new_empty(shape + (3,)),
            pose_changes.new_empty(shape + (9,)))


class FusedProjectionTrain(torch.autograd.Function):
    """Kernel forward and kernel backward (CUDA), or the plain forward and
    autograd of it (CPU), as the JAX package's ``fused_projection_train``
    custom VJP; the forward is ``pv2c::fused_projection_train_fwd``."""

    @staticmethod
    def forward(ctx, pose_changes, rel_loc, rel_rot, camera):
        _check_inputs(pose_changes, rel_loc, rel_rot)
        # an output that no loss used gets a zero cotangent, not None
        ctx.set_materialize_grads(True)
        ctx.camera = camera
        inputs = tuple(t.contiguous()
                       for t in (pose_changes, rel_loc, rel_rot))
        proj, abs_loc, states = fused_projection_train_fwd_op(
            *inputs, list(camera.constants()))
        if pose_changes.device.type == "cuda":
            ctx.save_for_backward(*inputs, states)
        else:
            ctx.save_for_backward(*inputs)
        return proj, abs_loc

    @staticmethod
    def backward(ctx, g_proj, g_abs):
        saved = ctx.saved_tensors
        if saved[0].device.type == "cuda":
            grads = fused_projection_train_cuda_bwd(
                *saved, g_proj.contiguous(), g_abs.contiguous(), ctx.camera)
        else:
            inputs = [t.detach().requires_grad_(True) for t in saved]
            with torch.enable_grad():
                outs = fused_projection_train_reference(*inputs, ctx.camera)
                grads = torch.autograd.grad(outs, inputs, (g_proj, g_abs))
        return (*grads, None)


def fused_projection_train(pose_changes: torch.Tensor, rel_loc: torch.Tensor,
                           rel_rot: torch.Tensor, camera: C.PinholeCamera
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trainable fused FK + projection: (B, L, 26, 3, 3), (B, 26, 3),
    (B, 26, 3, 3) float32 -> ``(projections (B, L, 26, 3), abs_loc
    (B, L, 26, 3))``: the screen projections and the absolute pose
    locations (P3D pose space), both tensors the 2D + 3D losses consume."""
    return FusedProjectionTrain.apply(pose_changes, rel_loc, rel_rot, camera)

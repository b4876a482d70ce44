"""Port parity for the fused FK + projection: the plain PyTorch version and
the ``"fused"`` route (which runs the plain version for CPU tensors) against
the JAX package's Pallas kernel (interpret mode on the CPU, as
tests/ops/test_pallas_fused.py runs it) and its XLA reference; the forward
kernels' algorithm in plain PyTorch against the JAX serving and training
kernels, and its chunk plan against the CUDA source's constants; the
autograd wrapper's gradients against ``jax.grad``; input checks; and, on a
CUDA card only, the CUDA kernels against the plain version and the
algorithm."""
import functools
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.ops import camera as JC
from pedestrians_video_2_carla_tpu.ops.pallas.fused_projection import (
    _train_fwd as j_train_fwd,
    fused_projection as j_fused_projection, fused_projection_pallas,
    fused_projection_reference as j_reference,
    fused_projection_train as j_fused_projection_train)
from pedestrians_video_2_carla_tpu.skeletons.carla import reference_poses_tensor

from pedestrians_video_2_carla_torch.ops import camera as TC
from pedestrians_video_2_carla_torch.ops import cuda_build
from pedestrians_video_2_carla_torch.ops import fused_projection as FP
from pedestrians_video_2_carla_torch.ops import kinematics as K
from pedestrians_video_2_carla_torch.ops.projection import ProjectionModule
from pedestrians_video_2_carla_torch.skeletons.carla import (BONE_DEPTHS,
                                                             PARENTS)

from .ops.np_reference import random_rotation_matrices
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L = 5, 4


def _inputs(rng, batch=B, clip=L):
    agi = rng.integers(0, 4, size=batch)
    locs, rots = reference_poses_tensor()
    changes = random_rotation_matrices(rng, (batch, clip, 26)).astype(np.float32)
    return changes, locs[agi], rots[agi]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@functools.lru_cache(maxsize=None)
def _pallas_case():
    """One seeded batch and the JAX Pallas kernel's output on it. Interpret
    mode takes seconds per call on the CPU, so the parametrized cases below
    share this one call."""
    changes, locs, rots = _inputs(np.random.default_rng(22742))
    pallas = np.asarray(fused_projection_pallas(
        jnp.asarray(changes), jnp.asarray(locs), jnp.asarray(rots),
        JC.make_camera()))
    return changes, locs, rots, pallas


@pytest.mark.parametrize("port_fn", [FP.fused_projection_reference,
                                     FP.fused_projection],
                         ids=["plain", "fused_route"])
def test_matches_jax_pallas_and_reference(port_fn):
    changes, locs, rots, pallas = _pallas_case()
    port = port_fn(*_t(changes, locs, rots), TC.make_camera()).numpy()
    assert port.shape == (B, L, 26, 3)
    ref = np.asarray(j_reference(changes, locs, rots, JC.make_camera()))
    np.testing.assert_allclose(port, pallas, atol=1e-3)   # pixels
    np.testing.assert_allclose(port, ref, atol=1e-4)


@pytest.mark.parametrize("batch,clip", [(3, 4), (1, 1), (7, 2)])
def test_ragged_batch_and_clip(rng, batch, clip):
    # no padding to a block in the port: any B and L go straight through
    changes, locs, rots = _inputs(rng, batch, clip)
    port = FP.fused_projection(*_t(changes, locs, rots), TC.make_camera())
    assert port.shape == (batch, clip, 26, 3)
    ref = np.asarray(j_reference(changes, locs, rots, JC.make_camera()))
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-4)


def test_gradients_match_jax(rng):
    """All three cotangents, with the scaled tolerance of the JAX package's
    kernel-gradient test (test_pallas_fused.py). A short clip: the JAX
    forward runs the kernel in interpret mode."""
    changes, locs, rots = _inputs(rng, 2, 2)
    tensors = [t.requires_grad_(True) for t in _t(changes, locs, rots)]
    out = FP.fused_projection(*tensors, TC.make_camera())
    torch.sin(out[..., :2] * 0.01).sum().backward()

    j_cam = JC.make_camera()  # outside the jit: nondiff args are no tracers

    def loss(c, l, r):
        return jnp.sum(jnp.sin(
            j_fused_projection(c, l, r, j_cam)[..., :2] * 0.01))
    refs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(changes), jnp.asarray(locs), jnp.asarray(rots))
    for t, ref in zip(tensors, refs):
        ref = np.asarray(ref)
        scale = max(float(np.abs(ref).max()), 1e-8)
        np.testing.assert_allclose(t.grad.numpy() / scale, ref / scale,
                                   rtol=1e-4, atol=1e-5)


def _train_bwd_case(batch, clip, seed=5):
    """Seeded inputs of the training backward: the forward's inputs, its
    states (the plain carry) and the two cotangents, as numpy arrays."""
    rng = np.random.default_rng(seed)
    changes, locs, rots = _inputs(rng, batch, clip)
    states = K.accumulate_pose_changes(*_t(changes, rots)).reshape(
        batch, clip, 26, 9).numpy()
    g_proj, g_abs = (rng.standard_normal((batch, clip, 26, 3)).astype(
        np.float32) for _ in range(2))
    return changes, locs, rots, states, g_proj, g_abs


def _assert_grads_close(got, refs):
    """Each gradient within 1e-4 of its largest magnitude (atol 1e-5 on
    that scale), the JAX kernel-gradient test's bar."""
    for g, ref in zip(got, refs):
        ref = np.asarray(ref)
        scale = max(float(np.abs(ref).max()), 1e-8)
        np.testing.assert_allclose(np.asarray(g) / scale, ref / scale,
                                   rtol=1e-4, atol=1e-5)


#: a clip longer than one of the backward kernel's chunks
_LONG_CLIP = FP.TRAIN_BWD_UNITS + 1


@pytest.mark.parametrize("batch,clip", [(1, 1), (1, 2), (1, 5), (3, 1),
                                        (3, 2), (3, 5), (2, _LONG_CLIP)])
def test_train_backward_decomposition_matches_autograd(batch, clip):
    # the backward kernel's algorithm (per-frame tree terms, then the carry)
    # against autograd of the plain forward
    changes, locs, rots, states, g_proj, g_abs = _train_bwd_case(batch, clip)
    cam = TC.make_camera()
    got = FP.fused_projection_train_bwd_reference(
        *_t(changes, locs, rots, states, g_proj, g_abs), cam)
    assert [tuple(g.shape) for g in got] == [
        changes.shape, locs.shape, rots.shape]
    inputs = [t.requires_grad_(True) for t in _t(changes, locs, rots)]
    refs = torch.autograd.grad(
        FP.fused_projection_train_reference(*inputs, cam), inputs,
        _t(g_proj, g_abs))
    _assert_grads_close([g.numpy() for g in got], [r.numpy() for r in refs])


@functools.lru_cache(maxsize=None)
def _jax_train_bwd_case():
    """The JAX package's training backward (its Pallas kernel, in
    interpret mode on the CPU) at B=3 and a clip longer than one of the
    port's chunks. One call (about 20 s) for the cases below: the clips are
    independent, so B=1 is the first clip's slice."""
    case = _train_bwd_case(3, _LONG_CLIP)
    changes, locs, rots, _, g_proj, g_abs = case
    cam = JC.make_camera()
    _, vjp = jax.vjp(lambda c, l, r: j_fused_projection_train(c, l, r, cam),
                     jnp.asarray(changes), jnp.asarray(locs),
                     jnp.asarray(rots))
    return case, [np.asarray(g) for g in vjp((jnp.asarray(g_proj),
                                                jnp.asarray(g_abs)))]


@pytest.mark.parametrize("batch", [1, 3])
def test_train_backward_decomposition_matches_jax(batch):
    (changes, locs, rots, states, g_proj, g_abs), refs = _jax_train_bwd_case()
    got = FP.fused_projection_train_bwd_reference(
        *_t(*(a[:batch] for a in (changes, locs, rots, states, g_proj,
                                  g_abs))), TC.make_camera())
    _assert_grads_close([g.numpy() for g in got], [r[:batch] for r in refs])


#: the forward algorithm's cases against the JAX kernels: clips longer than
#: one chunk (the carry passed from chunk to chunk), one frame a clip with
#: more clips than a thread block takes, and ``_pallas_case``'s batch (fewer
#: clips than a thread block takes)
_FWD_CASES = {"long": (2, FP.FWD_UNITS + 1), "one_frame":
              (FP.FWD_MAX_CLIPS + 1, 1), "ragged": (B, L)}


@functools.lru_cache(maxsize=None)
def _jax_fwd_case(name):
    """Seeded inputs, the JAX serving kernel's projections on them and the
    JAX training kernel's ``(proj, abs_loc, states)``, in interpret mode,
    one call each (about 3 to 10 s). The serving kernel's body holds the
    whole clip, and its interpret-mode compile grows past minutes at a few
    dozen frames, so the long case holds the serving algorithm to the
    training kernel's projections, the same function."""
    if name == "ragged":
        changes, locs, rots, pallas = _pallas_case()
    else:
        batch, clip = _FWD_CASES[name]
        changes, locs, rots = _inputs(np.random.default_rng(31), batch, clip)
        pallas = None if name == "long" else np.asarray(
            fused_projection_pallas(jnp.asarray(changes), jnp.asarray(locs),
                                    jnp.asarray(rots), JC.make_camera()))
    (proj, abs_loc), residuals = j_train_fwd(
        jnp.asarray(changes), jnp.asarray(locs), jnp.asarray(rots),
        JC.make_camera())
    # the states' slabs (L, 9, J, padded B) -> (B, L, J, 9)
    states = np.asarray(jnp.transpose(residuals[3], (3, 0, 2, 1)))
    trained = (np.asarray(proj), np.asarray(abs_loc),
               states[:changes.shape[0]])
    return (changes, locs, rots), \
        trained[0] if pallas is None else pallas, trained


def _assert_proj_close(got, ref):
    np.testing.assert_allclose(got[..., :2], ref[..., :2], atol=1e-3)  # px
    np.testing.assert_allclose(got[..., 2], ref[..., 2], atol=1e-4)


@pytest.mark.parametrize("case", list(_FWD_CASES))
def test_fwd_algorithm_matches_jax_serving_kernel(case):
    # the serving kernel's algorithm (chunked carry, FK level by level)
    inputs, pallas, _ = _jax_fwd_case(case)
    got = FP.fused_projection_fwd_algorithm(*_t(*inputs),
                                            TC.make_camera()).numpy()
    assert got.shape == pallas.shape
    _assert_proj_close(got, pallas)


@pytest.mark.parametrize("case", list(_FWD_CASES))
def test_fwd_algorithm_matches_jax_training_kernel(case):
    # the training forward's: proj, abs_loc and the carried states, which
    # are also the plane algebra's accumulate_pose_changes
    inputs, _, (proj, abs_loc, states) = _jax_fwd_case(case)
    changes, locs, rots = _t(*inputs)
    got = FP.fused_projection_fwd_algorithm(changes, locs, rots,
                                            TC.make_camera(), train=True)
    _assert_proj_close(got[0].numpy(), proj)
    np.testing.assert_allclose(got[1].numpy(), abs_loc, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), states, atol=1e-5)
    carried = K.accumulate_pose_changes(changes, rots)
    np.testing.assert_allclose(
        got[2].numpy(), carried.reshape(got[2].shape).numpy(), atol=1e-5)


def test_fwd_plan_mirror_matches_the_source():
    # the plan's constants as csrc/fk_forward.cuh has them, and the plan
    text = (cuda_build.CSRC / "fk_forward.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert (FP.FWD_UNITS, FP.FWD_LONG_FRAMES, FP.FWD_MAX_CLIPS,
            FP.FWD_THREADS) == tuple(int(consts[k]) for k in (
                "kUnits", "kLongFrames", "kMaxClips", "kThreads"))
    for clip in range(1, 3 * FP.FWD_UNITS):
        clips, frames = FP.fwd_plan(clip)
        if clip <= FP.FWD_UNITS:   # whole clips a chunk
            assert frames == clip
            assert clips == min(FP.FWD_UNITS // clip, FP.FWD_MAX_CLIPS)
        else:                      # a thread block a clip, chunk by chunk
            assert (clips, frames) == (1, FP.FWD_LONG_FRAMES)


def test_tree_levels_follow_the_skeleton():
    levels = FP.tree_levels()
    assert sorted(b for level in levels for b, _ in level) == list(range(26))
    for d, level in enumerate(levels):
        assert [b for b, _ in level] == sorted(b for b, _ in level)
        for b, p in level:
            assert (BONE_DEPTHS[b], PARENTS[b]) == (d, p)


def test_misaligned_views_are_copied_to_an_aligned_start():
    # the kernels stage their inputs with 16-byte copies
    x = torch.arange(40, dtype=torch.float32)
    assert FP._aligned(x) is x
    view = x[1:]
    assert view.data_ptr() % 16 != 0
    copy = FP._aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


@pytest.mark.parametrize("bad", ["float64", "joints", "rel_loc", "rel_rot",
                                 "rank"])
def test_rejects_bad_inputs(rng, bad):
    changes, locs, rots = _t(*_inputs(rng))
    if bad == "float64":
        changes = changes.double()
    elif bad == "joints":
        changes = changes[:, :, :25]
    elif bad == "rel_loc":
        locs = locs[:-1]
    elif bad == "rel_rot":
        rots = rots[..., :2]
    else:
        changes = changes[0]
    with pytest.raises((TypeError, ValueError)):
        FP.fused_projection(changes, locs, rots, TC.make_camera())


def test_kernel_wrapper_never_runs_on_the_cpu(rng):
    # no quiet fallback: the CUDA wrapper refuses CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        FP.fused_projection_cuda(*_t(*_inputs(rng)), TC.make_camera())
    assert FP.fused_projection_cuda.launches == 0


def test_projection_kernel_names():
    assert ProjectionModule(kernel="fused").kernel == "fused"
    assert ProjectionModule(kernel="fused_train").kernel == "fused_train"
    # the JAX package's names are not the port's
    for jax_name in ("xla", "pallas", "pallas_train"):
        with pytest.raises(ValueError):
            ProjectionModule(kernel=jax_name)


def test_library_path_follows_the_source(tmp_path, monkeypatch):
    # the build is keyed by the source: an edited .cu gets a new library
    first = FP.library_path()
    src = tmp_path / "fused_projection.cu"
    src.write_bytes(FP._SOURCE.read_bytes() + b"\n// edited\n")
    for header in cuda_build._local_headers(FP._SOURCE):  # its includes
        shutil.copy(header, tmp_path / header.name)
    monkeypatch.setattr(FP, "_SOURCE", src)
    assert FP.library_path() != first
    assert FP.library_path().parent == FP.BUILD_DIR


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,clip", [(1024, 16), (1000, 16), (5, 16),
                                        (64, 1)])
def test_cuda_kernel_matches_plain(rng, cuda_device, batch, clip):
    args = tuple(t.to(cuda_device) for t in _t(*_inputs(rng, batch, clip)))
    cam = TC.make_camera()
    out = FP.fused_projection_cuda(*args, cam)
    ref = FP.fused_projection_reference(*args, cam)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert float(err[..., :2].max()) <= 1e-3      # pixels
    assert float(err[..., 2].max()) <= 1e-4       # metres


@pytest.mark.cuda
@pytest.mark.parametrize("batch,clip", [(1024, 16), (1000, 16), (5, 16),
                                        (64, 1), (5, 2)])
def test_cuda_train_forward_matches_plain(rng, cuda_device, batch, clip):
    args = tuple(t.to(cuda_device) for t in _t(*_inputs(rng, batch, clip)))
    cam = TC.make_camera()
    proj, abs_loc, states = FP.fused_projection_train_cuda_fwd(*args, cam)
    ref_proj, ref_abs = FP.fused_projection_train_reference(*args, cam)
    torch.cuda.synchronize()
    err = (proj - ref_proj).abs()
    assert float(err[..., :2].max()) <= 1e-3      # pixels
    assert float(err[..., 2].max()) <= 1e-4       # metres
    assert float((abs_loc - ref_abs).abs().max()) <= 1e-5
    assert states.shape == (batch, clip, 26, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,clip", [(1024, 16), (1000, 16), (5, 16),
                                        (64, 1), (5, 2)])
def test_cuda_train_backward_matches_plain(rng, cuda_device, batch, clip):
    args = tuple(t.to(cuda_device) for t in _t(*_inputs(rng, batch, clip)))
    cam = TC.make_camera()
    g_proj = torch.from_numpy(rng.standard_normal(
        (batch, clip, 26, 3)).astype(np.float32)).to(cuda_device)
    g_abs = torch.from_numpy(rng.standard_normal(
        (batch, clip, 26, 3)).astype(np.float32)).to(cuda_device)
    _, _, states = FP.fused_projection_train_cuda_fwd(*args, cam)
    grads = FP.fused_projection_train_cuda_bwd(*args, states, g_proj, g_abs,
                                               cam)
    inputs = [t.clone().requires_grad_(True) for t in args]
    refs = torch.autograd.grad(FP.fused_projection_train_reference(
        *inputs, cam), inputs, (g_proj, g_abs))
    for g, ref in zip(grads, refs):
        scale = max(float(ref.abs().max()), 1e-8)
        torch.testing.assert_close(g / scale, ref / scale, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,clip", [(1024, 16), (3, 5), (1, 1),
                                        (3, _LONG_CLIP), (64, 81)])
def test_cuda_train_backward_matches_decomposition(cuda_device, batch, clip):
    # the kernel against its plain version, the same algorithm
    arrays = _train_bwd_case(batch, clip)
    args = tuple(t.to(cuda_device) for t in _t(*arrays))
    cam = TC.make_camera()
    grads = FP.fused_projection_train_cuda_bwd(*args, cam)
    refs = FP.fused_projection_train_bwd_reference(*args, cam)
    torch.cuda.synchronize()
    _assert_grads_close([g.cpu().numpy() for g in grads],
                        [r.cpu().numpy() for r in refs])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,clip", [(1024, 16), (1024, 1), (1024, 81),
                                        (3, 81)])
def test_cuda_forwards_match_algorithm_and_plain(rng, cuda_device, batch,
                                                 clip):
    args = tuple(t.to(cuda_device) for t in _t(*_inputs(rng, batch, clip)))
    cam = TC.make_camera()
    out = FP.fused_projection_cuda(*args, cam)
    proj, abs_loc, states = FP.fused_projection_train_cuda_fwd(*args, cam)
    algo = FP.fused_projection_fwd_algorithm(*args, cam, train=True)
    plain = FP.fused_projection_reference(*args, cam)
    torch.cuda.synchronize()
    for got in (out, proj):
        for ref in (algo[0], plain):
            err = (got - ref).abs()
            assert float(err[..., :2].max()) <= 1e-3      # pixels
            assert float(err[..., 2].max()) <= 1e-4       # metres
    assert float((abs_loc - algo[1]).abs().max()) <= 1e-5
    assert float((states - algo[2]).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_kernels_take_misaligned_views(rng, cuda_device):
    # views 936 and 312 bytes into their storage: the wrappers copy them
    args = tuple(t.to(cuda_device)[1:] for t in _t(*_inputs(rng, 5, 1)))
    assert all(t.data_ptr() % 16 for t in args)
    cam = TC.make_camera()
    plain = FP.fused_projection_reference(*args, cam)
    proj, _, states = FP.fused_projection_train_cuda_fwd(*args, cam)
    g = torch.ones_like(proj)
    grads = FP.fused_projection_train_cuda_bwd(*args, states, g, g, cam)
    refs = FP.fused_projection_train_bwd_reference(*args, states, g, g, cam)
    torch.cuda.synchronize()
    for got in (FP.fused_projection_cuda(*args, cam), proj):
        assert float((got - plain)[..., :2].abs().max()) <= 1e-3
    _assert_grads_close([x.cpu().numpy() for x in grads],
                        [r.cpu().numpy() for r in refs])

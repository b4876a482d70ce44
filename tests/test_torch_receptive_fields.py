"""PoseFormer at the published receptive fields the card now takes, on the
CPU: the port's ``PoseFormer(receptive_frames=27)`` against the JAX model on
its xla path (forward within 1e-5, and one ``training_step``'s loss and
gradients against the JAX flow's: each leaf within 1e-4 of its largest
magnitude) on seeded inputs and imported weights; and the transformer
kernels' limits, with the shared-memory layouts that decide them mirrored
in the wrappers, for T=81 at D=832 with 8 heads, the spatial head width 32
and E=64 with hidden 128."""
import functools

import jax
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
    PoseLiftingFlow as JPoseLiftingFlow
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.losses import primary_loss as j_primary
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.movements.pose_former import \
    PoseFormer as JPoseFormer

from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.jax_import import (
    import_flow_params, import_pose_former)
from pedestrians_video_2_carla_torch.models.movements.pose_former import \
    PoseFormer
from pedestrians_video_2_carla_torch.ops import fused_spatial_transformer as FS
from pedestrians_video_2_carla_torch.ops import \
    fused_temporal_transformer as FT
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L = 2, 29
#: receptive field 27 (3 windows a clip), depth 1, frame_dim 26 x 8 = 208
RF27 = dict(clip_length=L, receptive_frames=27,
            single_joint_embeddings_size=8, depth=1, num_heads=4)
ATOL, W_BAR, LOSS_RTOL, LR = 1e-5, 1e-4, 1e-4, 1e-3


@functools.lru_cache(maxsize=None)
def _jax_forward():
    x = np.random.default_rng(22746).standard_normal(
        (B, L, 26, 2)).astype(np.float32)
    model = JPoseFormer(**RF27, spatial_kernel="xla", temporal_kernel="xla")
    variables = model.init(jax.random.PRNGKey(5), x)
    return x, jax.device_get(variables["params"]), np.asarray(
        model.apply(variables, x))


def test_pose_former_rf27_matches_jax():
    x, params, ref = _jax_forward()
    model = PoseFormer(**RF27)
    model.load_state_dict(import_pose_former(params))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (B, L, 26, 3)
    assert model.eval_slice == slice(13, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """A JAX flow's initial params, a batch, and one training step's loss
    and gradients (the body of its ``training_step``)."""
    batch = jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(7), JD.Carla2D3DConfig(batch_size=B,
                                                  clip_length=L)))
    flow = JPoseLiftingFlow(
        movements_model=JPoseFormer(**RF27, spatial_kernel="xla",
                                    temporal_kernel="xla"),
        loss_modes=[JLossModes.loc_2d_3d],
        movements_optimizer=JOptimizerSettings(lr=LR))
    state = flow.init_state(jax.random.PRNGKey(1), batch)

    def loss_fn(params):
        sliced, _ = flow._inner_step(params, state.mutables, batch,
                                     training=True, rngs=None)
        losses = flow._compute_losses(sliced, sliced["targets"])
        return j_primary(losses, flow.requested_loss_modes)[1]
    primary, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    return jax.device_get((state.params, batch, primary, grads))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def test_pose_former_rf27_training_step_matches_jax():
    j_params, j_batch, j_primary_loss, j_grads = _jax_step()
    flow = PoseLiftingFlow(PoseFormer(**RF27), loss_modes=["loc_2d_3d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           device="cpu")
    state = flow.init_state(import_flow_params(j_params, device="cpu"))
    state, logs = flow.training_step(state, _to_torch(j_batch))
    np.testing.assert_allclose(float(logs["train_loss/primary"]),
                               float(j_primary_loss), rtol=LOSS_RTOL)
    ref = import_flow_params(j_grads, device="cpu")
    for name, tree in state.params.items():
        for k, p in tree.items():
            want = ref[name][k].numpy()
            got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
            scale = max(float(np.abs(want).max()), 1e-8)
            if k == "weighted_mean.bias":
                # exactly 0 in truth (it feeds a shift-invariant LayerNorm):
                # float32 noise on both sides
                assert np.abs(got).max() <= 1e-5 * float(np.abs(
                    ref[name]["weighted_mean.weight"].numpy()).max())
                continue
            assert np.abs(got - want).max() <= W_BAR * scale, f"{name}.{k}"


# -- the kernels' limits, without a card ----------------------------------------

@pytest.mark.parametrize("T, D, heads, hidden, ok", [
    (9, 832, 8, 1664, True),       # the main path
    (27, 832, 8, 1664, True),      # published receptive fields
    (81, 832, 8, 1664, True),
    (81, 1024, 8, 2048, True),     # head width 128 still fits at T=81
    (82, 832, 8, 1664, False),     # past the compiled token limit
    (9, 832, 4, 1664, False),      # head width 208
    (9, 836, 4, 1672, False),      # not a multiple of 8
])
def test_temporal_limits(T, D, heads, hidden, ok):
    if ok:
        FT.check_limits(T, D, heads, hidden)
        assert FT.attention_smem_bytes(T, D // heads) <= FT.MAX_SMEM_BYTES
    else:
        with pytest.raises(ValueError):
            FT.check_limits(T, D, heads, hidden)


def test_temporal_attention_smem_at_rf81():
    # q, k, v, do (81 x 104 each) and p, ds (81 x 81 each), in bytes; head
    # width 128 still fits at T=81, T=86 does not
    assert FT.attention_smem_bytes(81, 104) == \
        4 * (4 * 81 * 104 + 2 * 81 * 81) == 187_272
    assert FT.attention_smem_bytes(81, 128) <= FT.MAX_SMEM_BYTES \
        < FT.attention_smem_bytes(86, 128)


@pytest.mark.parametrize("J, E, heads, hidden, tiles", [
    (26, 32, 8, 64, (4, 96, 2)),    # the main path: two thread blocks an SM
    (26, 32, 1, 64, (4, 96, 2)),    # one head of width 32
    (25, 32, 8, 64, (4, 96, 2)),    # BODY_25's points
    (26, 64, 8, 128, (2, 32, 1)),   # fewer frames a thread block
    (26, 20, 5, 40, (4, 128, 4)),   # widths 4 mod 8: zero-padded k-edge
])
def test_spatial_tiles(J, E, heads, hidden, tiles):
    assert FS.kernel_tiles(J, E, heads, hidden) == tiles
    fwd, rows, frames = tiles
    # the forward: one frame a warp, two thread blocks an SM where they fit
    assert FS.forward_smem_bytes(J, E, hidden, fwd) <= (
        FS.TWO_PER_SM_BYTES if E <= 32 else FS.MAX_SMEM_BYTES)
    if fwd < FS.FORWARD_TILES[0]:   # the next larger tile would not fit
        assert FS.forward_smem_bytes(J, E, hidden, fwd + 1) > \
            FS.MAX_SMEM_BYTES
    for size in (FS.mlp_bwd_smem_bytes(E, hidden, rows),
                 FS.attn_bwd_smem_bytes(J, E, heads, frames)):
        assert size <= (FS.TWO_PER_SM_BYTES if E <= 32 else
                        FS.MAX_SMEM_BYTES)


@pytest.mark.parametrize("J,E,heads,hidden,tiles", [
    (32, 12, 3, 864, (1, 4, 4)),
    (32, 12, 3, 860, (1, 4, 4)),
    (32, 4, 1, 1172, (1, 8, 4)),
])
def test_spatial_edge_tiles(J, E, heads, hidden, tiles):
    # shapes at the edge of the forward's shared memory, which the earlier
    # CUDA-core forward took: one frame a thread block, only in the layout
    # without the padding (X and Y rows at stride E)
    assert FS.kernel_tiles(J, E, heads, hidden) == tiles
    assert FS.forward_smem_bytes(J, E, hidden, 1) <= FS.MAX_SMEM_BYTES
    assert FS.forward_smem_bytes(J, E, hidden, 2) > FS.MAX_SMEM_BYTES
    assert FS.forward_smem_bytes(J, E, hidden, 1, pad=4) > FS.MAX_SMEM_BYTES


@pytest.mark.parametrize("J, E, heads, hidden", [
    (33, 32, 8, 64),     # more than 32 tokens
    (26, 64, 1, 128),    # head width 64
    (26, 256, 8, 512),   # wider than the LayerNorm backward's lanes
    (26, 128, 8, 256),   # one frame's layout exceeds 227 KB
    (26, 30, 5, 60),     # not a multiple of 4
])
def test_spatial_limits_refuse(J, E, heads, hidden):
    with pytest.raises(ValueError):
        FS.kernel_tiles(J, E, heads, hidden)


def test_spatial_saved_residuals():
    # per token row and depth block: 4 statistics, qkv, o, x2, h and the
    # block's output: 260 floats at E=32, hidden 64
    shapes = FS.saved_shapes(4, 10, 32, 64)
    assert shapes == [(4, 4, 10), (4, 10, 96), (4, 10, 32), (4, 10, 32),
                      (4, 10, 64), (4, 10, 32)]
    assert sum(int(np.prod(s)) for s in shapes) == 4 * 10 * 260


def test_stage_keeps_residuals_only_for_gradients():
    # on the CPU the autograd Function takes the plain route either way;
    # the gradient it returns matches autograd of the plain version
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 26, 8)).astype(np.float32))
    model = PoseFormer(**dict(RF27, clip_length=27))
    ws = [w.detach().clone().requires_grad_(True)
          for w in model.spatial_weights()]
    out = FS.fused_spatial_stack(x, ws, 4)
    ref = FS.spatial_stack_reference(x, [w.detach() for w in ws], 4)
    assert torch.allclose(out, ref)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, ws, g)
    leaves = [w.detach().clone().requires_grad_(True) for w in ws]
    want = torch.autograd.grad(
        FS.spatial_stack_reference(x, leaves, 4), leaves, g)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
    with torch.no_grad():
        assert torch.allclose(FS.fused_spatial_stack(x, ws, 4), ref)

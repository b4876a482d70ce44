"""Port parity for the PoseFormer training slice, on the CPU: the gradients of
the spatial stack, the temporal block (both TPU layouts) and the temporal
stack against ``jax.vjp`` of the JAX package's kernels (their Pallas backward
in interpret mode); PoseFormer's and PoseFormerRot's parameter gradients
against the JAX models on their xla and pallas paths; one ``training_step``
(loss, gradients, AdamW update) against the JAX flow's; the CLI trains
PoseFormer and its checkpoint round-trips; the backward wrappers refuse CPU
tensors; and, on a CUDA card only, the backward kernels against autograd of
their plain versions.

Bars (``tests/ops/test_pallas_{spatial,temporal}.py``): dx to atol 1e-4,
each weight gradient to 1e-4 of its largest magnitude, losses to rtol 1e-4.
"""
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
    PoseLiftingFlow as JPoseLiftingFlow
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.losses import primary_loss as j_primary
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.movements.pose_former import (
    PoseFormer as JPoseFormer, PoseFormerRot as JPoseFormerRot)
from pedestrians_video_2_carla_tpu.ops.pallas import flops as JF
from pedestrians_video_2_carla_tpu.ops.pallas import \
    fused_spatial_transformer as JS
from pedestrians_video_2_carla_tpu.ops.pallas import \
    fused_temporal_transformer as JT

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.jax_import import (
    import_flow_params, import_pose_former)
from pedestrians_video_2_carla_torch.models.movements.pose_former import (
    PoseFormer, PoseFormerRot)
from pedestrians_video_2_carla_torch.ops import flops as TF
from pedestrians_video_2_carla_torch.ops import fused_spatial_transformer as FS
from pedestrians_video_2_carla_torch.ops import \
    fused_temporal_transformer as FT
from pedestrians_video_2_carla_torch.training.checkpoint import \
    CheckpointManager

from .test_torch_transformer_kernels import _block_weights, _to_port
from .torch_threads import limit_torch_threads

limit_torch_threads()

J, E, H_S, DEPTH = 26, 8, 4, 2        # spatial: head width 2
T, D, H_T, N_T = 3, 208, 4, 7         # temporal: frame_dim 26 x 8
B, L = 2, 5
SMALL = dict(clip_length=L, receptive_frames=3,
             single_joint_embeddings_size=8, depth=2, num_heads=4)
DX_ATOL, W_BAR, LOSS_RTOL = 1e-4, 1e-4, 1e-4
LR = 1e-3
KERNELS = (2, 4, 8, 10)   # the Dense kernels among a block's 12 weights


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_grads(fn, x, weights, g):
    """Autograd through a port entry: (dx, [weight grads])."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *weights)]
    dx, *dws = torch.autograd.grad(fn(leaves[0], leaves[1:]), leaves, g)
    return dx, dws


def _close_grads(dx, dws, ref_dx, ref_dws, names):
    np.testing.assert_allclose(dx.numpy(), ref_dx, rtol=0, atol=DX_ATOL,
                               err_msg="dx")
    for name, got, ref in zip(names, dws, ref_dws):
        got, ref = got.numpy(), np.asarray(ref)
        assert got.shape == ref.shape, name
        scale = max(float(np.abs(ref).max()), 1e-8)
        assert np.abs(got - ref).max() <= W_BAR * scale, name


def _to_port_grads(grads):
    """JAX weight gradients (Dense kernels (in, out)) -> the port's
    layouts."""
    return [np.swapaxes(np.asarray(g), -1, -2) if i in KERNELS
            else np.asarray(g) for i, g in enumerate(grads)]


BLOCK_NAMES = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
               "ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


# -- the stage kernels' backward ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _spatial_grad_case(n):
    """Seeded x, weights and cotangent, and ``jax.vjp`` of the JAX
    ``fused_spatial_stack`` (its Pallas backward ``_fused_bwd_impl``)."""
    rng = np.random.default_rng(1000 + n)
    x = rng.standard_normal((n, J, E)).astype(np.float32)
    g = rng.standard_normal((n, J, E)).astype(np.float32)
    blocks = _block_weights(rng, E, lead=(DEPTH,))
    lnf = [(1 + 0.2 * rng.standard_normal(E)).astype(np.float32),
           (0.2 * rng.standard_normal(E)).astype(np.float32)]
    jw = tuple(jnp.asarray(w) for w in blocks) + (
        jnp.asarray(lnf[0])[None], jnp.asarray(lnf[1])[None])

    def vjp(x, w, g):
        return jax.vjp(lambda x, w: JS.fused_spatial_stack(x, w, H_S),
                       x, w)[1](g)
    dx, dws = jax.device_get(jax.jit(vjp)(jnp.asarray(x), jw, jnp.asarray(g)))
    ref_dws = _to_port_grads(dws[:12]) + [dws[12][0], dws[13][0]]
    weights = _to_port(blocks) + [_t(lnf[0]), _t(lnf[1])]
    return x, weights, g, dx, ref_dws


@pytest.mark.parametrize("n", [13, 5])
def test_spatial_stack_grads_match_jax(n):
    x, weights, g, ref_dx, ref_dws = _spatial_grad_case(n)
    dx, dws = _port_grads(
        lambda x, w: FS.fused_spatial_stack(x, w, H_S), _t(x), weights, _t(g))
    _close_grads(dx, dws, ref_dx, ref_dws, BLOCK_NAMES + ("lnf_s", "lnf_b"))


@functools.lru_cache(maxsize=None)
def _temporal_weights():
    rng = np.random.default_rng(22744)
    x = rng.standard_normal((N_T, T, D)).astype(np.float32)
    g = rng.standard_normal((N_T, T, D)).astype(np.float32)
    return x, g, [_block_weights(rng, D) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _temporal_grad_case(layout, stack):
    """``jax.vjp`` of the JAX ``fused_temporal_block`` (``stack`` False: its
    first block) or ``fused_temporal_stack`` in ``layout`` ("tl": the
    token-leading backward ``_bwd_impl_slab_tl``; "legacy":
    ``_bwd_impl_slab``), which the caller has set."""
    assert JT.LAYOUT == layout
    x, g, blocks = _temporal_weights()
    jw = [tuple(jnp.asarray(w) for w in b) for b in blocks]

    def vjp(x, w, g):
        if stack:
            fn = lambda x, w: JT.fused_temporal_stack(x, w, H_T)
        else:
            fn = lambda x, w: JT.fused_temporal_block(x, w[0], H_T)
        return jax.vjp(fn, x, w)[1](g)
    dx, dws = jax.device_get(jax.jit(vjp)(jnp.asarray(x), jw, jnp.asarray(g)))
    return dx, [_to_port_grads(d) for d in dws[:2 if stack else 1]]


@pytest.mark.parametrize("layout", ["tl", "legacy"])
def test_temporal_block_grads_match_jax(monkeypatch, layout):
    monkeypatch.setattr(JT, "LAYOUT", layout)
    ref_dx, (ref_dws,) = _temporal_grad_case(layout, False)
    x, g, blocks = _temporal_weights()
    dx, dws = _port_grads(lambda x, w: FT.fused_temporal_block(x, w, H_T),
                          _t(x), _to_port(blocks[0]), _t(g))
    _close_grads(dx, dws, ref_dx, ref_dws, BLOCK_NAMES)


def test_temporal_stack_grads_match_jax():
    ref_dx, ref_dws = _temporal_grad_case(JT.LAYOUT, True)
    x, g, blocks = _temporal_weights()
    weights = _to_port(blocks[0]) + _to_port(blocks[1])
    dx, dws = _port_grads(
        lambda x, w: FT.fused_temporal_stack(x, [w[:12], w[12:]], H_T),
        _t(x), weights, _t(g))
    _close_grads(dx, dws, ref_dx, ref_dws[0] + ref_dws[1],
                 [f"{b}.{k}" for b in range(2) for k in BLOCK_NAMES])


def test_backward_wrappers_never_run_on_the_cpu():
    x, weights, g, _, _ = _spatial_grad_case(5)
    saved = [torch.zeros(s) for s in FS.saved_shapes(DEPTH, 5 * J, E, 2 * E)]
    with pytest.raises(ValueError, match="CUDA"):
        FS.fused_spatial_stack_cuda_bwd(_t(x), weights, saved, _t(g), H_S)
    xt, gt, blocks = _temporal_weights()
    M = N_T * T
    saved = [torch.zeros(s) for s in ((4 * M,), (M, 3 * D), (M, D), (M, D),
                                      (M, 2 * D), (M, 2 * D))]
    with pytest.raises(ValueError, match="CUDA"):
        FT.fused_temporal_block_cuda_bwd(_t(xt), _to_port(blocks[0]), saved,
                                         _t(gt), H_T)
    assert FS.fused_spatial_stack_cuda_bwd.launches == 0
    assert FT.fused_temporal_block_cuda_bwd.launches == 0


def test_train_flops_match_jax_and_the_train_shape():
    for kw in (dict(include_attention=False), dict(include_attention=True)):
        assert TF.poseformer_kernel_train_flops(1024, **kw) == \
            JF.poseformer_kernel_train_flops(1024, **kw)
    # B=1024, L=16: 16,384 frames x 26 tokens, 8,192 windows x 9 tokens
    assert 4 * TF.transformer_block_backward_flops(425984, 32, 2.0, 26) \
        == 67_175_972_864
    assert TF.transformer_block_backward_flops(73728, 832, 2.0, 9) \
        == 1_637_577_916_416
    assert TF.transformer_block_backward_flops(100, 16) == \
        2 * TF.transformer_block_matmul_flops(100, 16)


# -- the models ------------------------------------------------------------------

class _JRaw(JPoseFormerRot):
    """The JAX PoseFormerRot's 6D output, before Gram-Schmidt."""

    def _finalize(self, out):
        return out


def _assert_noise(got, want, sibling):
    """``weighted_mean.bias``'s true gradient is exactly 0 (it feeds
    head_norm, a shift-invariant LayerNorm): both sides are float32
    cancellation noise, about 1e-6 of the weighted mean's weight gradient
    here; bound both at 1e-5 of it."""
    bound = 1e-5 * float(np.abs(sibling).max())
    assert np.abs(got).max() <= bound and np.abs(want).max() <= bound


@functools.lru_cache(maxsize=None)
def _jax_model_grads(name, path):
    """Input, params, a seeded output weighting, and the gradient of the
    weighted output sum over the JAX model's params on the "xla" or
    "pallas" path."""
    cls = {"PoseFormer": JPoseFormer, "PoseFormerRot": JPoseFormerRot}[name]
    rng = np.random.default_rng(22745)
    x = rng.standard_normal((B, L, 26, 2)).astype(np.float32)
    model = cls(**SMALL, spatial_kernel=path, temporal_kernel=path)
    params = model.init(jax.random.PRNGKey(3), x)["params"]
    shape = jax.eval_shape(lambda p: model.apply({"params": p}, x), params)
    weight = rng.standard_normal(shape.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(model.apply({"params": p}, x, training=True) * weight)
    grads = jax.jit(jax.grad(loss))(params)
    return x, weight, jax.device_get(params), jax.device_get(grads)


@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["PoseFormer", "PoseFormerRot"])
def test_model_grads_match_jax(name, path):
    x, weight, params, j_grads = _jax_model_grads(name, path)
    model = {"PoseFormer": PoseFormer, "PoseFormerRot": PoseFormerRot}[name](
        **SMALL)
    model.load_state_dict(import_pose_former(params))
    out = model(torch.from_numpy(x), training=True)
    (out * torch.from_numpy(weight)).sum().backward()
    ref = import_pose_former(j_grads)
    for k, p in model.named_parameters():
        got, want = p.grad.numpy(), ref[k].numpy()
        if k == "weighted_mean.bias":
            _assert_noise(got, want, ref["weighted_mean.weight"].numpy())
            continue
        scale = max(float(np.abs(want).max()), 1e-8)
        assert np.abs(got - want).max() <= W_BAR * scale, k


# -- training_step against the JAX flow ------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step_case():
    """A JAX PoseFormer flow (both stages through their Pallas kernels), its
    initial params, a batch and one training step: the body of the flow's
    ``training_step``, keeping the gradients it takes."""
    batch = jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(6), JD.Carla2D3DConfig(batch_size=B,
                                                  clip_length=L)))
    flow = JPoseLiftingFlow(
        movements_model=JPoseFormer(**SMALL, spatial_kernel="pallas",
                                    temporal_kernel="pallas"),
        loss_modes=[JLossModes.loc_2d_3d],
        movements_optimizer=JOptimizerSettings(lr=LR))
    state = flow.init_state(jax.random.PRNGKey(1), batch)

    def loss_fn(params):
        sliced, _ = flow._inner_step(params, state.mutables, batch,
                                     training=True, rngs=None)
        losses = flow._compute_losses(sliced, sliced["targets"])
        return j_primary(losses, flow.requested_loss_modes)[1], losses
    (primary, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    updates, _ = flow._tx.update(grads, state.opt_state, state.params,
                                 value=primary)
    new_params = optax.apply_updates(state.params, updates)
    logs = {f"train_loss/{k}": v for k, v in losses.items()}
    logs["train_loss/primary"] = primary
    return jax.device_get((state.params, batch, grads, new_params, logs))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def test_training_step_matches_jax():
    j_params, j_batch, j_grads, j_new, j_logs = _jax_step_case()
    flow = PoseLiftingFlow(PoseFormer(**SMALL), loss_modes=["loc_2d_3d"],
                           movements_optimizer=OptimizerSettings(lr=LR),
                           device="cpu")
    state = flow.init_state(import_flow_params(j_params, device="cpu"))
    state, logs = flow.training_step(state, _to_torch(j_batch))
    assert state.step == 1
    assert set(logs) == set(j_logs)
    for k, ref in j_logs.items():
        np.testing.assert_allclose(float(logs[k]), ref, rtol=LOSS_RTOL,
                                   err_msg=k)

    ref_grads = import_flow_params(j_grads, device="cpu")
    ref_new = import_flow_params(j_new, device="cpu")
    for name, tree in state.params.items():
        assert set(tree) == set(ref_grads[name]) == set(ref_new[name])
        for k, p in tree.items():
            g_ref = ref_grads[name][k].numpy()
            g = np.zeros_like(g_ref) if p.grad is None else p.grad.numpy()
            if k == "weighted_mean.bias":
                _assert_noise(g, g_ref,
                              ref_grads[name]["weighted_mean.weight"].numpy())
                continue
            scale = max(float(np.abs(g_ref).max()), 1e-8)
            assert np.abs(g - g_ref).max() <= W_BAR * scale, f"{name}.{k}"
            # Adam's first step is about lr * sign(g): where g is tiny
            # against the leaf's largest, float32 rounding can flip its
            # sign between the frameworks (see test_torch_training.py)
            diff = np.abs(p.detach().numpy() - ref_new[name][k].numpy())
            big = np.abs(g_ref) > 1e-3 * np.abs(g_ref).max()
            assert diff[big].max(initial=0.0) <= 1e-5, f"{name}.{k}"
            assert diff[~big].max(initial=0.0) <= 2 * LR + 1e-6, \
                f"{name}.{k}"


# -- the CLI and checkpoints -------------------------------------------------------

def test_cli_trains_pose_former_and_its_checkpoint_round_trips(tmp_path):
    result = modeling.main([
        "--mode=train", "--movements_model_name=PoseFormer", "--device=cpu",
        "--batch_size=2", "--clip_length=5", "--val_set_size=2",
        "--receptive_frames=3", "--single_joint_embeddings_size=8",
        "--depth=1", "--num_heads=2", "--max_epochs=1",
        "--limit_train_batches=3", "--log_every_n_steps=1",
        "--loss_modes", "loc_2d_3d", f"--root_dir={tmp_path}",
        "--run_name=pf"])
    run = tmp_path / "logs" / "pose_lifting" / "pf"
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss/primary"] for r in records if "lr-movements" in r]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert math.isfinite(result["val_metrics"]["val_loss/primary"])
    assert (run / "checkpoints" / "last.pt").exists()

    trainer = result["trainer"]
    trained = trainer.state
    fresh = result["flow"].init_state()
    CheckpointManager(str(run / "checkpoints")).restore(
        fresh, str(run / "checkpoints" / "last"))
    assert fresh.step == trained.step == 3
    for name, tree in trained.params.items():
        for k, v in tree.items():
            assert torch.equal(fresh.params[name][k], v), k
    saved, loaded = (s.optimizer.state_dict()["state"]
                     for s in (trained, fresh))
    assert saved and set(saved) == set(loaded)
    for i, st in saved.items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(loaded[i][k]),
                               torch.as_tensor(v)), (i, k)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # the plain versions' GEMMs in full float32, as the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scaled_ok(got, ref):
    """Over the reference's largest magnitude: rtol 1e-4, atol 1e-5."""
    scale = max(float(ref.abs().max()), 1e-8)
    return bool(((got - ref).abs() / scale
                 <= 1e-5 + 1e-4 * ref.abs() / scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4093, 5])
def test_cuda_spatial_backward_matches_plain(rng, cuda_device, n):
    def cuda(a):
        return torch.from_numpy(a).to(cuda_device)
    x, g = (cuda(rng.standard_normal((n, 26, 32)).astype(np.float32))
            for _ in range(2))
    weights = [w.to(cuda_device) for w in
               _to_port(_block_weights(rng, 32, lead=(4,)))] + [
        cuda((1 + 0.2 * rng.standard_normal(32)).astype(np.float32)),
        cuda((0.2 * rng.standard_normal(32)).astype(np.float32))]
    _, saved = FS.fused_spatial_stack_cuda(x, weights, 8, keep=True)
    dx, dws = FS.fused_spatial_stack_cuda_bwd(x, weights, saved, g, 8)
    again = FS.fused_spatial_stack_cuda_bwd(x, weights, saved, g, 8)
    ref = _port_grads(lambda x, w: FS.spatial_stack_reference(x, w, 8),
                      x, weights, g)
    torch.cuda.synchronize()
    for got, want in zip([dx, *dws], [ref[0], *ref[1]]):
        assert _scaled_ok(got, want)
    assert all(torch.equal(a, b) for a, b in zip([dx, *dws],
                                                 [again[0], *again[1]]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2045, 3])
def test_cuda_temporal_backward_matches_plain(rng, cuda_device, n):
    x, g = (torch.from_numpy(rng.standard_normal((n, 9, 832)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    weights = [w.to(cuda_device) for w in _to_port(_block_weights(rng, 832))]
    _, saved = FT.fused_temporal_block_cuda(x, weights, 8, keep=True)
    dx, dws = FT.fused_temporal_block_cuda_bwd(x, weights, saved, g, 8)
    again = FT.fused_temporal_block_cuda_bwd(x, weights, saved, g, 8)
    ref = _port_grads(lambda x, w: FT.temporal_block_reference(x, w, 8),
                      x, weights, g)
    torch.cuda.synchronize()
    for got, want in zip([dx, *dws], [ref[0], *ref[1]]):
        assert _scaled_ok(got, want)
    assert all(torch.equal(a, b) for a, b in zip([dx, *dws],
                                                 [again[0], *again[1]]))

"""bf16 mixed precision in the port, on the CPU, against the JAX package in
bf16 on the same seeded numpy inputs and weights (``models/jax_import.py``):

* the flows' cast (``precision="bf16"``): for each model family of the JAX
  ``test_bf16_training_step`` and LinearAE, VideoPose3D and two classifiers
  (GConvGRU and LSTM on their plain routes), an evaluation forward and one
  ``training_step``: outputs, losses and gradients against the JAX flow in
  bf16; the port's parameters and running statistics stay float32 and the
  statistics move;
* the bf16 plain versions of the PoseFormer kernels (rows 4, 5, 8, 9):
  output, dx and every weight gradient against ``jax.vjp`` of the JAX
  ``fused_spatial_stack`` / ``fused_temporal_block`` on bf16 inputs (their
  Pallas kernels in interpret mode);
* the bf16 plain versions of the scan kernels (rows 10-13: the graph-GRU
  and graph-LSTM at k=2, the dense LSTM at k=1, J=1), through autograd
  and as the kernels' algorithm (the training forward with residuals,
  the backward from them), against the JAX ``graph_gru_scan`` /
  ``graph_lstm_scan`` and ``jax.vjp`` on bf16 inputs at L=16, where the
  rounding compounds; where they keep float32 and where they round; the
  classifiers' fused routes (GConvGRU, GConvLSTM, the LSTM classifier)
  against the JAX flows on ``pallas``;
* ``--precision bf16`` through the port's CLI, a bf16 PoseFormer and a
  bf16 GConvGRU exported and served on the CPU, ``torch.library.opcheck``
  of the five ops in bf16, the graph scans taking bf16 CUDA tensors;
* on a CUDA card only, the bf16 kernels against their plain versions.

Bars. Both packages compute in bf16 but round at other places, so values
agree to a few bf16 ulps (2^-8 relative each) compounded through the
model: outputs within ``OUT_BAR`` of max |JAX| and losses within
``LOSS_RTOL`` (largest seen: 2.5e-2 and 1.7e-2, the LSTM), below the
ceiling of 5e-2 of max |JAX| that the JAX bf16 kernel tests use
(``tests/ops/test_pallas_spatial.py:103-111``). A model's gradient (every
leaf, as one vector) is within ``GRAD_BAR`` of the JAX bf16 gradient in
norm, and no further from the JAX float32 gradient than ``NOISE_RATIO``
times the JAX bf16 gradient's own distance from it: bf16 alone moves a
recurrent model's gradient by up to a quarter (LinearAEResidual 0.25, the
LSTM 0.18 in JAX), so the second bar says that the port's bf16 rounds no
worse than the reference's. The kernels' plain versions: outputs within
``KERNEL_OUT_BAR`` and gradients within ``KERNEL_GRAD_BAR`` of max |JAX|.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.autoencoder import \
    AutoencoderFlow as JAutoencoderFlow
from pedestrians_video_2_carla_tpu.flows.classification import \
    ClassificationFlow as JClassificationFlow
from pedestrians_video_2_carla_tpu.flows.output_types import \
    MovementsModelOutputType as JMOT
from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
    PoseLiftingFlow as JPoseLiftingFlow
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.losses import primary_loss as j_primary
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.classification import \
    CLASSIFICATION_MODELS as J_CLASSIFIERS
from pedestrians_video_2_carla_tpu.models.movements import \
    MOVEMENTS_MODELS as J_MODELS
from pedestrians_video_2_carla_tpu.models.movements import transformers as JT
from pedestrians_video_2_carla_tpu.ops.pallas import fused_graph_gru as JG
from pedestrians_video_2_carla_tpu.ops.pallas import \
    fused_spatial_transformer as JS
from pedestrians_video_2_carla_tpu.ops.pallas import \
    fused_temporal_transformer as JTT

from pedestrians_video_2_carla_torch import modeling, serving
from pedestrians_video_2_carla_torch.flows.autoencoder import AutoencoderFlow
from pedestrians_video_2_carla_torch.flows.classification import \
    ClassificationFlow
from pedestrians_video_2_carla_torch.flows.output_types import \
    MovementsModelOutputType as MOT
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.classification import \
    CLASSIFICATION_MODELS
from pedestrians_video_2_carla_torch.models.jax_import import \
    import_flow_params
from pedestrians_video_2_carla_torch.models.movements import MOVEMENTS_MODELS
from pedestrians_video_2_carla_torch.ops import fused_graph_gru as FG
from pedestrians_video_2_carla_torch.skeletons.carla import CARLA_SKELETON
from pedestrians_video_2_carla_torch.ops import fused_spatial_transformer as FS
from pedestrians_video_2_carla_torch.ops import \
    fused_temporal_transformer as FT

from .test_torch_transformer_kernels import _block_weights, _to_port
from .torch_threads import limit_torch_threads

limit_torch_threads()

B, L = 3, 9
LR = 1e-3
OUT_BAR, LOSS_RTOL, GRAD_BAR, NOISE_RATIO = 4e-2, 3e-2, 0.12, 1.25
KERNEL_OUT_BAR, KERNEL_GRAD_BAR = 2e-2, 3e-2

#: case -> (model, the JAX model's arguments, the port's, flow, loss). The
#: lifting models predict absolute locations and the flows run without the
#: hips-neck transform: a 6D rotation's Gram-Schmidt and the division by a
#: projected hips-neck length magnify bf16's rounding by more than an order
#: of magnitude on these random inputs, in both packages alike (a bf16
#: pose_changes LSTM is 0.32 of max |out| off its float32 self in JAX), so
#: that two bf16 runs would be compared on their amplified rounding alone.
POSE_FORMER = dict(clip_length=L, receptive_frames=3,
                   single_joint_embeddings_size=8, depth=2, num_heads=4)
LOC = dict(movements_output_type=MOT.absolute_loc)
J_LOC = dict(movements_output_type=JMOT.absolute_loc)
CASES = {
    "LSTM": ("LSTM", dict(J_LOC, hidden_size=16),
             dict(LOC, hidden_size=16, rnn_kernel="plain"),
             "pose_lifting", "loc_2d_3d"),
    "Seq2SeqEmbeddings": (
        "Seq2SeqEmbeddings",
        dict(J_LOC, hidden_size=16, p_dropout=0.0,
             single_joint_embeddings_size=4),
        dict(LOC, hidden_size=16, p_dropout=0.0,
             single_joint_embeddings_size=4, rnn_kernel="plain"),
        "pose_lifting", "loc_2d_3d"),
    "LinearAEResidual": ("LinearAEResidual", dict(linear_size=64),
                         dict(linear_size=64), "pose_lifting", "loc_2d_3d"),
    "SimpleTransformer": ("SimpleTransformer", dict(num_layers=2),
                          dict(num_layers=2), "autoencoder", "loc_2d"),
    "PoseFormer": ("PoseFormer",
                   dict(POSE_FORMER, spatial_kernel="xla",
                        temporal_kernel="xla"),
                   dict(POSE_FORMER, spatial_kernel="plain",
                        temporal_kernel="plain"),
                   "pose_lifting", "loc_2d_3d"),
    "LinearAE": ("LinearAE", J_LOC, LOC, "pose_lifting", "loc_2d_3d"),
    "VideoPose3D": ("VideoPose3D",
                    dict(filter_widths=(3, 3), channels=64, p_dropout=0.0),
                    dict(filter_widths=(3, 3), channels=64, p_dropout=0.0),
                    "pose_lifting", "loc_2d_3d"),
}
FLOWS = {"pose_lifting": (JPoseLiftingFlow, PoseLiftingFlow),
         "autoencoder": (JAutoencoderFlow, AutoencoderFlow)}
#: the classifiers: case -> (model, arguments of both packages, the route
#: field, the port's route: "plain" against the JAX "xla", "fused" against
#: its "pallas" kernels in interpret mode)
GNN_ARGS = dict(hidden_size=16, p_dropout=0.0)
LSTM_ARGS = dict(hidden_size=16, embeddings_size=12, p_dropout=0.0)
CLASSIFIERS = {"GConvGRU": ("GConvGRU", GNN_ARGS, "graph_kernel", "plain"),
               "LSTM": ("LSTM", LSTM_ARGS, "rnn_kernel", "plain"),
               "GConvGRU_fused": ("GConvGRU", GNN_ARGS, "graph_kernel",
                                  "fused"),
               "GConvLSTM": ("GConvLSTM", GNN_ARGS, "graph_kernel", "plain"),
               "GConvLSTM_fused": ("GConvLSTM", GNN_ARGS, "graph_kernel",
                                   "fused"),
               "LSTM_fused": ("LSTM", LSTM_ARGS, "rnn_kernel", "fused")}
JAX_ROUTES = {"plain": "xla", "fused": "pallas"}


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """flax's ``nn.Dropout`` as the identity, and the JAX transformer's
    encoder layers built with attention dropout 0 (the port's SimpleTransformer
    is built with its rates at 0)."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *args, **kwargs: inputs)
    monkeypatch.setattr(JT, "_EncoderLayer", functools.partial(
        JT._EncoderLayer, dropout=0.0))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return _t(np.array(tree))


def _random_stats(tree, rng):
    """A ``batch_stats`` tree drawn away from 0 / 1."""
    if "mean" in tree:
        return {"mean": rng.normal(0.0, 0.5, np.shape(tree["mean"]))
                .astype(np.float32),
                "var": rng.uniform(0.5, 2.0, np.shape(tree["var"]))
                .astype(np.float32)}
    return {k: _random_stats(v, rng) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _batch():
    """A Carla2D3D batch, its inputs replaced by seeded numpy values."""
    cfg = JD.Carla2D3DConfig(batch_size=B, clip_length=L)
    _, targets, meta = jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(3), cfg))
    inputs = np.random.default_rng(11).standard_normal(
        (B, L, 26, 2)).astype(np.float32)
    return inputs, targets, meta


def _flat(tree):
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    if isinstance(tree, (tuple, list)):
        return np.concatenate([_flat(v) for v in tree])
    return np.asarray(tree, np.float32).reshape(-1)


def _assert_close(got, ref, bar, what):
    got, ref = _flat(got), _flat(ref)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= bar, f"{what}: {err:.3g} of max |JAX| > {bar}"


def _grad_distance(grads, ref):
    """|g - ref| / |ref| over every leaf of a model, as one vector."""
    got, want = _flat(grads), _flat(ref)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _assert_grads_close(grads, ref16, ref32, what):
    """Within GRAD_BAR of the JAX bf16 gradient, and no further from the
    JAX float32 one than NOISE_RATIO times the JAX bf16 gradient is."""
    grads, ref16, ref32 = ({k: np.asarray(v) for k, v in t.items()}
                           for t in (grads, ref16, ref32))
    err = _grad_distance(grads, ref16)
    assert err <= GRAD_BAR, f"{what}: gradient off by {err:.3g} > {GRAD_BAR}"
    noise = _grad_distance(ref16, ref32)
    own = _grad_distance(grads, ref32)
    assert own <= NOISE_RATIO * noise + 1e-3, \
        f"{what}: {own:.3g} from float32, the JAX bf16 gradient {noise:.3g}"


# -- the flows in bf16 ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """The JAX flow in bf16: its state (random batch_stats), the evaluation
    outputs, one training step's losses, gradients and new mutables."""
    name, j_kwargs, _, flow_name, loss = CASES[case]
    flow, flow32 = (FLOWS[flow_name][0](
        movements_model=J_MODELS[name](**j_kwargs),
        loss_modes=[JLossModes[loss]],
        movements_optimizer=JOptimizerSettings(lr=LR), transform="none",
        precision=precision) for precision in ("bf16", "32"))
    batch = _batch()
    state = flow.init_state(jax.random.PRNGKey(1), batch)
    mutables = state.mutables
    if mutables["movements"]:
        mutables = {**mutables, "movements": {"batch_stats": _random_stats(
            jax.device_get(mutables["movements"]["batch_stats"]),
            np.random.default_rng(5))}}
    rngs = {"dropout": jax.random.PRNGKey(2)}
    out_key = flow.outputs_key if flow_name == "autoencoder" \
        else "projection_2d"

    def loss_fn(params, flow):
        sliced, new = flow._inner_step(params, mutables, batch,
                                       training=True, rngs=rngs)
        losses = flow._compute_losses(sliced, sliced["targets"])
        return j_primary(losses, flow.requested_loss_modes)[1], (losses, new)

    @jax.jit    # one compile for the three
    def run(params):
        sliced, _ = flow._inner_step(params, mutables, batch,
                                     training=False, rngs=rngs)
        (_, (losses, new)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, flow)
        grads32 = jax.grad(lambda p: loss_fn(p, flow32)[0])(params)
        return sliced[out_key], losses, grads, new, grads32
    out, losses, grads, new, grads32 = run(state.params)
    return jax.device_get((state.params, mutables, out, losses, grads, new,
                           grads32))


def _port_flow(case):
    name, _, p_kwargs, flow_name, loss = CASES[case]
    model = MOVEMENTS_MODELS[name](**p_kwargs)
    for module in model.modules():   # the rates fixed in the model
        if hasattr(module, "rate"):
            module.rate = 0.0
    if hasattr(model, "P_DROPOUT"):
        model.P_DROPOUT = 0.0
    return FLOWS[flow_name][1](model, loss_modes=[loss],
                               movements_optimizer=OptimizerSettings(lr=LR),
                               transform="none", precision="bf16",
                               device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_flow_matches_jax_in_bf16(case, no_flax_dropout):
    j_params, j_mutables, j_out, j_losses, j_grads, j_new, j_grads32 = \
        _jax_case(case)
    flow = _port_flow(case)
    params = import_flow_params(j_params, device="cpu", mutables=j_mutables)
    batch = _to_torch(_batch())
    flow_name, loss = CASES[case][3:]
    out_key = flow.outputs_key if flow_name == "autoencoder" \
        else "projection_2d"

    # evaluation: the outputs are float32 again after the model
    sliced = flow._inner_step(params, batch, training=False)
    assert sliced[out_key].dtype == torch.float32
    _assert_close(sliced[out_key].numpy(), j_out, OUT_BAR, "eval output")

    # one training step: losses and gradients; float32 leaves and
    # statistics, the statistics moved
    state = flow.init_state(params)
    before = {k: v.clone() for k, v in state.params["movements"].items()
              if not v.requires_grad}
    _, logs = flow.training_step(state, batch)
    np.testing.assert_allclose(float(logs[f"train_loss/{loss}"]),
                               float(j_losses[loss]), rtol=LOSS_RTOL)
    tree = state.params["movements"]
    assert all(v.dtype == torch.float32 for v in tree.values())
    ref = import_flow_params(j_grads, device="cpu")["movements"]
    ref32 = import_flow_params(j_grads32, device="cpu")["movements"]
    assert set(ref) == set(tree) - set(before)
    _assert_grads_close({k: tree[k].grad for k in ref}, ref, ref32, case)
    assert bool(before) == (case in ("LinearAEResidual", "VideoPose3D"))
    stats = import_flow_params({"movements": {}}, device="cpu", mutables={
        "movements": j_new["movements"]})["movements"]
    for k, v in before.items():
        assert tree[k].dtype == torch.float32 and tree[k].grad is None
        assert not torch.equal(tree[k], v), k
        _assert_close(tree[k].numpy(), stats[k].numpy(), OUT_BAR, k)


def _classifier_batch():
    rng = np.random.default_rng(17)
    inputs = rng.standard_normal((B, L, 26, 2)).astype(np.float32)
    return inputs, {"crossing": rng.integers(0, 2, size=B).astype(
        np.int32)}, {}


@functools.lru_cache(maxsize=None)
def _jax_classifier(case):
    name, kwargs, field, route = CLASSIFIERS[case]
    flow, flow32 = (JClassificationFlow(
        classification_model=J_CLASSIFIERS[name](
            **{field: JAX_ROUTES[route]}, **kwargs),
        classification_optimizer=JOptimizerSettings(lr=LR),
        precision=precision) for precision in ("bf16", "32"))
    batch = _classifier_batch()
    state = flow.init_state(jax.random.PRNGKey(1), batch)
    rngs = {"dropout": jax.random.PRNGKey(2)}

    def loss_fn(p, flow):
        out, _ = flow._apply(p, state.mutables, batch[0], True, rngs)
        return flow._loss(out, batch[1])

    @jax.jit    # one compile for the three
    def run(params):
        logits, _ = flow._apply(params, state.mutables, batch[0], False,
                                rngs)
        loss, grads = jax.value_and_grad(loss_fn)(params, flow)
        return logits, loss, grads, jax.grad(loss_fn)(params, flow32)
    logits, loss, grads, grads32 = run(state.params)
    return jax.device_get((state.params, logits, loss, grads, grads32))


@pytest.mark.parametrize("name", list(CLASSIFIERS))
def test_classifier_matches_jax_in_bf16(name):
    j_params, j_logits, j_loss, j_grads, j_grads32 = _jax_classifier(name)
    model, kwargs, field, route = CLASSIFIERS[name]
    flow = ClassificationFlow(
        CLASSIFICATION_MODELS[model](**{field: route}, **kwargs),
        classification_optimizer=OptimizerSettings(lr=LR), precision="bf16",
        device="cpu")
    params = import_flow_params(j_params, device="cpu")
    batch = _to_torch(_classifier_batch())
    _, preds, _ = flow.eval_step(params, batch)
    logits = preds[flow.outputs_key]
    assert logits.dtype == torch.float32
    _assert_close(logits.numpy(), j_logits, OUT_BAR, "logits")
    state = flow.init_state(params)
    _, logs = flow.training_step(state, batch)
    np.testing.assert_allclose(float(logs["train_loss/primary"]),
                               float(j_loss), rtol=LOSS_RTOL)
    tree = state.params["classification"]
    assert all(v.dtype == torch.float32 for v in tree.values())
    ref = import_flow_params(j_grads, device="cpu")["classification"]
    ref32 = import_flow_params(j_grads32, device="cpu")["classification"]
    _assert_grads_close({k: tree[k].grad for k in ref}, ref, ref32, name)


# -- the bf16 plain versions of rows 4, 5, 8 and 9 -----------------------------

SJ, SE, SH, SDEPTH, SN = 26, 8, 4, 2, 13     # spatial: head width 2
TT, TD, TH, TN = 3, 208, 4, 7                # temporal
BF = jnp.bfloat16


def _bf(a):
    """numpy float32 -> the bf16 values (as float32 numpy)."""
    return np.asarray(jnp.asarray(a, BF).astype(jnp.float32))


def _to_port_grads(grads):
    return [np.swapaxes(np.asarray(g, np.float32), -1, -2) if i in (2, 4, 8,
                                                                   10)
            else np.asarray(g, np.float32) for i, g in enumerate(grads)]


@functools.lru_cache(maxsize=None)
def _kernel_case(kind):
    """Seeded bf16 x, weights and cotangent and the JAX kernel's output and
    ``jax.vjp`` on them (the Pallas kernels in interpret mode)."""
    rng = np.random.default_rng(2718 if kind == "spatial" else 2719)
    if kind == "spatial":
        x = rng.standard_normal((SN, SJ, SE)).astype(np.float32)
        blocks = _block_weights(rng, SE, lead=(SDEPTH,))
        lnf = [(1 + 0.2 * rng.standard_normal(SE)).astype(np.float32),
               (0.2 * rng.standard_normal(SE)).astype(np.float32)]
        jw = tuple(jnp.asarray(w, BF) for w in blocks) + (
            jnp.asarray(lnf[0], BF)[None], jnp.asarray(lnf[1], BF)[None])
        fn = lambda x, w: JS.fused_spatial_stack(x, w, SH)
        port_w = _to_port(blocks) + [_t(lnf[0]), _t(lnf[1])]
    else:
        x = rng.standard_normal((TN, TT, TD)).astype(np.float32)
        blocks = _block_weights(rng, TD)
        jw = tuple(jnp.asarray(w, BF) for w in blocks)
        fn = lambda x, w: JTT.fused_temporal_block(x, w, TH)
        port_w = _to_port(blocks)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def fwd_vjp(x, w, g):
        out, vjp = jax.vjp(fn, x, w)
        return out, vjp(g)
    out, (dx, dws) = jax.device_get(jax.jit(fwd_vjp)(
        jnp.asarray(x, BF), jw, jnp.asarray(g, BF)))
    assert out.dtype == BF and dx.dtype == BF
    ref_dws = _to_port_grads(dws[:12])
    if kind == "spatial":
        ref_dws += [np.asarray(dws[12][0], np.float32),
                    np.asarray(dws[13][0], np.float32)]
    port_w = [w.to(torch.bfloat16) for w in port_w]
    return (x, port_w, g, np.asarray(out, np.float32),
            np.asarray(dx, np.float32), ref_dws)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_bf16_plain_versions_match_the_jax_kernels(kind):
    x, weights, g, ref_out, ref_dx, ref_dws = _kernel_case(kind)
    fn = (lambda x, w: FS.fused_spatial_stack(x, w, SH)) \
        if kind == "spatial" else \
        (lambda x, w: FT.fused_temporal_block(x, w, TH))
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (_t(x).to(torch.bfloat16), *weights)]
    out = fn(leaves[0], leaves[1:])
    assert out.dtype == torch.bfloat16
    dx, *dws = torch.autograd.grad(out, leaves, _t(g).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16
    assert all(d.dtype == torch.bfloat16 for d in dws)
    _assert_close(out.float().detach().numpy(), ref_out, KERNEL_OUT_BAR,
                  f"{kind} output")
    _assert_close(dx.float().numpy(), ref_dx, KERNEL_GRAD_BAR, f"{kind} dx")
    for i, (d, ref) in enumerate(zip(dws, ref_dws)):
        _assert_close(d.float().numpy(), ref, KERNEL_GRAD_BAR,
                      f"{kind} weight gradient {i}")


def test_bf16_forward_gemm_plan_mirrors_the_source():
    """The bf16 GEMM's plan (``csrc/wgmma_bf16.cuh``, its wg::k*
    constants) as ``BF16_GEMM`` mirrors it, and its shared memory as
    ``forward_gemm_smem_bytes(2)`` counts it: the ring's stages of a 128 x
    64 A and B tile of bf16, the swizzle's alignment slack, two mbarriers a
    stage and the bias column sums' rows; the float32 count is
    unchanged."""
    import re
    src = FT._SOURCE.read_text()
    hdr = (FT._SOURCE.parent / "wgmma_bf16.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"\b{name} = (\w+)", text).group(1))
    plan = FT.BF16_GEMM
    assert plan["block"] == (const(hdr, "kBM"), const(hdr, "kBN"))
    assert (plan["k_step"], plan["stages"], plan["blocks_per_sm"],
            plan["consumer_warpgroups"]) == (
        const(hdr, "kBK"), const(hdr, "kStages"), const(hdr, "kMinBlocks"),
        const(hdr, "kConsumers"))
    assert plan["threads"] == 128 * plan["consumer_warpgroups"] + 32
    assert re.search(r"constexpr int kAlign = 1024;", hdr)
    assert re.search(r"kBarrierBytes = 2 \* kStages \* 8;", hdr)
    assert re.search(r"kColsumBytes = kConsumers \* 4 \* 64 \* 4;", hdr)
    assert plan["extra_bytes"] == (1024, 2 * plan["stages"] * 8,
                                   plan["consumer_warpgroups"] * 4 * 64 * 4)
    assert FT.forward_gemm_smem_bytes(2) == FT.bf16_gemm_smem_bytes() == \
        2 * plan["stages"] * sum(plan["block"]) * plan["k_step"] + \
        sum(plan["extra_bytes"]) == 101424
    fp32 = FT.FORWARD_GEMM
    assert FT.forward_gemm_smem_bytes(4) == FT.forward_gemm_smem_bytes() \
        == 4 * const(src, "kFStages") * sum(fp32["block"]) * (
            const(src, "kFBK") + 4)


def test_bf16_gemm_ring_fits_the_thread_blocks_of_an_sm():
    """Two bf16 GEMM thread blocks an SM: each within one thread block's
    shared memory, both with what the hardware keeps for each within the
    SM's, and a third would not fit."""
    plan, smem = FT.BF16_GEMM, FT.bf16_gemm_smem_bytes()
    assert smem <= FT.MAX_SMEM_BYTES
    per_block = smem + FT.BLOCK_RESERVED_BYTES
    assert plan["blocks_per_sm"] * per_block <= FT.SM_SMEM_BYTES
    assert (plan["blocks_per_sm"] + 1) * per_block > FT.SM_SMEM_BYTES


@pytest.mark.parametrize("shape, what", [
    ((9, 836, 8, 1664), "multiples of 8"),      # D: a 16-byte TMA row stride
    ((9, 832, 8, 1660), "multiples of 8"),      # hidden
    ((82, 832, 8, 1664), "T <= 81"),
    ((9, 832, 4, 1664), "head width <= 128"),
])
def test_temporal_limits_refuse_what_the_bf16_kernels_cannot_take(shape,
                                                                   what):
    """``check_limits`` for bf16 elements raises a clear ValueError for the
    shapes the kernels refuse, and takes the main path's and the edge
    shapes the card's tests run."""
    T, D, heads, hidden = shape
    with pytest.raises(ValueError, match=what):
        FT.check_limits(T, D, heads, hidden, element_size=2)
    for ok in ((9, 832, 8, 1664), (9, 208, 2, 416), (81, 208, 2, 416),
               (81, 832, 8, 1664)):
        FT.check_limits(*ok, element_size=2)


def test_bf16_products_go_to_the_wgmma_gemm():
    """The bf16 entries' twelve products are the wgmma GEMM's: the source
    has no TF32 GEMM on bf16 tiles left, its forward and backward GEMM
    dispatch bf16 to ``wg::gemm``, and that template issues wgmma on tiles
    TMA loads, with no other product."""
    src = FT._SOURCE.read_text()
    hdr = (FT._SOURCE.parent / "wgmma_bf16.cuh").read_text()
    assert "gemm_fwd_bf16_kernel" not in src and "load_bf" not in src
    assert '#include "wgmma_bf16.cuh"' in src
    assert src.count("return wg::gemm<") == 2
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in hdr
    assert "cp.async.bulk.tensor.2d" in hdr
    assert "mma.sync" not in hdr and "mma_tf32" not in hdr


def test_bf16_plain_versions_round_where_the_kernels_store():
    """The temporal plain version keeps its scratch in bf16 (the statistics
    in float32) and its output is the keep version's; the spatial one
    keeps nothing in bf16 but its output; float32 is unchanged."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((TN, TT, TD)).astype(np.float32))
    w = _to_port(_block_weights(rng, TD))
    out, saved = FT.temporal_block_keep_reference(
        x.to(torch.bfloat16), [t.to(torch.bfloat16) for t in w], TH)
    assert out.dtype == torch.bfloat16
    assert saved[0].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for t in saved[1:])
    assert torch.equal(out, FT.temporal_block_reference(
        x.to(torch.bfloat16), [t.to(torch.bfloat16) for t in w], TH))
    # float32 unchanged: the keep version's output is the plain block's
    out32, _ = FT.temporal_block_keep_reference(x, w, TH)
    assert torch.allclose(out32, FT.temporal_block_reference(x, w, TH),
                          atol=1e-5)
    with pytest.raises(TypeError):
        FT.check_block(x.half(), [t.half() for t in w], TH)
    with pytest.raises(TypeError):
        FT.check_block(x.to(torch.bfloat16), w, TH)


# -- the bf16 plain versions of rows 10-13 -------------------------------------

#: cell -> (B, L, J, H, k): B=6 pads to the TPU layout's multiple of 4,
#: L=16 as config 3's clips, where bf16's rounding compounds frame by frame
SCAN_CASES = {"gru": (6, 16, 26, 16, 2), "lstm": (6, 16, 26, 16, 2),
              "dense": (6, 16, 1, 16, 1)}


def _scan_operator(J):
    return -CARLA_SKELETON.get_adjacency_matrix(
        normalized=True, self_loops=False) if J == 26 else np.zeros((J, J))


def _scan_inputs(cell):
    """Seeded bf16 values (as float32 numpy): xg, the weights, the
    cotangents of ys (and cs)."""
    B, L, J, H, k = SCAN_CASES[cell]
    rng = np.random.default_rng(sum(map(ord, "bf16" + cell)))

    def rnd(*shape, scale=1.0):
        return _bf((scale * rng.standard_normal(shape)).astype(np.float32))
    gates = 3 if cell == "gru" else 4
    groups = (2, 1) if cell == "gru" else (4,)
    xg = rnd(L, B, J, gates * H)
    weights = tuple(rnd(H, k * g * H, scale=H ** -0.5) for g in groups)
    cots = tuple(rnd(L, B, J, H) for _ in range(1 if cell == "gru" else 2))
    return xg, weights, cots


@functools.lru_cache(maxsize=None)
def _jax_scan_bf16(cell):
    """One JAX call per cell: the Pallas kernel (interpret mode) on bf16
    inputs, its outputs in the port's layout and ``jax.vjp``."""
    B, L, J, H, k = SCAN_CASES[cell]
    xg, weights, cots = _scan_inputs(cell)
    a_ops = jnp.asarray(JG.kron_cheb_ops(_scan_operator(J), k), BF)
    R = J * JG.BBR

    def to_port(ys):                        # (L, rows, H) -> (L, B, J, H)
        return jnp.swapaxes(JG.from_slabs(ys, B, J), 0, 1)

    def run(xg_, *ws):
        xs, _ = JG.to_slabs(jnp.swapaxes(xg_, 0, 1))
        bg = JG.pick_block_groups(xs.shape[1] // R)
        if cell == "gru":
            return (to_port(JG.graph_gru_scan(xs, a_ops, *ws, k, R, bg)),)
        ys, cs = JG.graph_lstm_scan(xs, a_ops, *ws, k, R, bg, True)
        return to_port(ys), to_port(cs)

    def fwd_vjp(xg_, ws, cts):
        outs, vjp = jax.vjp(run, xg_, *ws)
        return outs, vjp(cts)
    outs, grads = jax.jit(fwd_vjp)(
        jnp.asarray(xg, BF), tuple(jnp.asarray(w, BF) for w in weights),
        tuple(jnp.asarray(c, BF) for c in cots))
    assert all(o.dtype == BF for o in outs) and grads[0].dtype == BF
    return ([np.asarray(o, np.float32) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


def _port_scan_bf16(cell, xg, weights, cots):
    """The port's scan on CPU bf16 tensors through autograd (its CUDA
    route's entry): outputs and gradients of xg and the weights."""
    k = SCAN_CASES[cell][4]
    J = xg.shape[2]
    cheb = _t(FG.cheb_matrices(_scan_operator(J), k)).to(torch.bfloat16)
    leaves = [t.detach().clone().requires_grad_(True) for t in (xg, *weights)]
    if cell == "gru":
        outs = (FG.graph_gru_scan(leaves[0], cheb, *leaves[1:]),)
    else:
        outs = FG.graph_lstm_scan(leaves[0], cheb, leaves[1], with_c=True)
    grads = torch.autograd.grad(outs, leaves, cots)
    return outs, grads, cheb


def _kernel_algorithm_bf16(cell, xg, cheb, weights, cots):
    """The bf16 kernels' algorithm in plain PyTorch: the training forward
    with its residuals, then the backward from them."""
    if cell == "gru":
        ys, res = FG.graph_gru_scan_keep_reference(xg, cheb, *weights)
        return (ys,), FG.graph_gru_scan_bwd_reference(cheb, *weights, res,
                                                      cots[0])
    if cell == "dense":
        ys, cs, gates = FG.dense_lstm_scan_keep_reference(xg, *weights)
        return (ys, cs), FG.dense_lstm_scan_bwd_reference(
            *weights, gates, ys, cs, *cots)
    ys, cs, res = FG.graph_lstm_scan_keep_reference(xg, cheb, *weights)
    return (ys, cs), FG.graph_lstm_scan_bwd_reference(cheb, *weights, res,
                                                      cs, *cots)


@pytest.mark.parametrize("cell", list(SCAN_CASES))
def test_bf16_scan_plain_versions_match_the_jax_kernels(cell):
    """Rows 10-13's bf16 plain versions against the JAX kernels in bf16:
    through autograd (the entry's CPU route), and as the CUDA kernels'
    algorithm (training forward with residuals, backward from them);
    outputs, dxg and the weight gradients in bf16."""
    xg, weights, cots = _scan_inputs(cell)
    ref_outs, ref_grads = _jax_scan_bf16(cell)
    bf = torch.bfloat16
    xg_t, w_t = _t(xg).to(bf), [_t(w).to(bf) for w in weights]
    cots_t = tuple(_t(c).to(bf) for c in cots)
    outs, grads, cheb = _port_scan_bf16(cell, xg_t, w_t, cots_t)
    algo_outs, algo_grads = _kernel_algorithm_bf16(cell, xg_t, cheb, w_t,
                                                   cots_t)
    for what, os_, gs in (("autograd", outs, grads),
                          ("kernel algorithm", algo_outs, algo_grads)):
        assert all(o.dtype == bf for o in os_)
        assert all(g.dtype == bf for g in gs)
        for i, (o, ref) in enumerate(zip(os_, ref_outs)):
            _assert_close(o.detach().float().numpy(), ref, KERNEL_OUT_BAR,
                          f"{cell} {what} output {i}")
        for i, (g, ref) in enumerate(zip(gs, ref_grads)):
            _assert_close(g.float().numpy(), ref, KERNEL_GRAD_BAR,
                          f"{cell} {what} gradient {i}")


def test_bf16_scan_plain_versions_keep_the_carry_in_float32():
    """The bf16 plain versions round what the kernels round and keep
    float32 what they keep: a hand-written GRU and LSTM frame loop with the
    carry (and c) in float32, h and r h rounded to bf16 and the graph terms
    T_n h as product operands to TF32 (10 mantissa bits, ties away from
    zero; the GRU) or to two bf16 parts, bf16(T_n h) + bf16(the rest) (the
    LSTM, whose bf16 kernels take them so) gives their bits; the same loop
    with a bf16 carry does not. ys and cs come out bf16, the gates and the
    expanded operands float32."""
    rng = np.random.default_rng(12)
    B, L, J, H, k = 3, 4, 26, 8, 2
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return _t((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(bf)
    cheb = _t(FG.cheb_matrices(_scan_operator(J), k)).to(bf)

    def rounded(x):
        return x.to(bf).float()

    def tf32(x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1fff).view(torch.float32)

    def two_bf16(x):
        hi = rounded(x)
        return hi + rounded(x - hi)

    def expand(h, term=tf32):
        h = rounded(h)
        return torch.stack([h] + [term(torch.einsum(
            "ij,bjc->bic", cheb[0].float(), h))], dim=-1).flatten(-2)

    def gru(carry_rounded):
        xg, wzr, wh = rnd(L, B, J, 3 * H), rnd(H, k * 2 * H, scale=0.3), \
            rnd(H, k * H, scale=0.3)
        h, ys = torch.zeros(B, J, H), []
        for t in range(L):
            x = xg[t].float()
            zr = torch.sigmoid(x[..., :2 * H]
                               + expand(h) @ wzr.float().reshape(k * H, -1))
            z, r = zr[..., :H], zr[..., H:]
            ht = torch.tanh(x[..., 2 * H:]
                            + expand(r * h) @ wh.float().reshape(k * H, -1))
            h = z * h + (1 - z) * ht
            h = rounded(h) if carry_rounded else h
            ys.append(h.to(bf))
        return (xg, wzr, wh), torch.stack(ys)

    for carry_rounded in (False, True):
        rng = np.random.default_rng(12)
        inputs, want = gru(carry_rounded)
        ys, res = FG.graph_gru_scan_keep_reference(inputs[0], cheb,
                                                   *inputs[1:])
        assert ys.dtype == bf
        assert res.gates.dtype == res.sa.dtype == res.sb.dtype \
            == torch.float32
        assert torch.equal(ys, want) != carry_rounded
        assert torch.equal(FG.graph_gru_scan_reference(inputs[0], cheb,
                                                       *inputs[1:]), ys)

    def lstm(c_rounded):
        xg, w = rnd(L, B, J, 4 * H), rnd(H, k * 4 * H, scale=0.3)
        h, c, ys, cs = torch.zeros(B, J, H), torch.zeros(B, J, H), [], []
        for t in range(L):
            a = xg[t].float() + expand(h, two_bf16) @ w.float().reshape(
                k * H, -1)
            i, f, g, o = a.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            c = rounded(c) if c_rounded else c
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h.to(bf))
            cs.append(c.to(bf))
        return (xg, w), torch.stack(ys), torch.stack(cs)

    for c_rounded in (False, True):
        rng = np.random.default_rng(13)
        (xg, w), want_ys, want_cs = lstm(c_rounded)
        ys, cs, res = FG.graph_lstm_scan_keep_reference(xg, cheb, w)
        assert ys.dtype == cs.dtype == bf
        assert res.gates.dtype == res.sa.dtype == torch.float32
        assert (torch.equal(ys, want_ys) and torch.equal(cs, want_cs)) \
            != c_rounded
    # float32 is unchanged: the keep versions' outputs are the plain ones'
    x32, w32 = xg.float(), w.float()
    np.testing.assert_allclose(
        FG.graph_lstm_scan_keep_reference(x32, cheb.float(), w32)[0].numpy(),
        FG.graph_lstm_scan_reference(x32, cheb.float(), w32)[0].numpy(),
        rtol=0, atol=1e-6)
    # the backward's cotangents are rounded where the kernels store them:
    # dxg and the weight gradients come out bf16, bf16 values
    dxg, dw = FG.graph_lstm_scan_bwd_reference(
        cheb, w, res, cs, rnd(L, B, J, H), rnd(L, B, J, H))
    assert dxg.dtype == dw.dtype == bf


def test_bf16_scan_byte_counts():
    """The bf16 scans' bytes (``ops/flops.py``): bf16 tensors at 2 bytes,
    the training forward's residuals (gates and expanded operands) at 4 in
    both dtypes; float32's counts are the element size 4 ones."""
    from pedestrians_video_2_carla_torch.ops import flops as TF
    rows, weights = 256 * 16 * 26, 256 * 384 + 26 * 26
    count = functools.partial(TF.graph_scan_bytes, "gru", 256, 16, 26, 128, 2)
    assert count(element_size=2) == 2 * (rows * 512 + weights)
    # kept: gates 3H = 384, sa and sb k H = 256 each, a row
    assert count(keep=True, element_size=2) \
        == 4 * rows * (384 + 512) + 2 * (rows * 512 + weights)
    assert count(backward=True, element_size=2) \
        == 4 * rows * (384 + 512) + 2 * (rows * (128 + 384) + 2 * weights)
    for kw in ({}, {"keep": True}, {"backward": True}):
        assert count(**kw) == count(element_size=4, **kw)
    # the dense form's backward reads its kept gates and, in place of the
    # expanded operand, ys at the element size
    dense = TF.graph_scan_bytes("lstm", 4, 2, 1, 8, 1, backward=True,
                                with_dcs=True, dense=True, element_size=2)
    assert dense == 4 * 8 * 32 + 2 * (8 * (32 + 8 * 3 + 8) + 2 * 8 * 32)


# -- the CLI, serving, the ops -------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--flow=pose_lifting", "--movements_model_name=LinearAE",
     "--loss_modes", "loc_2d_3d"],
    ["--flow=classification", "--classification_model_name=GConvGRU",
     "--hidden_size=8", "--graph_kernel=plain"],
    ["--flow=classification", "--classification_model_name=GConvGRU",
     "--hidden_size=8", "--graph_kernel=fused"],
])
def test_cli_trains_in_bf16(tmp_path, flags):
    results = modeling.main(flags + [
        "--precision", "bf16", "--data_module_name=Carla2D3D",
        "--batch_size=4", "--clip_length=8", "--max_epochs=1",
        "--limit_train_batches=2", "--val_set_size=4", "--device=cpu",
        f"--root_dir={tmp_path}", "--run_name=bf16"])
    flow = results["flow"]
    assert flow.precision == "bf16"
    state = results["trainer"].state
    leaves = [v for tree in state.params.values() for v in tree.values()]
    assert leaves and all(v.dtype == torch.float32 for v in leaves)
    losses = [float(v) for k, v in results["val_metrics"].items()
              if "loss" in k]
    assert losses and all(np.isfinite(losses))


def test_bf16_pose_former_exports_and_serves_on_the_cpu(tmp_path):
    """The casts sit inside the program: fp32 in, fp32 out, the closure's
    values; the spatial and temporal ops run in bf16."""
    model = MOVEMENTS_MODELS["PoseFormer"](
        **POSE_FORMER, spatial_kernel="fused", temporal_kernel="fused",
        generator=torch.Generator().manual_seed(0))
    flow = PoseLiftingFlow(model, loss_modes=["loc_2d_3d"], precision="bf16",
                           device="cpu")
    params = flow.init_params()
    inputs, _, meta = _to_torch(_batch())
    agi = meta["age_gender_idx"]
    closure = serving.make_inference_fn(flow, params)(inputs, agi)
    path = serving.export_inference(flow, params, inputs, agi,
                                    str(tmp_path / "pf.pt2"))
    infer, meta_json = serving.load_inference(path, device="cpu")
    assert meta_json["input_dtypes"][0] == "float32"
    served = infer(inputs, agi)
    assert set(served) == set(closure)
    for k, v in closure.items():
        assert served[k].dtype == v.dtype == torch.float32, k
        torch.testing.assert_close(served[k], v, rtol=0, atol=0)
    program = torch.export.load(path)
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert any("pv2c.fused_spatial_stack" in t for t in targets)
    assert any("pv2c.fused_temporal_block" in t for t in targets)
    assert any("_to_copy" in t or "to.dtype" in t for t in targets)


def test_bf16_gconvgru_exports_and_serves_on_the_cpu(tmp_path):
    """A bf16 GConvGRU on its fused route: the program carries the bf16
    scan op, fp32 in and out, the closure's bits."""
    model = CLASSIFICATION_MODELS["GConvGRU"](
        hidden_size=16, graph_kernel="fused",
        generator=torch.Generator().manual_seed(0))
    flow = ClassificationFlow(model, precision="bf16", device="cpu")
    params = flow.init_params()
    inputs = _t(_classifier_batch()[0])
    agi = torch.zeros(B, dtype=torch.int64)
    closure = serving.make_inference_fn(flow, params)(inputs, agi)
    path = serving.export_inference(flow, params, inputs, agi,
                                    str(tmp_path / "gru.pt2"))
    infer, _ = serving.load_inference(path, device="cpu")
    served = infer(inputs, agi)
    assert set(served) == set(closure)
    for k, v in closure.items():
        assert served[k].dtype == v.dtype == torch.float32, k
        torch.testing.assert_close(served[k], v, rtol=0, atol=0)
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert sum("pv2c.graph_gru_scan_fwd" in t for t in targets) == 2


def test_ops_pass_opcheck_in_bf16():
    rng = np.random.default_rng(9)
    bf = torch.bfloat16
    x = _t(rng.standard_normal((5, SJ, SE)).astype(np.float32)).to(bf)
    w = [t.to(bf) for t in _to_port(_block_weights(rng, SE, lead=(SDEPTH,)))]
    w += [torch.ones(SE, dtype=bf), torch.zeros(SE, dtype=bf)]
    torch.library.opcheck(FS.fused_spatial_stack_op, (x, w, SH))
    xt = _t(rng.standard_normal((4, TT, TD)).astype(np.float32)).to(bf)
    wt = [t.to(bf) for t in _to_port(_block_weights(rng, TD))]
    torch.library.opcheck(FT.fused_temporal_block_op, (xt, wt, TH))
    assert FS.fused_spatial_stack_op(x, w, SH).dtype == bf
    assert FT.fused_temporal_block_op(xt, wt, TH).dtype == bf
    # the scans (rows 10 and 12, graph and dense form)
    H = 8
    cheb = _t(FG.cheb_matrices(_scan_operator(26), 2)).to(bf)

    def rnd(*shape):
        return _t((0.3 * rng.standard_normal(shape)).astype(
            np.float32)).to(bf)
    cases = ((FG.graph_gru_scan_fwd_op, (rnd(3, 2, 26, 3 * H), cheb,
                                         rnd(H, 4 * H), rnd(H, 2 * H))),
             (FG.graph_lstm_scan_fwd_op, (rnd(3, 2, 26, 4 * H), cheb,
                                          rnd(H, 8 * H))),
             (FG.dense_lstm_scan_fwd_op, (rnd(3, 5, 1, 4 * H),
                                          rnd(H, 4 * H))))
    for op, args in cases:
        torch.library.opcheck(op, args)
        outs = op(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert all(o.dtype == bf for o in outs)


def test_graph_scans_run_bf16_on_the_cpu_and_refuse_it_on_the_card():
    """Rows 10-13 run bf16 on both devices (ROADMAP M5b step 4, which
    lifted the refusal this test once pinned): their plain versions run
    bf16 on the CPU; a bf16 CUDA tensor passes the scans' checks on every
    route, one dtype a call. The card is stood in for by meta tensors of
    type cuda, which no kernel reads."""
    rng = np.random.default_rng(4)
    xg = _t(rng.standard_normal((3, 2, 26, 3 * 8)).astype(np.float32))
    cheb = _t(FG.cheb_matrices(np.eye(26, dtype=np.float32), 2))
    wzr = _t(0.3 * rng.standard_normal((8, 2 * 2 * 8)).astype(np.float32))
    wh = _t(0.3 * rng.standard_normal((8, 2 * 8)).astype(np.float32))
    bf = torch.bfloat16
    ys = FG.graph_gru_scan(xg.to(bf), cheb.to(bf), wzr.to(bf), wh.to(bf))
    ref = FG.graph_gru_scan(xg, cheb, wzr, wh)
    assert ys.dtype == bf
    _assert_close(ys.float().numpy(), ref.numpy(), 2e-2, "bf16 GRU scan")
    meta = [t.to(bf).to("meta") for t in (xg, cheb, wzr, wh)]
    assert FG._check_scan(meta[0], meta[1], (("wzr", meta[2], 2),
                                             ("wh", meta[3], 1)),
                          FG.GRU_GATES) == (3, 2, 26, 8, 2)
    # the backward's kept gates are float32 beside bf16 weights
    gates = torch.empty((3, 2, 26, 3 * 8), device="meta")
    assert FG._check_scan(gates, meta[1], (("wzr", meta[2], 2),
                                           ("wh", meta[3], 1)),
                          FG.GRU_GATES, bf) == (3, 2, 26, 8, 2)
    w4 = torch.empty((8, 4 * 8), dtype=bf, device="meta")
    assert FG._check_dense(torch.empty((3, 2, 1, 32), dtype=bf,
                                       device="meta"), w4) == (3, 2, 1, 8)
    with pytest.raises(TypeError, match="one dtype"):   # one dtype a call
        FG._check_scan(meta[0], cheb.to("meta"), (("wzr", meta[2], 2),
                                                  ("wh", meta[3], 1)),
                       FG.GRU_GATES)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bf16 kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SCAN_CASES))
def test_bf16_scan_kernels_match_their_plain_versions(cuda_device, cell):
    """Rows 10-13's bf16 kernels (the training forward, the backward from
    its residuals) against the kernels' algorithm in plain PyTorch."""
    xg, weights, cots = _scan_inputs(cell)
    bf = torch.bfloat16
    args = [_t(xg).to(bf), [_t(w).to(bf) for w in weights],
            tuple(_t(c).to(bf) for c in cots)]
    k = SCAN_CASES[cell][4]
    cheb = _t(FG.cheb_matrices(_scan_operator(xg.shape[2]), k)).to(bf)
    ref_outs, ref_grads = _kernel_algorithm_bf16(cell, args[0], cheb,
                                                 *args[1:])
    cuda = lambda t: t.to(cuda_device)
    xg_c, w_c, cots_c, cheb_c = cuda(args[0]), [cuda(w) for w in args[1]], \
        tuple(cuda(c) for c in args[2]), cuda(cheb)
    if cell == "gru":
        ys, res = FG.graph_gru_scan_cuda_fwd(xg_c, cheb_c, *w_c, keep=True)
        outs, grads = (ys,), FG.graph_gru_scan_cuda_bwd(cheb_c, *w_c, res,
                                                        cots_c[0])
    elif cell == "dense":
        ys, cs, gates = FG.dense_lstm_scan_cuda_fwd(xg_c, *w_c, keep=True)
        outs, grads = (ys, cs), FG.dense_lstm_scan_cuda_bwd(
            *w_c, gates, ys, cs, *cots_c)
    else:
        ys, cs, res = FG.graph_lstm_scan_cuda_fwd(xg_c, cheb_c, *w_c,
                                                  keep=True)
        outs, grads = (ys, cs), FG.graph_lstm_scan_cuda_bwd(
            cheb_c, *w_c, res, cs, *cots_c)
    for got, ref in zip((*outs, *grads), (*ref_outs, *ref_grads)):
        assert got.dtype == bf
        _assert_close(got.float().cpu().numpy(), ref.float().numpy(),
                      KERNEL_OUT_BAR, cell)


#: the spatial bf16 backward against its plain algorithm in float32 from
#: the same residuals: one bf16 rounding of fp32-accurate results
SPATIAL_BWD_BAR = 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_bf16_kernels_match_their_plain_versions(cuda_device, kind):
    """The bf16 kernels through autograd against the bf16 plain versions;
    the spatial backward's dx and weight gradients also within 2^-8 of
    max |plain| of its plain algorithm in float32
    (``spatial_stack_bwd_reference``) from the kernel forward's
    residuals: its products stayed fp32-accurate."""
    x, weights, g, _, _, _ = _kernel_case(kind)
    fn = (lambda x, w: FS.fused_spatial_stack(x, w, SH)) \
        if kind == "spatial" else \
        (lambda x, w: FT.fused_temporal_block(x, w, TH))
    grads = []
    for device in ("cpu", cuda_device):
        leaves = [t.detach().to(device).requires_grad_(True)
                  for t in (_t(x).to(torch.bfloat16), *weights)]
        out = fn(leaves[0], leaves[1:])
        grads.append([out.detach().float().cpu()] + [
            d.float().cpu() for d in torch.autograd.grad(
                out, leaves, _t(g).to(torch.bfloat16).to(device))])
    for got, ref in zip(grads[1], grads[0]):
        _assert_close(got.numpy(), ref.numpy(), KERNEL_GRAD_BAR, kind)
    if kind != "spatial":
        return
    xc = _t(x).to(torch.bfloat16).to(cuda_device)
    gc = _t(g).to(torch.bfloat16).to(cuda_device)
    wc = [w.to(cuda_device) for w in weights]
    with torch.no_grad():
        _, saved = FS.fused_spatial_stack_cuda(xc, wc, SH, keep=True)
        dx, dws = FS.fused_spatial_stack_cuda_bwd(xc, wc, saved, gc, SH)
        exact = FS.spatial_stack_bwd_reference(xc, wc, saved, gc, SH)
    for got, want in zip((dx, *dws), (exact[0], *exact[1])):
        want = want.cpu().numpy()
        err = np.abs(got.float().cpu().numpy() - want).max()
        assert err <= SPATIAL_BWD_BAR * np.abs(want).max(), err


#: (n, T, D, heads, hidden) whose M = n T and N leave partial tiles of the
#: bf16 GEMM's 128 x 128: 63 rows at D=208 (1.625 tiles), hidden 416; T=81
EDGE_SHAPES = ((7, 9, 208, 2, 416), (3, 81, 208, 2, 416))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_bf16_temporal_kernels_match_their_plain_versions_at_edge_shapes(
        cuda_device, shape):
    """Rows 8 and 9 in bf16 where the GEMM's tiles are partial: the
    forward, the training forward's kept scratch and the backward against
    the bf16 plain versions on the same values, and two backward calls'
    bits."""
    n, T, D, heads, hidden = shape
    rng = np.random.default_rng(2720)
    w = [a.to(torch.bfloat16) for a in _to_port(_block_weights(
        rng, D, hidden=hidden))]
    x = _t(rng.standard_normal((n, T, D)).astype(np.float32)).to(
        torch.bfloat16)
    g = _t(rng.standard_normal((n, T, D)).astype(np.float32)).to(
        torch.bfloat16)
    cw = [t.to(cuda_device) for t in w]
    with torch.no_grad():
        out = FT.fused_temporal_block_cuda(x.to(cuda_device), cw, heads)
        out_k, saved = FT.fused_temporal_block_cuda(x.to(cuda_device), cw,
                                                    heads, keep=True)
        dx, dws = FT.fused_temporal_block_cuda_bwd(
            x.to(cuda_device), cw, saved, g.to(cuda_device), heads)
        dx2, dws2 = FT.fused_temporal_block_cuda_bwd(
            x.to(cuda_device), cw, saved, g.to(cuda_device), heads)
    ref_out, ref_saved = FT.temporal_block_keep_reference(x, w, heads)
    for got, ref in zip((out, out_k, *saved), (ref_out, ref_out,
                                               *ref_saved)):
        _assert_close(got.float().cpu().numpy(), ref.float().numpy(),
                      KERNEL_OUT_BAR, f"{shape} forward")
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *w)]
    ref = torch.autograd.grad(FT.temporal_block_reference(
        leaves[0], leaves[1:], heads), leaves, g)
    for got, again, want in zip((dx, *dws), (dx2, *dws2), ref):
        assert torch.equal(got, again)
        _assert_close(got.float().cpu().numpy(), want.float().numpy(),
                      KERNEL_GRAD_BAR, f"{shape} backward")

"""Port parity for serving export (``serving.py``), on the CPU: the port's
``torch.export`` artifact reproduces its inference closure (1e-6) on the
``plain`` and ``fused`` routes, equals the JAX package's StableHLO
artifact on the same weights (LinearAE, a small PoseFormer, the LSTM and
GConvGRU classifiers: 1e-3 px on projections, 1e-5 elsewhere), filters its
outputs, serves any batch with a polymorphic batch (refused on ``fused``),
refuses a wrong clip length, writes the JAX meta's keys and loads in a
process that imports the port alone; every ``pv2c`` op passes
``torch.library.opcheck`` (its fake against its CPU implementation); the
card-marked cases hold each op's CUDA kernel to its plain version."""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu import serving as JS
from pedestrians_video_2_carla_tpu.data.carla import carla_2d3d as JD
from pedestrians_video_2_carla_tpu.flows.classification import \
    ClassificationFlow as JClassificationFlow
from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
    PoseLiftingFlow as JPoseLiftingFlow
from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
from pedestrians_video_2_carla_tpu.models.base import \
    OptimizerSettings as JOptimizerSettings
from pedestrians_video_2_carla_tpu.models.classification import \
    CLASSIFICATION_MODELS as J_CLASSIFIERS
from pedestrians_video_2_carla_tpu.models.movements import \
    MOVEMENTS_MODELS as J_MOVEMENTS

from pedestrians_video_2_carla_torch import serving as TS
from pedestrians_video_2_carla_torch.flows.classification import \
    ClassificationFlow
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.classification import \
    CLASSIFICATION_MODELS
from pedestrians_video_2_carla_torch.models.jax_import import \
    import_flow_params
from pedestrians_video_2_carla_torch.models.movements import \
    MOVEMENTS_MODELS
from pedestrians_video_2_carla_torch.ops import camera as C
from pedestrians_video_2_carla_torch.ops import fused_graph_gru as G
from pedestrians_video_2_carla_torch.ops import fused_projection as FP
from pedestrians_video_2_carla_torch.ops import \
    fused_spatial_transformer as FS
from pedestrians_video_2_carla_torch.ops import \
    fused_temporal_transformer as FT
from .torch_threads import limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 4, 9
#: a small PoseFormer: depth 2, receptive field 9
SMALL_POSE_FORMER = dict(clip_length=L, receptive_frames=9,
                         single_joint_embeddings_size=8, depth=2,
                         num_heads=4)
#: case -> (flow, movements or classification model, its arguments, the
#: JAX route fields, the port's kernel route fields)
CASES = {
    "LinearAE": ("pose_lifting", "LinearAE", {}, {}, {}),
    "PoseFormer": ("pose_lifting", "PoseFormer", SMALL_POSE_FORMER,
                   dict(spatial_kernel="xla", temporal_kernel="xla"),
                   dict(spatial_kernel="fused", temporal_kernel="fused")),
    "LSTM": ("classification", "LSTM",
             dict(hidden_size=16, embeddings_size=12),
             dict(rnn_kernel="xla"), dict(rnn_kernel="fused")),
    "GConvGRU": ("classification", "GConvGRU", dict(hidden_size=16),
                 dict(graph_kernel="xla"), dict(graph_kernel="fused")),
}


def _close(port, ref, atol, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=0.0, err_msg=msg)


def _assert_same_preds(port, ref):
    """The bars of the serving slices: 1e-3 px on the projections' x and
    y, 1e-5 elsewhere."""
    assert set(port) == set(ref)
    for k, v in port.items():
        v, r = np.asarray(v), np.asarray(ref[k])
        assert v.shape == r.shape, k
        if k.startswith("projection_2d"):
            _close(v[..., :2], r[..., :2], 1e-3 if k == "projection_2d"
                   else 1e-5, k)
            _close(v[..., 2:], r[..., 2:], 1e-5, k)
        else:
            _close(v, r, 1e-5, k)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return str(tmp_path_factory.mktemp("artifacts"))


@functools.lru_cache(maxsize=None)
def _jax_case(name, store):
    """A JAX flow of the case with its initialised state, a batch, and its
    artifact (``export_inference``, the ``xla`` routes) loaded back."""
    flow_name, model, kwargs, routes, _ = CASES[name]
    batch = jax.device_get(JD.generate_batch(
        jax.random.PRNGKey(0), JD.Carla2D3DConfig(batch_size=B,
                                                  clip_length=L)))
    if flow_name == "pose_lifting":
        flow = JPoseLiftingFlow(
            movements_model=J_MOVEMENTS[model](**kwargs, **routes),
            loss_modes=[JLossModes.loc_2d_3d],
            movements_optimizer=JOptimizerSettings(lr=1e-3))
    else:
        flow = JClassificationFlow(
            classification_model=J_CLASSIFIERS[model](**kwargs, **routes),
            classification_optimizer=JOptimizerSettings(lr=1e-3))
    state = flow.init_state(jax.random.PRNGKey(1), batch)
    inputs, agi = np.asarray(batch[0]), np.asarray(batch[2]["age_gender_idx"])
    path = JS.export_inference(flow, state, inputs, agi,
                               os.path.join(store, f"{name}.jaxexp"))
    call, meta = JS.load_inference(path)
    preds = jax.device_get(call(inputs, agi))
    return jax.device_get(state.params), inputs, agi, preds, meta


def _port_flow(name, kernel="plain"):
    flow_name, model, kwargs, _, routes = CASES[name]
    if flow_name == "pose_lifting":
        return PoseLiftingFlow(MOVEMENTS_MODELS[model](**kwargs, **routes),
                               loss_modes=["loc_2d_3d"],
                               projection_kernel=kernel, device="cpu")
    return ClassificationFlow(CLASSIFICATION_MODELS[model](**kwargs,
                                                           **routes),
                              device="cpu")


@functools.lru_cache(maxsize=None)
def _port_case(name, kernel, store, output_keys=None,
               polymorphic_batch=False):
    """The port's flow on the JAX case's weights, its closure's outputs on
    the case's batch, and its artifact loaded back on the CPU."""
    j_params, inputs, agi, _, _ = _jax_case(name, store)
    flow = _port_flow(name, kernel)
    params = import_flow_params(j_params, device="cpu")
    x, a = torch.from_numpy(inputs), torch.from_numpy(agi).long()
    direct = TS.make_inference_fn(flow, params, output_keys)(x, a)
    path = TS.export_inference(
        flow, params, x, a,
        os.path.join(store, f"{name}-{kernel}-{output_keys}-"
                            f"{polymorphic_batch}.pt2"),
        output_keys=output_keys, polymorphic_batch=polymorphic_batch)
    call, meta = TS.load_inference(path, device="cpu")
    return flow, params, x, a, direct, path, call, meta


@pytest.mark.parametrize("kernel", ["plain", "fused"])
def test_export_roundtrip_matches_the_closure(kernel, store):
    _, _, x, a, direct, path, call, meta = _port_case("LinearAE", kernel,
                                                      store)
    served = call(x, a)
    assert set(served) == set(direct)
    assert "projection_2d" in served and "absolute_pose_loc" in served
    for k, v in direct.items():
        _close(served[k], v, 1e-6 * float(v.abs().max()), k)
    assert meta["flow"] == "PoseLiftingFlow"
    assert meta["output_keys"] == sorted(direct)
    assert meta["platforms"] == ["cpu"]
    assert os.path.exists(path) and os.path.exists(path + ".json")


def _program_ops(path):
    """The ``pv2c`` ops an exported program calls, in order."""
    return [str(n.target).split(".")[1]
            for n in torch.export.load(path).graph.nodes
            if n.op == "call_function" and str(n.target).startswith("pv2c.")]


@pytest.mark.parametrize("name,kernel,ops", [
    ("LinearAE", "fused", ["fused_projection"]),
    ("LinearAE", "plain", []),
    ("PoseFormer", "plain", ["fused_spatial_stack"]
     + ["fused_temporal_block"] * 2),
    ("LSTM", "plain", ["graph_lstm_scan_fwd"] * 2),
    ("GConvGRU", "plain", ["graph_gru_scan_fwd"] * 2)])
def test_artifact_carries_the_kernel_ops(name, kernel, ops, store):
    """Each kernel route's forward is one node of the program: the
    projection's serving op on ``fused`` (none on ``plain``), PoseFormer's
    stage ops (a spatial stack, a temporal block per depth), a scan op per
    layer of the classifiers (on CPU tensors the LSTM's scan takes the
    graph form)."""
    assert _program_ops(_port_case(name, kernel, store)[5]) == ops


@pytest.mark.parametrize("name,kernel", [
    ("LinearAE", "plain"), ("LinearAE", "fused"), ("PoseFormer", "plain"),
    ("LSTM", "plain"), ("GConvGRU", "plain")])
def test_artifact_matches_the_jax_artifact(name, kernel, store):
    """The port's artifact and the JAX package's, on the same weights and
    the same batch; PoseFormer and the classifiers take their stage and
    scan ops (``fused``, their CPU implementations here)."""
    _, _, _, j_preds, j_meta = _jax_case(name, store)
    _, _, x, a, _, _, call, meta = _port_case(name, kernel, store)
    _assert_same_preds(call(x, a), j_preds)
    assert set(meta) == set(j_meta)
    assert meta["output_keys"] == j_meta["output_keys"]
    assert meta["input_shapes"] == j_meta["input_shapes"]
    assert meta["flow"] == j_meta["flow"]


def test_output_keys_filter_the_artifact(store):
    _, _, x, a, direct, _, call, meta = _port_case(
        "LinearAE", "fused", store, output_keys=("projection_2d",))
    served = call(x, a)
    assert list(served) == ["projection_2d"] == meta["output_keys"]
    _close(served["projection_2d"], direct["projection_2d"], 0.0)
    # what no output reads is not in the program: the plane path of the
    # full artifact (hundreds of index, mul and add nodes) is gone
    lean = torch.export.load(_port_case("LinearAE", "fused", store,
                                        output_keys=("projection_2d",))[5])
    full = torch.export.load(_port_case("LinearAE", "fused", store)[5])
    assert 10 * len(lean.graph.nodes) < len(full.graph.nodes)
    assert _program_ops(_port_case("LinearAE", "fused", store,
                                   output_keys=("projection_2d",))[5]) \
        == ["fused_projection"]
    flow, params = _port_case("LinearAE", "plain", store)[:2]
    with pytest.raises(KeyError, match="not produced"):
        TS.make_inference_fn(flow, params, output_keys=("nope",))(x, a)
    with pytest.raises(KeyError, match="not produced"):
        TS.export_inference(flow, params, x, a, os.path.join(store, "n.pt2"),
                            output_keys=("nope",))


def test_polymorphic_batch_serves_any_batch(store):
    flow, params, x, a, _, _, call, meta = _port_case(
        "LinearAE", "plain", store, polymorphic_batch=True)
    assert meta["input_shapes"] == [["b", str(L), "26", "2"], ["b"]]
    direct = TS.make_inference_fn(flow, params)
    xs, ags = torch.cat([x, x.flip(0)]), torch.cat([a, a.flip(0)])
    for bs in (2, 5):
        served, ref = call(xs[:bs], ags[:bs]), direct(xs[:bs], ags[:bs])
        for k, v in ref.items():
            _close(served[k], v, 1e-5, f"{k} at B={bs}")
    fused = _port_flow("LinearAE", "fused")
    with pytest.raises(ValueError, match="polymorphic_batch"):
        TS.export_inference(fused, params, x, a,
                            os.path.join(store, "nope.pt2"),
                            polymorphic_batch=True)


def test_artifact_refuses_a_wrong_clip_length(store):
    _, _, x, a, _, _, call, _ = _port_case("LinearAE", "fused", store)
    with pytest.raises(Exception):
        call(x[:, :4], a)


def test_artifact_loads_in_a_process_without_the_flow(store):
    """A fresh process imports ``serving`` alone: the program runs on the
    CPU without the flows, the models or JAX."""
    _, _, x, a, direct, path, _, _ = _port_case("GConvGRU", "plain", store)
    absent = ("jax", "pedestrians_video_2_carla_tpu",
              "pedestrians_video_2_carla_torch.flows",
              "pedestrians_video_2_carla_torch.models")
    np.save(os.path.join(store, "x.npy"), x.numpy())
    np.save(os.path.join(store, "a.npy"), a.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from pedestrians_video_2_carla_torch.serving import load_inference\n"
        f"call, meta = load_inference({path!r}, device='cpu')\n"
        f"out = call(np.load({os.path.join(store, 'x.npy')!r}),\n"
        f"           np.load({os.path.join(store, 'a.npy')!r}))\n"
        f"np.save({os.path.join(store, 'out.npy')!r},\n"
        "        out[meta['output_keys'][0]].numpy())\n"
        f"bad = sorted(m for m in sys.modules if m.startswith({absent!r}))\n"
        "assert not bad, bad\n"
        "print('SERVED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SERVED" in proc.stdout
    _close(np.load(os.path.join(store, "out.npy")),
           direct["crossing_logits"], 0.0)


# -- the ops -------------------------------------------------------------

def _rotations(rng, shape):
    q = rng.standard_normal(shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return torch.from_numpy(np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        -1).reshape(shape + (3, 3)).astype(np.float32))


def _t(rng, *shape, scale=0.3):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32))


def _block_weights(rng, dim, hidden, lead=()):
    shapes = ((dim,), (dim,), (3 * dim, dim), (3 * dim,), (dim, dim),
              (dim,), (dim,), (dim,), (hidden, dim), (hidden,),
              (dim, hidden), (dim,))
    return [_t(rng, *lead, *s) + (1.0 if i in (0, 6) else 0.0)
            for i, s in enumerate(shapes)]


OPS = ("fused_projection", "fused_projection_train_fwd",
       "fused_spatial_stack", "fused_temporal_block", "graph_gru_scan_fwd",
       "graph_lstm_scan_fwd", "dense_lstm_scan_fwd")


@functools.lru_cache(maxsize=None)
def _op_cases():
    """(op, args, plain version of its output) on small CPU tensors."""
    rng = np.random.default_rng(5)
    camera = C.make_camera()
    consts = list(camera.constants())
    changes = _rotations(rng, (2, 3, 26))
    rel_loc, rel_rot = _t(rng, 2, 26, 3), _rotations(rng, (2, 26))
    spatial = _block_weights(rng, 8, 16, lead=(2,)) + [
        _t(rng, 8) + 1.0, _t(rng, 8)]
    temporal = _block_weights(rng, 16, 32)
    H, k = 4, 2
    cheb = torch.from_numpy(G.cheb_matrices(
        np.eye(26, k=1) + np.eye(26, k=-1), k))
    gru_xg, lstm_xg = _t(rng, 3, 2, 26, 3 * H), _t(rng, 3, 2, 26, 4 * H)
    wzr, wh, w = _t(rng, H, 2 * k * H), _t(rng, H, k * H), \
        _t(rng, H, 4 * k * H)
    dense_xg, dense_w = _t(rng, 3, 5, 1, 4 * H), _t(rng, 4 * H, H).t()
    proj, abs_loc = FP.fused_projection_train_reference(
        changes, rel_loc, rel_rot, camera)
    states = FP.fused_projection_fwd_algorithm(
        changes, rel_loc, rel_rot, camera, train=True)[2]
    return {
        "fused_projection": (
            FP.fused_projection_op, (changes, rel_loc, rel_rot, consts),
            (FP.fused_projection_reference(changes, rel_loc, rel_rot,
                                           camera),)),
        "fused_projection_train_fwd": (
            FP.fused_projection_train_fwd_op,
            (changes, rel_loc, rel_rot, consts), (proj, abs_loc, states)),
        "fused_spatial_stack": (
            FS.fused_spatial_stack_op, (_t(rng, 6, 26, 8), spatial, 2),
            None),
        "fused_temporal_block": (
            FT.fused_temporal_block_op, (_t(rng, 3, 9, 16), temporal, 4),
            None),
        "graph_gru_scan_fwd": (
            G.graph_gru_scan_fwd_op, (gru_xg, cheb, wzr, wh),
            (G.graph_gru_scan_reference(gru_xg, cheb, wzr, wh),)),
        "graph_lstm_scan_fwd": (
            G.graph_lstm_scan_fwd_op, (lstm_xg, cheb, w),
            G.graph_lstm_scan_reference(lstm_xg, cheb, w)),
        "dense_lstm_scan_fwd": (
            G.dense_lstm_scan_fwd_op, (dense_xg, dense_w),
            G.graph_lstm_scan_reference(
                dense_xg, torch.zeros((0, 1, 1)), dense_w)),
    }


@pytest.mark.parametrize("name", OPS)
def test_op_passes_opcheck_and_runs_its_plain_version(name):
    op, args, ref = _op_cases()[name]
    assert str(op._qualname) == f"pv2c::{name}"
    torch.library.opcheck(op, args)
    out = op(*args)
    out = out if isinstance(out, tuple) else (out,)
    if name == "fused_spatial_stack":
        ref = (FS.spatial_stack_reference(*args),)
    elif name == "fused_temporal_block":
        ref = (FT.temporal_block_reference(*args),)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        _close(o, r, 1e-6 if not name.startswith("fused_projection")
               else 1e-4, name)


def test_every_registered_op_is_listed():
    """The ops this file checks are all of the ``pv2c`` namespace, and
    ``load_inference`` imports each module that registers one."""
    for module in TS.OP_MODULES:
        __import__(f"pedestrians_video_2_carla_torch.ops.{module}")
    registered = {name for name in dir(torch.ops.pv2c)
                  if isinstance(getattr(torch.ops.pv2c, name),
                                torch._ops.OpOverloadPacket)}
    assert registered == set(OPS) == set(_op_cases())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", OPS)
def test_op_cuda_kernel_matches_its_plain_version(name, cuda_device):
    """On the card each op launches its kernel (its wrapper's count goes
    up by one) and agrees with the CPU implementation (1e-3 px on the
    projections, 1e-5 of max |plain| elsewhere)."""
    op, args, _ = _op_cases()[name]
    entry = {"fused_projection": FP.fused_projection_cuda,
             "fused_projection_train_fwd": FP.fused_projection_train_cuda_fwd,
             "fused_spatial_stack": FS.fused_spatial_stack_cuda,
             "fused_temporal_block": FT.fused_temporal_block_cuda,
             "graph_gru_scan_fwd": G.graph_gru_scan_cuda_fwd,
             "graph_lstm_scan_fwd": G.graph_lstm_scan_cuda_fwd,
             "dense_lstm_scan_fwd": G.dense_lstm_scan_cuda_fwd}[name]

    def to(a):
        if isinstance(a, torch.Tensor):
            return a.to(cuda_device)
        if isinstance(a, list) and a and isinstance(a[0], torch.Tensor):
            return [t.to(cuda_device) for t in a]
        return a
    cpu = op(*args)
    before = entry.launches
    card = op(*map(to, args))
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    card = card if isinstance(card, tuple) else (card,)
    for c, g in zip(cpu, card):
        bar = 1e-3 if name.startswith("fused_projection") \
            else 1e-5 * float(c.abs().max())
        _close(g.cpu(), c, bar, name)

"""Multi-card training in the port (``parallel/``), on the CPU over gloo.

The ranks are processes started by ``parallel.launch`` (one spawn per
world layout, several checks a spawn); they import neither JAX nor the
JAX package (their functions live here, and this module imports JAX only
inside its tests). The parent test runs the JAX side and compares.

* In process: ``MeshConfig.axis_sizes``, ``batch_spec`` and
  ``param_spec`` against the JAX package's (the same leaves picked,
  through ``models/jax_import.py``), ``shard_batch``'s rows, the metric
  states' sum, the refusals (more ranks than cards, graphs over gloo).
* World 2 (data 2): one training step of LinearAEResidual (BatchNorm over
  the global batch), Seq2SeqEmbeddings, PoseFormer and GConvGRU, from the
  JAX parameters through the bridge, against the JAX single-device step
  on the whole batch (loss rel 1e-5; gradients atol 1e-4; parameters
  after the step atol 1e-5 where the gradient is not tiny against its
  leaf's largest, 2 lr elsewhere: Adam's first step is about lr * sign(g)
  and rounding can flip a tiny g's sign, as ``test_torch_training.py``
  holds it) and, tighter, the port's one-process step; GConvGRU's metrics
  against one process's; a loss whose missing-joint mask differs between
  the two halves against the JAX global loss; the resident epoch against
  per-batch sharded steps, bit for bit; a ``Trainer.fit`` on both ranks,
  ``Trainer.evaluate`` and ``Trainer.predict`` (on batches that split and
  on batches that do not) against one process's.
* World 4 (data 2 x model 2): LinearAE in ``tests/multihost_worker.py``'s
  setup (batch 16, clip 4, loc_2d, lr 1e-3), 3 steps against the JAX steps
  on a 2 x 2 mesh of four virtual devices (losses and the final parameter
  norm, rel 1e-5); its checkpoint restored into one process, and one
  process's into it; a ``Trainer.fit`` on the 2 x 2 mesh against one
  process's.
* The CLI with ``--num_devices 2 --device cpu``: two processes, one run
  directory, rank 0's ``metrics.jsonl`` alone, the one-process run's
  numbers; a rank that fails fails the run.
"""
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_torch import modeling
from pedestrians_video_2_carla_torch.data.base.hdf5_utils import save_subset
from pedestrians_video_2_carla_torch.data.base.subsets_datamodule import \
    SubsetsDataModule
from pedestrians_video_2_carla_torch.flows.autoencoder import AutoencoderFlow
from pedestrians_video_2_carla_torch.flows.base import optimizer_update
from pedestrians_video_2_carla_torch.flows.classification import \
    ClassificationFlow
from pedestrians_video_2_carla_torch.flows.output_types import \
    MovementsModelOutputType as MOT
from pedestrians_video_2_carla_torch.flows.pose_lifting import PoseLiftingFlow
from pedestrians_video_2_carla_torch.metrics.base import MetricCollection
from pedestrians_video_2_carla_torch.metrics.pose import MPJPE
from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
from pedestrians_video_2_carla_torch.models.classification import \
    CLASSIFICATION_MODELS
from pedestrians_video_2_carla_torch.models.movements import MOVEMENTS_MODELS
from pedestrians_video_2_carla_torch.parallel import (MeshConfig, launch,
                                                      make_mesh, shard_batch,
                                                      shard_state)
from pedestrians_video_2_carla_torch.parallel.mesh import (Mesh, ShardedBatch,
                                                           batch_spec,
                                                           data_shard,
                                                           param_spec)
from pedestrians_video_2_carla_torch.runtime.resident_scan import \
    build_scan_runner
from pedestrians_video_2_carla_torch.skeletons import CARLA_SKELETON
from pedestrians_video_2_carla_torch.training.checkpoint import \
    CheckpointManager
from pedestrians_video_2_carla_torch.training.trainer import (Trainer,
                                                              TrainerConfig)
from .torch_threads import limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
B, L = 4, 9
LOSS_RTOL, GRAD_ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
#: the port's world-2 step against its one-process step
TIGHT = 1e-6
#: each rank's intra-op threads: the ranks share the test's cores
RANK_THREADS = 2

#: case -> (flow, model, constructor arguments, loss mode)
CASES = {
    "LinearAEResidual": ("pose_lifting", "LinearAEResidual",
                         {"linear_size": 64}, "loc_3d"),
    "Seq2SeqEmbeddings": ("autoencoder", "Seq2SeqEmbeddings",
                          {"hidden_size": 8, "p_dropout": 0.0,
                           "single_joint_embeddings_size": 4},
                          "loc_2d"),
    "PoseFormer": ("pose_lifting", "PoseFormer",
                   {"clip_length": L, "receptive_frames": L, "depth": 1,
                    "num_heads": 2}, "loc_3d"),
    "GConvGRU": ("classification", "GConvGRU",
                 {"hidden_size": 16, "p_dropout": 0.0}, None),
}
#: leaves whose exact gradient is 0 (a bias that reaches the loss only
#: through a training-mode BatchNorm, ``test_torch_lifters.py``;
#: PoseFormer's ``weighted_mean.bias``, which feeds a shift-invariant
#: LayerNorm, ``test_torch_pose_former_training.py``): rounding on both
#: sides, each held to 1e-5 of the model's largest gradient
ZERO_GRADS = {"LinearAEResidual": {f"Dense_{i}.bias" for i in range(7)},
              "PoseFormer": {"weighted_mean.bias"}}
#: the runtime tests' draws: noise, missing joints, flips, rotations
STOCHASTIC = dict(noise="gaussian", missing_joint_probabilities=[0.1] * 26,
                  augment_flip=True, augment_rotate=True)


# -- the port's side (the ranks run only this) ---------------------------------

def port_flow(case):
    flow_name, name, sizes, loss = CASES[case]
    generator = torch.Generator().manual_seed(0)
    if flow_name == "classification":
        return ClassificationFlow(
            CLASSIFICATION_MODELS[name](generator=generator, **sizes),
            classification_optimizer=OptimizerSettings(lr=LR), device="cpu")
    if flow_name == "autoencoder":
        sizes = {**sizes, "movements_output_type": MOT.pose_2d}
    model = MOVEMENTS_MODELS[name](generator=generator, **sizes)
    for module in model.modules():   # the rates fixed in the model
        if hasattr(module, "rate"):
            module.rate = 0.0
    if hasattr(model, "P_DROPOUT"):
        model.P_DROPOUT = 0.0
    flow_cls = AutoencoderFlow if flow_name == "autoencoder" \
        else PoseLiftingFlow
    return flow_cls(model, loss_modes=[loss],
                    movements_optimizer=OptimizerSettings(lr=LR),
                    device="cpu")


def linear_ae_flow(loss="loc_2d"):
    return PoseLiftingFlow(
        MOVEMENTS_MODELS["LinearAE"](generator=torch.Generator()
                                     .manual_seed(0)),
        loss_modes=[loss], movements_optimizer=OptimizerSettings(lr=LR),
        device="cpu")


def _snapshot(state):
    """A state's parameters, gradients and running statistics, copied."""
    out = {"params": {}, "grads": {}}
    for name, tree in state.params.items():
        for k, v in tree.items():
            out["params"][f"{name}.{k}"] = v.detach().clone()
            if v.requires_grad:  # an unused leaf's gradient is 0
                out["grads"][f"{name}.{k}"] = torch.zeros_like(v) \
                    if v.grad is None else v.grad.clone()
    return out


def one_step(flow, params, batch, mesh=None):
    """The training step of ``flow`` from ``params`` on ``batch`` (this
    rank's rows of it under ``mesh``): its loss, the gradients it took and
    the parameters after it."""
    state = flow.init_state(params)
    shard_state(mesh, state)
    logs = flow.backward_step(state, shard_batch(mesh, batch))
    grads = _snapshot(state)["grads"]
    optimizer_update(state, logs["train_loss/primary"])
    return {"loss": float(logs["train_loss/primary"]), "grads": grads,
            "params": _snapshot(state)["params"]}


def eval_metrics(flow, params, batch, mesh=None):
    """The eval step's losses and the flow's metrics of ``batch``, this
    rank's rows summed over ``data`` under ``mesh``."""
    local = shard_batch(mesh, batch)
    losses, preds, targets = flow.eval_step(params, local)
    collection = flow.metrics
    mstate = collection.update(collection.init_state("cpu"), preds, targets)
    if mesh is not None:
        mstate = collection.all_reduce(mstate, mesh.data_group)
    computed = collection.compute(mstate)
    return {k: float(v) for k, v in losses.items()}, {
        k: v.numpy() if isinstance(v, torch.Tensor) else v
        for k, v in computed.items() if not isinstance(v, dict)}


def subsets_dm(root, **kwargs):
    dm = SubsetsDataModule(subsets_dir=root, batch_size=4, clip_length=4,
                           data_nodes=CARLA_SKELETON, device="cpu",
                           **kwargs)
    dm.prepare_data()
    dm.setup("fit")
    return dm


def resident_flow():
    return PoseLiftingFlow(
        MOVEMENTS_MODELS["LinearAE"](generator=torch.Generator()
                                     .manual_seed(0)),
        loss_modes=["loc_2d_3d"], projection_kernel="fused_train",
        movements_optimizer=OptimizerSettings(lr=LR), device="cpu")


def fit_records(root, run, resident):
    """A 2-epoch ``Trainer.fit`` of :func:`resident_flow` on the subsets
    under ``root``; its ``metrics.jsonl`` without the clock's entries (None
    on a rank that writes none) and its parameters."""
    dm = subsets_dm(os.path.join(root, "subsets"), device_resident=resident,
                    **STOCHASTIC)
    trainer = Trainer(resident_flow(), dm, TrainerConfig(
        max_epochs=2, log_every_n_steps=1, seed=3,
        logs_dir=os.path.join(root, "logs"), run_name=run, device="cpu"))
    trainer.fit()
    assert (trainer.runner is not None) == resident
    path = os.path.join(root, "logs", run, "metrics.jsonl")
    records = None
    if trainer.is_main_process:
        with open(path) as f:
            records = [{k: v for k, v in json.loads(line).items()
                        if k not in ("time", "epoch_time_s")} for line in f]
    return records, _snapshot(trainer.state)["params"]


def resident_against_per_batch(root, mesh):
    """The runner over this rank's rows against per-batch
    ``training_step`` on the same sharded batches: whether the
    parameters, running statistics and logs are the same bits."""
    dm = subsets_dm(os.path.join(root, "subsets"), device_resident=True,
                    **STOCHASTIC)
    flow_a, flow_b = resident_flow(), resident_flow()
    state_a = flow_a.init_state()
    logs_a = [flow_a.training_step(state_a, shard_batch(mesh, b))[1]
              for b in dm.train_batches(3)]
    spec = dm.resident_scan_inputs("train", True, True, seed=3)
    runner = build_scan_runner(flow_b, spec, mesh=mesh)
    state_b, logs_b = flow_b.init_state(), []
    for b0 in range(0, spec.num_batches, 2):
        k = min(2, spec.num_batches - b0)
        state_b, stacked, _ = runner(state_b, b0, k)
        logs_b += [{key: v[j] for key, v in stacked.items()}
                   for j in range(k)]
    same = not runner.graphs and len(logs_a) == len(logs_b) == 5 and all(
        set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(logs_a, logs_b)) and all(
        torch.equal(v, state_b.params[name][k])
        for name, tree in state_a.params.items() for k, v in tree.items())
    return same


def carla_dm(batch_size, sets):
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    return Carla2D3DDataModule(batch_size=batch_size, clip_length=4,
                               val_set_size=sets, test_set_size=sets,
                               device="cpu")


def evaluate_and_predict(root, run):
    """``Trainer.evaluate`` and ``Trainer.predict`` of LinearAE's seeded
    init on Carla2D3D sets of batches that split over two ranks (B=4)
    and of batches that do not (B=3, run whole by every rank)."""
    out = {}
    for batch_size, sets in ((4, 8), (3, 9)):
        trainer = Trainer(linear_ae_flow("loc_2d_3d"),
                          carla_dm(batch_size, sets), TrainerConfig(
                              logs_dir=os.path.join(root, "logs"),
                              run_name=f"{run}-{batch_size}", device="cpu"))
        out[batch_size] = (trainer.evaluate("val"), trainer.predict("test"))
    return out


def _rank_setup():
    """A rank shares the test's cores, and its TensorBoard writer runs
    without TensorFlow, as on the card's machine (importing TensorFlow
    takes seconds here)."""
    torch.set_num_threads(RANK_THREADS)
    sys.modules.setdefault("tensorflow", None)


def rank_world2(root):
    """World 2, data 2: every check of the layout (module docstring)."""
    _rank_setup()
    mesh = make_mesh(MeshConfig())
    assert mesh.shape == {"data": 2, "model": 1}
    inputs = torch.load(os.path.join(root, "inputs2.pt"), weights_only=False)
    out = {"steps": {}}
    for case, (params, batch) in inputs["cases"].items():
        flow = port_flow(case)
        out["steps"][case] = one_step(flow, params, batch, mesh)
        if case == "GConvGRU":
            out["metrics"] = eval_metrics(flow, params, batch, mesh)
    params, batch = inputs["masked"]
    flow = linear_ae_flow()
    out["masked"] = {"train": one_step(flow, params, batch, mesh)["loss"],
                     "eval": eval_metrics(flow, params, batch, mesh)[0]}
    out["resident_same"] = resident_against_per_batch(root, mesh)
    out["fit"] = {run: fit_records(root, run, resident)
                  for run, resident in (("s2", False), ("r2", True))}
    out["evaluate_predict"] = evaluate_and_predict(root, "e2")
    torch.save(out, os.path.join(root, f"out2_{mesh.rank}.pt"))


def tp_steps(flow, state, batch, mesh, n):
    losses = []
    for _ in range(n):
        _, logs = flow.training_step(state, shard_batch(mesh, batch))
        losses.append(float(logs["train_loss/primary"]))
    return losses


def param_norm(state) -> float:
    return float(torch.sqrt(sum((v.detach().double() ** 2).sum()
                                for tree in state.params.values()
                                for v in tree.values() if v.requires_grad)))


def fit_2x2(root, run):
    """A 2-epoch ``Trainer.fit`` of LinearAE (2 steps an epoch, a
    validation pass each); its ``metrics.jsonl`` without the clock's
    entries (None on a rank that writes none) and its parameters."""
    trainer = Trainer(linear_ae_flow("loc_2d_3d"), carla_dm(8, 8),
                      TrainerConfig(max_epochs=2, limit_train_batches=2,
                                    log_every_n_steps=1,
                                    logs_dir=os.path.join(root, "logs"),
                                    run_name=run, device="cpu",
                                    mesh=MeshConfig(model_axis_size=2)
                                    if run == "fit4" else MeshConfig()))
    trainer.fit()
    records = None
    if trainer.is_main_process:
        with open(os.path.join(root, "logs", run, "metrics.jsonl")) as f:
            records = [{k: v for k, v in json.loads(line).items()
                        if k not in ("time", "epoch_time_s")} for line in f]
    return records, _snapshot(trainer.state)["params"]


def rank_world4(root):
    """World 4, data 2 x model 2: LinearAE's steps, its checkpoint, and a
    one-process checkpoint restored into the layout."""
    _rank_setup()
    mesh = make_mesh(MeshConfig(data_axis_size=2, model_axis_size=2))
    inputs = torch.load(os.path.join(root, "inputs4.pt"), weights_only=False)
    params, batch = inputs["params"], inputs["batch"]
    flow = linear_ae_flow()
    state = shard_state(mesh, flow.init_state(params))
    sharded = sorted(name for name, *_ in state.sharding.entries)
    losses = tp_steps(flow, state, batch, mesh, 3)
    norm = param_norm(state)
    manager = CheckpointManager(os.path.join(root, "ckpt4"),
                                enabled=mesh.is_main)
    manager.save(state, {"val_loss/primary": losses[-1]}, step=3)
    at3 = _snapshot(state)["params"]
    tp_steps(flow, state, batch, mesh, 1)
    at4 = _snapshot(state)["params"]
    # the other way: a one-process archive into the 2 x 2 layout
    other = shard_state(mesh, flow.init_state(params))
    CheckpointManager(os.path.join(root, "ckpt1"), enabled=False).restore(
        other, os.path.join(root, "ckpt1", "last"))
    tp_steps(flow, other, batch, mesh, 1)
    fit = fit_2x2(root, "fit4")
    if mesh.is_main:
        torch.save({"sharded": sharded, "losses": losses, "norm": norm,
                    "fit": fit,
                    "at3": at3, "at4": at4,
                    "from_one": _snapshot(other)["params"],
                    "moment_shapes": [
                        tuple(other.optimizer.state[part]["exp_avg"].shape)
                        for _, _, part, _ in other.sharding.entries]},
                   os.path.join(root, "out4.pt"))


def fail_on_rank_one():
    """Rank 1 raises; rank 0 would wait far longer than the test runs
    (spawn stops it when rank 1 fails)."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(600)


# -- the JAX side and the comparisons ------------------------------------------

def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.numpy()


def _carla_batch(batch_size, clip_length, seed):
    """A Carla2D3D training batch (the port's generator), as numpy."""
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    dm = Carla2D3DDataModule(batch_size=batch_size, clip_length=clip_length,
                             device="cpu")
    return _numpy(next(iter(dm.train_batches(seed))))


def _jax_batch(case):
    """Seeded numpy inputs (BatchNorm's fast variance loses digits on the
    normalised Carla inputs in both packages, F9); Carla2D3D's targets, or
    labels for the classifier."""
    rng = np.random.default_rng(11)
    inputs = rng.standard_normal((B, L, 26, 2)).astype(np.float32)
    if CASES[case][0] == "classification":
        return inputs, {"crossing": np.array([0, 1, 1, 0], np.int32)}, {}
    _, targets, meta = _carla_batch(B, L, 3)
    return inputs, targets, meta


def _jax_flow(case):
    from pedestrians_video_2_carla_tpu.flows.autoencoder import \
        AutoencoderFlow as JAutoencoderFlow
    from pedestrians_video_2_carla_tpu.flows.classification import \
        ClassificationFlow as JClassificationFlow
    from pedestrians_video_2_carla_tpu.flows.output_types import \
        MovementsModelOutputType as JMOT
    from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
        PoseLiftingFlow as JPoseLiftingFlow
    from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
    from pedestrians_video_2_carla_tpu.models.base import \
        OptimizerSettings as JOptimizerSettings
    from pedestrians_video_2_carla_tpu.models.classification import \
        CLASSIFICATION_MODELS as JC
    from pedestrians_video_2_carla_tpu.models.movements import \
        MOVEMENTS_MODELS as JM
    flow_name, name, sizes, loss = CASES[case]
    if flow_name == "classification":
        return JClassificationFlow(
            classification_model=JC[name](**sizes),
            classification_optimizer=JOptimizerSettings(lr=LR))
    if flow_name == "autoencoder":
        sizes = {**sizes, "movements_output_type": JMOT.pose_2d}
    flow_cls = JAutoencoderFlow if flow_name == "autoencoder" \
        else JPoseLiftingFlow
    return flow_cls(movements_model=JM[name](**sizes),
                    loss_modes=[JLossModes[loss or "loc_2d"]],
                    movements_optimizer=JOptimizerSettings(lr=LR))


def _jax_init(flow, batch):
    """The JAX flow's initial state on ``batch`` (its ``init_state``,
    jitted)."""
    import jax
    return jax.jit(flow.init_state)(jax.random.PRNGKey(1), batch)


def _jax_step(flow, state, batch, classification=False):
    """The body of the JAX flow's ``training_step`` from ``state``, jitted:
    the loss, the gradients, the new parameters and mutables."""
    import jax
    import optax
    from pedestrians_video_2_carla_tpu.losses import primary_loss

    @jax.jit
    def run(state):
        rngs = {"dropout": jax.random.PRNGKey(2)}

        def loss_fn(params):
            if classification:
                logits, _ = flow._apply(params, state.mutables, batch[0],
                                        True, rngs)
                return flow._loss(logits, batch[1]), state.mutables
            sliced, new = flow._inner_step(params, state.mutables, batch,
                                           training=True, rngs=rngs)
            losses = flow._compute_losses(sliced, sliced["targets"])
            return primary_loss(losses, flow.requested_loss_modes)[1], new
        (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        updates, _ = flow._tx.update(grads, state.opt_state, state.params,
                                     value=loss)
        return {"loss": loss, "grads": grads,
                "new_params": optax.apply_updates(state.params, updates),
                "new_mutables": new}
    return jax.device_get(run(state))


def _launching(fn, world_size, root):
    """``launch`` of ``fn(root)`` on a thread, so that the parent's JAX
    compiles run beside the ranks; ``.result()`` waits for them."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1)
    future = pool.submit(launch, fn, world_size, (root,), device="cpu",
                         init_method="file://" + os.path.join(root, "store"))
    pool.shutdown(wait=False)
    return future


def _bridge(tree, mutables=None):
    from pedestrians_video_2_carla_torch.models.jax_import import \
        import_flow_params
    out = import_flow_params(tree, device="cpu", mutables=mutables)
    return {f"{name}.{k}": v for name, t in out.items()
            for k, v in t.items()}


def _write_subsets(root, n=20):
    rng = np.random.default_rng(22742)
    proj = rng.normal(size=(n, 4, 26, 2)).astype(np.float32) + 300
    targets = {"absolute_pose_loc":
               rng.normal(size=(n, 4, 26, 3)).astype(np.float32),
               "bboxes": rng.uniform(0, 600, (n, 4, 2, 2)).astype(np.float32)}
    meta = {"age": ["adult"] * n, "gender": ["female"] * n,
            "clip_width": np.full(n, 800, np.int32),
            "clip_height": np.full(n, 600, np.int32)}
    os.makedirs(os.path.join(root, "subsets"), exist_ok=True)
    for name in ("train", "val"):
        save_subset(os.path.join(root, "subsets", f"{name}.hdf5"), proj,
                    targets, meta)


def _masked_batch():
    """LinearAE's loc_2d batch whose first half misses joints (zeros in
    the targets) and whose second half misses none."""
    batch = _carla_batch(B, 4, 5)
    targets = dict(batch[1])
    for key in ("projection_2d", "projection_2d_transformed"):
        t = np.array(targets[key])
        t[0, :, 3:9] = 0.0
        t[1, 1:, 12:20] = 0.0
        targets[key] = t
    return batch[0], targets, batch[2]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The ranks' outputs beside the JAX references: the JAX flows'
    initial states go to the ranks through the bridge, and the JAX steps
    compile while the ranks run."""
    import flax.linen as fnn
    from pedestrians_video_2_carla_torch.models.jax_import import \
        import_flow_params
    root = str(tmp_path_factory.mktemp("world2"))
    flows, states, cases = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        # flax's nn.Dropout as the identity (LinearAEResidual's fixed 0.5)
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, inputs, *args, **kwargs: inputs)
        for case in CASES:
            batch = _jax_batch(case)
            flows[case] = _jax_flow(case)
            states[case] = _jax_init(flows[case], batch)
            cases[case] = (import_flow_params(
                states[case].params, device="cpu",
                mutables=states[case].mutables), _to_torch(batch))
        masked = (linear_ae_flow().init_params(), _to_torch(_masked_batch()))
        _write_subsets(root)
        torch.save({"cases": cases, "masked": masked},
                   os.path.join(root, "inputs2.pt"))
        ranks = _launching(rank_world2, 2, root)
        refs = {case: _jax_step(flows[case], states[case],
                                _numpy(cases[case][1]),
                                CASES[case][0] == "classification")
                for case in CASES}
        for case in CASES:
            refs[case]["mutables"] = states[case].mutables
        ranks.result()
    outs = [torch.load(os.path.join(root, f"out2_{r}.pt"),
                       weights_only=False) for r in range(2)]
    return root, refs, cases, outs


def _assert_step_close(got, ref_loss, ref_grads, ref_new, case, loss_rtol,
                       grad_atol, param_atol):
    np.testing.assert_allclose(got["loss"], float(ref_loss), rtol=loss_rtol)
    grads = {k: v.numpy() for k, v in got["grads"].items()}
    assert set(grads) == set(ref_grads), sorted(set(grads) ^ set(ref_grads))
    top = max(float(np.abs(g).max()) for g in ref_grads.values())
    for k, g_ref in ref_grads.items():
        g_ref = np.asarray(g_ref)
        if k.split(".", 1)[1] in ZERO_GRADS.get(case, ()):
            assert max(np.abs(grads[k]).max(), np.abs(g_ref).max()) \
                <= 1e-5 * top, k
            continue
        np.testing.assert_allclose(grads[k], g_ref, rtol=0, atol=grad_atol,
                                   err_msg=k)
        diff = np.abs(got["params"][k].numpy() - np.asarray(ref_new[k]))
        big = np.abs(g_ref) > 1e-3 * np.abs(g_ref).max()
        assert diff[big].max(initial=0.0) <= param_atol, k
        assert diff[~big].max(initial=0.0) <= 2 * LR + 1e-6, k


@pytest.mark.parametrize("case", list(CASES))
def test_data_parallel_step_matches_the_jax_single_device_step(world2, case):
    _, refs, cases, outs = world2
    ref = refs[case]
    got = outs[0]["steps"][case]
    _assert_step_close(
        got, ref["loss"], {k: v.numpy() for k, v in
                           _bridge(ref["grads"]).items()},
        {k: v.numpy() for k, v in _bridge(ref["new_params"]).items()},
        case, LOSS_RTOL, GRAD_ATOL, PARAM_ATOL)
    # and the port's own one-process step, tighter
    one = one_step(port_flow(case), *cases[case])
    _assert_step_close(got, one["loss"],
                       {k: v.numpy() for k, v in one["grads"].items()},
                       {k: v.numpy() for k, v in one["params"].items()},
                       case, TIGHT, TIGHT * 10, TIGHT * 10)
    # both ranks end with the same parameters and running statistics
    other = outs[1]["steps"][case]["params"]
    assert all(torch.equal(v, other[k]) for k, v in got["params"].items())


def test_batch_norm_running_statistics_are_the_global_batch_s(world2):
    _, refs, _, outs = world2
    ref = refs["LinearAEResidual"]
    from pedestrians_video_2_carla_torch.models.jax_import import \
        batch_stats_to_state_dict
    stats = batch_stats_to_state_dict(
        ref["new_mutables"]["movements"]["batch_stats"])
    assert stats
    for rank in range(2):
        got = outs[rank]["steps"]["LinearAEResidual"]["params"]
        for k, v in stats.items():
            np.testing.assert_allclose(got[f"movements.{k}"].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_classification_metrics_equal_one_device_s(world2):
    _, _, cases, outs = world2
    losses, metrics = outs[0]["metrics"]
    one_losses, one_metrics = eval_metrics(port_flow("GConvGRU"),
                                           *cases["GConvGRU"])
    assert set(metrics) == set(one_metrics) and "ConfusionMatrix" in metrics
    for k, v in one_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert outs[1]["metrics"][1].keys() == metrics.keys()
    for k, v in one_losses.items():
        np.testing.assert_allclose(losses[k], v, rtol=LOSS_RTOL)


def test_loss_with_differing_masks_is_the_global_loss(world2):
    """The two halves miss different joints: the ranks' loss is the JAX
    package's ``loss_loc_2d`` of the whole batch's outputs, which divides
    by the global count of valid joints (the mean of the halves' own
    losses would not)."""
    import jax.numpy as jnp
    from pedestrians_video_2_carla_tpu.losses import LossContext, loss_loc_2d
    from pedestrians_video_2_carla_tpu.skeletons.carla import \
        CARLA_SKELETON as J_CARLA
    _, _, _, outs = world2
    flow = linear_ae_flow()
    params, batch = flow.init_params(), _to_torch(_masked_batch())
    _, preds, targets = flow.eval_step(params, batch)
    key = "projection_2d_transformed"
    # (the hips sit at 0 in every row after the hips-neck transform)
    assert int((targets[key][:2] == 0).sum()) \
        > 2 * int((targets[key][2:] == 0).sum())
    ref = float(loss_loc_2d(LossContext(
        input_nodes=J_CARLA, output_nodes=J_CARLA,
        sliced={key: jnp.asarray(preds[key].numpy())},
        targets={key: jnp.asarray(targets[key].numpy())})))
    for rank in range(2):
        np.testing.assert_allclose(outs[rank]["masked"]["train"], ref,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(outs[rank]["masked"]["eval"]["loc_2d"],
                                   ref, rtol=LOSS_RTOL)
    halves = [flow.eval_step(
        params, tuple(_map_rows(x, rows) for x in batch))[0]["loc_2d"]
        for rows in (slice(0, 2), slice(2, 4))]
    assert abs(float(sum(halves)) / 2 - ref) > 100 * LOSS_RTOL * ref


def _map_rows(tree, rows):
    if isinstance(tree, dict):
        return {k: _map_rows(v, rows) for k, v in tree.items()}
    return tree[rows]


def test_resident_epoch_equals_per_batch_sharded_steps(world2):
    _, _, _, outs = world2
    assert outs[0]["resident_same"] and outs[1]["resident_same"]


def test_evaluate_and_predict_on_two_ranks_equal_one_process_s(world2):
    """Evaluation (losses and metric states summed over ``data``) and
    prediction (the rows gathered back in order), on batches that split
    and on batches that every rank runs whole (their metrics counted
    once), against one process."""
    root, _, _, outs = world2
    one = evaluate_and_predict(root, "e1")
    for batch_size, (metrics, preds) in one.items():
        for rank in range(2):
            got_metrics, got_preds = outs[rank]["evaluate_predict"][
                batch_size]
            assert set(got_metrics) == set(metrics)
            assert "val_MPJPE" in metrics
            for k, v in metrics.items():
                np.testing.assert_allclose(got_metrics[k], v, rtol=1e-5,
                                           atol=1e-7, err_msg=k)
            assert len(got_preds) == len(preds)
            for (gp, gt, gm), (p, t, m) in zip(got_preds, preds):
                assert gp.keys() == p.keys() and gt.keys() == t.keys()
                for a, b in [(gp[k], p[k]) for k in p] + [
                        (gt[k], t[k]) for k in t] + [
                        (gm[k], m[k]) for k in m]:
                    if b is None:
                        assert a is None
                    else:
                        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_fit_on_two_ranks_equals_one_process_fit(world2):
    """Streamed and resident fits on two ranks (the same bits), against a
    streamed fit in one process; rank 0 alone writes ``metrics.jsonl``."""
    root, _, _, outs = world2
    (s2, s2_params), (r2, r2_params) = (outs[0]["fit"][run]
                                        for run in ("s2", "r2"))
    assert outs[1]["fit"]["s2"][0] is None
    assert r2 == s2
    assert all(torch.equal(v, r2_params[k]) for k, v in s2_params.items())
    steps = [r["step"] for r in s2 if "lr-movements" in r]
    assert steps == list(range(1, 11))
    s1, s1_params = fit_records(root, "s1", False)
    assert [set(r) for r in s1] == [set(r) for r in s2]
    for a, b in zip(s1, s2):
        for k, v in a.items():
            if isinstance(v, float):
                np.testing.assert_allclose(b[k], v, rtol=1e-4, atol=1e-7,
                                           err_msg=k)
    for k, v in s1_params.items():
        np.testing.assert_allclose(s2_params[k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)


# -- world 4: data 2 x model 2 -----------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The JAX steps on a 2 x 2 mesh of four virtual devices
    (``tests/multihost_worker.py``'s setup), compiled while the ranks run;
    the ranks' outputs and the one-process checkpoint they restored."""
    import jax
    from pedestrians_video_2_carla_tpu.flows.pose_lifting import \
        PoseLiftingFlow as JPoseLiftingFlow
    from pedestrians_video_2_carla_tpu.losses import LossModes as JLossModes
    from pedestrians_video_2_carla_tpu.models.base import \
        OptimizerSettings as JOptimizerSettings
    from pedestrians_video_2_carla_tpu.models.movements import \
        MOVEMENTS_MODELS as JM
    from pedestrians_video_2_carla_tpu.parallel import mesh as JP
    from pedestrians_video_2_carla_torch.models.jax_import import \
        import_flow_params
    root = str(tmp_path_factory.mktemp("world4"))
    batch = _carla_batch(16, 4, 0)
    flow = JPoseLiftingFlow(movements_model=JM["LinearAE"](),
                            loss_modes=[JLossModes.loc_2d],
                            movements_optimizer=JOptimizerSettings(lr=LR))
    state = _jax_init(flow, batch)
    params, t_batch = import_flow_params(jax.device_get(state.params),
                                         device="cpu"), _to_torch(batch)
    # a one-process archive after one step, for the ranks to restore
    one = linear_ae_flow()
    one_state = one.init_state(params)
    one.training_step(one_state, t_batch)
    CheckpointManager(os.path.join(root, "ckpt1")).save(one_state, {}, 1)
    torch.save({"params": params, "batch": t_batch},
               os.path.join(root, "inputs4.pt"))
    ranks = _launching(rank_world4, 4, root)
    mesh = JP.make_mesh(JP.MeshConfig(data_axis_size=2, model_axis_size=2),
                        devices=jax.devices()[:4])
    with mesh:
        shardings = JP.state_shardings(mesh, state)
        state = JP.shard_state(mesh, state)
        step = jax.jit(
            lambda s, b, rng: flow.training_step(
                s, JP.constrain_batch(mesh, b), rng),
            in_shardings=(shardings, None, None),
            out_shardings=(shardings, None))
        j_losses = []
        for i in range(3):
            state, logs = step(state, JP.shard_batch(mesh, batch),
                               jax.random.PRNGKey(2 + i))
            j_losses.append(float(logs["train_loss/primary"]))
        j_norm = float(np.sqrt(sum(
            (np.asarray(x, np.float64) ** 2).sum()
            for x in jax.tree_util.tree_leaves(jax.device_get(
                state.params)))))
    ranks.result()
    out = torch.load(os.path.join(root, "out4.pt"), weights_only=False)
    return root, params, t_batch, j_losses, j_norm, out


def test_tensor_parallel_steps_match_the_jax_2x2_mesh(world4):
    _, _, _, j_losses, j_norm, out = world4
    assert out["sharded"] == ["movements.Dense_5.weight"]
    np.testing.assert_allclose(out["losses"], j_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["norm"], j_norm, rtol=LOSS_RTOL)


def test_a_world4_checkpoint_restores_into_one_process(world4):
    """Rank 0's archive of the 2 x 2 run holds the whole state: restored
    into one process, the parameters are the layout's, and the next step
    from it is the layout's next step."""
    root, params, batch, _, _, out = world4
    flow = linear_ae_flow()
    state = flow.init_state(params)
    CheckpointManager(os.path.join(root, "ckpt4")).restore(
        state, os.path.join(root, "ckpt4", "last"))
    assert state.step == 3 and state.sharding is None
    got = _snapshot(state)["params"]
    assert all(torch.equal(v, got[k]) for k, v in out["at3"].items())
    weight = state.params["movements"]["Dense_5.weight"]
    assert state.optimizer.state[weight]["exp_avg"].shape == weight.shape
    flow.training_step(state, batch)
    for k, v in _snapshot(state)["params"].items():
        np.testing.assert_allclose(v.numpy(), out["at4"][k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_trainer_fit_on_a_2x2_mesh_equals_one_process_fit(world4):
    """``Trainer.fit`` with ``MeshConfig(model_axis_size=2)`` in the group
    of four: the step and epoch records and the parameters of a fit in
    one process."""
    root, _, _, _, _, out = world4
    records, params = out["fit"]
    one_records, one_params = fit_2x2(root, "fit1")
    assert [r["step"] for r in records] == [r["step"] for r in one_records]
    assert [set(r) for r in records] == [set(r) for r in one_records]
    for a, b in zip(one_records, records):
        for k, v in a.items():
            if isinstance(v, float):
                np.testing.assert_allclose(b[k], v, rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    for k, v in one_params.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)


def test_a_one_process_checkpoint_restores_into_world4(world4):
    """The other way: a one-process archive (after one step) restored into
    the 2 x 2 layout, whose slices then hold their part of each moment;
    the next step is one process's."""
    root, params, batch, _, _, out = world4
    whole = tuple(params["movements"]["Dense_5.weight"].shape)
    assert out["moment_shapes"] == [(whole[0] // 2, whole[1])]
    flow = linear_ae_flow()
    state = flow.init_state(params)
    CheckpointManager(os.path.join(root, "ckpt1")).restore(
        state, os.path.join(root, "ckpt1", "last"))
    flow.training_step(state, batch)
    for k, v in _snapshot(state)["params"].items():
        np.testing.assert_allclose(v.numpy(), out["from_one"][k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


# -- in process ----------------------------------------------------------------

def _fake_mesh(data, model=1, rank=0, backend="gloo"):
    return Mesh(data, model, rank, None, None, backend)


@pytest.mark.parametrize("sizes", [(None, 1), (None, 2), (2, 2), (4, 1),
                                   (2, 4)])
def test_mesh_config_axis_sizes_match_jax(sizes):
    from pedestrians_video_2_carla_tpu.parallel import mesh as JP
    data, model = sizes
    for n in (1, 4, 8):
        assert MeshConfig(data, model).axis_sizes(n) \
            == JP.MeshConfig(data, model).axis_sizes(n)


def test_batch_spec_and_shard_batch_follow_jax():
    import jax
    from jax.sharding import PartitionSpec as P
    from pedestrians_video_2_carla_tpu.parallel import mesh as JP
    j_mesh = JP.make_mesh(JP.MeshConfig(data_axis_size=2),
                          devices=jax.devices()[:2])
    mesh = _fake_mesh(2, rank=1)
    leaves = [np.zeros((4, 3)), np.zeros((3, 2)), np.zeros(()),
              np.zeros((6,)), np.float32(1.0)]
    for x in leaves:
        want = JP.batch_spec(j_mesh, x)
        assert batch_spec(mesh, x) == ("data" if want == P("data")
                                       else None), x
    batch = (torch.arange(8.0).reshape(4, 2),
             {"y": torch.arange(4), "table": torch.zeros(3, 2)},
             {"ids": np.arange(4), "name": ["a", "b", "c", "d"]})
    local = shard_batch(mesh, batch)
    assert isinstance(local, ShardedBatch) and data_shard(local).rows == 2
    assert torch.equal(local[0], batch[0][2:])
    assert torch.equal(local[1]["y"], batch[1]["y"][2:])
    assert local[1]["table"] is batch[1]["table"]        # not batch rows
    assert list(local[2]["ids"]) == [2, 3]
    assert local[2]["name"] == batch[2]["name"]
    odd = (torch.zeros(3, 2), {}, {})
    assert shard_batch(mesh, odd) is odd                 # replicated
    assert shard_batch(None, batch) is batch


#: case -> (registry, model, constructor arguments)
SPEC_CASES = {
    "LinearAE": ("movements", "LinearAE", {}),
    "PoseFormer": ("movements", "PoseFormer",
                   {"clip_length": L, "receptive_frames": L, "depth": 1,
                    "num_heads": 2}),
    "SimpleTransformer": ("movements", "SimpleTransformer",
                          {"num_layers": 1}),
    "Seq2SeqEmbeddings": ("movements", "Seq2SeqEmbeddings",
                          {"hidden_size": 64}),
    "GConvGRU": ("classification", "GConvGRU", {"hidden_size": 128}),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_param_spec_picks_the_jax_leaves(case):
    """The JAX ``param_spec`` at model 2 marks the leaves it shards; the
    bridge carries the marks to the port's names, where the port's rule
    must pick exactly those."""
    import jax
    from jax.sharding import PartitionSpec as P
    from pedestrians_video_2_carla_tpu.models.classification import \
        CLASSIFICATION_MODELS as JC
    from pedestrians_video_2_carla_tpu.models.movements import \
        MOVEMENTS_MODELS as JM
    from pedestrians_video_2_carla_tpu.parallel import mesh as JP
    from pedestrians_video_2_carla_torch.models.jax_import import \
        import_flow_params
    kind, name, sizes = SPEC_CASES[case]
    j_model = (JM if kind == "movements" else JC)[name](**sizes)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: j_model.init(
        {"params": k, "dropout": k}, np.zeros((2, L, 26, 2), np.float32),
        training=False), key)["params"]
    marks = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float(JP.param_spec(
            np.zeros(x.shape, np.float32), 2) == P(None, "model")),
            np.float32), shapes)
    bridged = import_flow_params({kind: marks}, device="cpu")[kind]
    want = {k for k, v in bridged.items() if float(v.max()) == 1.0}
    model = (MOVEMENTS_MODELS if kind == "movements"
             else CLASSIFICATION_MODELS)[name](**sizes)
    got = {k for k, v in model.state_dict().items()
           if param_spec(k, v, 2) is not None}
    assert got == want
    if case == "LinearAE":
        assert got == {"Dense_5.weight"}
    assert got or case == "PoseFormer"
    assert not {k for k, v in model.state_dict().items()
                if param_spec(k, v, 1) is not None}


def test_metric_states_sum_to_the_global_state():
    """Per-shard metric states summed (``tree_sum``, the host side of the
    all-reduce) give the global value (``test_parallel.py``'s check)."""
    m = MetricCollection({"MPJPE": MPJPE()})
    gt = torch.zeros(8, 3, 26, 3)
    pred = gt + 0.002
    whole = m.update(m.init_state("cpu"), {"absolute_pose_loc": pred},
                     {"absolute_pose_loc": gt})
    parts = [m.update(m.init_state("cpu"),
                      {"absolute_pose_loc": pred[2 * i:2 * i + 2]},
                      {"absolute_pose_loc": gt[2 * i:2 * i + 2]})
             for i in range(4)]
    np.testing.assert_allclose(float(m.compute(m.tree_sum(parts))["MPJPE"]),
                               float(m.compute(whole)["MPJPE"]), rtol=1e-6)


def test_more_ranks_than_cards_raise(tmp_path):
    """Asking for cards that are not there raises before any process
    starts, from the launcher and from the CLI; a CUDA run never goes
    quietly to the CPU or to gloo."""
    with pytest.raises(RuntimeError, match="NCCL|card"):
        launch(fail_on_rank_one, 2, device="cuda")
    with pytest.raises(RuntimeError, match="NCCL|card"):
        modeling.main(["--num_devices", "2", f"--root_dir={tmp_path}",
                       "--run_name=r"])
    assert not os.path.exists(tmp_path / "logs" / "pose_lifting" / "r")


def test_gloo_groups_take_the_eager_resident_route(tmp_path):
    _write_subsets(str(tmp_path))
    dm = subsets_dm(str(tmp_path / "subsets"), device_resident=True)
    spec = dm.resident_scan_inputs("train", True, True)
    with pytest.raises(ValueError, match="gloo"):
        build_scan_runner(resident_flow(), spec, graphs=True,
                          mesh=_fake_mesh(2))
    assert not build_scan_runner(resident_flow(), spec,
                                 mesh=_fake_mesh(2)).graphs


def test_a_failed_rank_fails_the_run(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        launch(fail_on_rank_one, 2, device="cpu",
               init_method=f"file://{tmp_path}/store")


CLI = ["--flow=pose_lifting", "--movements_model_name=LinearAE",
       "--batch_size=4", "--clip_length=4", "--max_epochs=1",
       "--limit_train_batches=3", "--val_set_size=8",
       "--log_every_n_steps=1", "--loss_modes", "loc_2d_3d",
       "--device", "cpu"]


def test_cli_trains_on_two_processes_as_on_one(tmp_path):
    """``--num_devices 2 --device cpu`` spawns two ranks that draw one run
    name; rank 0 alone writes the run's files, and its numbers are the
    one-process run's."""
    # its processes' TensorBoard writer without TensorFlow, as on the
    # card's machine (a package that refuses to import stands first)
    no_tf = tmp_path / "no_tf"
    (no_tf / "tensorflow").mkdir(parents=True)
    (no_tf / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('no TensorFlow for the ranks')\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pedestrians_video_2_carla_torch", *CLI,
         "--num_devices", "2", f"--root_dir={tmp_path / 'two'}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": f"{no_tf}{os.pathsep}{REPO}",
             "OMP_NUM_THREADS": str(RANK_THREADS)})
    # the one-process run beside it
    results = modeling.main([*CLI, "--num_devices", "1",
                             f"--root_dir={tmp_path / 'one'}",
                             "--run_name=one"])
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    runs = glob.glob(str(tmp_path / "two" / "logs" / "pose_lifting" / "*"))
    assert len(runs) == 1, runs
    assert os.path.basename(runs[0]).startswith("Carla2D3D-")
    with open(os.path.join(runs[0], "metrics.jsonl")) as f:
        two = [json.loads(line) for line in f]
    assert [r["step"] for r in two] == [1, 2, 3, 3]
    assert os.path.exists(os.path.join(runs[0], "checkpoints", "last.pt"))
    assert stdout.count("| model      | params") == 1
    assert results["trainer"].mesh is None
    with open(tmp_path / "one" / "logs" / "pose_lifting" / "one"
              / "metrics.jsonl") as f:
        one = [json.loads(line) for line in f]
    assert [set(r) for r in one] == [set(r) for r in two]
    for a, b in zip(one, two):
        for k, v in a.items():
            if isinstance(v, float) and k not in ("time", "epoch_time_s"):
                np.testing.assert_allclose(b[k], v, rtol=1e-4, err_msg=k)

"""The port's runtime on the CPU, beside ``tests/test_runtime.py``: the
native binary cache (against numpy and against the JAX package's cache
files, both ways), the prefetcher, the datamodule's native gather,
device-resident subsets (bit for bit the streamed batches, the hoisted
deterministic path within 1e-6), the resident epoch runner (bit for bit
per-batch ``training_step``), a resident ``Trainer.fit`` against a streamed
one, and a capturable AdamW through a checkpoint. The CUDA graph route
runs on the card alone: its tests here are marked ``cuda`` and skip."""
import json
import os

import numpy as np
import pytest
import torch

from pedestrians_video_2_carla_tpu.runtime import native_loader as JN

from pedestrians_video_2_carla_torch.data.base.hdf5_utils import save_subset
from pedestrians_video_2_carla_torch.data.base.subsets_datamodule import \
    SubsetsDataModule
from pedestrians_video_2_carla_torch.flows.base import FlowState
from pedestrians_video_2_carla_torch.flows.pose_lifting import \
    PoseLiftingFlow
from pedestrians_video_2_carla_torch.models.base import (OptimizerSettings,
                                                          is_capturable,
                                                          set_capturable)
from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
    LinearAE
from pedestrians_video_2_carla_torch.runtime import native_loader as TN
from pedestrians_video_2_carla_torch.runtime.prefetcher import (
    DevicePrefetcher, device_put)
from pedestrians_video_2_carla_torch.runtime.resident_scan import \
    build_scan_runner
from pedestrians_video_2_carla_torch.skeletons import CARLA_SKELETON
from pedestrians_video_2_carla_torch.training.checkpoint import \
    CheckpointManager
from pedestrians_video_2_carla_torch.training.trainer import (Trainer,
                                                              TrainerConfig)
from .torch_threads import limit_torch_threads

limit_torch_threads()

STOCHASTIC = dict(noise="gaussian", missing_joint_probabilities=[0.1] * 26,
                  augment_flip=True, augment_rotate=True)

needs_native = pytest.mark.skipif(not TN.native_loader_available(),
                                  reason="g++ native build unavailable")


def _arrays(rng, n=40):
    return {
        "projection_2d": rng.normal(size=(n, 8, 26, 2)).astype(np.float32),
        "targets/absolute_pose_loc":
            rng.normal(size=(n, 8, 26, 3)).astype(np.float32),
        "targets/crossing": rng.integers(0, 2, size=(n,)).astype(np.int32),
    }


@needs_native
def test_binary_cache_gathers_what_numpy_slices(tmp_path, rng):
    arrays = _arrays(rng)
    cache = TN.BinarySubsetCache.write(str(tmp_path / "train.bin"), arrays)
    idx = rng.permutation(40)[:16]
    out = cache.gather(idx)
    for k, v in arrays.items():
        np.testing.assert_array_equal(out[k], v[idx], err_msg=k)
    assert TN.library_path().parent == TN.BUILD_DIR
    cache.close()


@needs_native
@pytest.mark.parametrize("bad", [[0, 7], [-1], [4]])
def test_binary_cache_rejects_out_of_bounds(tmp_path, bad):
    cache = TN.BinarySubsetCache.write(
        str(tmp_path / "t.bin"), {"a": np.zeros((4, 2, 2), np.float32),
                                  "b": np.zeros((4, 3), np.float32)})
    with pytest.raises(IndexError):
        cache.gather(bad)
    cache.close()


@needs_native
@pytest.mark.skipif(not JN.native_loader_available(),
                    reason="the JAX package's native build unavailable")
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_cache(tmp_path, rng, writer):
    arrays = _arrays(rng)
    path = str(tmp_path / "train.bin")
    (JN if writer == "jax" else TN).BinarySubsetCache.write(path, arrays)
    reader = (TN if writer == "jax" else JN).BinarySubsetCache(path)
    idx = rng.permutation(40)[:9]
    out = reader.gather(idx)
    assert reader.num_clips == 40
    for k, v in arrays.items():
        np.testing.assert_array_equal(out[k], v[idx], err_msg=k)
    reader.close()


def test_prefetcher_keeps_order():
    out = list(DevicePrefetcher(iter(range(10)), put_fn=lambda x: x * 2,
                                depth=2))
    assert out == [x * 2 for x in range(10)]


def test_prefetcher_raises_its_workers_error():
    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    it = DevicePrefetcher(gen())
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(ValueError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_device_put_passes_cpu_batches_through():
    batch = (torch.ones(2), {"a": torch.zeros(3)}, {"m": [torch.ones(1)]})
    out = device_put("cpu")(batch)
    assert out[0] is batch[0] and out[1]["a"] is batch[1]["a"]
    # the device half runs on the worker, in order
    out = list(DevicePrefetcher(
        iter([torch.full((2,), float(i)) for i in range(5)]),
        put_fn=device_put("cpu", lambda t: t * 3), depth=2))
    assert [float(t[0]) for t in out] == [0.0, 3.0, 6.0, 9.0, 12.0]


def _write_subsets(tmp_path, rng, n=14, names=("train", "val")):
    proj = rng.normal(size=(n, 4, 26, 2)).astype(np.float32) + 300
    targets = {"absolute_pose_loc":
               rng.normal(size=(n, 4, 26, 3)).astype(np.float32),
               "bboxes": rng.uniform(0, 600, (n, 4, 2, 2)).astype(np.float32)}
    meta = {"age": ["adult"] * n, "gender": ["female"] * n,
            "clip_width": np.full(n, 800, np.int32),
            "clip_height": np.full(n, 600, np.int32)}
    for name in names:
        save_subset(str(tmp_path / f"{name}.hdf5"), proj, targets, meta)
    return proj, targets, meta


def _subsets_dm(tmp_path, **kwargs):
    dm = SubsetsDataModule(subsets_dir=str(tmp_path), batch_size=4,
                           clip_length=4, data_nodes=CARLA_SKELETON,
                           device="cpu", **kwargs)
    dm.prepare_data()
    dm.setup("fit")
    return dm


def _equal(a, b):
    return torch.equal(a[0], b[0]) and all(
        set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a[1:], b[1:]))


@needs_native
def test_datamodule_gathers_from_the_native_cache(tmp_path, rng,
                                                  monkeypatch):
    """``setup`` slices with numpy and writes no cache;
    ``build_native_cache`` renders a subset into its binary cache and
    gathers its batches from it: the sliced batches' bits."""
    _write_subsets(tmp_path, rng)
    sliced = _subsets_dm(tmp_path)
    assert not sliced._native_caches
    assert not os.path.exists(tmp_path / "train.bin")
    dm = _subsets_dm(tmp_path)
    for name in ("train", "val"):
        dm.build_native_cache(name, str(tmp_path / f"{name}.hdf5"))
    assert set(dm._native_caches) == {"train", "val"}
    assert os.path.exists(tmp_path / "train.bin.json")
    calls = []
    gather = TN.BinarySubsetCache.gather
    monkeypatch.setattr(TN.BinarySubsetCache, "gather",
                        lambda self, idx, **kw: calls.append(len(idx))
                        or gather(self, idx, **kw))
    native = list(dm.train_batches(3)) + list(dm.val_batches())
    assert calls == [4] * len(native)
    for a, b in zip(native, list(sliced.train_batches(3))
                    + list(sliced.val_batches())):
        assert _equal(a, b)


@pytest.mark.parametrize("config", ["deterministic", "stochastic"])
def test_train_stream_halves_make_the_streamed_batches(tmp_path, rng,
                                                       config):
    """``train_stream``: host halves on the CPU (the preprocessing seed
    where it draws), which ``finish`` makes into the streamed batches bit
    for bit; a resident subset's stream is the whole batches."""
    _write_subsets(tmp_path, rng)
    kwargs = STOCHASTIC if config == "stochastic" else {}
    dm = _subsets_dm(tmp_path, **kwargs)
    host, finish = dm.train_stream(3)
    host = list(host)
    assert len(host) == 3
    for raw, targets, meta, seed in host:
        assert raw.device.type == "cpu" and raw.dtype == torch.float32
        assert (seed is not None) == (config == "stochastic")
    for a, b in zip(map(finish, host), dm.train_batches(3)):
        assert _equal(a, b)
    resident = _subsets_dm(tmp_path, device_resident=True, **kwargs)
    batches, finish = resident.train_stream(3)
    assert finish is None
    for a, b in zip(batches, dm.train_batches(3)):
        assert _equal(a, b)


@pytest.mark.parametrize("config", ["deterministic", "stochastic"])
def test_resident_batches_equal_streamed(tmp_path, rng, config):
    """n = 14: training drops 2 clips, evaluation wraps 2 around."""
    _write_subsets(tmp_path, rng)
    kwargs = STOCHASTIC if config == "stochastic" else {}
    streamed = _subsets_dm(tmp_path, **kwargs)
    resident = _subsets_dm(tmp_path, device_resident=True, **kwargs)
    assert set(resident._resident) == {"train", "val"}
    for stage, args in (("train", (True, True)), ("val", (False, False))):
        spec = resident.resident_scan_inputs(stage, *args, seed=3)
        assert spec.draws == (config == "stochastic")
        assert spec.num_batches == (3 if stage == "train" else 4)
    host = list(streamed.train_batches(3)) + list(streamed.val_batches())
    res = list(resident.train_batches(3)) + list(resident.val_batches())
    assert len(host) == len(res) == 7
    for a, b in zip(host, res):
        assert _equal(a, b)
    if config == "deterministic":
        # the per-batch resident gather gives the streamed bits; the epoch
        # spec's hoisted preprocessing is within 1e-6
        spec = resident.resident_scan_inputs("val", False, False)
        gather = resident._resident_gather(False)
        for b, want in enumerate(host[3:]):
            got = gather(None, spec.order, b, *resident._resident["val"])
            assert _equal(got, want)
            hoisted = spec.gather(None, spec.order, b, *spec.trees)
            for x, y in [(hoisted[0], want[0])] + [
                    (hoisted[i][k], want[i][k]) for i in (1, 2)
                    for k in want[i]]:
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)


def test_resident_empty_subset_yields_nothing(tmp_path, rng):
    _write_subsets(tmp_path, rng, n=8, names=("train",))
    save_subset(str(tmp_path / "val.hdf5"),
                np.zeros((0, 4, 26, 2), np.float32), {},
                {"age": [], "gender": []})
    dm = _subsets_dm(tmp_path, device_resident=True)
    assert len(list(dm.train_batches(0))) == 2
    assert "val" not in dm._resident
    assert dm.resident_scan_inputs("val", False, False) is None
    assert list(dm.val_batches()) == []


def _flow():
    return PoseLiftingFlow(
        LinearAE(generator=torch.Generator().manual_seed(0)),
        loss_modes=["loc_2d_3d"], projection_kernel="fused_train",
        movements_optimizer=OptimizerSettings(lr=1e-2), device="cpu")


@pytest.mark.parametrize("k", [4, 3])
def test_runner_equals_per_batch_training_step(tmp_path, rng, k):
    """The CPU runner against per-batch ``training_step`` over the same
    resident batches (5 of them; K = 3 does not divide them), with
    dropout, flip, rotation, noise and missing joints drawing: the same
    parameters, running statistics and per-step logs, bit for bit."""
    _write_subsets(tmp_path, rng, n=20)
    dm = _subsets_dm(tmp_path, device_resident=True, **STOCHASTIC)
    flow_a, flow_b = _flow(), _flow()
    state_a = flow_a.init_state()
    logs_a = [flow_a.training_step(state_a, b)[1]
              for b in dm.train_batches(3)]
    spec = dm.resident_scan_inputs("train", True, True, seed=3)
    assert spec.num_batches == 5 and spec.draws
    runner = build_scan_runner(flow_b, spec)
    assert not runner.graphs
    state_b, logs_b, lrs = flow_b.init_state(), [], []
    for b0 in range(0, spec.num_batches, k):
        state_b, stacked, step_lrs = runner(state_b, b0,
                                            min(k, spec.num_batches - b0))
        lrs += step_lrs
        logs_b += [{key: v[j] for key, v in stacked.items()}
                   for j in range(len(step_lrs))]
    assert state_b.step == state_a.step == 5
    assert len(logs_b) == len(logs_a)
    for la, lb in zip(logs_a, logs_b):
        assert set(la) == set(lb)
        assert all(torch.equal(la[key], lb[key]) for key in la)
    for name, tree in state_a.params.items():
        for key, v in tree.items():
            assert torch.equal(v, state_b.params[name][key]), (name, key)
    assert lrs == [{"lr-movements": 1e-2, "lr-trajectory": 1e-4}] * 5
    with pytest.raises(IndexError):
        runner(state_b, 4, 2)


def test_runner_refuses_graphs_on_the_cpu(tmp_path, rng):
    _write_subsets(tmp_path, rng)
    dm = _subsets_dm(tmp_path, device_resident=True)
    spec = dm.resident_scan_inputs("train", True, True)
    with pytest.raises(ValueError, match="CUDA"):
        build_scan_runner(_flow(), spec, graphs=True)


def _fit(tmp_path, dm, run, every):
    trainer = Trainer(_flow(), dm, TrainerConfig(
        max_epochs=2, log_every_n_steps=every, seed=3,
        logs_dir=str(tmp_path / "logs"), run_name=run, device="cpu"))
    trainer.fit()
    with open(tmp_path / "logs" / run / "metrics.jsonl") as f:
        records = [{k: v for k, v in json.loads(line).items()
                    if k not in ("time", "epoch_time_s")} for line in f]
    return trainer, records


@pytest.mark.parametrize("every", [1, 2])
def test_resident_fit_equals_streamed(tmp_path, rng, every):
    _write_subsets(tmp_path, rng, n=20)
    streamed, s_records = _fit(tmp_path, _subsets_dm(tmp_path), "s", every)
    resident, r_records = _fit(
        tmp_path, _subsets_dm(tmp_path, device_resident=True), "r", every)
    assert streamed.runner is None and resident.runner is not None
    assert r_records == s_records
    steps = [r["step"] for r in r_records if "lr-movements" in r]
    assert steps == list(range(every, 11, every))
    for name, tree in streamed.state.params.items():
        for key, v in tree.items():
            assert torch.equal(v, resident.state.params[name][key])


def test_prefetched_fit_equals_unprefetched(tmp_path, rng, monkeypatch):
    """The streamed epoch through the prefetcher (the host halves sliced
    and finished on its worker) against the same epoch without it."""
    from pedestrians_video_2_carla_torch.training import trainer as T

    _write_subsets(tmp_path, rng, n=20)
    dm = _subsets_dm(tmp_path, **STOCHASTIC)
    prefetched, p_records = _fit(tmp_path, dm, "p", 1)
    monkeypatch.setattr(T, "PREFETCH_DEPTH", 0)
    plain, records = _fit(tmp_path, dm, "n", 1)
    assert p_records == records
    for name, tree in plain.state.params.items():
        for key, v in tree.items():
            assert torch.equal(v, prefetched.state.params[name][key])


def test_counting_wrappers_register_themselves():
    """Every kernel wrapper with a launch count is in the registry the
    resident runner and the smoke read, under one name."""
    from pedestrians_video_2_carla_torch.ops import (  # noqa: F401
        fused_graph_gru, fused_projection, fused_spatial_transformer,
        fused_temporal_transformer)
    from pedestrians_video_2_carla_torch.ops.cuda_build import COUNTED

    found = {id(fn) for mod in (fused_graph_gru, fused_projection,
                                fused_spatial_transformer,
                                fused_temporal_transformer)
             for fn in vars(mod).values()
             if callable(fn) and hasattr(fn, "launches")}
    assert found == {id(fn) for fn in COUNTED.values()}
    assert len(COUNTED) == 13


def _trained_state(steps=2):
    flow = _flow()
    state = flow.init_state()
    generator = torch.Generator().manual_seed(5)
    for _ in range(steps):
        batch = (torch.randn(4, 4, 26, 2, generator=generator),
                 {"projection_2d": torch.randn(4, 4, 26, 2,
                                               generator=generator),
                  "projection_2d_transformed": torch.randn(
                      4, 4, 26, 2, generator=generator),
                  "absolute_pose_loc": torch.randn(4, 4, 26, 3,
                                                   generator=generator)},
                 {"age_gender_idx": torch.zeros(4, dtype=torch.int64)})
        flow.training_step(state, batch)
    return flow, state


def test_capturable_adamw_checkpoint_restores_exactly(tmp_path):
    """A capturable AdamW (lrs and step counts as tensors) through a
    checkpoint: the moments, steps and lrs come back exactly, in the form
    of the optimizer restored into."""
    flow, state = _trained_state()
    set_capturable(state.optimizer, True)
    assert is_capturable(state.optimizer)
    assert all(isinstance(g["lr"], torch.Tensor)
               for g in state.optimizer.param_groups)
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    manager.save(state, {"val_loss/primary": 1.0}, step=state.step)
    want = state.optimizer.state_dict()
    for capturable in (True, False):
        fresh = flow.init_state()
        set_capturable(fresh.optimizer, capturable)
        manager.restore(fresh, str(tmp_path / "ckpt" / "last"))
        assert is_capturable(fresh.optimizer) == capturable
        got = fresh.optimizer.state_dict()
        for i, st in want["state"].items():
            for key, v in st.items():
                assert torch.equal(torch.as_tensor(got["state"][i][key])
                                   .float(), torch.as_tensor(v).float())
        assert [float(g["lr"]) for g in got["param_groups"]] \
            == [float(g["lr"]) for g in want["param_groups"]]
        assert fresh.step == state.step
    # back to the host form, the same trajectory as never having switched
    set_capturable(state.optimizer, False)
    assert not is_capturable(state.optimizer)
    assert all(isinstance(g["lr"], float)
               for g in state.optimizer.param_groups)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["deterministic", "stochastic"])
def test_graphed_epoch_equals_eager_on_the_card(tmp_path, rng, cuda_device,
                                                config):
    """On the card: the graphed resident epoch against the eager one, bit
    for bit (parameters and per-step logs), dropout and preprocessing
    drawing; the kernels counted once a replay."""
    from pedestrians_video_2_carla_torch.ops import fused_projection as FP

    _write_subsets(tmp_path, rng, n=40)
    kwargs = STOCHASTIC if config == "stochastic" else {}
    dm = SubsetsDataModule(subsets_dir=str(tmp_path), batch_size=4,
                           clip_length=4, data_nodes=CARLA_SKELETON,
                           device_resident=True, **kwargs)
    dm.prepare_data()
    dm.setup("fit")
    results = []
    for graphs in (False, True):
        flow = PoseLiftingFlow(
            LinearAE(generator=torch.Generator().manual_seed(0)),
            loss_modes=["loc_2d_3d"], projection_kernel="fused_train",
            movements_optimizer=OptimizerSettings(lr=1e-2))
        spec = dm.resident_scan_inputs("train", True, True, seed=3)
        runner = build_scan_runner(flow, spec, graphs=graphs)
        state: FlowState = flow.init_state()
        before = FP.fused_projection_train_cuda_fwd.launches
        state, logs, _ = runner(state, 0, spec.num_batches)
        torch.cuda.synchronize()
        launched = FP.fused_projection_train_cuda_fwd.launches - before
        assert launched == spec.num_batches
        results.append((state.params, logs))
    (pa, la), (pb, lb) = results
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all(torch.equal(pa[n][k], pb[n][k]) for n in pa for k in pa[n])


@pytest.mark.cuda
def test_prefetched_stream_equals_the_streamed_batches_on_the_card(
        tmp_path, rng, cuda_device):
    """On the card: the host halves copied and finished on the
    prefetcher's side stream give the streamed batches bit for bit, with
    the preprocessing drawing."""
    _write_subsets(tmp_path, rng, n=40)
    dm = SubsetsDataModule(subsets_dir=str(tmp_path), batch_size=4,
                           clip_length=4, data_nodes=CARLA_SKELETON,
                           **STOCHASTIC)
    dm.prepare_data()
    dm.setup("fit")
    host, finish = dm.train_stream(3)
    got = list(DevicePrefetcher(host, put_fn=device_put(cuda_device, finish),
                                depth=3))
    want = list(dm.train_batches(3))
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a[0].is_cuda and _equal(a, b)


@pytest.mark.cuda
def test_prefetcher_copies_cpu_batches_to_the_card(cuda_device):
    """``device_put``: CPU tensors reach the card through pinned memory on
    a side stream, in order, with their values; card tensors pass
    through."""
    on_card = torch.arange(3, device=cuda_device)
    batches = [(torch.full((4, 2), float(i)), {"t": torch.arange(i + 1)},
                {"m": on_card}) for i in range(6)]
    out = list(DevicePrefetcher(iter(batches), put_fn=device_put(cuda_device),
                                depth=2))
    assert len(out) == 6
    for i, (x, targets, meta) in enumerate(out):
        assert x.device.type == "cuda" and targets["t"].device.type == "cuda"
        assert torch.equal(x.cpu(), batches[i][0])
        assert torch.equal(targets["t"].cpu(), batches[i][1]["t"])
        assert meta["m"] is on_card

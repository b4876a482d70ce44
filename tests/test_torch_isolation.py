"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
what chip_smoke.py imports needs none of pandas, h5py, PyYAML and
matplotlib (the card's machine has none of them), its entry points refuse
to fall back to the CPU when no card is present, and chip_smoke.py fails
(printing no result) without a card or without the rest of the
repository."""
import ast
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import pedestrians_video_2_carla_torch as port
from .torch_threads import limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pedestrians_video_2_carla_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="pedestrians_video_2_carla_torch."))


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b|"
        r"pedestrians_video_2_carla_tpu", re.M)
    root = os.path.dirname(port.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu")):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    assert not pattern.search(fh.read()), path
    # chip_smoke.py names the TPU kernels' file and line it replaces, but
    # imports nothing of JAX or of the JAX package, in any form
    imports = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
        r"pedestrians_video_2_carla_tpu)\b|"
        r"(import_module|__import__)\(\s*[\"'](jax|flax|optax|"
        r"pedestrians_video_2_carla_tpu)", re.M)
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        assert not imports.search(fh.read())


def test_port_has_the_classification_slice_and_packages_its_kernel():
    """The classification slice's modules are part of what the isolation
    checks walk, and the packaging names the new sub-packages' files."""
    modules = _port_modules()
    for name in ("ops.fused_graph_gru", "flows.classification",
                 "models.classification.gnn",
                 "models.classification.recurrent", "models.rnn",
                 "metrics.base", "metrics.classification"):
        assert f"pedestrians_video_2_carla_torch.{name}" in modules
    root = os.path.dirname(port.__file__)
    assert os.path.exists(os.path.join(root, "csrc", "fused_graph_gru.cu"))
    with open(os.path.join(REPO, "pyproject.toml")) as fh:
        packaging = fh.read()
    assert "pedestrians_video_2_carla_torch*" in packaging
    assert "csrc/*.cu" in packaging


def test_port_has_the_lifters_slice():
    """Config 4's slice and the rest of the movements zoo are modules the
    isolation checks walk."""
    modules = _port_modules()
    for name in ("video_pose_3d", "baseline_3d_pose", "linear_ae",
                 "transformers", "spatial_gnn"):
        assert f"pedestrians_video_2_carla_torch.models.movements.{name}" \
            in modules
    assert "pedestrians_video_2_carla_torch.models.torch_import" in modules


def test_port_has_the_openpose_slice():
    """BASELINE config 3's data path and the rest of its slice: each module
    at its JAX relative path, walked by the isolation checks."""
    modules = _port_modules()
    slice_ = ("skeletons.factory", "skeletons.openpose", "ops.augmentation",
              "ops.preprocessing", "data.base.hdf5_utils",
              "data.base.hdf5_datamodule", "data.base.subsets_datamodule",
              "data.base.pandas_mixin", "data.base.classification_mixin",
              "data.openpose.annotations", "data.openpose.datamodules",
              "training.plots", "utils.naming")
    for name in slice_:
        assert f"pedestrians_video_2_carla_torch.{name}" in modules
        path = name.replace(".", os.sep) + ".py"
        assert os.path.exists(os.path.join(
            REPO, "pedestrians_video_2_carla_tpu", path)), path


def test_port_has_the_serving_slice():
    """Serving export and the three prediction-chaining scripts: each
    module at its JAX relative path, walked by the isolation checks, and
    importable in a fresh process with pandas, h5py, PyYAML and matplotlib
    blocked (they are imported only where subsets are written or read)."""
    modules = _port_modules()
    slice_ = ("serving", "classification_finetuning",
              "separated_classification", "replacement_metric_flow")
    for name in slice_:
        assert f"pedestrians_video_2_carla_torch.{name}" in modules
        assert os.path.exists(os.path.join(
            REPO, "pedestrians_video_2_carla_tpu", f"{name}.py")), name
    code = (
        "import importlib, sys\n"
        f"for name in {CPU_ONLY!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {slice_!r}:\n"
        "    importlib.import_module('pedestrians_video_2_carla_torch.' + "
        "name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('IMPORTED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


#: what the card's machine lacks; the port imports them only where it reads
#: or writes the data that needs them, or draws (cv2)
CPU_ONLY = ("pandas", "h5py", "yaml", "matplotlib", "cv2")


def test_port_has_the_logging_slice():
    """The loggers, renderers and tracing: each module at its JAX relative
    path, walked by the isolation checks; every module of the port imports
    in a fresh process with the CPU-only packages and tensorboard blocked
    (the renderers import cv2, the TensorBoard channel tensorboard, only
    where they draw or write)."""
    modules = _port_modules()
    slice_ = ("utils.profiling", "training.loggers", "renderers.renderer",
              "renderers.points_renderer", "renderers.source_videos_renderer",
              "data.base.video_mixin", "loggers.pedestrian_writer",
              "loggers.pedestrian_logger")
    for name in slice_:
        assert f"pedestrians_video_2_carla_torch.{name}" in modules
        path = name.replace(".", os.sep) + ".py"
        assert os.path.exists(os.path.join(
            REPO, "pedestrians_video_2_carla_tpu", path)), path
    code = (
        "import importlib, sys\n"
        f"for name in {CPU_ONLY + ('tensorboard',)!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print('IMPORTED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def test_port_has_the_pose_estimation_slice():
    """Pose estimation: each module at its JAX relative path, walked by
    the isolation checks, importable in a fresh process with the CPU-only
    packages blocked (cv2 is imported where frames are decoded or drawn),
    and the JAX registries' names in the port's."""
    modules = _port_modules()
    slice_ = ("ops.heatmaps", "models.backbones.resnet",
              "models.pose_estimation.linear",
              "models.pose_estimation.regular",
              "models.pose_estimation.unipose_lstm",
              "flows.pose_estimation", "data.base.video_mixin",
              "data.unipose.jaad_unipose", "utils.visualize_heatmaps")
    for name in slice_:
        assert f"pedestrians_video_2_carla_torch.{name}" in modules
        path = name.replace(".", os.sep) + ".py"
        assert os.path.exists(os.path.join(
            REPO, "pedestrians_video_2_carla_tpu", path)), path
    code = (
        "import importlib, sys\n"
        f"for name in {CPU_ONLY!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {slice_ + ('modeling', 'data')!r}:\n"
        "    importlib.import_module('pedestrians_video_2_carla_torch.' + "
        "name)\n"
        "from pedestrians_video_2_carla_torch import modeling\n"
        "assert 'pose_estimation' in modeling.FLOWS\n"
        "assert {'CarlaRecordedVideo', 'JAADUniPose'} <= set("
        "modeling.DATA_MODULES)\n"
        "print('IMPORTED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def test_port_has_the_smpl_and_mixed_slice():
    """SMPL, AMASS, MPII, the mixed data modules and the SMPL renderer:
    each module at its JAX relative path, walked by the isolation checks,
    importable in a fresh process with the CPU-only packages blocked, and
    the JAX registry's fifteen data modules all in the port's."""
    modules = _port_modules()
    slice_ = ("skeletons.smpl", "skeletons.mpii", "data.smpl.body_model",
              "data.smpl.amass", "data.mpii.mpii", "data.mixed.mixed",
              "renderers.smpl_renderer")
    for name in slice_:
        assert f"pedestrians_video_2_carla_torch.{name}" in modules
        path = name.replace(".", os.sep) + ".py"
        assert os.path.exists(os.path.join(
            REPO, "pedestrians_video_2_carla_tpu", path)), path
    code = (
        "import importlib, sys\n"
        f"for name in {CPU_ONLY!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {slice_ + ('modeling', 'data')!r}:\n"
        "    importlib.import_module('pedestrians_video_2_carla_torch.' + "
        "name)\n"
        "from pedestrians_video_2_carla_torch import modeling\n"
        "print(sorted(modeling.DATA_MODULES))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from pedestrians_video_2_carla_tpu.data import discover
    assert proc.stdout.strip() == str(sorted(discover()))


def test_port_has_the_carla_control_and_orchestration_slice():
    """CARLA control, the gym environment, the orchestration scripts and
    the helpers: each module at its JAX relative path, walked by the
    isolation checks; every one but the gym package imports in a fresh
    process with the CPU-only packages, gymnasium and carla blocked (the
    scripts import PyYAML where they read a file; the mock stands in for
    carla), and the gym package with the CPU-only packages blocked."""
    modules = _port_modules()
    slice_ = ("walker_control", "walker_control.carla_utils",
              "walker_control.pose", "walker_control.pose_projection",
              "walker_control.controlled_pedestrian",
              "renderers.carla_renderer", "compare", "sweep",
              "missing_joints_sensitivity", "utils.argparse", "utils.paths",
              "utils.printing", "utils.term", "utils.exceptions")
    gym = ("gym_carla_pedestrians", "gym_carla_pedestrians.envs",
           "gym_carla_pedestrians.wrappers")
    for name in slice_ + gym:
        assert f"pedestrians_video_2_carla_torch.{name}" in modules
        path = name.replace(".", os.sep)
        assert any(os.path.exists(os.path.join(
            REPO, "pedestrians_video_2_carla_tpu", path + suffix))
            for suffix in (".py", os.sep + "__init__.py")), path
    for blocked, names in ((CPU_ONLY + ("gymnasium", "carla"), slice_),
                           (CPU_ONLY, gym)):
        code = (
            "import importlib, sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module('pedestrians_video_2_carla_torch.' + "
            "name)\n"
            "from pedestrians_video_2_carla_torch.walker_control import "
            "carla_utils\n"
            "assert carla_utils.using_mock_carla()\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print('IMPORTED')\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=180)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "IMPORTED" in proc.stdout


def test_port_has_the_parallel_slice():
    """Multi-card training: ``parallel`` and ``parallel.mesh`` at their
    JAX relative paths (``parallel.launcher`` is the port's own), walked by
    the isolation checks, and importing in a fresh process with the
    CPU-only packages blocked."""
    modules = _port_modules()
    for name in ("parallel", "parallel.mesh", "parallel.launcher"):
        assert f"pedestrians_video_2_carla_torch.{name}" in modules
    for path in ("parallel/__init__.py", "parallel/mesh.py"):
        assert os.path.exists(os.path.join(
            REPO, "pedestrians_video_2_carla_tpu", path)), path
    code = (
        "import importlib, sys\n"
        f"for name in {CPU_ONLY!r}:\n"
        "    sys.modules[name] = None\n"
        "for name in ('parallel', 'parallel.mesh', 'parallel.launcher'):\n"
        "    importlib.import_module('pedestrians_video_2_carla_torch.' + "
        "name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('IMPORTED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def _chip_smoke_imports():
    """The port imports of chip_smoke.py, at any depth, as statements."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    return sorted({ast.unparse(node) for node in ast.walk(tree)
                   if isinstance(node, (ast.Import, ast.ImportFrom))
                   and "pedestrians_video_2_carla_torch" in ast.unparse(node)})


def test_chip_smoke_imports_need_no_cpu_only_package():
    statements = _chip_smoke_imports()
    assert any("openpose" in s or "hdf5_datamodule" in s
               for s in statements), statements
    code = (
        "import sys\n"
        f"for name in {CPU_ONLY!r}:\n"
        "    sys.modules[name] = None\n"
        + "".join(f"{s}\n" for s in statements) +
        "import chip_smoke\n"
        "print('IMPORTED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def test_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    from pedestrians_video_2_carla_torch.data.carla.carla_2d3d import \
        Carla2D3DDataModule
    from pedestrians_video_2_carla_torch.flows.classification import \
        ClassificationFlow
    from pedestrians_video_2_carla_torch.flows.pose_lifting import \
        PoseLiftingFlow
    from pedestrians_video_2_carla_torch.models.jax_import import \
        import_flow_params
    from pedestrians_video_2_carla_torch.models.movements.linear_ae import \
        LinearAE

    from pedestrians_video_2_carla_torch import modeling
    from pedestrians_video_2_carla_torch.training.trainer import (
        Trainer, TrainerConfig)

    flow = PoseLiftingFlow(LinearAE(), device="cpu")
    dm = Carla2D3DDataModule(batch_size=2, clip_length=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseLiftingFlow(LinearAE())
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(flow, dm, TrainerConfig(logs_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        modeling.main(["--flow=pose_lifting", "--mode=train",
                       f"--root_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ClassificationFlow()
    with pytest.raises(RuntimeError, match="CUDA"):
        modeling.main(["--flow=classification",
                       "--classification_model_name=GConvGRU",
                       f"--root_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        import_flow_params({"classification": {}})
    with pytest.raises(RuntimeError, match="CUDA"):
        Carla2D3DDataModule(batch_size=2, clip_length=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        import_flow_params({"movements": {}})
    from pedestrians_video_2_carla_torch.data.openpose.datamodules import \
        JAADOpenPoseDataModule
    with pytest.raises(RuntimeError, match="CUDA"):
        JAADOpenPoseDataModule(outputs_dir=str(tmp_path))
    # asked for by name, the CPU works
    assert PoseLiftingFlow(LinearAE(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True],
                         ids=["no_card", "script_alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        shutil.copy(script, cwd)
        script = os.path.join(cwd, "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

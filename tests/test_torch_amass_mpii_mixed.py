"""Port parity for the SMPL body model, AMASS, MPII and the mixed data
modules, on the CPU, against the JAX package on the same seeded inputs.

* The SMPL and MPII skeletons (joints, edges, colours, flip masks, hips
  and neck), ``get_common_indices`` between every pair of CARLA, SMPL,
  MPII and BODY_25, ``map_from_original`` / ``map_to_original``.
* ``axis_angle_to_matrix``: values, and the gradient at zero (finite,
  the skew matrix's).
* A synthetic body model with SMPL-X's 55-joint tree (the kintree of
  ``tests/data/test_amass_mpii_mixed.py``), cut to 22 joints: the folded
  skin weights exactly, ``joint_locations`` / ``vertex_locations`` within
  atol 1e-5.
* AMASS prepared by both packages (synthetic 156-wide mocaps at 60 fps),
  with and without the body model: every HDF5 dataset (floats within 1e-5,
  pixels rtol 1e-6 beside it; the rest exactly), ``dparams.yaml``, each
  package reading the other's subsets, the batches; ``amass_subset`` gives
  the prepared arrays.
* MPII (a ``.mat`` written with ``scipy.io.savemat``), both variants.
* ``map_missing_joint_probabilities``; the mixer's order and every aligned
  batch of ``CarlaRecAMASS`` and ``JAADCarlaRec`` (the fixtures of
  ``test_torch_carla_recorded.py`` and ``test_torch_openpose.py``); the
  proportion rules; one config-2 training step on a mixed batch with
  imported weights (loss rtol 1e-4, the plain route).
* The SMPL renderer's frames, with the mesh and its skeleton fallback.
"""
import functools
import os

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from pedestrians_video_2_carla_tpu.data.mixed import mixed as JM
from pedestrians_video_2_carla_tpu.data.mpii import mpii as JMPII
from pedestrians_video_2_carla_tpu.data.smpl import amass as JA
from pedestrians_video_2_carla_tpu.data.smpl import body_model as JB
from pedestrians_video_2_carla_tpu.ops import rotations as JR
from pedestrians_video_2_carla_tpu.renderers import smpl_renderer as JRend
from pedestrians_video_2_carla_tpu import skeletons as JS
from pedestrians_video_2_carla_tpu.skeletons import smpl as JSMPL

from pedestrians_video_2_carla_torch.data.base import hdf5_utils as TU
from pedestrians_video_2_carla_torch.data.mixed import mixed as TM
from pedestrians_video_2_carla_torch.data.mpii import mpii as TMPII
from pedestrians_video_2_carla_torch.data.smpl import amass as TA
from pedestrians_video_2_carla_torch.data.smpl import body_model as TB
from pedestrians_video_2_carla_torch.ops import rotations as TR
from pedestrians_video_2_carla_torch.renderers import smpl_renderer as TRend
from pedestrians_video_2_carla_torch import skeletons as TS
from pedestrians_video_2_carla_torch.skeletons import smpl as TSMPL

from tests.test_torch_carla_recorded import carla_csv  # noqa: F401
from tests.test_torch_openpose import datasets  # noqa: F401
from .torch_threads import limit_torch_threads

limit_torch_threads()

N_MOCAPS, MOCAP_FRAMES, CLIP_LEN = 4, 60, 6
ATOL, RTOL = 1e-5, 1e-6
#: SMPL-X's first 22 parents as the JAX package's test writes them, then a
#: chain
SMPLX_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                 16, 17, 18, 19] + list(range(20, 53))
N_VERTS, N_JOINTS, N_FACES = 300, 55, 500
GENDERS = ("female", "male")


# -- fixtures ------------------------------------------------------------------

def write_body_models(root, n_verts=N_VERTS, n_faces=N_FACES, seed=4,
                      mesh=True):
    """Synthetic SMPL-X ``model.npz`` files (SMPL-X's joint count, a
    one-vertex regressor per joint, Dirichlet skin weights, random faces)
    under ``root/models/smpl-x/smplx_locked_head/<gender>/``."""
    rng = np.random.default_rng(seed)
    v_template = rng.normal(scale=0.3, size=(n_verts, 3))
    j_regressor = np.zeros((N_JOINTS, n_verts))
    for j in range(N_JOINTS):
        j_regressor[j, (j * 3) % n_verts] = 1.0
    kintree = np.zeros((2, N_JOINTS), dtype=np.int64)
    kintree[0] = np.asarray(SMPLX_PARENTS[:N_JOINTS])
    files = dict(v_template=v_template, J_regressor=j_regressor,
                 kintree_table=kintree)
    if mesh:
        files.update(weights=rng.dirichlet(np.full(N_JOINTS, 0.3),
                                           size=n_verts),
                     f=rng.integers(0, n_verts, size=(n_faces, 3)))
    base = os.path.join(str(root), TB.SMPL_BODY_MODEL_DIR)
    for gender in ("male", "female", "neutral"):
        os.makedirs(os.path.join(base, gender), exist_ok=True)
        np.savez(os.path.join(base, gender, "model.npz"), **files)
    return base


def write_mocaps(root, n=N_MOCAPS, frames=MOCAP_FRAMES, seed=3):
    """``n`` mocaps of 156-wide axis-angle poses at 60 fps (small motions
    around a root turned a quarter about x, as AMASS's are) under
    ``root/AMASS/<dataset>/<subject>/``."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = os.path.join(str(root), "AMASS", f"Set{i % 2}", f"subject_{i}")
        os.makedirs(d, exist_ok=True)
        poses = rng.normal(scale=0.1, size=(frames, 156))
        poses[:, 0] += np.pi / 2
        poses[:, 2] += np.linspace(0, 0.5 * i, frames)
        np.savez(os.path.join(d, f"mocap_{i}.npz"), poses=poses,
                 gender=np.array(GENDERS[i % 2]))
    return str(root)


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("smpl_models")
    write_body_models(root)
    return str(root)


@pytest.fixture(scope="module")
def amass_root(tmp_path_factory):
    return write_mocaps(tmp_path_factory.mktemp("amass"))


@pytest.fixture
def body_models(models_root, monkeypatch):
    """The working directory holding the synthetic models at the default
    place, both packages' model caches empty before and after."""
    for m in (TB, JB):
        m.get_body_model.cache_clear()
    monkeypatch.chdir(models_root)
    yield models_root
    for m in (TB, JB):
        m.get_body_model.cache_clear()


def write_mpii(root, n_imgs=40, seed=5):
    """An MPII ``.mat`` (``scipy.io.savemat``): one annotated person a
    train image, a second one in every third image (the ``multiple``
    variant's), every fourth point invisible, every tenth image a test
    one."""
    from scipy.io import savemat
    rng = np.random.default_rng(seed)

    def person(x0):
        points = [{"id": j, "x": float(x0 + rng.uniform(0, 200)),
                   "y": float(rng.uniform(0, 400)),
                   "is_visible": int(j % 4 != 0)} for j in range(16)]
        return {"x1": float(x0), "y1": 10.0, "x2": float(x0 + 50),
                "y2": 60.0, "scale": float(rng.uniform(1, 3)),
                "objpos": {"x": 300, "y": 200},
                "annopoints": {"point": points}}
    annolist = []
    for i in range(n_imgs):
        rects = [person(10.0)] + ([person(300.0)] if i % 3 == 0 else [])
        annolist.append({"image": {"name": f"img_{i:05d}.jpg"},
                         "annorect": rects if len(rects) > 1 else rects[0],
                         "vididx": (i % 5) + 1, "frame_sec": i})
    mat = {"RELEASE": {
        "annolist": annolist,
        "video_list": [f"vid{v}" for v in range(5)],
        "single_person": [1] * n_imgs,
        "img_train": np.asarray([int(i % 10 != 9) for i in range(n_imgs)]),
    }}
    d = os.path.join(str(root), "MPII")
    os.makedirs(d, exist_ok=True)
    savemat(os.path.join(d, "mpii_human_pose_v1_u12_1.mat"), mat)
    return str(root)


@pytest.fixture(scope="module")
def mpii_root(tmp_path_factory):
    return write_mpii(tmp_path_factory.mktemp("mpii"))


@pytest.fixture(scope="module")
def combo(tmp_path_factory, carla_csv, datasets, amass_root):  # noqa: F811
    """One datasets directory for the mixed modules: the CarlaRecorded CSV
    (``default/``), JAAD's annotations and keypoints and the mocaps."""
    root = tmp_path_factory.mktemp("combo")
    for src, name in ((carla_csv, "default"), (datasets, "JAAD"),
                      (amass_root, "AMASS")):
        os.symlink(os.path.join(src, name), root / name)
    return str(root)


# -- helpers -------------------------------------------------------------------

def _files(path):
    """Every dataset of every HDF5 file under ``path``: (file, name) ->
    (array, attributes)."""
    out = {}
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".hdf5"):
            continue
        with h5py.File(os.path.join(path, fname), "r") as f:
            f.visititems(lambda name, obj: out.__setitem__(
                (fname, name), (obj[()], {k: np.asarray(v)
                                          for k, v in obj.attrs.items()}))
                if isinstance(obj, h5py.Dataset) else None)
    return out


def _close(port, ref, msg=""):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, msg
    if port.dtype.kind == "f":
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
    else:
        np.testing.assert_array_equal(port, ref, err_msg=msg)


def _assert_same_subsets(port_dir, ref_dir):
    port, ref = _files(port_dir), _files(ref_dir)
    assert set(port) == set(ref) and port
    for key, (arr, attrs) in ref.items():
        _close(port[key][0], arr, msg=str(key))
        assert set(port[key][1]) == set(attrs), key
        for a, v in attrs.items():
            np.testing.assert_array_equal(port[key][1][a], v)
    with open(os.path.join(port_dir, "dparams.yaml")) as f, \
            open(os.path.join(ref_dir, "dparams.yaml")) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _assert_same_batches(port_batches, ref_batches, exact_keys=()):
    port_batches, ref_batches = list(port_batches), list(ref_batches)
    assert len(port_batches) == len(ref_batches) > 0
    for pb, rb in zip(port_batches, ref_batches):
        (pi, pt, pm), (ri, rt, rm) = _host(pb), _host(rb)
        _close(pi, ri, "inputs")
        # the same keys (the packages' preprocessing adds its keys in
        # another order)
        assert sorted(pt) == sorted(k for k in rt if np.asarray(rt[k])
                                    .dtype.kind in "biuf")
        for k, v in pt.items():
            if k in exact_keys:
                np.testing.assert_array_equal(v, rt[k], err_msg=k)
            else:
                np.testing.assert_allclose(v, rt[k], rtol=RTOL, atol=ATOL,
                                           err_msg=k)
        for k, v in pm.items():
            np.testing.assert_array_equal(v, rm[k], err_msg=k)


# -- skeletons -----------------------------------------------------------------

SKELETONS = ("CARLA_SKELETON", "SMPL_SKELETON", "MPII_SKELETON",
             "BODY_25_SKELETON")


@pytest.mark.parametrize("name", ["SMPL_SKELETON", "MPII_SKELETON"])
def test_skeleton_matches_jax(name):
    port, ref = (getattr(m, name) for m in (TS, JS))
    assert [(j.name, j.value) for j in port] \
        == [(j.name, j.value) for j in ref]
    np.testing.assert_array_equal(port.get_edge_index(),
                                  ref.get_edge_index())
    assert {int(k): v for k, v in port.get_colors().items()} \
        == {int(k): v for k, v in ref.get_colors().items()}
    np.testing.assert_array_equal(port.get_flip_mask(), ref.get_flip_mask())
    np.testing.assert_array_equal(port.get_hips_indices(),
                                  ref.get_hips_indices())
    np.testing.assert_array_equal(port.get_neck_indices(),
                                  ref.get_neck_indices())
    assert TS.get_skeleton_type_by_name(name) is port
    for other in SKELETONS:
        for pair in ((port, getattr(TS, other)), (getattr(TS, other), port)):
            got = TS.get_common_indices(*pair)
            want = JS.get_common_indices(
                *(getattr(JS, s.__name__) for s in pair))
            for g, w in zip(got, want):
                if isinstance(w, slice):
                    assert g == w
                else:
                    np.testing.assert_array_equal(g, w)


def test_smpl_index_maps_match_jax():
    assert TS.SMPL_SKELETON.get_root_point() is TS.SMPL_SKELETON.Pelvis
    np.testing.assert_array_equal(TSMPL.FROM_ORIG_INDICES,
                                  JSMPL.FROM_ORIG_INDICES)
    np.testing.assert_array_equal(TSMPL.TO_ORIG_INDICES,
                                  JSMPL.TO_ORIG_INDICES)
    x = np.random.default_rng(0).normal(size=(2, 5, 66)).astype(np.float32)
    ref = JSMPL.map_from_original(x)
    np.testing.assert_array_equal(TSMPL.map_from_original(x), ref)
    np.testing.assert_array_equal(
        TSMPL.map_from_original(torch.from_numpy(x)).numpy(), ref)
    for reshape in (True, False):
        want = JSMPL.map_to_original(ref, reshape=reshape)
        np.testing.assert_array_equal(
            TSMPL.map_to_original(ref, reshape=reshape), want)
        np.testing.assert_array_equal(TSMPL.map_to_original(
            torch.from_numpy(ref), reshape=reshape).numpy(), want)
    np.testing.assert_array_equal(TSMPL.map_to_original(ref), x)


# -- rotations and the body model -----------------------------------------------

def test_axis_angle_to_matrix_matches_jax():
    aa = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
    aa[0] = 0.0
    np.testing.assert_allclose(
        TR.axis_angle_to_matrix(torch.from_numpy(aa)).numpy(),
        np.asarray(JR.axis_angle_to_matrix(aa)), atol=1e-6)
    np.testing.assert_array_equal(
        TR.axis_angle_to_matrix(torch.zeros(3)).numpy(), np.eye(3))
    w = np.random.default_rng(2).normal(size=(3, 3)).astype(np.float32)
    zero = torch.zeros(3, requires_grad=True)
    (TR.axis_angle_to_matrix(zero) * torch.from_numpy(w)).sum().backward()
    ref = jax.grad(lambda a: (JR.axis_angle_to_matrix(a) * w).sum())(
        np.zeros(3, np.float32))
    assert torch.isfinite(zero.grad).all()
    np.testing.assert_array_equal(zero.grad.numpy(), np.asarray(ref))
    # the derivative of I + [w]x: the clamped norm adds nothing at zero
    np.testing.assert_allclose(zero.grad.numpy(), [
        w[2, 1] - w[1, 2], w[0, 2] - w[2, 0], w[1, 0] - w[0, 1]], rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _poses(n=5, seed=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.4, size=(n, 21 * 3)).astype(np.float32),
            rng.normal(scale=0.4, size=(n, 3)).astype(np.float32))


def test_body_model_matches_jax(models_root):
    path = os.path.join(models_root, TB.SMPL_BODY_MODEL_DIR, "female",
                        "model.npz")
    port, ref = (m.load_body_model_npz(path, num_joints=22)
                 for m in (TB, JB))
    assert port.parents == ref.parents
    for field in ("rest_joints", "v_template", "skin_weights", "faces"):
        _close(getattr(port, field), getattr(ref, field), field)
    # the folded weights still sum to one per vertex
    np.testing.assert_allclose(port.skin_weights.sum(-1), 1.0, atol=1e-5)
    body, root = _poses()
    for root_orient in (None, root):
        args = (body,) if root_orient is None else (body, root_orient)
        t_args = tuple(torch.from_numpy(a) for a in args)
        np.testing.assert_allclose(
            TB.joint_locations(port, *t_args).numpy(),
            np.asarray(JB.joint_locations(ref, *args)), atol=ATOL)
        np.testing.assert_allclose(
            TB.vertex_locations(port, *t_args).numpy(),
            np.asarray(JB.vertex_locations(ref, *args)), atol=ATOL)
    # zero pose: the rest joints
    np.testing.assert_allclose(TB.joint_locations(
        port, torch.zeros(2, 63)).numpy()[1], port.rest_joints, atol=1e-6)
    full = TB.load_body_model_npz(path)
    assert len(full.parents) == N_JOINTS
    with pytest.raises(FileNotFoundError, match="smplx_locked_head"):
        TB.load_body_model_npz(os.path.join(models_root, "none.npz"))
    no_mesh = TB.BodyModelData(rest_joints=port.rest_joints,
                               parents=port.parents)
    with pytest.raises(ValueError, match="mesh"):
        TB.vertex_locations(no_mesh, torch.zeros(1, 63))


# -- AMASS ---------------------------------------------------------------------

AMASS_KW = dict(batch_size=3, clip_length=CLIP_LEN, clip_offset=4,
                val_set_frac=0.25, test_set_frac=0.25)


def _amass(root, out, side, **kw):
    if side == "port":
        kw.setdefault("device", "cpu")
    dm = (TA if side == "port" else JA).AMASSDataModule(
        datasets_dir=root, outputs_dir=str(out), **{**AMASS_KW, **kw})
    dm.prepare_data()
    dm.setup("fit")
    return dm


@pytest.mark.parametrize("with_model", [False, True])
def test_amass_prepared_matches_jax(with_model, amass_root, models_root,
                                    monkeypatch, tmp_path):
    for m in (TB, JB):
        m.get_body_model.cache_clear()
    monkeypatch.chdir(models_root if with_model else str(tmp_path))
    try:
        port, ref = (_amass(amass_root, tmp_path / side, side)
                     for side in ("port", "jax"))
    finally:
        for m in (TB, JB):
            m.get_body_model.cache_clear()
    assert port.subsets_dir.replace(str(tmp_path / "port"), "") \
        == ref.subsets_dir.replace(str(tmp_path / "jax"), "")
    _assert_same_subsets(port.subsets_dir, ref.subsets_dir)
    proj = TU.load_subset(os.path.join(port.subsets_dir, "train.hdf5"))[0]
    assert proj.shape[1:] == (CLIP_LEN, 22, 2)
    assert np.abs(proj).max() > 0
    # each package reads the other's subsets
    for side, dm in (("jax", _amass(amass_root, tmp_path / "port", "jax")),
                     ("port", _amass(amass_root, tmp_path / "jax", "port"))):
        own = ref if side == "jax" else port
        for name in ("train", "val", "test"):
            p_sub, r_sub = dm._subsets[name], own._subsets[name]
            _close(p_sub[0], r_sub[0], name)
    exact = ("amass_body_pose",)
    _assert_same_batches(port.train_batches(1), ref.train_batches(1), exact)
    _assert_same_batches(port.val_batches(), ref.val_batches(), exact)
    # the numeric part alone, from the mocaps in memory: the prepared arrays
    mocaps = sorted(_read_mocaps(amass_root))
    sub = TA.amass_subset(
        [m[3] for m in mocaps], [m[2] for m in mocaps], CLIP_LEN, 4,
        datasets=[m[0] for m in mocaps], ids=[m[1] for m in mocaps],
        body_model=port._body_model if with_model else None, device="cpu")
    assert not with_model or np.abs(sub[1]["absolute_pose_loc"]).max() > 0
    rows = {(v, p, int(c)): i for i, (v, p, c) in enumerate(zip(
        sub[2]["video_id"], sub[2]["pedestrian_id"], sub[2]["clip_id"]))}
    seen = 0
    for name in ("train", "val", "test"):
        proj, targets, meta = TU.load_subset(
            os.path.join(port.subsets_dir, f"{name}.hdf5"))
        idx = [rows[(v, p, int(c))] for v, p, c in zip(
            meta["video_id"], meta["pedestrian_id"], meta["clip_id"])]
        seen += len(idx)
        np.testing.assert_array_equal(sub[0][idx], proj)
        for k, v in targets.items():
            np.testing.assert_array_equal(sub[1][k][idx], v, err_msg=k)
        for k in ("start_frame", "end_frame"):
            np.testing.assert_array_equal(sub[2][k][idx], meta[k])
    assert seen == len(rows)


def _read_mocaps(root):
    out = []
    base = os.path.join(root, "AMASS")
    for dirpath, _, files in os.walk(base):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), base)
            with np.load(os.path.join(dirpath, f)) as m:
                out.append((rel.split(os.sep)[0],
                            rel.split(os.sep, 1)[1].removesuffix(".npz"),
                            str(m["gender"]), np.asarray(m["poses"])))
    return out


def test_amass_subset_fast_dev_run_and_short_mocaps():
    poses = [np.zeros((30, 156)), np.zeros((10, 156))]
    proj, targets, meta = TA.amass_subset(poses, ["male", "female"], 4, 2,
                                          device="cpu")
    # 30 frames: starts 0, 4, ..., 20 (22 = 30 - 8 - 2 + 1 is the end)
    assert len(proj) == 6 + 1 and meta["clip_id"].tolist()[:3] == [0, 1, 2]
    assert targets["world_rot"].shape == (7, 4, 3, 3)
    np.testing.assert_array_equal(targets["world_rot"][:, 0],
                                  np.broadcast_to(np.eye(3), (7, 3, 3)))
    assert len(TA.amass_subset(poses, ["male", "female"], 4, 2,
                               fast_dev_run=True, device="cpu")[0]) == 2
    with pytest.raises(ValueError, match="long enough"):
        TA.amass_subset([np.zeros((5, 156))], ["male"], 4, device="cpu")


# -- MPII ----------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["single", "multiple"])
def test_mpii_prepared_matches_jax(variant, mpii_root, tmp_path):
    kw = dict(datasets_dir=mpii_root, data_variant=variant, batch_size=4,
              val_set_frac=0.3, test_set_frac=0)
    port = TMPII.MPIIDataModule(outputs_dir=str(tmp_path / "port"),
                                device="cpu", **kw)
    ref = JMPII.MPIIDataModule(outputs_dir=str(tmp_path / "jax"), **kw)
    for dm in (port, ref):
        dm.prepare_data()
        dm.setup("fit")
    _assert_same_subsets(port.subsets_dir, ref.subsets_dir)
    n = 36 + (12 if variant == "multiple" else 0)
    assert port.train_set_size + port.val_set_size == n
    _assert_same_batches(port.train_batches(), ref.train_batches(),
                         ("joints_visibility",))
    inputs, targets, _ = next(iter(port.val_batches()))
    assert inputs.shape[1:] == (1, 16, 2)
    assert targets["head_bbox"].shape[1:] == (1, 2, 2)


# -- the mixer -----------------------------------------------------------------

def test_missing_joint_probabilities_match_jax():
    rng = np.random.default_rng(7)
    for src, dst in (("BODY_25_SKELETON", "CARLA_SKELETON"),
                     ("SMPL_SKELETON", "CARLA_SKELETON"),
                     ("CARLA_SKELETON", "MPII_SKELETON")):
        probs = rng.uniform(size=len(getattr(TS, src))).tolist()
        assert TM.map_missing_joint_probabilities(
            probs, getattr(TS, src), getattr(TS, dst)) \
            == JM.map_missing_joint_probabilities(
                probs, getattr(JS, src), getattr(JS, dst))
    assert TM.map_missing_joint_probabilities(
        [0.2], TS.SMPL_SKELETON, TS.CARLA_SKELETON) == [0.2]


MIX_KW = dict(batch_size=2, clip_length=CLIP_LEN, clip_offset=3,
              val_set_frac=0.25, test_set_frac=0.25, use_body_model=False)


def _mixed(name, combo, out, side, **kw):
    module = TM if side == "port" else JM
    if side == "port":
        kw.setdefault("device", "cpu")
    dm = getattr(module, f"{name}DataModule")(
        datasets_dir=combo, outputs_dir=str(out), **{**MIX_KW, **kw})
    dm.prepare_data()
    dm.setup("fit")
    return dm


def _mix_order(proportions, seed, counts):
    """The member of each batch, drawn as ``_mix`` draws (numpy,
    ``default_rng(1234 + seed)``)."""
    weights = np.asarray([max(p, 0) if p >= 0 else 1.0
                          for p in proportions], dtype=np.float64)
    weights = weights / weights.sum()
    rng = np.random.default_rng(1234 + seed)
    left = list(counts)
    alive = [p != 0 and c > 0 for p, c in zip(proportions, counts)]
    order = []
    while any(alive):
        choices = np.nonzero(alive)[0]
        i = int(rng.choice(choices, p=weights[choices]
                           / weights[choices].sum()))
        order.append(i)
        left[i] -= 1
        alive[i] = left[i] > 0
    return order


@pytest.mark.parametrize("name,proportions", [
    ("CarlaRecAMASS", [0.5, 0.5]), ("JAADCarlaRec", [0.3, 0.7])])
def test_mixed_batches_match_jax(name, proportions, combo, tmp_path):
    kw = dict(train_proportions=proportions)
    port, ref = (_mixed(name, combo, tmp_path / side, side, **kw)
                 for side in ("port", "jax"))
    for seed in (0, 3):
        batches = list(port.train_batches(seed))
        _assert_same_batches(batches, ref.train_batches(seed))
        counts = [sum(1 for _ in m.train_batches(seed))
                  for m in port.members]
        want = _mix_order(proportions, seed, counts)
        sources = [int(np.argmax([
            any(torch.equal(b[0], mb[0]) for mb in m.train_batches(seed))
            for m in port.members])) for b in batches]
        assert sources == want
    _assert_same_batches(port.val_batches(), ref.val_batches())
    _assert_same_batches(port.test_batches(), ref.test_batches())
    keys = list(next(iter(port.val_batches()))[1])
    for batch in port.val_batches():
        assert list(batch[1]) == keys
    if name == "JAADCarlaRec":
        # the recorded clips' label reaches the classifier's key
        assert "crossing" in keys
        assert "frame.pedestrian.is_crossing" not in keys
        labels = torch.cat([b[1]["crossing"].reshape(-1).float()
                            for b in port.train_batches()])
        assert torch.isfinite(labels).all() and labels.max() == 1
    else:
        # AMASS's targets are NaN on the recorded batches and back
        assert "amass_body_pose" in keys and "bboxes" in keys
    assert port.hparams["mixed_datasets"] == ref.hparams["mixed_datasets"]
    assert port.hparams["train_proportions"] == proportions


def test_mixed_proportions_are_checked_as_jax(combo, tmp_path):
    for bad in ([0.5, 0.6], [0.5], [-1, 0.5], [1.5, -0.5]):
        for side in ("port", "jax"):
            with pytest.raises(AssertionError):
                (TM if side == "port" else JM).CarlaRecAMASSDataModule(
                    datasets_dir=combo, outputs_dir=str(tmp_path / side),
                    train_proportions=bad,
                    **({"device": "cpu"} if side == "port" else {}),
                    **MIX_KW)
    for good in ([1.0, 0.0], [-1, 0], [0, -1], [-1, -1]):
        dm = TM.CarlaRecAMASSDataModule(
            datasets_dir=combo, outputs_dir=str(tmp_path / "port"),
            train_proportions=good, device="cpu", **MIX_KW)
        assert dm.requested_train_proportions == good
    with pytest.raises(ValueError, match="device_resident"):
        TM.CarlaRecAMASSDataModule(datasets_dir=combo, device="cpu",
                                   device_resident=True, **MIX_KW)
    with pytest.raises(AssertionError):
        TM.MixedDataModule(datasets_dir=combo, device="cpu")
    assert not TM.CarlaRecAMASSDataModule.uses_infinite_train_set()


# -- config 2 on a mixed batch ---------------------------------------------------

def _jax_step(batch):
    """The JAX config-2 flow's initial params and one training step's
    loss on a mixed batch."""
    from pedestrians_video_2_carla_tpu.flows.autoencoder import \
        AutoencoderFlow
    from pedestrians_video_2_carla_tpu.flows.output_types import \
        MovementsModelOutputType
    from pedestrians_video_2_carla_tpu.models.base import OptimizerSettings
    from pedestrians_video_2_carla_tpu.models.movements import \
        MOVEMENTS_MODELS
    flow = AutoencoderFlow(
        movements_model=MOVEMENTS_MODELS["Seq2SeqEmbeddings"](
            movements_output_type=MovementsModelOutputType.pose_2d,
            hidden_size=8, single_joint_embeddings_size=4, p_dropout=0.0),
        loss_modes=["loc_2d"],
        movements_optimizer=OptimizerSettings(lr=1e-3))
    state = flow.init_state(jax.random.PRNGKey(1), batch)
    _, logs = flow.training_step(state, batch, jax.random.PRNGKey(2))
    return jax.device_get((state.params, logs))


def test_config2_step_on_a_mixed_batch_matches_jax(combo, tmp_path):
    """One ``Seq2SeqEmbeddings`` autoencoder step (config 2 at small
    widths) on an AMASS batch of ``CarlaRecAMASS``: the JAX flow's initial
    weights through ``import_flow_params``, the loss within rtol 1e-4."""
    from pedestrians_video_2_carla_torch.flows.autoencoder import \
        AutoencoderFlow
    from pedestrians_video_2_carla_torch.flows.output_types import \
        MovementsModelOutputType
    from pedestrians_video_2_carla_torch.models.base import OptimizerSettings
    from pedestrians_video_2_carla_torch.models.jax_import import \
        import_flow_params
    from pedestrians_video_2_carla_torch.models.movements import \
        MOVEMENTS_MODELS
    port, ref = (_mixed("CarlaRecAMASS", combo, tmp_path / side, side,
                        train_proportions=[0.5, 0.5])
                 for side in ("port", "jax"))
    p_batches = list(port.train_batches())
    r_batches = [jax.device_get(b) for b in ref.train_batches()]
    # the first AMASS batch (the recorded ones hold NaN amass_body_pose)
    i = next(i for i, b in enumerate(p_batches)
             if not bool(torch.isnan(b[1]["amass_body_pose"]).all()))
    j_params, j_logs = _jax_step(r_batches[i])
    flow = AutoencoderFlow(
        MOVEMENTS_MODELS["Seq2SeqEmbeddings"](
            movements_output_type=MovementsModelOutputType.pose_2d,
            hidden_size=8, single_joint_embeddings_size=4,
            p_dropout=0.0, rnn_kernel="plain"),
        loss_modes=["loc_2d"],
        movements_optimizer=OptimizerSettings(lr=1e-3), device="cpu")
    state = flow.init_state(import_flow_params(j_params, device="cpu"))
    _, logs = flow.training_step(state, p_batches[i])
    np.testing.assert_allclose(float(logs["train_loss/loc_2d"]),
                               float(j_logs["train_loss/loc_2d"]),
                               rtol=1e-4)


# -- the SMPL renderer -----------------------------------------------------------

def test_smpl_renderer_matches_jax(body_models):
    rng = np.random.default_rng(8)
    pose = rng.normal(scale=0.3, size=(2, 3, 66)).astype(np.float32)
    proj = rng.uniform(50, 500, size=(2, 3, 22, 2)).astype(np.float32)
    meta = {"gender": np.asarray(["male", "female"])}
    kw = dict(image_size=(160, 120))
    port = list(TRend.SMPLRenderer(**kw).render(
        amass_body_pose=pose, projection_2d=proj, meta=meta))
    ref = list(JRend.SMPLRenderer(**kw).render(
        amass_body_pose=pose, projection_2d=proj, meta=meta))
    assert len(port) == len(ref) == 2
    for p, r in zip(port, ref):
        assert p.shape == r.shape == (3, 120, 160, 3) and p.any()
        np.testing.assert_array_equal(p, r)
    # no model with a mesh: the SMPL points of the projections
    for m in (TB, JB):
        m.get_body_model.cache_clear()
    fallback = [list(cls(body_model_dir=os.path.join(body_models, "none"),
                         **kw).render(amass_body_pose=pose,
                                      projection_2d=proj, meta=meta))
                for cls in (TRend.SMPLRenderer, JRend.SMPLRenderer)]
    for p, r in zip(*fallback):
        np.testing.assert_array_equal(p, r)
        assert p.any()
    assert [c.any() for c in TRend.SMPLRenderer(**kw).render(
        projection_2d=proj)] == [True, True]

"""Command line for the ported path, with the JAX package's flag names:

    python -m pedestrians_video_2_carla_torch --flow=pose_lifting --mode=train \
        --data_module_name=Carla2D3D --movements_model_name=LinearAE \
        --loss_modes loc_2d_3d --projection_kernel fused_train ...

    python -m pedestrians_video_2_carla_torch --flow=classification \
        --classification_model_name=GConvGRU --graph_kernel fused ...

    python -m pedestrians_video_2_carla_torch --flow=autoencoder \
        --movements_model_name=Seq2SeqEmbeddings \
        --movements_output_type=pose_2d --loss_modes loc_2d \
        --rnn_kernel fused ...

    python -m pedestrians_video_2_carla_torch --flow=pose_estimation \
        --data_module_name=CarlaRecordedVideo \
        --movements_model_name=UniPoseLSTM --loss_modes heatmaps \
        --video_size 256 256 --heatmaps_stride 8 ...

The chosen model's constructor arguments are flags as well
(``--receptive_frames``, ``--depth``, ``--hidden_size``, ``--k``,
``--graph_kernel``, ``--rnn_kernel``, ...; ``--clip_length`` feeds both the
data module and the model), as the JAX CLI adds one per model field; so are
the training options (``--gradient_clip_val``, ``--loss_weights``,
``--loss_params_{i}``, ``--{prefix}_enable_lr_scheduler`` and the
``--{prefix}_scheduler_*`` family; ``--lr`` sets the lr of every model
type whose ``--{type}_lr`` is not given). Logs and checkpoints go to
``<logs_dir>/<run_name>/`` (``--logs_dir``, by default
``<root_dir>/logs/<flow>``); a
``--ckpt_path`` ending in ``.ckpt``, ``.pth`` or ``.pt`` that is not the
port's own archive is a reference torch checkpoint, whose movements-model
weights load through ``Trainer.restore_torch``; a ``file://`` or
``wandb://`` path is first resolved to a local one
(``training/checkpoint.py::resolve_ckpt_path``). The data
modules are the JAX CLI's by name (``Carla2D3D``, ``CarlaRecorded``,
``CarlaBenchmark``, ``CarlaRecordedVideo``, ``JAADOpenPose``,
``PIEOpenPose``, ``JAADBenchmark``, ``PIEBenchmark``, ``JAADUniPose``;
``--subsets_dir`` trains on an existing HDF5 subsets tree), with its
DataModule flags. The pose-estimation flow takes clips of frames from a
video data module (``--video_size``, ``--crop_to_bbox``,
``--heatmaps_sigma``, ``--heatmaps_stride``), and only it does;
``--pretrained_backbone_path`` grafts a local torchvision ResNet file onto
its model's backbone before any ``--ckpt_path``. An
unnamed run gets a directory of its own (``utils/naming.py``). It runs
on the card unless ``--device cpu`` is given. A flow, data module, model,
loss or renderer that the JAX package has but the port does not yet raises
``NotImplementedError`` naming ``ROADMAP.md``; flags the chosen flow and
model do not take are ignored with a warning, as in the JAX CLI.

Logging and tracing: ``--logger wandb`` also writes a W&B offline run
directory under the run's; ``--renderers input_points projection_points``
(``zeros``, ``target_points``, ``source_videos``, ``smpl``, ``carla``,
``source_carla`` too) write mp4s under
``<log_dir>/videos`` (``--max_videos``,
``--video_saving_frequency_reduction``, ``--merging_method``,
``--source_videos_*``); ``--profile`` writes a ``torch.profiler`` trace of
the fit to ``<log_dir>/trace/trace.json`` and prints the timings;
``-v`` / ``-vv`` set the logging level to INFO / DEBUG.

The JAX CLI's five modes: ``train`` and ``tune`` fit, then evaluate the
validation set; ``test`` evaluates the test set; ``predict`` runs
``Trainer.predict`` over each of ``--predict_sets`` (``results
["predictions"]``); ``export`` writes ``<log_dir>/exported/model.pt2``
(``serving.export_inference``, ``--export_keys``,
``--export_polymorphic_batch``) from a batch of the data module. In every
mode but ``train`` a ``--ckpt_path`` restores the weights alone.
"""
import argparse
import inspect
import logging
import os
import sys
import warnings
from typing import Any, Dict, List, Optional

import torch

from . import data as data_registry
from .data.base.subsets_datamodule import SubsetsDataModule
from .flows.autoencoder import AutoencoderFlow
from .flows.classification import ClassificationFlow
from .data.base.video_mixin import VideoDataModuleMixin
from .flows.output_types import MovementsModelOutputType
from .flows.pose_estimation import PoseEstimationFlow
from .flows.pose_lifting import PoseLiftingFlow
from .loggers.pedestrian_logger import PedestrianLogger
from .loggers.pedestrian_writer import RENDERERS, check_renderers
from .losses import LossModes
from .models.base import SCHEDULER_TYPES, OptimizerSettings
from .models.classification import CLASSIFICATION_MODELS
from .models.classification.common import ClassificationModel
from .models.movements import MOVEMENTS_MODELS
from .models.movements.common import MovementsModel
from .models.pose_estimation import POSE_ESTIMATION_MODELS
from .models.pose_estimation.linear import PoseEstimationModel
from .models.trajectory import TRAJECTORY_MODELS
from .ops.projection import KERNELS
from .serving import export_inference
from .skeletons.base import get_skeleton_type_by_name
from .skeletons.carla import CARLA_SKELETON
from .training.checkpoint import is_archive, resolve_ckpt_path
from .training.trainer import LOGGERS, Trainer, TrainerConfig
from .utils.argparse import boolean, flat_args_as_list_arg
from .utils.naming import unique_run_name
from .utils.printing import print_metrics
from .utils.profiling import device_trace, print_timing, timed

DEFAULT_SEED = 22742

FLOWS = {"pose_lifting": PoseLiftingFlow,
         "classification": ClassificationFlow,
         "autoencoder": AutoencoderFlow,
         "pose_estimation": PoseEstimationFlow}
#: each flow's default model, as the JAX flows' ``get_default_models``
DEFAULT_MODELS = {"pose_estimation": "UniPoseLSTM"}
DATA_MODULES = data_registry.discover()
MODES = ("train", "tune", "test", "predict", "export")


def _ported(kind: str, name: str, available) -> None:
    if name not in available:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to PyTorch yet (ported: "
            f"{sorted(available)}; see ROADMAP.md)")


#: model constructor arguments that are not flags (``num_classes`` is the
#: classification flow's flag, which also feeds the model)
_NOT_FLAGS = ("generator", "input_nodes", "output_nodes", "num_classes")
#: what the model flags that change nothing in the port are
MODEL_FLAG_HELP = {
    "remat": "the JAX package's rematerialisation of the transformer "
             "blocks under the gradient; the port keeps the activations "
             "and computes the same numbers whatever it is",
    "unroll": "the JAX package's scan unroll factor of the recurrences; "
              "the port runs one frame a step and computes the same "
              "numbers whatever it is",
    "scan_unroll": "the JAX package's unroll factor of the graph scans; "
                   "the port's scans run one frame a step, in its kernels "
                   "or its plain loop, and compute the same numbers "
                   "whatever it is",
    "needs_confidence": "the data carries a confidence channel: models that "
                        "read every channel take (x, y, confidence)",
}
#: the model types a flow trains, each with its ``--{type}_model_name``,
#: ``--{type}_lr`` and optimizer flags
MODEL_TYPES = ("movements", "classification", "trajectory")
#: the number of ``--loss_params_{i}`` and
#: ``--missing_joint_probabilities_{i}`` flags: one per CARLA joint
LOSS_PARAMS = 26


def model_params(model_cls) -> Dict[str, Any]:
    """The constructor arguments of ``model_cls`` and of its bases down to
    the framework's model base (a Seq2Seq variant's own, Seq2Seq's and
    ``MovementsModel``'s) that flags set (those with a bool, int, float or
    str default), and their defaults (a subclass's default first)."""
    params: Dict[str, Any] = {}
    for cls in model_cls.__mro__:
        if "__init__" in vars(cls):
            for name, p in inspect.signature(
                    cls.__init__).parameters.items():
                if name not in _NOT_FLAGS and name not in params \
                        and isinstance(p.default, (bool, int, float, str)):
                    params[name] = p.default
        if cls in (MovementsModel, ClassificationModel,
                   PoseEstimationModel):
            break
    return params


def add_model_args(parser: argparse.ArgumentParser, model_cls) -> None:
    """A flag for each of ``model_params(model_cls)``, as the JAX CLI adds
    one per model field; a name another group has already (``clip_length``
    of the data module) is left to that flag, which then feeds the model
    too."""
    group = parser.add_argument_group(model_cls.__name__)
    for name, default in model_params(model_cls).items():
        kind = boolean if isinstance(default, bool) else type(default)
        try:
            group.add_argument(f"--{name}", type=kind, default=default,
                               help=MODEL_FLAG_HELP.get(name))
        except argparse.ArgumentError:
            pass


def make_parser(argv: Optional[List[str]] = None) -> argparse.ArgumentParser:
    """The CLI's parser; the model named in ``argv`` (the classifier for
    ``--flow=classification``, else the movements model) adds its own
    flags."""
    parser = argparse.ArgumentParser(
        prog="pedestrians_video_2_carla_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--flow", default="pose_lifting")
    flow = parser.parse_known_args(argv)[0].flow
    parser.add_argument("--mode", default="train")
    parser.add_argument("--data_module_name", default="Carla2D3D")
    parser.add_argument("--predict_sets", nargs="+", default=["test"])
    parser.add_argument("--export_keys", nargs="+", default=None,
                        help="restrict the --mode=export artifact's outputs "
                             "(e.g. projection_2d)")
    parser.add_argument("--export_polymorphic_batch", action="store_true",
                        help="export the --mode=export artifact with a "
                             "symbolic batch dimension: one artifact serves "
                             "any batch size; requires --projection_kernel "
                             "plain")
    parser.add_argument("--movements_model_name",
                        default=DEFAULT_MODELS.get(flow, "LSTM"))
    parser.add_argument("--classification_model_name", default="LSTM")
    parser.add_argument("--trajectory_model_name", default="ZeroTrajectory")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--root_dir", default="outputs")
    parser.add_argument("--logs_dir", default=None,
                        help="where the run directories go (default "
                             "<root_dir>/logs/<flow>)")
    parser.add_argument("--run_name", default=None)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--pretrained_backbone_path", default=None,
                        help="a local torchvision ResNet-50/101 state_dict "
                             "(.pth) grafted onto the pose-estimation "
                             "model's backbone")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    add_logging_args(parser)

    group = parser.add_argument_group("Trainer")
    group.add_argument("--max_epochs", type=int, default=1)
    group.add_argument("--limit_train_batches", type=int, default=None)
    group.add_argument("--limit_val_batches", type=int, default=None)
    group.add_argument("--limit_test_batches", type=int, default=None)
    group.add_argument("--log_every_n_steps", type=int, default=50)
    group.add_argument("--check_val_every_n_epoch", type=int, default=1)
    group.add_argument("--skip_initial_metrics", type=boolean, default=False,
                       help="skip the fit-start pass of the initial "
                            "(inputs as predictions) metrics")
    group.add_argument("--detect_anomaly", type=boolean, nargs="?",
                       const=True, default=False)
    group.add_argument("--gradient_clip_val", type=float, default=0.0,
                       help="global-norm gradient clipping (0 = off)")

    add_datamodule_args(parser)

    group = parser.add_argument_group("Flow")
    group.add_argument("--loss_modes", nargs="+", default=[])
    group.add_argument("--loss_weights", nargs="+", default=[],
                       help="e.g. loc_2d=1.0 loc_3d=1.0 rot_3d=3.0")
    group.add_argument("--mask_missing_joints", type=boolean, default=True)
    group.add_argument("--precision", default="32",
                       choices=["32", "16", "bf16"],
                       help="16/bf16 = AMP-style: bf16 model compute, fp32 "
                            "master weights and fp32 FK/projection geometry")
    group.add_argument("--movements_output_type", default="pose_changes",
                       choices=[t.name for t in MovementsModelOutputType])
    for i in range(LOSS_PARAMS):
        group.add_argument(f"--loss_params_{i}", type=float, default=None)
    group.add_argument("--projection_kernel", default="plain",
                       choices=list(KERNELS),
                       help="plain = PyTorch ops (JAX 'xla'); fused = the "
                            "serving CUDA kernel (JAX 'pallas'); fused_train "
                            "= the training CUDA kernels, forward and "
                            "backward (JAX 'pallas_train')")

    group = parser.add_argument_group("ClassificationFlow")
    group.add_argument("--classification_average", default="macro",
                       choices=["micro", "macro", "weighted", "none",
                                "benchmark"])
    group.add_argument("--num_classes", type=int, default=2)

    group = parser.add_argument_group("optimizers")
    group.add_argument("--lr", type=float, default=None,
                       help="the lr of every model type whose --{type}_lr "
                            "is not given")
    for prefix in MODEL_TYPES:
        add_optimizer_args(group, prefix)

    chosen, _ = parser.parse_known_args(argv)
    models, name = chosen_model(chosen)
    if name in models:
        add_model_args(parser, models[name])
    return parser


def add_logging_args(parser: argparse.ArgumentParser) -> None:
    """The JAX CLI's logging, video and tracing flags."""
    parser.add_argument("--logger", default="auto", choices=list(LOGGERS),
                        help="'wandb' also writes a W&B offline run "
                             "directory (no network, no wandb package)")
    parser.add_argument("--prefer_tensorboard", action="store_true",
                        help="the JAX CLI's flag: every logger already "
                             "writes TensorBoard events where "
                             "torch.utils.tensorboard imports")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of the fit "
                             "(CUDA kernels too on the card) to "
                             "{log_dir}/trace/trace.json and print the "
                             "timings")
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="logging level INFO")
    parser.add_argument("--very_verbose", "-vv", action="store_true",
                        help="logging level DEBUG")
    parser.add_argument("--renderers", nargs="*", default=["none"],
                        help=f"the video renderers: {list(RENDERERS)}, or "
                             f"none")
    parser.add_argument("--source_videos_overlay_skeletons", type=boolean,
                        default=False,
                        help="draw the skeletons in the source_videos "
                             "renderer")
    parser.add_argument("--source_videos_overlay_bboxes", type=boolean,
                        default=False)
    parser.add_argument("--source_videos_overlay_classes", type=boolean,
                        default=False,
                        help="write the class label on the source_videos "
                             "renderer's frames")
    parser.add_argument("--max_videos", type=int, default=4)
    parser.add_argument("--video_saving_frequency_reduction", type=int,
                        default=10,
                        help="a training step logs videos every "
                             "log_every_n_steps times this many steps")
    parser.add_argument("--merging_method", default="square",
                        choices=["square", "horizontal", "vertical"])


def add_datamodule_args(parser: argparse.ArgumentParser) -> None:
    """The JAX CLI's DataModule flags of the ported datamodules, with its
    defaults; each datamodule takes the ones it knows."""
    group = parser.add_argument_group("DataModule")
    group.add_argument("--batch_size", type=int, default=64)
    group.add_argument("--clip_length", type=int, default=30)
    group.add_argument("--data_nodes", default=None,
                       type=get_skeleton_type_by_name)
    group.add_argument("--input_nodes", default=None,
                       type=get_skeleton_type_by_name)
    group.add_argument("--output_nodes", default=None,
                       type=get_skeleton_type_by_name)
    group.add_argument("--transform", default="hips_neck",
                       choices=["hips_neck", "hips_neck_bbox", "bbox", "none"])
    group.add_argument("--val_set_size", type=int, default=64)
    group.add_argument("--test_set_size", type=int, default=64)
    group.add_argument("--random_changes_each_frame", type=int, default=3)
    group.add_argument("--max_change_in_deg", type=float, default=5.0)
    group.add_argument("--max_world_rot_change_in_deg", type=float,
                       default=0.0)
    group.add_argument("--max_initial_world_rot_change_in_deg", type=float,
                       default=0.0)
    group.add_argument("--noise", default="zero",
                       choices=["zero", "gaussian", "uniform"])
    group.add_argument("--noise_param", type=float, default=1.0)
    group.add_argument("--data_variant", default=None)
    group.add_argument("--source_videos_dir", default=None)
    for i in range(LOSS_PARAMS):
        group.add_argument(f"--missing_joint_probabilities_{i}", type=float,
                           default=None)
    group.add_argument("--datasets_dir", default="datasets")
    group.add_argument("--outputs_dir", default="outputs")
    group.add_argument("--subsets_dir", default=None)
    group.add_argument("--clip_offset", type=int, default=None)
    group.add_argument("--val_set_frac", type=float, default=0.2)
    group.add_argument("--test_set_frac", type=float, default=0.2)
    group.add_argument("--strong_points", type=float, default=0)
    group.add_argument("--iou_threshold", type=float, default=0.1)
    group.add_argument("--sample_type", default="beh", choices=["beh", "all"])
    group.add_argument("--augment_flip", type=boolean, default=False)
    group.add_argument("--augment_rotate", type=boolean, default=False)
    group.add_argument("--balance_classes", type=boolean, default=False)
    group.add_argument("--label_frames", type=float, default=-1)
    group.add_argument("--classification_targets_key", default=None)
    group.add_argument("--tte", nargs=2, type=int, default=[30, 60],
                       help="the benchmark's time-to-event window")
    group.add_argument("--train_proportions", nargs="+", type=float,
                       default=None,
                       help="a mixed data module's members' proportions "
                            "(summing to 1, or each -1 or 0)")
    group.add_argument("--val_proportions", nargs="+", type=float,
                       default=None)
    group.add_argument("--test_proportions", nargs="+", type=float,
                       default=None)
    group.add_argument("--video_size", nargs=2, type=int, default=[256, 256],
                       help="the decoded frames' size (H W)")
    group.add_argument("--crop_to_bbox", type=boolean, default=True,
                       help="square-crop the frames to the pedestrian's "
                            "bbox")
    group.add_argument("--heatmaps_sigma", type=float, default=3.0)
    group.add_argument("--heatmaps_stride", type=int, default=8)
    group.add_argument("--device_resident", type=boolean, default=False,
                       help="keep the HDF5 subsets on the device: batches "
                            "are gathered and preprocessed there, and a "
                            "training epoch runs as the resident epoch "
                            "(CUDA graph replays on the card)")


def add_optimizer_args(group, prefix: str) -> None:
    """``--{prefix}_lr``, ``--{prefix}_enable_lr_scheduler`` and the
    ``--{prefix}_scheduler_*`` family, with the JAX CLI's defaults."""
    group.add_argument(f"--{prefix}_lr", type=float, default=None)
    group.add_argument(f"--{prefix}_enable_lr_scheduler", action="store_true")
    group.add_argument(f"--{prefix}_scheduler_type",
                       default="ReduceLROnPlateau",
                       choices=list(SCHEDULER_TYPES))
    group.add_argument(f"--{prefix}_scheduler_gamma", type=float,
                       default=0.98)
    group.add_argument(f"--{prefix}_scheduler_step_size", type=int,
                       default=1)
    group.add_argument(f"--{prefix}_scheduler_min_lr", type=float,
                       default=1e-8)
    group.add_argument(f"--{prefix}_scheduler_patience", type=int,
                       default=50)
    group.add_argument(f"--{prefix}_scheduler_cooldown", type=int,
                       default=20)
    group.add_argument(f"--{prefix}_weight_decay", type=float, default=1e-8)


def is_reference_checkpoint(path: str) -> bool:
    """Whether ``--ckpt_path`` names a reference torch or Lightning
    checkpoint (``.ckpt``, ``.pth``, or a ``.pt`` that is not the port's
    own archive), whose movements-model weights alone load."""
    return path.endswith((".ckpt", ".pth")) \
        or (path.endswith(".pt") and not is_archive(path))


def chosen_model(args):
    """(the registry, the name) of the model the chosen flow trains."""
    if args.flow == "classification":
        return CLASSIFICATION_MODELS, args.classification_model_name
    if args.flow == "pose_estimation":
        return POSE_ESTIMATION_MODELS, args.movements_model_name
    return MOVEMENTS_MODELS, args.movements_model_name


def check_inputs(flow: str, dm_cls) -> None:
    """Frames feed the pose-estimation flow, and it takes nothing else: a
    video data module with another flow, or the pose-estimation flow on
    keypoints, raises ``ValueError`` before any model is built."""
    videos = isinstance(dm_cls, type) \
        and issubclass(dm_cls, VideoDataModuleMixin)
    if videos != (flow == "pose_estimation"):
        video_modules = sorted(n for n, c in DATA_MODULES.items()
                               if issubclass(c, VideoDataModuleMixin))
        raise ValueError(
            f"--flow={flow} with --data_module_name={dm_cls.__name__}: "
            f"the pose-estimation flow takes the frames of a video data "
            f"module ({video_modules}), and the other flows take "
            f"keypoints")


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    argv = sys.argv[1:] if argv is None else argv
    args, unknown = make_parser(argv).parse_known_args(argv)
    if unknown:
        # another flow's or model's flags: the chaining scripts pass one
        # argument list through every stage
        warnings.warn(f"ignoring unrecognized arguments: {unknown}")
    if args.very_verbose or args.verbose:
        logging.basicConfig(
            level=logging.DEBUG if args.very_verbose else logging.INFO)
    _ported("flow", args.flow, FLOWS)
    _ported("mode", args.mode, MODES)
    _ported("data module", args.data_module_name, DATA_MODULES)
    models, model_name = chosen_model(args)
    _ported("classification model" if args.flow == "classification"
            else "movements model", model_name, models)
    _ported("trajectory model", args.trajectory_model_name,
            TRAJECTORY_MODELS)
    for mode in args.loss_modes:
        _ported("loss mode", mode, LossModes.__members__)
    renderers = check_renderers(args.renderers)
    # the bare --lr: every model type without its own --{type}_lr
    for model_type in MODEL_TYPES:
        if getattr(args, f"{model_type}_lr") is None:
            setattr(args, f"{model_type}_lr", args.lr)

    # the JAX CLI's rule: the datamodule's own skeleton unless
    # --data_nodes names one; the model reads --input_nodes, else that,
    # and outputs --output_nodes, else its input skeleton
    dm_cls = DATA_MODULES[args.data_module_name]
    check_inputs(args.flow, SubsetsDataModule if args.subsets_dir
                 else dm_cls)
    data_nodes = args.data_nodes or getattr(dm_cls, "default_data_nodes",
                                            None)
    input_nodes = args.input_nodes or data_nodes
    output_nodes = args.output_nodes or input_nodes
    model_cls = models[model_name]
    model_kwargs = {k: getattr(args, k) for k in model_params(model_cls)}
    takes = set().union(*(inspect.signature(c.__init__).parameters
                          for c in model_cls.__mro__
                          if "__init__" in vars(c)))
    for key, value in (("input_nodes", input_nodes),
                       ("output_nodes", output_nodes),
                       ("video_size", tuple(args.video_size))):
        if value is not None and key in takes:
            model_kwargs[key] = value
    generator = torch.Generator().manual_seed(args.seed)
    if args.flow == "classification":
        flow = ClassificationFlow(
            model_cls(generator=generator, num_classes=args.num_classes,
                      **model_kwargs),
            classification_targets_key=args.classification_targets_key
            or "crossing",
            classification_average=args.classification_average,
            num_classes=args.num_classes,
            classification_optimizer=OptimizerSettings.from_kwargs(
                "classification", vars(args)),
            gradient_clip_val=args.gradient_clip_val,
            precision=args.precision, seed=args.seed, device=args.device)
    else:
        # a model whose output type is fixed takes no flag for it
        mot = MovementsModelOutputType[args.movements_output_type]
        supported = model_cls.supported_output_types()
        if len(supported) > 1 and mot in supported:
            model_kwargs["movements_output_type"] = mot
        trajectory = {}
        if args.flow == "pose_lifting":  # the JAX flow with a trajectory
            trajectory = dict(
                trajectory_model=TRAJECTORY_MODELS[
                    args.trajectory_model_name](),
                trajectory_optimizer=OptimizerSettings.from_kwargs(
                    "trajectory", vars(args)))
        flow = FLOWS[args.flow](
            model_cls(generator=generator, **model_kwargs), **trajectory,
            loss_modes=args.loss_modes,
            loss_weights={k: float(v) for k, v in (
                w.split("=") for w in args.loss_weights)},
            loss_params=flat_args_as_list_arg(vars(args), "loss_params"),
            mask_missing_joints=args.mask_missing_joints,
            transform=args.transform,
            movements_optimizer=OptimizerSettings.from_kwargs("movements",
                                                              vars(args)),
            gradient_clip_val=args.gradient_clip_val,
            precision=args.precision,
            projection_kernel=args.projection_kernel, seed=args.seed,
            device=args.device)

    dm_kwargs = dict(
        batch_size=args.batch_size, clip_length=args.clip_length,
        transform=args.transform,
        needs_confidence=getattr(flow, "needs_confidence", False),
        needs_heatmaps=getattr(flow, "needs_heatmaps", False),
        video_size=tuple(args.video_size), crop_to_bbox=args.crop_to_bbox,
        heatmaps_sigma=args.heatmaps_sigma,
        heatmaps_stride=args.heatmaps_stride,
        val_set_size=args.val_set_size, test_set_size=args.test_set_size,
        random_changes_each_frame=args.random_changes_each_frame,
        max_change_in_deg=args.max_change_in_deg,
        max_world_rot_change_in_deg=args.max_world_rot_change_in_deg,
        max_initial_world_rot_change_in_deg=(
            args.max_initial_world_rot_change_in_deg),
        noise=args.noise, noise_param=args.noise_param,
        missing_joint_probabilities=flat_args_as_list_arg(
            vars(args), "missing_joint_probabilities"),
        seed=args.seed, datasets_dir=args.datasets_dir,
        outputs_dir=args.outputs_dir, subsets_dir=args.subsets_dir,
        clip_offset=args.clip_offset, val_set_frac=args.val_set_frac,
        test_set_frac=args.test_set_frac, strong_points=args.strong_points,
        iou_threshold=args.iou_threshold, sample_type=args.sample_type,
        augment_flip=args.augment_flip, augment_rotate=args.augment_rotate,
        balance_classes=args.balance_classes, label_frames=args.label_frames,
        num_classes=args.num_classes, tte=tuple(args.tte),
        device_resident=args.device_resident, device=args.device)
    for prop in ("train_proportions", "val_proportions",
                 "test_proportions"):
        if getattr(args, prop) is not None:
            dm_kwargs[prop] = getattr(args, prop)
    if args.classification_targets_key:
        dm_kwargs["classification_targets_key"] = \
            args.classification_targets_key
    if args.data_variant:
        dm_kwargs["data_variant"] = args.data_variant
    if args.source_videos_dir:
        dm_kwargs["source_videos_dir"] = args.source_videos_dir
    if data_nodes is not None:
        dm_kwargs["data_nodes"] = data_nodes
    if input_nodes is not None:
        dm_kwargs["input_nodes"] = input_nodes
    if args.subsets_dir:
        # train and evaluate on an existing subsets tree, whichever
        # datamodule wrote it
        dm_cls = SubsetsDataModule
    dm = dm_cls(**dm_kwargs)

    logs_dir = args.logs_dir or os.path.join(args.root_dir, "logs",
                                             args.flow)
    config = TrainerConfig(
        max_epochs=args.max_epochs,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches,
        limit_test_batches=args.limit_test_batches,
        log_every_n_steps=args.log_every_n_steps,
        check_val_every_n_epoch=args.check_val_every_n_epoch,
        seed=args.seed,
        logs_dir=logs_dir,
        # an unnamed run reserves its own directory (never one in use)
        run_name=args.run_name or unique_run_name(
            logs_dir, prefix=f"{args.data_module_name}-"),
        skip_initial_metrics=args.skip_initial_metrics,
        detect_anomaly=args.detect_anomaly,
        logger=args.logger,
        device=args.device)
    video_logger = None
    if renderers:
        video_logger = PedestrianLogger(
            save_dir=os.path.join(logs_dir, config.run_name, "videos"),
            renderers=renderers,
            input_nodes=input_nodes or CARLA_SKELETON,
            output_nodes=output_nodes or CARLA_SKELETON,
            log_every_n_steps=args.log_every_n_steps,
            max_videos=args.max_videos,
            video_saving_frequency_reduction=(
                args.video_saving_frequency_reduction),
            merging_method=args.merging_method,
            source_videos_dir=args.source_videos_dir,
            overlay_skeletons=args.source_videos_overlay_skeletons,
            overlay_bboxes=args.source_videos_overlay_bboxes,
            overlay_classes=args.source_videos_overlay_classes)
    trainer = Trainer(flow, dm, config, video_logger=video_logger)
    dm.prepare_data()
    dm.setup(args.mode)

    results: Dict[str, Any] = {"trainer": trainer, "flow": flow, "dm": dm}
    if args.pretrained_backbone_path:
        # before any checkpoint, which then wins
        trainer.restore_pretrained_backbone(args.pretrained_backbone_path)
    if args.ckpt_path:
        ckpt_path = resolve_ckpt_path(args.ckpt_path)
        if is_reference_checkpoint(ckpt_path):
            trainer.restore_torch(ckpt_path, args.movements_model_name)
        else:
            trainer.restore(ckpt_path,
                            weights_only=(args.mode != "train"))
    if args.mode in ("train", "tune"):
        if args.profile:
            with device_trace(os.path.join(trainer.log_dir, "trace"),
                              device=trainer.device), timed("Trainer.fit"):
                trainer.fit()
            print_timing()
        else:
            trainer.fit()
        results["val_metrics"] = trainer.evaluate(
            "val", config.limit_val_batches)
    elif args.mode == "test":
        results["test_metrics"] = trainer.test()
    elif args.mode == "predict":
        results["predictions"] = {set_name: trainer.predict(set_name)
                                  for set_name in args.predict_sets}
    else:  # export: the (restored) weights baked into a serving artifact
        trainer._init_state()
        inputs, _, meta = next(iter(dm.val_batches()), None) \
            or next(iter(dm.train_batches(args.seed)))
        path = os.path.join(trainer.log_dir, "exported", "model.pt2")
        results["export_path"] = export_inference(
            flow, trainer.state.params, inputs, meta["age_gender_idx"],
            path,
            output_keys=tuple(args.export_keys) if args.export_keys else None,
            polymorphic_batch=args.export_polymorphic_batch)
        print(f"exported inference artifact: {path}")
    return results


def run():
    """The CLI: ``main`` of the command line, then the run's scalar
    validation (or test) metrics printed, so that a captured output (the
    files of ``compare.py``) holds the results."""
    results = main()
    for stage in ("val", "test"):
        metrics = {k: v for k, v in results.get(f"{stage}_metrics",
                                                {}).items()
                   if isinstance(v, float)}
        if metrics:
            print_metrics(metrics, header=f"{stage} metrics:")

"""Movements models: the JAX package's registry of 22, in the same order
(``models/movements/__init__.py`` there)."""
from .baseline_3d_pose import Baseline3DPose, Baseline3DPoseRot
from .linear import Linear
from .linear_ae import (LinearAE, LinearAE2D, LinearAEResidual,
                        LinearAEResidualLeaky)
from .lstm import LSTM
from .pose_former import PoseFormer, PoseFormerRot
from .seq2seq import (Seq2Seq, Seq2SeqEmbeddings, Seq2SeqFlatEmbeddings,
                      Seq2SeqResidualA, Seq2SeqResidualB, Seq2SeqResidualC)
from .spatial_gnn import GNNLinearAutoencoder, SpatialGnn, VariationalGcn
from .transformers import SimpleTransformer
from .video_pose_3d import VideoPose3D
from .zero import ZeroMovements

MOVEMENTS_MODELS = {
    m.__name__: m for m in [
        ZeroMovements, Linear, LSTM, LinearAE, LinearAE2D,
        LinearAEResidual, LinearAEResidualLeaky,
        Seq2Seq, Seq2SeqEmbeddings, Seq2SeqFlatEmbeddings,
        Seq2SeqResidualA, Seq2SeqResidualB, Seq2SeqResidualC,
        Baseline3DPose, Baseline3DPoseRot,
        PoseFormer, PoseFormerRot, VideoPose3D,
        SimpleTransformer, SpatialGnn, GNNLinearAutoencoder, VariationalGcn,
    ]
}

"""Movements models: ``ZeroMovements``, ``Linear``, ``LSTM``,
``LinearAE``, the Seq2Seq family and ``PoseFormer`` / ``PoseFormerRot``
so far."""
from .linear import Linear
from .linear_ae import LinearAE
from .lstm import LSTM
from .pose_former import PoseFormer, PoseFormerRot
from .seq2seq import (Seq2Seq, Seq2SeqEmbeddings, Seq2SeqFlatEmbeddings,
                      Seq2SeqResidualA, Seq2SeqResidualB, Seq2SeqResidualC)
from .zero import ZeroMovements

MOVEMENTS_MODELS = {
    m.__name__: m for m in [
        ZeroMovements, Linear, LSTM, LinearAE,
        Seq2Seq, Seq2SeqEmbeddings, Seq2SeqFlatEmbeddings,
        Seq2SeqResidualA, Seq2SeqResidualB, Seq2SeqResidualC,
        PoseFormer, PoseFormerRot,
    ]
}

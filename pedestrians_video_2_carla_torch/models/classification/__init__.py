"""Crossing/action classification models (reference
``modules/classification/``): the dense-adjacency graph-recurrent family and
the LSTM / GRU classifiers. ``GCNBestPaper`` and ``GCNBestPaperTransformer``
are not ported yet (see ``ROADMAP.md``)."""
from .common import ClassificationModel
from .gnn import DCRNN, GConvGRU, GConvLSTM, SpatialTemporalGNN, TGCN
from .recurrent import GRU, LSTM

CLASSIFICATION_MODELS = {
    "GConvLSTM": GConvLSTM,
    "DCRNN": DCRNN,
    "TGCN": TGCN,
    "GConvGRU": GConvGRU,
    "LSTM": LSTM,
    "GRU": GRU,
    "SpatialTemporalGNN": SpatialTemporalGNN,
}

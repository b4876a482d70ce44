"""Crossing/action classification models (reference
``modules/classification/``): the dense-adjacency graph-recurrent family, the
LSTM / GRU classifiers and the two GCN classifiers."""
from .common import ClassificationModel
from .gnn import (DCRNN, GCNBestPaper, GCNBestPaperTransformer, GConvGRU,
                  GConvLSTM, SpatialTemporalGNN, TGCN)
from .recurrent import GRU, LSTM

CLASSIFICATION_MODELS = {
    "GConvLSTM": GConvLSTM,
    "DCRNN": DCRNN,
    "TGCN": TGCN,
    "GConvGRU": GConvGRU,
    "LSTM": LSTM,
    "GRU": GRU,
    "GCNBestPaper": GCNBestPaper,
    "GCNBestPaperTransformer": GCNBestPaperTransformer,
    "SpatialTemporalGNN": SpatialTemporalGNN,
}

"""Movements models (``LinearAE`` so far)."""
from .linear_ae import LinearAE

MOVEMENTS_MODELS = {m.__name__: m for m in [LinearAE]}

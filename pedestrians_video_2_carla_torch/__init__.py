"""PyTorch + CUDA port of the JAX/TPU package of this repository.

The layout mirrors the JAX package module for module, so each counterpart
sits at the same relative path. The port imports ``torch`` and ``numpy``
only; it keeps its own copies of the skeleton data and of every helper it
needs. Entry points (flow constructors, datamodules, ``make_inference_fn``)
run on the CUDA device unless the caller passes ``device="cpu"``.
"""

"""graphblas_tpu_torch: the PyTorch + CUDA port of graphblas_tpu.

This slice carries the SpMV loop path: a graph is analyzed once into an
``ops.fastspmv.SpmvPlan``, then ``models.fast`` runs PageRank, level BFS and
SSSP on it.  On CUDA tensors the path runs through the hand-written Hopper
kernels of ``kernels`` (built with nvcc on first use); on CPU tensors it runs
their plain PyTorch versions.  The package imports torch and numpy only.
"""

from . import kernels, models, ops

__all__ = ["kernels", "models", "ops"]

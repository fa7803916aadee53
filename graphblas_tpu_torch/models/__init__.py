"""Counterpart of ``graphblas_tpu/models``: the graph container and the
loop-layout algorithms of ``models/fast.py``."""

from . import fast
from .graph import Graph, rmat

__all__ = ["Graph", "fast", "rmat"]

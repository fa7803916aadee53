"""Counterpart of ``graphblas_tpu/models``: the graph container, the generic
models over the edge-wise ops (``bfs_level``, ``bfs_parent``, ``sssp``,
``pagerank``, ``connected_components``) and the loop-layout algorithms of
``models/fast.py``.  The SpGEMM models (triangle, louvain, ktruss,
centrality, matching) are ROADMAP.md's queue 6."""

from . import fast
from .bfs import bfs_level, bfs_parent
from .fastsv import connected_components
from .graph import Graph, rmat
from .pagerank import pagerank
from .sssp import sssp

__all__ = ["Graph", "bfs_level", "bfs_parent", "connected_components", "fast", "pagerank", "rmat", "sssp"]

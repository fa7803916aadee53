"""Counterpart of ``graphblas_tpu/models``: the graph container, the generic
models over the edge-wise ops (``bfs_level``, ``bfs_parent``, ``sssp``,
``pagerank``, ``connected_components``), the dense n x n models
(``triangle_count``, ``louvain``, ``betweenness_centrality``, ``k_truss``,
``maximal_matching``: f32 indicator matmuls with TF32 off, and scatter-max
rounds), the loop-layout algorithms of ``models/fast.py`` and the compiled
DSL recipes of ``models/dsl.py``."""

from . import dsl, fast
from .bfs import bfs_level, bfs_parent
from .centrality import betweenness_centrality
from .fastsv import connected_components
from .graph import Graph, rmat
from .ktruss import k_truss
from .louvain import louvain
from .matching import maximal_matching
from .pagerank import pagerank
from .sssp import sssp
from .triangle import triangle_count

__all__ = [
    "Graph",
    "betweenness_centrality",
    "bfs_level",
    "bfs_parent",
    "connected_components",
    "dsl",
    "fast",
    "k_truss",
    "louvain",
    "maximal_matching",
    "pagerank",
    "rmat",
    "sssp",
    "triangle_count",
]

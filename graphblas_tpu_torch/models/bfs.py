"""Level and parent BFS over the edge-wise ops.

Counterpart of ``graphblas_tpu/models/bfs.py`` (the recipes of the level BFS,
``w(~visited.S, replace) << A.T.mxv(frontier, any_pair)``, and the parent
BFS over any_secondi).  The reference's ``lax.while_loop`` is an eager loop
here: each level is one O(E) edge-wise SpMV and a few vector ops, and each
round ends on one device flag read (``frontier.any()``); the stop condition
is the reference's, ``frontier.any() & (depth < n)``.
"""

import torch

from ..ops import edgewise as _ew
from .graph import Graph


def _bfs_loop(graph, source, step, init):
    n = graph.n
    dev = graph.src.device
    state = torch.full((n,), -1, dtype=torch.int32, device=dev)
    state[source] = init
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source] = True
    depth = 0
    while depth < n and bool(frontier.any()):
        state, frontier = step(state, frontier, depth)
        depth += 1
    return state


def bfs_level(graph, source, *, as_vector=False):
    """BFS levels from ``source``; -1 (absent) = unreachable.  Level of the
    source is 0."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    src, dst, valid, n = graph.src, graph.dst, graph.valid, graph.n

    def step(levels, frontier, depth):
        # w(~visited.S, replace) << A.T.mxv(frontier, any_pair), fused
        reached = _ew.spmv_any_reach(src, dst, valid, frontier, n)
        nxt = reached & (levels < 0)
        return torch.where(nxt, torch.full_like(levels, depth + 1), levels), nxt

    levels = _bfs_loop(graph, int(source), step, 0)
    return _levels_to_vector(levels) if as_vector else levels


def bfs_parent(graph, source, *, as_vector=False):
    """BFS parent tree from ``source``; parent of source is itself; -1 =
    unreachable."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    src, dst, valid, n = graph.src, graph.dst, graph.valid, graph.n

    def step(parents, frontier, depth):
        # v(~visited.S, replace) << A.T.mxv(frontier, any_secondi), fused
        cand = _ew.spmv_any_parent(src, dst, valid, frontier, n)
        nxt = (cand >= 0) & (parents < 0)
        return torch.where(nxt, cand, parents), nxt

    parents = _bfs_loop(graph, int(source), step, int(source))
    return _levels_to_vector(parents) if as_vector else parents


def _levels_to_vector(levels):
    from ..core import dtypes as _dt
    from ..core.vector import Vector

    it = _dt.default_int()
    return Vector._from_arrays(_dt.cast(levels, _dt.INT32, it), levels >= 0, it)

"""Betweenness centrality: batch Brandes as dense matmul sweeps.

Counterpart of ``graphblas_tpu/models/centrality.py``: a forward sweep
accumulates shortest-path counts level by level, a backward sweep
accumulates dependencies, and every step is an ``(ns, n) @ (n, n)`` f32
product (TF32 off, ``ops.mxm.full_f32_matmul``).  The reference's two
``lax.scan``s are Python loops of ``max_levels`` steps; the forward loop
stacks the frontiers for the backward one.
"""

import numpy as np
import torch

from ..ops.mxm import full_f32_matmul
from .graph import Graph, edge_index


def _bc_sweeps(a, sources_onehot, max_levels):
    """a: (n, n) f32 adjacency (a[i, j] = 1 for edge i->j).
    sources_onehot: (ns, n) f32 one-hot rows."""
    with full_f32_matmul():
        paths, frontier = sources_onehot, sources_onehot
        stack = []
        for _ in range(max_levels):
            nxt = (frontier @ a) * (paths == 0)
            paths, frontier = paths + nxt, nxt
            stack.append(nxt)
        # stack[d] = frontier at depth d+1; the sources are depth 0
        prev = [sources_onehot, *stack[:-1]]
        safe_paths = torch.where(paths > 0, paths, 1.0)
        bcu = torch.zeros_like(paths)
        for fr, fprev in zip(reversed(stack), reversed(prev)):
            t2 = torch.where(fr > 0, (1.0 + bcu) / safe_paths, 0.0)
            t4 = torch.where(fprev > 0, (t2 @ a.T) * paths, 0.0)
            bcu = bcu + t4
    # Brandes never adds a source's dependency to its own score
    bcu = torch.where(sources_onehot > 0, 0.0, bcu)
    return bcu.sum(dim=0)


def betweenness_centrality(graph, sources=None, *, max_levels=None):
    """Unnormalized betweenness centrality (directed; pass a symmetrized
    graph and halve for the undirected convention).

    ``sources`` restricts the batch to a sample of source vertices
    (approximate BC); default is all vertices (exact).  ``max_levels``
    bounds the sweep depth (default ``n - 1``; lower it to the graph's
    diameter to skip dead matmul steps).
    """
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    n = graph.n
    src, dst = edge_index(graph)
    dev = src.device
    a = torch.zeros((n, n), dtype=torch.float32, device=dev)
    a[src, dst] = 1.0
    a.fill_diagonal_(0.0)
    if sources is None:
        onehot = torch.eye(n, dtype=torch.float32, device=dev)
    else:
        sources = torch.from_numpy(np.asarray(sources, np.int64)).to(dev)
        onehot = torch.zeros((len(sources), n), dtype=torch.float32, device=dev)
        onehot[torch.arange(len(sources), device=dev), sources] = 1.0
    if max_levels is None:
        max_levels = max(n - 1, 1)
    return _bc_sweeps(a, onehot, int(max_levels))

"""Triangle counting: a blocked indicator matmul, tc = sum over the edges
(i, j) of L of (L @ L^T)[i, j].

Counterpart of ``graphblas_tpu/models/triangle.py``.  As the reference, each
block of L's int8 rows goes against ``L^T`` in int32
(``ops.mxm.indicator_counts``: ``torch._int_mm``), and the masked block sums
in int64.  The block loop keeps live memory at O(n x 1024) beside L.
"""

import torch

from ..ops.mxm import indicator_counts
from .graph import Graph, edge_index

_BLOCK = 1024


def _tc_blocked(ls, nblocks):
    """ls: (n, n) int8 lower-triangular struct (padded to nblocks*_BLOCK rows)."""
    total = torch.zeros((), dtype=torch.int64, device=ls.device)
    for i in range(nblocks):
        block = ls[i * _BLOCK : (i + 1) * _BLOCK]
        # wedges[b, j] = |N_L(row b) ∩ N_L(j)|, counted only where (row, j) is in L
        total += torch.sum(indicator_counts(block, ls.T) * block, dtype=torch.int64)
    return total


def triangle_count(graph):
    """Count undirected triangles.  Self-loops ignored; edges deduplicated."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    n = graph.n
    src, dst = edge_index(graph)
    # L: strictly-lower-triangular undirected struct, built on the device
    lo = torch.minimum(src, dst)
    hi = torch.maximum(src, dst)
    npad = -(-n // _BLOCK) * _BLOCK
    ls = torch.zeros((npad, npad), dtype=torch.int8, device=src.device)
    ls[hi, lo] = 1  # row > col: strictly lower; self-loops and padding land on the diagonal
    ls.diagonal().zero_()
    return int(_tc_blocked(ls, npad // _BLOCK))

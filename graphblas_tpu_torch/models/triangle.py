"""Triangle counting: a blocked indicator matmul, tc = sum over the edges
(i, j) of L of (L @ L^T)[i, j].

Counterpart of ``graphblas_tpu/models/triangle.py``.  The reference runs the
blocks in int32 on the MXU; torch has no integer GEMM on CUDA, so each block
is an f32 matmul of 0/1 indicators with TF32 off (``ops.mxm.full_f32_matmul``),
exact while every count is below 2^24, and the masked block sums in int64.
The block loop keeps live memory at O(n x 1024) beside L.
"""

import torch

from ..ops.mxm import full_f32_matmul
from .graph import Graph, edge_index

_BLOCK = 1024


def _tc_blocked(ls, nblocks):
    """ls: (n, n) int8 lower-triangular struct (padded to nblocks*_BLOCK rows)."""
    lf = ls.to(torch.float32)
    total = torch.zeros((), dtype=torch.int64, device=ls.device)
    with full_f32_matmul():
        for i in range(nblocks):
            block = lf[i * _BLOCK : (i + 1) * _BLOCK]
            # wedges[b, j] = |N_L(row b) ∩ N_L(j)|, counted only where (row, j) is in L
            total += torch.sum((block @ lf.T) * block, dtype=torch.int64)
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

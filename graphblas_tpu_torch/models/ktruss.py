"""k-truss: iterated masked support counting.

Counterpart of ``graphblas_tpu/models/ktruss.py``: support(e) = triangles
through e = ``(A @ A) .* A``; drop edges with support < k-2; repeat to
fixpoint.  The reference keeps A in int32; here it is an f32 0/1 indicator
matrix and the product runs with TF32 off (``ops.mxm.full_f32_matmul``),
exact while every support is below 2^24.  The reference's ``while_loop`` is
an eager loop that reads its ``changed`` flag once a round.
"""

import torch

from ..ops.mxm import full_f32_matmul
from .graph import Graph, _padded, edge_index

last_rounds = None  # diagnostic: the support products the last fixpoint ran


def _ktruss_fixpoint(a0, k):
    """a0: (n, n) f32 symmetric 0/1 adjacency, zero diagonal."""
    global last_rounds
    a = a0
    rounds = 0
    with full_f32_matmul():
        while True:
            support = (a @ a) * a
            a2 = torch.where(support >= k - 2, a, 0.0)
            changed = bool((a2 != a).any())
            a = a2
            rounds += 1
            if not changed:
                last_rounds = rounds
                return a


def k_truss(graph, k):
    """Maximal subgraph where every edge is in >= k-2 triangles.

    The input is symmetrized (treated as undirected) and self-loops are
    dropped.  Returns a new undirected ``Graph`` (both edge directions
    present) of the surviving edges, on the input's device.
    """
    if k < 3:
        raise ValueError(f"k must be >= 3 for a k-truss; got {k}")
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    n = graph.n
    src, dst = edge_index(graph)
    a = torch.zeros((n, n), dtype=torch.float32, device=src.device)
    a[src, dst] = 1.0
    a = torch.maximum(a, a.T)
    a.fill_diagonal_(0.0)
    rr, cc = torch.nonzero(_ktruss_fixpoint(a, int(k)), as_tuple=True)  # row-major, as np.nonzero
    return _padded(rr, cc, n)

"""PageRank: plus_first SpMV + plus reduce + apply per iteration.

Counterpart of ``graphblas_tpu/models/pagerank.py``.  The reference's
``lax.while_loop`` is an eager loop over the O(E) edge-wise sum and O(n)
vector ops, in float32 as the reference computes; each round ends on one
device flag read (``delta > tol``), and the stop condition is the
reference's, ``(delta > tol) & (it < max_iters)``.
"""

import torch

from ..ops import edgewise as _ew
from .graph import Graph


def pagerank(graph, *, damping=0.85, tol=1e-6, max_iters=100, as_vector=False):
    """PageRank scores (sum to 1)."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    n, dev = graph.n, graph.src.device
    f32 = dict(dtype=torch.float32, device=dev)
    outdeg = _ew.degrees(graph.src, graph.valid, n)
    safe_deg = torch.where(outdeg > 0, outdeg, 1).to(torch.float32)
    dangling = outdeg == 0
    d = torch.tensor(damping, **f32)
    tol = torch.tensor(tol, **f32)
    teleport = (1.0 - d) / n
    r = torch.full((n,), 1.0 / n, **f32)
    it = 0
    while it < int(max_iters):
        contrib = r / safe_deg
        # w << A.T.mxv(r / outdeg, plus_times) via the edge-wise sum
        pulled = _ew.spmv_plus_first(graph.src, graph.dst, graph.valid, contrib, n)
        dangling_mass = torch.where(dangling, r, torch.zeros((), **f32)).sum()
        new_r = teleport + d * (pulled + dangling_mass / n)
        delta = (new_r - r).abs().sum()
        r = new_r
        it += 1
        if not bool(delta > tol):
            break
    if as_vector:
        from ..core import dtypes as _dt
        from ..core.vector import Vector

        ft = _dt.default_float()
        return Vector._from_arrays(_dt.cast(r, _dt.FP32, ft), torch.ones(n, dtype=torch.bool, device=dev), ft)
    return r

"""Single-source shortest paths (Bellman-Ford over the min_plus semiring).

Counterpart of ``graphblas_tpu/models/sssp.py``: the recipe
``dist(accum=binary.min) << A.T.mxv(dist, semiring.min_plus)`` iterated to a
fixed point over the O(E) edge-wise min_plus.  The reference's
``lax.while_loop`` is an eager loop; each round ends on one device flag read
(``changed``), and the stop condition is the reference's,
``changed & (it < n)``.
"""

import torch

from ..ops import edgewise as _ew
from .graph import Graph

_BIG = float(torch.tensor(3.4e38, dtype=torch.float32) / 4)  # float32, as the reference's


def sssp(graph, source, *, as_vector=False):
    """Shortest-path distances from ``source``; unreachable nodes absent
    (``_BIG`` in the plain tensor)."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    if graph.weights is None:
        raise ValueError("sssp requires an edge-weighted graph")
    n = graph.n
    dist = torch.full((n,), _BIG, dtype=torch.float32, device=graph.src.device)
    dist[int(source)] = 0.0
    it = 0
    while it < n:
        relaxed = _ew.spmv_min_plus(graph.src, graph.dst, graph.weights, graph.valid, dist, n, big=_BIG)
        # dist(accum=min) << relaxed
        new_dist = torch.minimum(dist, relaxed)
        changed = bool((new_dist < dist).any())
        dist = new_dist
        it += 1
        if not changed:
            break
    if as_vector:
        from ..core import dtypes as _dt
        from ..core.vector import Vector

        ft = _dt.default_float()
        present = dist < _BIG
        vals = torch.where(present, dist, torch.zeros((), dtype=dist.dtype, device=dist.device))
        return Vector._from_arrays(_dt.cast(vals, _dt.FP32, ft), present, ft)
    return dist

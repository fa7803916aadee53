"""Connected components: FastSV.

Counterpart of ``graphblas_tpu/models/fastsv.py`` (min_second SpMV +
assign/extract hot loop).  The hooking step's scatter-min is a
``scatter_reduce_`` into a copy of the parent vector.  The reference's two
``lax.while_loop``s are eager loops; each round ends on one device flag read
(``changed``), and the stop conditions are the reference's.
"""

import torch

from ..ops import edgewise as _ew
from .graph import Graph


def connected_components(graph, *, as_vector=False):
    """Component label (minimum node id in component) per node."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    src, dst, valid, n = graph.src, graph.dst, graph.valid, graph.n
    f = torch.arange(n, dtype=torch.int32, device=src.device)
    it = 0
    while it < n:
        gp = f[f.long()]  # grandparents
        # mngp[j] = min over edges (i->j) of gp[i] (min_second mxv), symmetrized
        mngp = torch.minimum(
            _ew.spmv_min_second(src, dst, valid, gp, n, big=n), _ew.spmv_min_second(dst, src, valid, gp, n, big=n)
        )
        mngp = torch.minimum(mngp, gp)
        # hooking: f[f[j]] = min(f[f[j]], mngp[j]) (scatter-min assign)
        f1 = f.clone().scatter_reduce_(0, f.long(), mngp, "amin")
        # shortcut: f = f[f]
        f2 = torch.minimum(f1[f1.long()], f1)
        changed = bool((f2 != f).any())
        f = f2
        it += 1
        if not changed:
            break
    # final full shortcut to a fixed point
    while True:
        nf = f[f.long()]
        changed = bool((nf != f).any())
        f = nf
        if not changed:
            break
    if as_vector:
        from ..core import dtypes as _dt
        from ..core.vector import Vector

        it_t = _dt.default_int()
        return Vector._from_arrays(_dt.cast(f, _dt.INT32, it_t), torch.ones(n, dtype=torch.bool, device=f.device), it_t)
    return f

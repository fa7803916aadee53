"""Maximal matching: parallel local-max (Luby-style) rounds.

Counterpart of ``graphblas_tpu/models/matching.py``: every edge gets a random
priority; an edge joins the matching when it holds the maximum priority
among all edges incident to both endpoints; matched vertices drop out;
repeat to fixpoint.  Each round is two O(E) scatter-max passes
(``scatter_reduce_(..., "amax")`` for ``.at[].max``) and elementwise masks
over the padded edge arrays; the ``mode="drop"`` sets at index n write into
an (n + 1)-slot buffer.  The reference's ``while_loop`` is an eager loop
that reads its ``live.any()`` flag once a round.
"""

import numpy as np
import torch

from .graph import Graph

last_rounds = None  # diagnostic: the rounds the last matching ran


def _matching_loop(src, dst, valid, prio, n):
    global last_rounds
    e = src.shape[0]
    dev = src.device
    s, d = src.long(), dst.long()
    matched = torch.zeros(e, dtype=torch.bool, device=dev)
    used = torch.zeros(n + 1, dtype=torch.bool, device=dev)  # slot n: the dropped writes
    live = valid & (src != dst)
    drop = torch.full((), n, dtype=torch.int64, device=dev)
    ninf = torch.full((), float("-inf"), dtype=prio.dtype, device=dev)
    rounds = 0
    while bool(live.any()):
        rounds += 1
        p = torch.where(live, prio, ninf)
        vmax = torch.full((n,), float("-inf"), dtype=prio.dtype, device=dev)
        vmax.scatter_reduce_(0, s, p, "amax").scatter_reduce_(0, d, p, "amax")
        win = live & (p == vmax[s]) & (p == vmax[d])
        matched |= win
        used[torch.where(win, s, drop)] = True
        used[torch.where(win, d, drop)] = True
        live = live & ~used[s] & ~used[d]
    last_rounds = rounds
    return matched, used[:n]


def maximal_matching(graph, *, seed=0):
    """Maximal (not maximum) matching of the undirected view of ``graph``.

    Returns a boolean mask over the graph's padded edge arrays: True where
    that edge is in the matching.  Every vertex appears in at most one
    matched edge, and no unmatched edge has both endpoints free (maximality).
    ``seed`` picks the random edge priorities; ties are broken by edge index
    so priorities are strictly ordered.
    """
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    e = int(graph.src.shape[0])
    rng = np.random.default_rng(seed)
    # random strict total order on edges (permutation -> no ties), the
    # reference's float32 priorities
    prio = torch.from_numpy(rng.permutation(e).astype(np.float32)).to(graph.src.device)
    matched, _ = _matching_loop(graph.src, graph.dst, graph.valid, prio, graph.n)
    return matched

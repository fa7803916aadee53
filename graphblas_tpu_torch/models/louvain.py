"""Louvain community detection (synchronous modularity-gain label moving).

Counterpart of ``graphblas_tpu/models/louvain.py``.  Communities are a
one-hot assignment matrix, so the per-iteration "gain of moving node i to
community c" is one dense f32 matmul (TF32 off, ``ops.mxm.full_f32_matmul``):

    gain[i, c] = (A @ C)[i, c] - k_i * (k @ C)[c] / 2m

Dense in n x n, as the reference: n up to ~16k on one card.  The
reference's ``while_loop`` is an eager loop that reads its ``changed`` flag
once an iteration; ``argmax`` takes the first maximum, as ``jnp.argmax``.
"""

import torch

from ..ops.mxm import full_f32_matmul
from .graph import Graph, edge_index

last_iters = None  # diagnostic: the iterations the last run made


def _louvain_loop(adj, k, two_m, n, max_iters):
    global last_iters
    dev = adj.device
    rows = torch.arange(n, device=dev)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    it = 0
    changed = True
    with full_f32_matmul():
        while changed and it < max_iters:
            lab = labels.long()
            onehot = torch.zeros((n, n), dtype=torch.float32, device=dev)
            onehot[rows, lab] = 1.0  # (n, n) C
            w_to_comm = adj @ onehot  # (n, n): weight from i to community c
            comm_deg = k @ onehot  # (n,): total degree per community
            gain = w_to_comm - k[:, None] * comm_deg[None, :] / two_m
            # moving to own community must compare against (comm minus self)
            gain[rows, lab] = w_to_comm[rows, lab] - k * (comm_deg[lab] - k) / two_m
            new_labels = torch.argmax(gain, dim=1).to(torch.int32)
            changed = bool((new_labels != labels).any())
            labels = new_labels
            it += 1
    last_iters = it
    return labels


def modularity(adj, labels, two_m):
    """Q = (1/2m) * sum_ij (A_ij - k_i k_j / 2m) [c_i == c_j]."""
    k = adj.sum(dim=1)
    same = labels[:, None] == labels[None, :]
    return torch.where(same, adj - k[:, None] * k[None, :] / two_m, 0.0).sum() / two_m


def louvain(graph, *, max_iters=50, as_vector=False):
    """One-level Louvain labels (undirected view of the graph)."""
    if not isinstance(graph, Graph):
        graph = Graph.from_matrix(graph)
    n = graph.n
    src, dst = edge_index(graph)
    dev = src.device
    if graph.weights is not None:
        w = torch.where(graph.valid, graph.weights.to(torch.float32), 0.0)
    else:
        w = graph.valid.to(torch.float32)
    adj = torch.zeros((n, n), dtype=torch.float32, device=dev)
    adj.index_put_((src, dst), w, accumulate=True)
    adj.index_put_((dst, src), w, accumulate=True)  # symmetrize
    adj.fill_diagonal_(0.0)
    k = adj.sum(dim=1)
    two_m = torch.clamp(k.sum(), min=1.0)
    labels = _louvain_loop(adj, k, two_m, n, int(max_iters))
    if as_vector:
        from ..core import dtypes as _dt
        from ..core.vector import Vector

        it = _dt.default_int()
        return Vector._from_arrays(_dt.cast(labels, _dt.INT32, it), torch.ones(n, dtype=torch.bool, device=dev), it)
    return labels

"""Bellman-Ford SSSP in plain torch, in float64: the reference of ``algorithms/sssp.py``.

From the root, every round relaxes every entry (i, j) as
dist[i] = min(dist[i], dist[j] + w) until a round changes nothing, so the
distances are the exact shortest paths over the float32 weights.  With
``store`` (the control) distances and weights are held in that type.
"""

import torch

from . import blocks, rounded


def distances(rows, cols, w, n, root, store=None):
    acc = torch.float64 if store is None else torch.float32
    w = rounded(w.to(acc), store)
    dist = torch.full((n,), float("inf"), dtype=acc, device=rows.device)
    dist[root] = 0.0
    while True:
        relaxed = torch.full((n,), float("inf"), dtype=acc, device=rows.device)
        for lo, hi in blocks(rows.numel()):
            cand = rounded(dist[cols[lo:hi]] + w[lo:hi], store)
            relaxed.scatter_reduce_(0, rows[lo:hi], cand, "amin")
        new = torch.minimum(dist, relaxed)
        if torch.equal(new, dist):
            return dist
        dist = new


def answer(rows, cols, w, n, root, store):
    """The reference's own distances from ``root`` (the control: ``store`` set)."""
    return distances(rows, cols, w, n, root, store).double().cpu().numpy()


def gap(got, ref):
    """The widest gap between a trial's distances and the reference's, as a
    share of the largest finite reference distance; infinite where the two
    disagree on which vertices are reached."""
    got = torch.as_tensor(got).to(ref.device, torch.float64)
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    scale = float(ref[fin].max())
    return float((got[fin] - ref[fin]).abs().max()) / (scale if scale > 0 else 1.0)


def check(graph, params, results):
    """``dist_err`` of each judged trial: its ``gap`` against the float64
    reference from its own root."""
    rows, cols, w, n = graph["rows"], graph["cols"], graph["w"], graph["n"]
    refs, out = {}, []
    for dist, _, root in results:
        if root not in refs:
            refs[root] = distances(rows, cols, w, n, root)
        out.append({"dist_err": gap(dist, refs[root])})
    return out

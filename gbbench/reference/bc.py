"""Betweenness centrality in plain torch, in float64: the reference of ``algorithms/bc.py``.

Brandes (2001), level-synchronous from each source of a batch (a column
each) over the COO: the forward sweep counts shortest paths level by level
(``index_add_`` over the entries whose source is on the level, in blocks),
the backward sweep accumulates each vertex's dependency
delta(v) = sigma(v) * sum over neighbours w one level deeper of
(1 + delta(w)) / sigma(w), and a vertex's score is the sum of its
dependencies over the sources, its own source's left out.  Unnormalised, as
the recipe.  With ``store`` (the control) the path counts and dependencies
are held in that type.
"""

import torch

from . import blocks

# float32 matrix products stay in float32 on the card (no TF32): the
# reference multiplies nothing by a matrix, but holds to the rule
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _pull(rows, cols, n, values, on_level):
    """y[i] = sum over entries (i, j) with j on the level of values[j], per
    column."""
    y = torch.zeros((n, values.shape[1]), dtype=values.dtype, device=values.device)
    for lo, hi in blocks(rows.numel()):
        j = cols[lo:hi]
        y.index_add_(0, rows[lo:hi], torch.where(on_level[j], values[j], torch.zeros((), dtype=values.dtype)))
    return y


def brandes(rows, cols, n, sources, store=None):
    """(scores (n,) float64, deepest level) of a batch of sources."""
    dt = torch.float64 if store is None else store
    dev = rows.device
    k = len(sources)
    src = torch.as_tensor(list(sources), device=dev)
    col = torch.arange(k, device=dev)
    level = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    sigma = torch.zeros((n, k), dtype=dt, device=dev)
    level[src, col] = 0
    sigma[src, col] = 1.0
    depth = 0
    while True:
        paths = _pull(rows, cols, n, sigma, level == depth)
        new = (level < 0) & (paths > 0)
        if not bool(new.any()):
            break
        depth += 1
        level[new] = depth
        sigma = torch.where(new, paths, sigma)
    delta = torch.zeros((n, k), dtype=dt, device=dev)
    for d in range(depth, 1, -1):
        coef = torch.where(level == d, (1.0 + delta) / torch.where(level == d, sigma, 1.0), 0.0).to(dt)
        pulled = _pull(rows, cols, n, coef, level == d)
        delta = torch.where(level == d - 1, sigma * pulled, delta).to(dt)
    scores = torch.where(level > 0, delta, torch.zeros((), dtype=dt, device=dev)).double().sum(1)
    return scores, depth


def check(graph, params, results):
    """``bc_err`` (the widest gap of a vertex's score against the float64
    reference, over the largest reference score) and ``levels_off`` (the
    deepest level against the reference's) of each judged trial."""
    rows, cols, n = graph["rows"], graph["cols"], graph["n"]
    refs, out = {}, []
    for (scores, deepest), _, batch in results:
        if batch not in refs:
            refs[batch] = brandes(rows, cols, n, batch)
        ref, depth = refs[batch]
        got = torch.as_tensor(scores).to(ref.device, torch.float64)
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max()) / (scale if scale > 0 else 1.0)
        out.append({"bc_err": err, "levels_off": float(abs(int(deepest) - depth))})
    return out

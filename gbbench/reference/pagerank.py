"""GAP PageRank in plain torch, in float64: the reference of ``algorithms/pagerank.py``.

The same mathematics as ``pr.cc``: r0 = 1/n; each iteration
r_new[i] = (1 - d) / n + d * sum over entries (i, j) of r[j] / outdeg(j); stop
when sum |r_new - r| < tol or after max_iters iterations.  With ``store`` (the
control) the ranks and contributions are held in that type and the sums
accumulate in float32.
"""

import torch

from . import blocks, rounded


def iterate(rows, cols, n, params, *, upto, store=None):
    """(ranks after ``upto`` iterations, the iteration at which the reference's
    own stopping rule stops, the L1 change of each iteration).  ``rows`` and
    ``cols`` are int64 tensors of the COO, edge cols[k] -> rows[k]."""
    d, tol, max_iters = float(params["damping"]), float(params["tol"]), int(params["max_iters"])
    acc = torch.float64 if store is None else torch.float32
    outdeg = torch.bincount(cols, minlength=n).to(acc)
    inv = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1), torch.zeros((), dtype=acc, device=outdeg.device))
    r = rounded(torch.full((n,), 1.0 / n, dtype=acc, device=rows.device), store)
    kept, stop, errs = None, None, []
    for k in range(1, max_iters + 1):
        contrib = rounded(r * inv, store)
        y = torch.zeros(n, dtype=acc, device=rows.device)
        for lo, hi in blocks(rows.numel()):
            y.index_add_(0, rows[lo:hi], contrib[cols[lo:hi]])
        r_new = rounded((1.0 - d) / n + d * y, store)
        errs.append(float((r_new - r).abs().sum()))
        r = r_new
        if k == upto:
            kept = r
        if stop is None and errs[-1] < tol:
            stop = k
        if stop is not None and k >= upto:
            break
    return kept, (stop or max_iters), errs


def answer(rows, cols, n, params, store):
    """The reference's own run (the control: ``store`` set): (ranks,
    iterations), as a trial of the recipe gives them."""
    _, stop, _ = iterate(rows, cols, n, params, upto=0, store=store)
    ranks, _, _ = iterate(rows, cols, n, params, upto=stop, store=store)
    return ranks.double().cpu().numpy(), stop


def check(graph, params, results):
    """The numbers that decide ``correct``, one dict a judged trial.

    ``rank_rel_err``: the widest relative gap, over every vertex, between the
    trial's rank and the float64 reference's after as many iterations;
    ``iters_off``: how many iterations the trial ran more or fewer than the
    reference's own stopping rule asks."""
    rows, cols, n = graph["rows"], graph["cols"], graph["n"]
    refs = {}
    out = []
    for ranks, iters, _ in results:
        iters = int(iters)
        if iters not in refs:
            ref, stop, _ = iterate(rows, cols, n, params, upto=iters)
            refs[iters] = (ref.double(), stop)
        ref, stop = refs[iters]
        got = torch.from_numpy(ranks).to(ref.device, torch.float64)
        gap = float(((got - ref).abs() / ref).max())
        out.append({"rank_rel_err": gap if gap == gap else float("inf"), "iters_off": abs(iters - stop)})
    return out

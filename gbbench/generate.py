"""Seeded graphs on the card: Graph500's Kronecker generator and GAP's urand.

A configuration's graph is one instance, as GAP's benchmark graphs are: its
edges, weights and search keys come from the configuration's ``graph_seed``.
A run's ``--seed`` relabels the vertices by a permutation drawn from it (as
Graph500 relabels its Kronecker graph) and draws the order in which the
search keys are taken.  So every seed gives another input of the same work:
an isomorphic graph, in other ids, with the same keys in another order.

Edges: ``edge_factor * 2**scale`` draws, with a ``torch.Generator`` on the
device in a few large calls; then the graph is built as GAP's builder does
for an undirected input: self-loops dropped, each edge stored in both
directions once (duplicates dropped), a weight uniform in [0, 1) as float32
per undirected edge, the same in both directions.  ``kronecker`` is a torch
rewrite of the Graph500 v3 reference generator (initiator A, B, C,
D = 1 - A - B - C, one bit of source and destination a level); ``uniform`` is
GAP's ``UniformDist``, both endpoints uniform in [0, 2**scale).
"""

import torch


def generator(seed, device):
    """A generator on ``device`` seeded with ``seed`` (any non-negative whole
    number; larger ones are folded into 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _kronecker(cfg, g, device):
    scale, m = int(cfg["scale"]), int(cfg["edge_factor"]) << int(cfg["scale"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand((2, m), generator=g, device=device)
        s_bit = r[0] > a + b
        d_bit = r[1] > torch.where(s_bit, c / (1.0 - a - b), a / (a + b))
        src |= s_bit.long() << bit
        dst |= d_bit.long() << bit
    return src, dst


def _uniform(cfg, g, device):
    n, m = 1 << int(cfg["scale"]), int(cfg["edge_factor"]) << int(cfg["scale"])
    ends = torch.randint(0, n, (2, m), generator=g, device=device)
    return ends[0], ends[1]


GENERATORS = {"kronecker": _kronecker, "uniform": _uniform}


def graph(cfg, seed, device, keys=0):
    """(rows, cols, weights, n, roots) of the configuration's graph relabelled
    by ``seed``: int64 row and column ids and float32 weights on ``device``,
    row-major, symmetric, with no self-loop and no duplicate; and ``keys``
    distinct vertices of degree 1 or more (Graph500's search keys), in the
    order that ``seed`` draws."""
    n = 1 << int(cfg["scale"])
    g = generator(cfg["graph_seed"], device)
    u, v = GENERATORS[cfg["generator"]](cfg, g, device)
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    del u, v
    keep = lo != hi
    key = torch.unique(lo[keep] * n + hi[keep])
    del lo, hi, keep
    lo, hi = key // n, key % n
    del key
    w = torch.rand(lo.numel(), generator=g, device=device, dtype=torch.float32)
    roots = torch.empty(0, dtype=torch.int64, device=device)
    if keys:
        cand = torch.nonzero(torch.bincount(torch.cat([lo, hi]), minlength=n) > 0).flatten()
        roots = cand[torch.randperm(cand.numel(), generator=g, device=device)[:keys]]
    run = generator(seed, device)
    perm = torch.randperm(n, generator=run, device=device)
    lo, hi = perm[lo], perm[hi]
    roots = perm[roots][torch.randperm(roots.numel(), generator=run, device=device)]
    rows, cols, w = torch.cat([lo, hi]), torch.cat([hi, lo]), torch.cat([w, w])
    del lo, hi
    order = torch.argsort(rows * n + cols)
    return rows[order], cols[order], w[order], n, roots.cpu().tolist()

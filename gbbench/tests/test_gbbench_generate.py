"""The generators: a seed gives one graph; the graph is symmetric, without
self-loops or duplicates, row-major, with one weight in [0, 1) an undirected
edge; the search keys are distinct vertices of degree 1 or more; and two seeds
give the configuration's one graph in other vertex ids, with the same keys
in another order (the same work)."""

import pytest
import torch

from gbbench import generate, registry

from .conftest import SCALE


def _graph(name, seed, device="cpu"):
    cfg = dict(registry.config(name), scale=SCALE)
    return generate.graph(cfg, seed, device, 64)


@pytest.mark.parametrize("name", ["g500-kron21", "gap-urand21"])
def test_same_seed_same_graph(name):
    a, b = _graph(name, 2**31 + 17), _graph(name, 2**31 + 17)
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    c = _graph(name, 5)
    assert not torch.equal(a[1], c[1]) and a[4] != c[4]


@pytest.mark.parametrize("name", ["g500-kron21", "gap-urand21"])
def test_graph_shape(name):
    rows, cols, w, n, roots = _graph(name, 123456789)
    assert n == 1 << SCALE and rows.numel() > 0
    assert bool((rows != cols).all()), "self-loop"
    key = rows * n + cols
    assert bool((key[1:] > key[:-1]).all()), "not row-major or duplicated"
    # symmetric, with the same weight both ways
    back = torch.argsort(cols * n + rows)
    assert torch.equal(rows[back], cols) and torch.equal(cols[back], rows)
    assert torch.equal(w[back], w)
    assert w.dtype == torch.float32 and bool((w >= 0).all()) and bool((w < 1).all())
    deg = torch.bincount(rows, minlength=n)
    assert len(set(roots)) == len(roots) == min(64, int((deg > 0).sum()))
    assert all(int(deg[r]) > 0 for r in roots)


def _invariants(graph):
    """What a relabelling keeps: each edge as (its weight, the degrees of its
    ends), sorted; and the degrees of the search keys in their order's sort."""
    rows, cols, w, n, roots = graph
    deg = torch.bincount(rows, minlength=n)
    edges = torch.stack([w.double(), deg[rows].double(), deg[cols].double()], 1)
    order = torch.argsort(edges[:, 0] * 4 * n * n + edges[:, 1] * 2 * n + edges[:, 2])
    return edges[order], sorted(int(deg[r]) for r in roots)


@pytest.mark.parametrize("name", ["g500-kron21", "gap-urand21"])
def test_seeds_relabel_one_graph(name):
    a, b = _graph(name, 11), _graph(name, 2**33 + 1)
    assert not torch.equal(a[0], b[0]) and a[4] != b[4]
    ea, ka = _invariants(a)
    eb, kb = _invariants(b)
    assert torch.equal(ea, eb) and ka == kb


def test_kronecker_is_skewed():
    """Graph500's initiator makes hubs and isolated vertices; urand makes
    neither (the two configurations differ in degree skew)."""
    rows_k, _, _, n, _ = _graph("g500-kron21", 99)
    rows_u, _, _, _, _ = _graph("gap-urand21", 99)
    dk, du = torch.bincount(rows_k, minlength=n), torch.bincount(rows_u, minlength=n)
    assert int((dk == 0).sum()) > n // 20 and int((du == 0).sum()) == 0
    assert int(dk.max()) > 3 * int(du.max())


def test_card_generates(card):
    a, b = _graph("g500-kron21", 77, card), _graph("g500-kron21", 77, card)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2]) and a[4] == b[4]

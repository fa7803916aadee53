"""The plain references on graphs small enough to check by hand, and the
control (the reference in bfloat16) coming out not correct."""

import math

import numpy as np
import pytest
import torch

from gbbench import generate, registry
from gbbench.reference import pagerank, sssp

from .conftest import SCALE

PARAMS = {"damping": 0.85, "tol": 1e-4, "max_iters": 20}


def _undirected(edges, weights=None):
    rows, cols, w = [], [], []
    for k, (u, v) in enumerate(edges):
        x = 1.0 if weights is None else weights[k]
        rows += [u, v]
        cols += [v, u]
        w += [x, x]
    return torch.tensor(rows), torch.tensor(cols), torch.tensor(w, dtype=torch.float32)


def test_pagerank_triangle_is_uniform():
    rows, cols, _ = _undirected([(0, 1), (1, 2), (0, 2)])
    ranks, stop, errs = pagerank.iterate(rows, cols, 3, PARAMS, upto=1)
    assert torch.allclose(ranks, torch.full((3,), 1 / 3, dtype=torch.float64))
    assert stop == 1 and errs[0] < 1e-15


def test_pagerank_star_and_isolated_vertex():
    """A star 0-1, 0-2, 0-3 and an isolated vertex 4, one iteration by hand:
    r0 = 1/5; the centre takes 3 x 1/5, a leaf (1/5) / 3; the isolated vertex
    keeps only the teleport (1 - d) / n."""
    rows, cols, _ = _undirected([(0, 1), (0, 2), (0, 3)])
    ranks, _, errs = pagerank.iterate(rows, cols, 5, PARAMS, upto=1)
    base = 0.15 / 5
    want = [base + 0.85 * 3 / 5, base + 0.85 / 15, base + 0.85 / 15, base + 0.85 / 15, base]
    assert np.allclose(ranks.numpy(), want, rtol=0, atol=1e-15)
    assert math.isclose(errs[0], float(np.abs(np.array(want) - 0.2).sum()), rel_tol=1e-12)


def test_pagerank_check_counts_iterations():
    rows, cols, _ = _undirected([(0, 1), (1, 2), (0, 2), (2, 3), (3, 4), (1, 4)])
    graph = {"rows": rows, "cols": cols, "n": 5}
    ranks, stop = pagerank.answer(rows, cols, 5, PARAMS, None)
    assert 1 < stop < 20
    ok = pagerank.check(graph, PARAMS, [(ranks.astype(np.float32), stop, None)])[0]
    assert ok["iters_off"] == 0 and ok["rank_rel_err"] < 1e-6
    off = pagerank.check(graph, PARAMS, [(ranks, stop + 1, None)])[0]
    assert off["iters_off"] == 1 and off["rank_rel_err"] > 1e-6


def test_sssp_by_hand():
    """0-1 (0.5), 1-2 (0.25), 0-2 (1.0); vertex 3 unreached."""
    rows, cols, w = _undirected([(0, 1), (1, 2), (0, 2)], [0.5, 0.25, 1.0])
    d = sssp.distances(rows, cols, w, 4, 0)
    assert d.tolist() == [0.0, 0.5, 0.75, math.inf]
    assert sssp.distances(rows, cols, w, 4, 2).tolist() == [0.75, 0.25, 0.0, math.inf]


def test_sssp_gap():
    ref = torch.tensor([0.0, 0.5, 0.75, math.inf], dtype=torch.float64)
    assert sssp.gap(np.array([0, 0.5, 0.75, np.inf], np.float32), ref) == 0.0
    assert sssp.gap(np.array([0, 0.5, 0.75, 9.0], np.float32), ref) == math.inf
    assert sssp.gap(np.array([0, 0.5, np.inf, np.inf], np.float32), ref) == math.inf
    assert math.isclose(sssp.gap(np.array([0, 0.5, 0.675, np.inf]), ref), 0.1)


def _coo(seed, device="cpu"):
    cfg = dict(registry.config("g500-kron21"), scale=SCALE + 2)
    rows, cols, w, n, roots = generate.graph(cfg, seed, device, 64)
    return {"rows": rows, "cols": cols, "w": w, "n": n}, roots


def _control_numbers(graph, roots):
    """The control's compared numbers: the reference in bfloat16 in the
    library's place, judged as a run judges."""
    pr = registry.traffic("pagerank")
    ranks, iters = pagerank.answer(graph["rows"], graph["cols"], graph["n"], pr["params"], torch.bfloat16)
    got = pagerank.check(graph, pr["params"], [(ranks, iters, None)])[0]
    dists = [
        (sssp.answer(graph["rows"], graph["cols"], graph["w"], graph["n"], r, torch.bfloat16), 0, r) for r in roots[:3]
    ]
    return got, max(x["dist_err"] for x in sssp.check(graph, {}, dists))


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_control_is_not_correct(seed):
    """At a size a test holds, the bfloat16 control exceeds the limits that the
    traffic files set, and the float64 reference itself reads 0."""
    graph, roots = _coo(seed)
    got, dist_err = _control_numbers(graph, roots)
    limits_pr, limits_sssp = registry.traffic("pagerank")["limits"], registry.traffic("sssp")["limits"]
    assert got["rank_rel_err"] > limits_pr["rank_rel_err"] or got["iters_off"] > limits_pr["iters_off"]
    assert dist_err > limits_sssp["dist_err"]
    ranks, iters = pagerank.answer(graph["rows"], graph["cols"], graph["n"], PARAMS, None)
    assert pagerank.check(graph, PARAMS, [(ranks, iters, None)])[0] == {"rank_rel_err": 0.0, "iters_off": 0}


def test_control_on_card(card):
    graph, roots = _coo(11, card)
    got, dist_err = _control_numbers(graph, roots)
    assert got["rank_rel_err"] > registry.traffic("pagerank")["limits"]["rank_rel_err"]
    assert dist_err > registry.traffic("sssp")["limits"]["dist_err"]

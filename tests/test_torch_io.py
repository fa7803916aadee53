"""Parity of the port's interop (``graphblas_tpu_torch.io``, ``viz``, GBTX
serialization and pickle) with the JAX package's, case for case with
``tests/test_io.py``.

Each case runs the same statements on the same seeded numpy inputs through
both packages on the CPU and compares what comes out exactly: collections by
dtype, shape, storage format and ``to_coo()``, scipy arrays by format,
shape, dtype and their index and value arrays, graphs by their edges and
weights, serialized bytes byte for byte, canvases value for value.  Then the
port's results meet the reference test's own asserts.  ``sparse`` (pydata)
and ``awkward`` are optional in both packages: where they are missing, both
raise the same ImportError, and the round trips skip as the reference's do.
"""

import pickle

import numpy as np
import pytest
from test_torch_tx import R, both, ns, same  # noqa: F401

import graphblas_tpu_torch as P


@pytest.fixture(autouse=True)
def _pinned():
    with P.tx.config.set(platform="cpu"):
        yield


def _A(g):
    return g.Matrix.from_coo([0, 0, 1, 2], [1, 2, 2, 0], [1.5, 2.0, 3.0, 4.0], nrows=3, ncols=3)


def same_scipy(p, r):
    assert (p.format, p.shape, p.dtype) == (r.format, r.shape, r.dtype)
    p, r = p.tocoo(), r.tocoo()
    for a, b in ((p.row, r.row), (p.col, r.col), (p.data, r.data)):
        np.testing.assert_array_equal(a, b)


def same_graph(p, r):
    assert list(p.nodes) == list(r.nodes)
    assert list(p.edges(data=True)) == list(r.edges(data=True))


def test_scipy_roundtrip(R):
    def run(g):
        A = _A(g)
        out = []
        for fmt in ["csr", "csc", "coo"]:
            s = g.gb.io.to_scipy_sparse(A, fmt)
            B = g.gb.io.from_scipy_sparse(s)
            out.append((s, B, B.isequal(A)))
        return out

    p, r = both(R, run)
    for (ps, pb, pe), (rs, rb, re), fmt in zip(p, r, ["csr", "csc", "coo"]):
        same_scipy(ps, rs)
        same(pb, rb)
        assert ps.format == fmt and pe and re


def test_scipy_vector(R):
    p, r = both(R, lambda g: g.gb.io.to_scipy_sparse(g.Vector.from_coo([0, 2], [1.0, 2.0], size=4)))
    same_scipy(p, r)
    assert p.shape == (1, 4) and p.nnz == 2


def test_networkx_roundtrip(R):
    def run(g):
        A = _A(g)
        G = g.gb.io.to_networkx(A)
        B = g.gb.io.from_networkx(G)
        return G, B, B.isequal(A)

    (pg, pb, pe), (rg, rb, re) = both(R, run)
    same_graph(pg, rg)
    same(pb, rb)
    assert pg.number_of_edges() == 4 and pg[0][1]["weight"] == 1.5 and pe and re


def test_mmread_mmwrite(R, tmp_path):
    def run(g):
        A = _A(g)
        path = tmp_path / f"test_{g.gb.__name__}.mtx"
        g.gb.io.mmwrite(str(path), A)
        B = g.gb.io.mmread(str(path))
        return path.read_bytes(), B, B.isclose(A)

    p, r = both(R, run)
    same(p, r)
    assert p[2]


def test_serialize_roundtrip(R):
    def run(g):
        A = _A(g)
        mod = __import__(f"{g.gb.__name__}.tx.matrix", fromlist=["deserialize_matrix"])
        out = []
        for kw in ({}, {"compression": None}):
            data = A.tx.serialize(**kw)
            B = mod.deserialize_matrix(data)
            out += [bytes(data), B, B.isequal(A)]
        return out

    p, r = both(R, run)
    same(p, r)
    assert p[2] and p[5]


def test_serialize_vector_roundtrip(R):
    def run(g):
        v = g.Vector.from_coo([0, 2], [1.0, 2.0], size=4)
        mod = __import__(f"{g.gb.__name__}.tx.vector", fromlist=["deserialize_vector"])
        data = v.tx.serialize()
        w = mod.deserialize_vector(data)
        return bytes(data), w, w.isequal(v)

    p, r = both(R, run)
    same(p, r)
    assert p[2]


def test_pickle_roundtrip(R):
    def run(g):
        A = _A(g)
        B = pickle.loads(pickle.dumps(A))
        v = g.Vector.from_coo([1, 2], [3, 4], size=5, name="v")
        w = pickle.loads(pickle.dumps(v))
        s = g.Scalar.from_value(2.5)
        t = pickle.loads(pickle.dumps(s))
        empty = pickle.loads(pickle.dumps(g.Scalar(g.dtypes.INT8)))
        return [B, B.isequal(A, check_dtype=True), w, w.name, w.isequal(v, check_dtype=True), t, t == s, empty,
                empty.is_empty, empty.dtype == g.dtypes.INT8]

    p, r = both(R, run)
    same(p, r)
    assert p[1] and p[3] == "v" and p[4] and p[6] and p[8] and p[9]


def test_export_formats(R):
    def run(g):
        A = _A(g)
        d = A.tx.export("csr")
        B = g.Matrix.from_csr(d["indptr"], d["col_indices"], d["values"], nrows=3, ncols=3)
        return d, B, B.isequal(A), A.tx.export("densemasked")

    p, r = both(R, run)
    same(p, r)
    assert p[0]["format"] == "csr" and p[2] and p[3]["values"].shape == (3, 3)


def test_tx_hyper_import_export(R):
    def run(g):
        A = g.Matrix.from_coo([0, 0, 5], [1, 2, 0], [1.0, 2.0, 3.0], nrows=6, ncols=3)
        d = A.tx.export("hypercsr")
        B = g.tx.import_hypercsr(
            rows=d["rows"], indptr=d["indptr"], col_indices=d["col_indices"], values=d["values"], nrows=d["nrows"], ncols=d["ncols"],
        )
        d2 = A.tx.export("hypercsc")
        C = g.tx.import_hypercsc(
            cols=d2["cols"], indptr=d2["indptr"], row_indices=d2["row_indices"], values=d2["values"], nrows=d2["nrows"],
            ncols=d2["ncols"],
        )
        return d, B, B.isequal(A), d2, C, C.isequal(A)

    p, r = both(R, run)
    same(p, r)
    assert p[0]["rows"].tolist() == [0, 5] and p[2] and p[5]


def test_viz_draw_and_spy(R):
    """The viz helpers on the Agg backend: the same graph and the same
    sparsity pattern drawn."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def run(g):
        A = g.Matrix.from_coo([0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0], g.dtypes.FP64, nrows=3, ncols=3)
        G = g.gb.viz.draw(A)
        ax = g.gb.viz.spy(A, show=False)
        marks = [np.asarray(line.get_xydata()) for line in ax.get_lines()]
        plt.close("all")
        return G, marks

    (pg, pm), (rg, rm) = both(R, run)
    same_graph(pg, rg)
    assert pg.number_of_edges() == 3 and len(pm) == len(rm)
    for a, b in zip(pm, rm):
        np.testing.assert_array_equal(a, b)


def test_viz_datashade(R):
    """datashade renders a density canvas without the optional datashader
    stack; the aggregations equal the reference's and hand-computed values."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def run(g):
        from importlib import import_module

        viz = import_module(f"{g.gb.__name__}.viz")
        A = g.Matrix.from_coo([0, 0, 9], [0, 0, 9], [1.0, 3.0, 5.0], g.dtypes.FP32, nrows=10, ncols=10, dup_op="plus")
        canvases = [viz._canvas_aggregate(A, agg, 2, 2) for agg in ("count", "sum", "mean", "min", "max")]
        rng = np.random.default_rng(31)
        B = g.Matrix.from_coo(rng.integers(0, 50, 200), rng.integers(0, 70, 200), rng.random(200), nrows=50, ncols=70,
                              dup_op="plus")
        canvases += [viz._canvas_aggregate(B, agg, 16, 8) for agg in ("count", "sum", "mean", "min", "max")]
        ax = viz.datashade(A, "count", width=16, height=16, show=False)
        image = np.asarray(ax.get_images()[0].get_array())
        plt.close("all")
        return canvases, image

    p, r = both(R, run)
    same(p, r)
    assert p[0][0].tolist() == [[1.0, 0.0], [0.0, 1.0]]
    for k in (1, 2, 4):
        assert p[0][k].tolist() == [[4.0, 0.0], [0.0, 5.0]]


def test_scipy_all_formats_roundtrip(R):
    """from/to scipy for csr/csc/coo (reference io/_scipy.py)."""
    import scipy.sparse as sps

    rng = np.random.default_rng(3)
    dense = np.where(rng.random((6, 9)) < 0.4, rng.integers(1, 9, (6, 9)), 0)

    def run(g):
        out = []
        for fmt in ("csr", "csc", "coo"):
            M = g.gb.io.from_scipy_sparse(sps.coo_matrix(dense).asformat(fmt))
            out.append((M, g.gb.io.to_scipy_sparse(M, fmt)))
        return out

    p, r = both(R, run)
    for (pm, ps), (rm, rs), fmt in zip(p, r, ("csr", "csc", "coo")):
        same(pm, rm)
        same_scipy(ps, rs)
        assert pm.shape == (6, 9) and ps.format == fmt and (ps.toarray() == dense).all()


def test_mmwrite_mmread_pattern_and_general(R, tmp_path):
    def run(g):
        M = g.Matrix.from_coo([0, 2, 4], [1, 3, 0], [1.5, -2.0, 3.25], nrows=5, ncols=5)
        path = tmp_path / f"m_{g.gb.__name__}.mtx"
        g.gb.io.mmwrite(str(path), M)
        M2 = g.gb.io.mmread(str(path))
        # BOOL writes as uint8 0/1 (Matrix Market has no bool field)
        B = g.Matrix.from_coo([0, 1], [1, 0], [True, True], dtype=g.dtypes.BOOL, nrows=3, ncols=3)
        path2 = tmp_path / f"b_{g.gb.__name__}.mtx"
        g.gb.io.mmwrite(str(path2), B)
        B2 = g.gb.io.mmread(str(path2))
        return [path.read_bytes(), M2, M.isequal(M2, check_dtype=False), path2.read_bytes(), B2]

    p, r = both(R, run)
    same(p, r)
    rr, cc, _ = p[4].to_coo()
    assert p[2] and sorted(zip(rr.tolist(), cc.tolist())) == [(0, 1), (1, 0)]


def test_networkx_weighted_digraph(R):
    import networkx as nx

    G = nx.DiGraph()
    G.add_weighted_edges_from([(0, 1, 2.0), (1, 2, 3.0), (2, 0, 4.0)])

    def run(g):
        M = g.gb.io.from_networkx(G, nodelist=[0, 1, 2])
        M32 = g.gb.io.from_networkx(G, nodelist=[2, 1, 0], dtype=g.dtypes.FP32)
        return M, M32, g.gb.io.to_networkx(M), g.gb.io.to_networkx(M, edge_attribute=None)

    p, r = both(R, run)
    same(p[:2], r[:2])
    same_graph(p[2], r[2])
    same_graph(p[3], r[3])
    rr, cc, vv = p[0].to_coo()
    assert dict(zip(zip(rr.tolist(), cc.tolist()), vv.tolist())) == {(0, 1): 2.0, (1, 2): 3.0, (2, 0): 4.0}
    assert set(p[2].edges) == set(G.edges)


@pytest.mark.parametrize("fn", ["from_pydata_sparse", "to_pydata_sparse", "from_awkward", "to_awkward"])
def test_optional_converters_are_gated(R, fn):
    """pydata sparse and awkward: where the package is missing both
    packages raise the same ImportError; where it is installed, the round
    trip equals the reference's."""
    module = "sparse" if "pydata" in fn else "awkward"
    try:
        __import__(module)
    except ImportError:
        msgs = []
        for g in (P, R):
            with pytest.raises(ImportError) as err:
                getattr(g.io, fn)(None)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] and module in msgs[0]
        return
    to = getattr(P.io, fn.replace("from_", "to_"))

    def run(g):
        A = _A(g)
        back = getattr(g.gb.io, fn.replace("to_", "from_"))(getattr(g.gb.io, fn.replace("from_", "to_"))(A))
        return back

    assert to is not None
    same(*both(R, run))

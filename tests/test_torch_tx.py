"""Parity of the port's extension namespace (``graphblas_tpu_torch.tx``,
``Matrix.tx``/``Vector.tx``, aliased ``ss``) with the JAX package's.

Case for case with ``tests/test_tx_sparse.py``, the ``tx``/``burble``/
``config``/``deserialize`` tests of ``tests/test_misc.py`` and the ``.tx``/
``.ss`` cases of ``test_matrix_full.py``, ``test_vector_full.py``,
``test_sparse.py`` and ``test_structural_sweep.py``: each case runs the same
statements on the same seeded numpy inputs through both packages on the CPU
and compares what comes out exactly (indices, structures, storage format,
every value bit for bit, floats included: the tx ops reorder and select
values, the sparse scans are the reference's numpy code, and the dense scan
is the reference's ``associative_scan`` tree, float32 plus bit for bit as
``tests/test_torch_densemasked.py`` holds it), GBTX bytes byte for byte; then
the port's results meet the reference test's own asserts.
"""

from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest

import graphblas_tpu_torch as P

HUGE = 1 << 40


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def _pinned():
    with P.tx.config.set(platform="cpu"):
        yield


def ns(pkg):
    return SimpleNamespace(
        gb=pkg, Matrix=pkg.Matrix, Vector=pkg.Vector, Scalar=pkg.Scalar, dtypes=pkg.dtypes, binary=pkg.binary,
        monoid=pkg.monoid, semiring=pkg.semiring, tx=pkg.tx, dtm=import_module(f"{pkg.__name__}.core.dtypes"),
    )


def both(R, fn):
    """fn(namespace) on the port, then on the reference."""
    return fn(ns(P)), fn(ns(R))


def _exact(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (label, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.kind in "fc":
        for part in (np.real, np.imag) if a.dtype.kind == "c" else (lambda x: x,):
            x, y = part(a), part(b)
            nan = np.isnan(x) & np.isnan(y)
            np.testing.assert_array_equal(np.where(nan, 0, x), np.where(nan, 0, y), err_msg=label)
            np.testing.assert_array_equal(np.signbit(x) | nan, np.signbit(y) | nan, err_msg=f"{label}: signs")
    else:
        np.testing.assert_array_equal(a, b, err_msg=label)


def same(p, r, label=""):
    """Port results against the reference's, exactly: collections by type,
    dtype, shape, storage format and ``to_coo()``; containers item by item."""
    if hasattr(r, "to_coo") and hasattr(r, "dtype"):
        assert type(p).__name__ == type(r).__name__, label
        assert (p.dtype.name, p.shape) == (r.dtype.name, r.shape), (label, p.dtype, r.dtype, p.shape, r.shape)
        assert (p._sparse is None) == (r._sparse is None), (label, "storage format")
        for i, (a, b) in enumerate(zip(p.to_coo(), r.to_coo())):
            _exact(a, b, f"{label}.coo[{i}]")
    elif type(r).__name__ == "Scalar":
        assert (p.dtype.name, p.is_empty) == (r.dtype.name, r.is_empty), label
        if not r.is_empty:
            _exact(p.value, r.value, label)
    elif isinstance(r, (list, tuple)):
        assert isinstance(p, (list, tuple)) and len(p) == len(r), label
        for i, (a, b) in enumerate(zip(p, r)):
            same(a, b, f"{label}[{i}]")
    elif isinstance(r, dict):
        assert isinstance(p, dict) and list(p) == list(r), (label, list(p), list(r))
        for k in r:
            same(p[k], r[k], f"{label}.{k}")
    elif isinstance(r, (np.ndarray, np.generic)):
        _exact(p, r, label)
    else:
        assert p == r, (label, p, r)


# ---------------------------------------------------------------------------
# tests/test_tx_sparse.py: the sparse format against the dense one
# ---------------------------------------------------------------------------


def _pair(g, seed=0, n=20, e=60):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e)
    c = rng.integers(0, n, e)
    v = rng.random(e).round(3)
    dense = g.Matrix.from_coo(r, c, v, g.dtm.FP64, nrows=n, ncols=n, dup_op=g.binary.plus)
    with g.tx.config.set(dense_limit=0):
        sp = g.Matrix.from_coo(r, c, v, g.dtm.FP64, nrows=n, ncols=n, dup_op=g.binary.plus)
    assert sp._sparse is not None
    return dense, sp


def _vpair(g, seed=1, n=30, k=12):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, k, replace=False))
    v = rng.random(k).round(3)
    dense = g.Vector.from_coo(idx, v, g.dtm.FP64, size=n)
    with g.tx.config.set(dense_limit=0):
        sp = g.Vector.from_coo(idx, v, g.dtm.FP64, size=n)
    assert sp._sparse is not None
    return dense, sp


def _approx_dicts(d, s):
    assert set(d) == set(s)
    for rr in d:
        for cc in d[rr]:
            assert s[rr][cc] == pytest.approx(d[rr][cc])


def test_tx_matrix_scan_matches_dense(R):
    def run(g):
        return [[m.tx.scan(op) for m in _pair(g, seed=3)] for op in ("plus", "times", "min", "max")]

    p, r = both(R, run)
    same(p, r)
    for d, s in p:
        assert s._sparse is not None
        _approx_dicts(d.to_dicts(), s.to_dicts())


def test_tx_matrix_scan_columnwise(R):
    p, r = both(R, lambda g: [m.tx.scan("plus", "columnwise") for m in _pair(g, seed=4)])
    same(p, r)
    _approx_dicts(p[0].to_dicts(), p[1].to_dicts())


@pytest.mark.parametrize("how", ["first", "last", "smallest", "largest"])
def test_tx_matrix_selectk_matches_dense(R, how):
    p, r = both(R, lambda g: [m.tx.selectk(how, 2) for m in _pair(g, seed=5)])
    same(p, r)
    assert p[1]._sparse is not None and p[1].to_dicts() == p[0].to_dicts()


@pytest.mark.parametrize("how", ["first", "last", "smallest", "largest"])
def test_tx_matrix_compactify_matches_dense(R, how):
    p, r = both(R, lambda g: [m.tx.compactify(how) for m in _pair(g, seed=6)])
    same(p, r)
    assert p[1]._sparse is not None and p[1].to_dicts() == p[0].to_dicts()


def test_tx_matrix_sort_matches_dense(R):
    def run(g):
        dense, sp = _pair(g, seed=7)
        return [dense.tx.sort("lt"), sp.tx.sort("lt"), dense.tx.sort("gt", permutation=False), sp.tx.sort("gt", permutation=False)]

    p, r = both(R, run)
    same(p, r)
    (dv, dp), (sv, sp_), dv2, sv2 = p
    assert sv._sparse is not None
    assert sv.to_dicts() == dv.to_dicts() and sp_.to_dicts() == dp.to_dicts() and sv2.to_dicts() == dv2.to_dicts()


def test_tx_matrix_flatten_reshape_matches_dense(R):
    def run(g):
        dense, sp = _pair(g, seed=8, n=6, e=14)
        return [[m.tx.flatten(order) for m in (dense, sp)] + [m.tx.reshape(4, 9, order) for m in (dense, sp)]
                for order in ("rowwise", "columnwise")]

    p, r = both(R, run)
    same(p, r)
    for df, sf, dr, sr in p:
        assert df.to_dict() == sf.to_dict() and sr._sparse is not None and sr.to_dicts() == dr.to_dicts()


def test_tx_sparse_huge_ops_no_densify(R):
    def run(g):
        rows = np.array([0, 0, 0, 1 << 30, 1 << 30, HUGE - 1])
        cols = np.array([5, 2, 1 << 35, 7, 3, 0])
        vals = np.array([3.0, 1.0, 2.0, 9.0, 4.0, 5.0])
        A = g.Matrix.from_coo(rows, cols, vals, g.dtm.FP64, nrows=HUGE, ncols=HUGE)
        return [A.tx.selectk("smallest", 2), A.tx.compactify("smallest"), A.tx.scan("plus"), A.tx.sort("lt"),
                A.tx.head(3), A.tx.is_iso, A.tx.nbytes]

    p, r = both(R, run)
    same(p, r)
    k2, comp, sc, (sv, sperm), (hr, _, _), iso, nb = p
    assert k2.to_dicts() == {0: {2: 1.0, (1 << 35): 2.0}, 1 << 30: {3: 4.0, 7: 9.0}, HUGE - 1: {0: 5.0}}
    assert comp.to_dicts() == {0: {0: 1.0, 1: 2.0, 2: 3.0}, 1 << 30: {0: 4.0, 1: 9.0}, HUGE - 1: {0: 5.0}}
    assert sc.to_dicts()[0] == {2: 1.0, 5: 4.0, (1 << 35): 6.0}
    assert sv.to_dicts()[0] == {0: 1.0, 1: 2.0, 2: 3.0} and sperm.to_dicts()[0] == {0: 2, 1: 1 << 35, 2: 5}
    assert list(hr) == [0, 0, 0] and iso is False and nb > 0


def test_tx_vector_sparse_ops_match_dense(R):
    def run(g):
        dense, sp = _vpair(g)
        out = [[v.tx.scan("plus") for v in (dense, sp)]]
        for how in ("first", "largest"):
            out.append([v.tx.selectk(how, 3) for v in (dense, sp)] + [v.tx.compactify(how) for v in (dense, sp)])
        return out + [[v.tx.sort("lt") for v in (dense, sp)], [v.tx.is_iso for v in (dense, sp)]]

    p, r = both(R, run)
    same(p, r)
    assert p[0][1].to_dict() == pytest.approx(p[0][0].to_dict())
    for dk, sk, dc, sc in p[1:3]:
        assert sk.to_dict() == dk.to_dict() and sc.to_dict() == dc.to_dict()
    (dv, dp), (sv, sp_) = p[3]
    assert sv.to_dict() == dv.to_dict() and sp_.to_dict() == dp.to_dict() and p[4][0] == p[4][1]


def test_tx_vector_sparse_huge(R):
    def run(g):
        v = g.Vector.from_coo([5, 1 << 33, HUGE - 2], [2.0, 1.0, 3.0], g.dtm.FP64, size=HUGE)
        return [v.tx.selectk("smallest", 2), v.tx.compactify("smallest"), v.tx.scan("plus"), v.tx.is_iso]

    p, r = both(R, run)
    same(p, r)
    assert p[0].to_dict() == {5: 2.0, 1 << 33: 1.0}
    assert p[1].to_dict() == {0: 1.0, 1: 2.0, 2: 3.0}
    assert p[2].to_dict() == {5: 2.0, (1 << 33): 3.0, HUGE - 2: 6.0} and p[3] is False


def test_column_variant_import_export_roundtrip(R):
    def run(g):
        A = g.Matrix.from_coo([0, 0, 2, 3], [1, 3, 0, 2], [1.0, 2.0, 3.0, 4.0], g.dtypes.FP32, nrows=4, ncols=5)
        out = []
        for fmt in ["coor", "cooc", "bitmapr", "bitmapc", "fullr", "fullc", "csr"]:
            blob = A.ss.export(fmt)
            out.append((blob, g.tx.import_any(**dict(blob))))
        return A, out

    (A, p), (_, r) = both(R, run)
    same(p, r)
    for (blob, B), fmt in zip(p, ["coor", "cooc", "bitmapr", "bitmapc", "fullr", "fullc", "csr"]):
        assert blob["format"] == fmt
        if fmt.startswith("full"):
            assert np.array_equal(B.to_dense(fill_value=0), A.to_dense(fill_value=0))
        else:
            assert B.isequal(A), fmt
    blob = p[1][0]
    assert blob["sorted_cols"] and not blob["sorted_rows"] and list(blob["cols"]) == sorted(blob["cols"])
    bm = np.asarray(p[3][0]["bitmap"]).reshape(5, 4).T
    rr, cc, _ = A.to_coo()
    want = np.zeros((4, 5), bool)
    want[rr.astype(np.int64), cc.astype(np.int64)] = True
    assert np.array_equal(bm, want)


# ---------------------------------------------------------------------------
# tests/test_misc.py: config, the tx namespace, serialization, burble
# ---------------------------------------------------------------------------


def test_config(R):
    def run(g):
        out = [g.gb.config.get("autocompute")]
        with g.gb.config.set(autocompute=False):
            out.append(g.gb.config.get("autocompute"))
        out.append(g.gb.config.get("autocompute"))
        with pytest.raises(KeyError):
            g.gb.config.set(not_a_key=1)
        return out + ["autocompute" in g.gb.config, sorted(set(R.tx.config) - set(g.tx.config))]

    p, r = both(R, run)
    assert p == r == [True, False, True, True, []]


def test_tx_namespace(R):
    def run(g):
        v = g.Vector.from_coo([0, 2], [1.0, 2.0], size=4)
        m = g.tx.diag(v)
        back = g.tx.diag(m)
        with g.tx.burble():
            on = g.tx.config["burble"]
        return [m, back, back.isequal(v), on, g.tx.config["burble"], bool(g.tx.about["library_name"])]

    p, r = both(R, run)
    same(p, r)
    assert p[0].shape == (4, 4) and p[2:] == [True, True, False, True]
    about = P.tx.about
    assert about["torch_version"] and about["platform"] in ("cuda", "cpu") and "library_version" in repr(about)
    assert P.ss is P.tx and P.tx.config["mxm_strategy"] == "auto"


def test_tx_concat_split(R):
    def run(g):
        A = g.Matrix.from_coo([0, 1, 2, 3], [0, 1, 2, 3], [1, 2, 3, 4], nrows=4, ncols=4)
        tiles = A.tx.split(2)
        v = g.Vector.from_coo([0, 3], [1, 2], size=4)
        parts = v.tx.split(2)
        return [tiles, g.tx.concat(tiles), g.tx.concat(tiles).isequal(A), parts, g.tx.concat(parts).isequal(v)]

    p, r = both(R, run)
    same(p, r)
    assert len(p[0]) == 2 and len(p[0][0]) == 2 and p[2] and len(p[3]) == 2 and p[4]


def test_tx_matrix_utils(R):
    def run(g):
        A = g.Matrix.from_coo([0, 0, 1], [0, 2, 1], [3.0, 1.0, 2.0], nrows=2, ncols=3)
        flat = A.tx.flatten()
        return [A.tx.format, A.tx.is_iso, g.Matrix.from_scalar(1, 2, 2).tx.is_iso, flat, flat.tx.reshape(2, 3).isequal(A),
                list(A.tx.iterkeys()), list(A.tx.itervalues()), list(A.tx.iteritems()), A.tx.head(2), A.tx.nbytes]

    p, r = both(R, run)
    # FP64 values and bool structure have the same carriers in both packages,
    # so the byte counts agree here (UINT16/UINT32 differ: test_tx_nbytes)
    same(p, r)
    assert p[0] == "densemasked" and not p[1] and p[2] and p[3].size == 6 and p[4]
    assert p[5] == [(0, 0), (0, 2), (1, 1)] and p[6] == [3.0, 1.0, 2.0] and len(p[8][0]) == 2


def test_tx_scan(R):
    def run(g):
        v = g.Vector.from_coo([0, 1, 3], [1.0, 2.0, 3.0], size=4)
        A = g.Matrix.from_coo([0, 0, 1], [0, 1, 1], [1.0, 2.0, 3.0], nrows=2, ncols=2)
        return [v.tx.scan("plus"), A.tx.scan("plus")]

    p, r = both(R, run)
    same(p, r)
    assert p[0].to_dict() == {0: 1.0, 1: 3.0, 3: 6.0} and p[1].to_dicts() == {0: {0: 1.0, 1: 3.0}, 1: {1: 3.0}}


def test_tx_selectk_compactify_sort(R):
    def run(g):
        A = g.Matrix.from_coo([0, 0, 0, 1, 1], [0, 2, 4, 1, 3], [5.0, 1.0, 3.0, 2.0, 4.0], nrows=2, ncols=5)
        v = g.Vector.from_coo([0, 2, 3], [3.0, 1.0, 2.0], size=5)
        return [A.tx.selectk("largest", 1), A.tx.selectk("first", 2), A.tx.compactify("first"),
                A.tx.sort(permutation=False), v.tx.sort(permutation=False)]

    p, r = both(R, run)
    same(p, r)
    assert p[0].to_dicts() == {0: {0: 5.0}, 1: {3: 4.0}}
    assert p[1].to_dicts() == {0: {0: 5.0, 2: 1.0}, 1: {1: 2.0, 3: 4.0}}
    assert p[2].to_dicts() == {0: {0: 5.0, 1: 1.0, 2: 3.0}, 1: {0: 2.0, 1: 4.0}}
    assert p[3].to_dicts()[0] == {0: 1.0, 1: 3.0, 2: 5.0} and p[4].to_dict() == {0: 1.0, 1: 2.0, 2: 3.0}


def test_tx_descending_unsigned(R):
    def run(g):
        A = g.Matrix.from_coo([0, 0, 0], [0, 1, 2], [0, 200, 100], dtype=g.dtypes.UINT8, nrows=1, ncols=3)
        B = g.Matrix.from_coo([0, 0], [1, 3], [127, -5], dtype=g.dtypes.INT8, nrows=1, ncols=4)
        return [A.tx.selectk("largest", 1), A.tx.compactify("largest"), A.tx.sort("gt", permutation=False),
                B.tx.selectk("largest", 1), B.tx.selectk("smallest", 1)]

    p, r = both(R, run)
    same(p, r)
    assert p[0].to_dicts() == {0: {1: 200}} and list(p[1].to_dicts()[0].values()) == [200, 100, 0]
    assert list(p[2].to_dicts()[0].values()) == [200, 100, 0]
    assert p[3].to_dicts() == {0: {1: 127}} and p[4].to_dicts() == {0: {3: -5}}


@pytest.mark.parametrize("dtn", ["UINT16", "UINT32", "UINT64"])
def test_tx_descending_unsigned_wide_carriers(R, dtn):
    """The port's wider carriers order as the reference's unsigned types:
    UINT16 in int32 and UINT32 in int64 (non-negative), UINT64 in int64 bit
    for bit with the sign bit biased before sorting (values past 2^63)."""
    top = int(np.iinfo(np.dtype(dtn.lower())).max)
    vals = np.array([0, top, top // 2, 7, top - 1, 7], np.dtype(dtn.lower()))

    def run(g):
        dt = getattr(g.dtypes, dtn)
        A = g.Matrix.from_coo([0, 0, 0, 1, 1, 1], [0, 1, 3, 0, 2, 3], vals, dt, nrows=2, ncols=4)
        v = g.Vector.from_coo([0, 1, 2, 4, 5, 6], vals, dt, size=8)
        out = []
        for how in ("smallest", "largest", "first", "last"):
            out += [A.tx.selectk(how, 1), A.tx.compactify(how), v.tx.selectk(how, 2), v.tx.compactify(how)]
        return out + [A.tx.sort("gt"), A.tx.sort("lt"), v.tx.sort("gt"), A.tx.sort("gt", "columnwise")]

    p, r = both(R, run)
    same(p, r)
    assert p[4].to_dicts() == {0: {1: top}, 1: {2: top - 1}}


def test_tx_sort_ties_nan_and_signed_zeros(R):
    """Ties keep their order in both directions, NaN sorts last ascending
    and first descending, -0.0 ties +0.0: ``jnp.argsort(stable=True,
    descending=...)`` and ``torch.sort(stable=True, descending=...)``."""
    row = np.array([0.0, -0.0, 1.0, np.nan, 1.0, -np.nan, -0.0, 0.0, -1.0, np.inf], np.float32)
    cols = np.arange(len(row))

    def run(g):
        A = g.Matrix.from_coo(np.zeros(len(row), int), cols, row, g.dtypes.FP32, nrows=2, ncols=12)
        v = g.Vector.from_coo(cols, row, g.dtypes.FP32, size=12)
        out = [A.tx.sort("lt"), A.tx.sort("gt"), v.tx.sort("lt"), v.tx.sort("ge"), A.tx.sort("lt", "columnwise")]
        for how in ("smallest", "largest"):
            out += [A.tx.selectk(how, 4), A.tx.compactify(how), v.tx.compactify(how)]
        return out

    p, r = both(R, run)
    same(p, r)
    perm = p[0][1].to_dicts()[0]
    assert [perm[k] for k in range(10)] == [8, 0, 1, 6, 7, 2, 4, 9, 3, 5]


def test_tx_sort_complex_lexicographic(R):
    """Complex keys sort by the real part, then the imaginary part, as
    ``jnp.argsort`` (torch.sort takes no complex keys: two stable passes)."""
    vals = np.array([1 + 2j, 1 + 1j, -1 + 5j, 1 + 1j, 0 - 0j, 3j], np.complex128)

    def run(g):
        A = g.Matrix.from_coo([0, 0, 0, 1, 1, 1], [0, 1, 3, 0, 2, 3], vals, g.dtypes.FC64, nrows=2, ncols=4)
        return [A.tx.sort("lt"), A.tx.sort("gt"), A.tx.selectk("largest", 2), A.tx.compactify("smallest")]

    p, r = both(R, run)
    same(p, r)
    assert list(p[0][0].to_dicts()[0].values()) == [-1 + 5j, 1 + 1j, 1 + 2j]


def test_dense_scan_float32_bit_for_bit(R):
    rng = np.random.default_rng(21)
    cells = np.flatnonzero(rng.random(9 * 33) < 0.7)
    vals = (rng.random(len(cells)) * 4 - 1).astype(np.float32)

    def run(g):
        A = g.Matrix.from_coo(cells // 33, cells % 33, vals, g.dtypes.FP32, nrows=9, ncols=33)
        v = g.Vector.from_coo(cells[cells < 37], vals[cells < 37], g.dtypes.FP32, size=37)
        return [A.tx.scan(op, order) for op in ("plus", "times", "min", "max", "any") for order in ("rowwise", "columnwise")] + [
            v.tx.scan("plus"), v.tx.scan("max")
        ]

    p, r = both(R, run)
    same(p, r)


def test_deserialize_tags(R):
    def run(g):
        v = g.Vector.from_coo([0, 2], [1.5, 2.5], size=4)
        data = v.tx.serialize(compression=None)
        w = g.tx.deserialize(bytes(data))
        with pytest.raises(ValueError, match="unknown serialization tag"):
            g.tx.deserialize(b"XXXXjunk")
        return [bytes(data), w, w.to_dict() == v.to_dict()]

    p, r = both(R, run)
    same(p, r)
    assert p[2]


def test_tx_per_object_config_persists(R):
    def run(g):
        A = g.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], nrows=3, ncols=3)
        cfg = A.tx.config
        out = [cfg["storage"]]
        cfg["storage"] = "coo"
        out += [A.tx.format, A.tx.config["storage"], A.tx.config is cfg]
        A.tx.config["storage"] = "densemasked"
        out.append(A.tx.format)
        with pytest.raises(KeyError):
            A.tx.config["nonsense"] = 1
        v = g.Vector.from_coo([0], [1.0], size=2)
        out.append(v.tx.config["storage"])
        v.tx.config["storage"] = "coo"
        out += [v._sparse is not None, v.to_dict()]
        v.tx.config["storage"] = "densemasked"
        return out + [v._sparse is None, repr(A.tx.config)]

    p, r = both(R, run)
    assert p == r == ["auto", "coo", "coo", True, "densemasked", "auto", True, {0: 1.0}, True,
                      "Matrix.tx.config({'storage': 'densemasked'})"]


def test_tx_config_is_not_a_data_slot():
    """``_tx_config`` is a plain slot: the compiled loops' held data slots
    (``capture.HeldSlot``) are the storage alone."""
    from graphblas_tpu_torch.core import capture

    for cls in (P.Matrix, P.Vector):
        held = {name for name, _ in capture._held_slots(cls)}
        assert "_tx_config" not in held and {"_sparse", "_sp_dev"} <= held


def test_tx_binary_serialize_roundtrip(R):
    def run(g):
        A = g.Matrix.from_coo([0, 1, 2], [1, 0, 2], [1.5, 2.5, 3.5], nrows=3, ncols=4, name="A")
        out = []
        for comp in [None, "none", "zstd", "default"]:
            data = A.tx.serialize(compression=comp)
            out += [bytes(data), g.tx.deserialize(bytes(data)).isequal(A)]
        with pytest.raises(ValueError, match="unsupported compression"):
            A.tx.serialize(compression="lz4")
        iso = g.Matrix.from_coo([0, 1, 2], [0, 1, 2], 7.0, nrows=3, ncols=3)
        data = iso.tx.serialize(compression=None)
        J = g.tx.deserialize(bytes(data))
        v = g.Vector.from_coo([1, 3], [4.0, 5.0], size=6)
        w = g.tx.deserialize(bytes(v.tx.serialize()))
        with g.tx.config.set(dense_limit=0):
            S = g.Matrix.from_coo([0, 2], [1, 0], [9.0, 8.0], nrows=3, ncols=3)
        sdata = S.tx.serialize()
        S2 = g.tx.deserialize(bytes(sdata))
        return out + [bytes(data), J, J.isequal(iso), w, w.isequal(v), bytes(sdata), S2, S2.isequal(S)]

    p, r = both(R, run)
    same(p, r)
    assert all(p[1:8:2]) and p[10] and p[12] and p[15]
    assert p[2][:4] == b"RAW0" and p[2][4:8] == b"GBTX"


def test_tx_build_diag_and_build_scalar(R):
    def run(g):
        v = g.Vector.from_coo([0, 2], [5.0, 7.0], size=3)
        A = g.Matrix(g.dtypes.FP64, 3, 3)
        A.tx.build_diag(v)
        with pytest.raises(g.gb.exceptions.OutputNotEmpty):
            A.tx.build_diag(v)
        B = g.Matrix(g.dtypes.INT64, 2, 3)
        B.tx.build_scalar([0, 1], [2, 0], 9)
        with pytest.raises(g.gb.exceptions.OutputNotEmpty):
            B.tx.build_scalar([0], [0], 1)
        return [A, B, B.tx.is_iso]

    p, r = both(R, run)
    same(p, r)
    assert p[0].to_dicts() == {0: {0: 5.0}, 2: {2: 7.0}} and p[1].to_dicts() == {0: {2: 9}, 1: {0: 9}} and p[2]


def test_burble_prints_dispatch(R, capsys):
    """Burble prints one diagnostic line per engine op with storage formats;
    the port prints the reference's lines."""

    def run(g):
        A = g.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], g.dtypes.FP32, nrows=2, ncols=2, name="A")
        v = g.Vector.from_coo([0], [1.0], g.dtypes.FP32, size=2, name="v")
        w = A.mxv(v, g.semiring.plus_times).new(name="w")  # quiet: burble off
        quiet = capsys.readouterr().out
        burb = g.tx.burble()
        before = burb.is_enabled
        with burb:
            inside = burb.is_enabled
            w << A.mxv(v, g.semiring.min_plus)
        out = capsys.readouterr().out
        after = g.tx.config["burble"]
        w.dup()
        return [quiet, before, inside, out, after, capsys.readouterr().out]

    p, r = both(R, run)
    assert p == r
    assert "[burble] mxv[min_plus](w<dense 2 FP32>" in p[3] and "A<dense 2x2 FP32>" in p[3]


# ---------------------------------------------------------------------------
# the .tx/.ss cases of test_matrix_full, test_vector_full, test_sparse and
# test_structural_sweep
# ---------------------------------------------------------------------------

ROWS = [3, 0, 3, 5, 6, 0, 6, 1, 6, 2, 4, 1]
COLS = [0, 1, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6]
VALS = [3, 2, 3, 1, 5, 3, 7, 8, 3, 1, 7, 4]


def _full_A(g):
    return g.Matrix.from_coo(ROWS, COLS, VALS, g.dtypes.INT64, nrows=7, ncols=7)


def _full_v(g):
    return g.Vector.from_coo([1, 3, 4, 6], [1, 1, 2, 0], g.dtypes.INT64, size=7)


def _full_w(g):
    return g.Vector.from_coo([0, 1, 6], [5, -2, 3], g.dtypes.INT64, size=7)


def test_matrix_full_split_concat_flatten_sort(R):
    def run(g):
        A = _full_A(g)
        halves = A.tx.split([None, [3, 4]])
        f = A.tx.flatten()
        return [A.tx.split([4, [3, 4]]), g.gb.tx.concat([[halves[0][0], halves[0][1]]]), f, f.tx.reshape(7, 7),
                A.tx.sort(g.binary.lt)]

    p, r = both(R, run)
    same(p, r)
    A = _full_A(ns(P))
    assert p[0][0][0].shape == (4, 3) and p[0][1][1].shape == (3, 4) and p[1].isequal(A) and p[3].isequal(A)
    assert p[2].size == 49


def test_vector_full_diag_concat_split_sort(R):
    def run(g):
        v, w = _full_v(g), _full_w(g)
        return [g.gb.tx.diag(v, k=-1), g.gb.tx.concat([v, w]), v.tx.split(4), v.tx.sort(g.binary.lt),
                v.tx.compactify("first"), v.tx.nbytes > 0]

    p, r = both(R, run)
    same(p, r)
    assert p[0].shape == (8, 8) and p[1].size == 14 and [t.size for t in p[2]] == [4, 3]
    w2, perm = p[3]
    assert w2.to_dict() == {0: 0, 1: 1, 2: 1, 3: 2} and perm.to_dict() == {0: 6, 1: 1, 2: 3, 3: 4}
    assert p[4].to_dict() == {0: 1, 1: 1, 2: 2, 3: 0} and p[5]


def test_sparse_format_and_pickle(R):
    import pickle

    def run(g):
        rng = np.random.default_rng(17)
        n, e = 45, 260
        r, c, v = rng.integers(0, n, e), rng.integers(0, n, e), rng.random(e)
        dense = g.Matrix.from_coo(r, c, v, nrows=n, ncols=n, dup_op=g.binary.plus)
        with g.tx.config.set(dense_limit=0):
            sp = g.Matrix.from_coo(r, c, v, nrows=n, ncols=n, dup_op=g.binary.plus)
        big = 1 << 40
        H = g.Matrix.from_coo([0, big - 1, 12345], [big - 1, 0, 12345], [1.0, 2.0, 3.5], nrows=big, ncols=big)
        back = pickle.loads(pickle.dumps(sp))
        return [sp.tx.format, dense.tx.format, sp.T.new().tx.format, sp.dup().tx.format, back, back.isequal(sp), H.tx.format,
                sp.select("tril", -1).new().tx.format]

    p, r = both(R, run)
    same(p, r)
    assert p[:4] == ["coo", "densemasked", "coo", "coo"] and p[5] and p[6] == p[7] == "coo"


def test_structural_sweep_diag_flatten_split_concat(R):
    def run(g):
        vals = np.array([3.0, 1.0, 4.0, 1.0, 5.0])
        v = g.Vector.from_dense(vals)
        rng = np.random.default_rng(23)
        cells = np.flatnonzero(rng.random(48) < 0.5)
        A = g.Matrix.from_coo(cells // 8, cells % 8, rng.integers(1, 9, len(cells)).astype(np.float64), nrows=6, ncols=8)
        flat = A.tx.flatten()
        tiles = A.tx.split([[3, 3], [4, 4]])
        a, b = g.Vector.from_dense(np.array([1.0, 2.0])), g.Vector.from_dense(np.array([3.0, 4.0]))
        return [[g.gb.ss.diag(v, k=k) for k in (-2, -1, 0, 1, 2)], flat, flat.tx.reshape(6, 8), flat.tx.reshape(8, 6),
                tiles, g.gb.ss.concat(tiles), g.gb.ss.concat([[a._as_matrix(), b._as_matrix()]])]

    p, r = both(R, run)
    same(p, r)
    assert p[1].size == 48 and len(p[4]) == 2 and p[6].shape == (2, 2)


def test_tx_nbytes():
    """``nbytes`` counts the port's own storage: its carriers.  Where the
    carrier is the reference's buffer type the counts agree with the
    reference's (FP64 in ``test_tx_matrix_utils``); UINT16 rides int32 and
    UINT32 int64, so their dense counts are twice the reference's; the
    sparse format's host arrays are the reference's dtypes."""
    for dtn, width in (("UINT8", 1), ("UINT16", 4), ("UINT32", 8), ("UINT64", 8), ("FP32", 4)):
        dt = getattr(P.dtypes, dtn)
        A = P.Matrix.from_coo([0, 1], [1, 0], [1, 2], dt, nrows=3, ncols=5)
        assert A.tx.nbytes == 15 * width + 15, dtn
        with P.tx.config.set(dense_limit=0):
            S = P.Matrix.from_coo([0, 1], [1, 0], [1, 2], dt, nrows=3, ncols=5)
        assert S.tx.nbytes == 2 * 8 + 2 * 8 + 2 * dt.np_type.itemsize, dtn


@pytest.mark.cuda
def test_cuda_tx_ops_equal_the_cpu():
    """On the card, the dense tx ops and a round trip through GBTX and pickle
    give the CPU's results bit for bit, and stay on the card."""
    import pickle

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    cells = np.flatnonzero(rng.random(64 * 48) < 0.3)
    vals = rng.integers(-9, 9, len(cells))

    def run(platform):
        with P.tx.config.set(platform=platform):
            A = P.Matrix.from_coo(cells // 48, cells % 48, vals, P.dtypes.INT64, nrows=64, ncols=48)
            B = P.tx.deserialize(A.tx.serialize("none"))
            C = pickle.loads(pickle.dumps(A))
            outs = [A.tx.scan("plus"), A.tx.scan("plus", "columnwise"), *A.tx.sort("gt"), A.tx.selectk("largest", 3),
                    A.tx.compactify("smallest"), A.tx.flatten(), A.tx.reshape(48, 64), B, C]
            return outs, {str(o._device.type) for o in outs}

    got, where = run("cuda")
    want, _ = run("cpu")
    assert where == {"cuda"}
    same(got, want)

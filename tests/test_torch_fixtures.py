"""The committed serialization fixtures (``tests/fixtures/``, written by the
JAX package's ``tools/create_fixtures.py``) in the port.

- Every GBTX file reads in the port as the reference reads it.
- The port's ``serialize`` writes the reference's bytes for the same
  objects, under ``"none"`` and ``"zstd"``, and each package reads the
  other's.  (``matrix_fp64.gbtx`` holds its FP64 values as float32 blocks:
  an older reference wrote it, so today's bytes are held against today's
  reference, and the files by what they read as.)
- ``pickle1.pkl`` names the reference's classes, so the port's pickles are
  held by value: the same objects built in the port and round-tripped
  through pickle equal the reference's load of the file, the operators
  unpickle to the port's own singletons, and the UDT matrix keeps its
  record type.  ``FixturePoint`` is registered in both packages as
  ``tests/test_fixtures.py`` registers it.
"""

import os
import pickle

import numpy as np
import pytest
from test_torch_tx import R, both, ns, same  # noqa: F401

import graphblas_tpu_torch as P

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GBTX = ["matrix_fp64.gbtx", "matrix_int32_zstd.gbtx", "matrix_sparse_fp32.gbtx", "vector_bool.gbtx"]


@pytest.fixture(autouse=True)
def _pinned():
    with P.tx.config.set(platform="cpu"):
        yield


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _fixture_point(g):
    """The record type of pickle1.pkl, as tests/test_fixtures.py registers it."""
    try:
        g.dtm.register_new("FixturePoint", [("x", "<f8"), ("y", "<i4")])
    except ValueError:
        pass  # already registered in this process
    return g.dtypes.FixturePoint


def _objects(g):
    """The objects of the reference's tools/create_fixtures.py, by file."""
    return {
        "matrix_fp64.gbtx": g.Matrix.from_coo([0, 1, 3], [2, 0, 3], [1.5, -2.0, 7.25], g.dtm.FP64, nrows=4, ncols=4),
        "matrix_int32_zstd.gbtx": g.Matrix.from_coo([0, 2], [1, 2], [7, -9], g.dtm.INT32, nrows=3, ncols=3),
        "matrix_sparse_fp32.gbtx": g.Matrix.from_coo([0, 1 << 30], [5, 3], [1.0, 2.0], g.dtm.FP32, nrows=1 << 32, ncols=1 << 32),
        "vector_bool.gbtx": g.Vector.from_coo([1, 4, 6], [True, False, True], g.dtm.BOOL, size=8),
    }


@pytest.mark.parametrize("name", GBTX)
def test_gbtx_fixture_reads_as_in_the_reference(R, name):
    p, r = both(R, lambda g: g.tx.deserialize(_read(name)))
    same(p, r, name)
    assert p._device.type == "cpu"


@pytest.mark.parametrize("compression", ["none", "zstd"])
@pytest.mark.parametrize("name", GBTX + ["iso", "sparse_vector", "uint64", "udt"])
def test_serialize_bytes_equal_the_reference(R, name, compression):
    def build(g):
        if name in GBTX:
            return _objects(g)[name]
        if name == "iso":
            return g.Matrix.from_coo([0, 1, 2], [0, 1, 2], 7.0, nrows=3, ncols=5)
        if name == "sparse_vector":
            return g.Vector.from_coo([5, 1 << 33], [2.0, 1.0], g.dtm.FP64, size=1 << 40)
        if name == "uint64":
            return g.Matrix.from_coo([0, 1], [1, 0], np.array([2**64 - 1, 3], np.uint64), g.dtm.UINT64, nrows=2, ncols=2)
        point = _fixture_point(g)
        with g.tx.config.set(dense_limit=0):
            return g.Matrix.from_coo([0, 1], [1, 0], np.array([(1.0, 2), (3.0, 4)], point.np_type), point, nrows=2, ncols=2)

    def run(g):
        data = bytes(build(g).tx.serialize(compression=compression))
        if name == "udt":
            # a record block is written as raw bytes ('|V12'); neither
            # package reads it back into the record type
            with pytest.raises(ValueError):
                g.tx.deserialize(data)
            return data, None
        return data, g.tx.deserialize(data)

    p, r = both(R, run)
    assert p[0] == r[0]
    same(p[1], r[1])


def test_port_reads_reference_bytes_and_back(R):
    """Bytes written by either package read in the other."""
    for name, obj in _objects(ns(R)).items():
        same(P.tx.deserialize(bytes(obj.tx.serialize("zstd"))), obj, name)
    for name, obj in _objects(ns(P)).items():
        same(obj, R.tx.deserialize(bytes(obj.tx.serialize("none"))), name)


def test_pickle_fixture_against_port_round_trip(R):
    _fixture_point(ns(R))
    want = pickle.loads(_read("pickle1.pkl"))

    def build(g):
        point = _fixture_point(g)
        objs = _objects(g)
        pv = np.array([(1.0, 2), (3.0, 4)], dtype=point.np_type)
        return {
            "matrix": objs["matrix_fp64.gbtx"],
            "vector": objs["vector_bool.gbtx"],
            "udt_matrix": g.Matrix.from_coo([0, 1], [1, 0], pv, point, nrows=2, ncols=2),
            "op": g.binary.plus,
            "semiring": g.semiring.min_plus,
            "dtype": point,
        }

    got = pickle.loads(pickle.dumps(build(ns(P)), protocol=4))
    assert list(got) == list(want)
    for key in ("matrix", "vector", "udt_matrix"):
        same(got[key], want[key], key)
    assert got["op"] is P.binary.plus and got["semiring"] is P.semiring.min_plus
    assert got["op"].name == want["op"].name and got["semiring"].name == want["semiring"].name
    assert got["dtype"] is P.dtypes.FixturePoint and got["dtype"].np_type == want["dtype"].np_type
    assert got["udt_matrix"].dtype._is_udt and got["udt_matrix"].dtype == got["dtype"]
    r, c, vals = got["udt_matrix"].to_coo()
    assert vals["x"].tolist() == [1.0, 3.0] and vals["y"].tolist() == [2, 4]
    assert got["matrix"].to_dicts() == {0: {2: 1.5}, 1: {0: -2.0}, 3: {3: 7.25}}
    assert got["vector"].to_dict() == {1: True, 4: False, 6: True}


def test_pickle_udt_vector_scalar_and_names(R):
    def run(g):
        point = _fixture_point(g)
        vals = np.array([(1.5, -2), (0.25, 7)], point.np_type)
        v = g.Vector.from_coo([0, 3], vals, point, size=5, name="pts")
        s = g.Scalar(point, name="one")
        s.value = vals[1]
        empty = g.Scalar(g.dtypes.UINT64, is_cscalar=True, name="e")
        big = g.Scalar.from_value(np.uint64(2**64 - 2), g.dtypes.UINT64)
        out = [pickle.loads(pickle.dumps(x)) for x in (v, s, empty, big)]
        return out + [[x.name for x in out], out[2].is_cscalar, out[1].value["y"]]

    p, r = both(R, run)
    same(p, r)
    assert p[4] == ["pts", "one", "e", None] and p[5] and p[6] == 7 and p[3].value == 2**64 - 2

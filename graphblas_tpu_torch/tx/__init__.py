"""``graphblas_tpu_torch.tx``: the engine's extension namespace.

Counterpart of ``graphblas_tpu/tx/__init__.py`` (the analogue of
``graphblas.ss``): the global engine config, an ``about`` mapping, the free
functions ``diag`` and ``concat``, the ``burble`` context manager, the
raw-buffer importers ``import_*``/``import_any`` and ``deserialize``.
``graphblas_tpu_torch.ss`` aliases this module.  Every constructor here puts
its result on ``config["platform"]``.
"""

import numpy as np

from ..core import dtypes as _dt
from ..core.config import Config

config = Config(
    "graphblas_tpu_torch.tx",
    defaults={
        # dense mxm lowering: "auto" takes the matmul forms where one applies,
        # then the tropical kernel; "mxu" the matmul forms only; "pallas" the
        # tropical kernel (also off float32 and below 128 x 128 outputs);
        # "generic" the chunked semiring contraction
        "mxm_strategy": "auto",
        # generic-mxm k-chunk size (kept for the reference's key set)
        "mxm_chunk": 128,
        # the device of new collections: "cuda" (the card) or "cpu"
        "platform": "cuda",
        # print engine dispatch diagnostics (analogue of SuiteSparse burble)
        "burble": False,
        # matrices above this many cells store as analyzed-COO sparse
        # (analogue of SuiteSparse sparsity_control / hyper_switch)
        "dense_limit": 1 << 24,
        # hard guard: densifying a sparse matrix past this many cells raises
        "densify_limit": 1 << 26,
        # sparse mxv/vxm lowering: auto | plan (SpmvPlan engine) | generic
        "mxv_strategy": "auto",
        # unmasked sparse mxm: intermediate products materialized at most
        "spgemm_flop_limit": 1 << 28,
        # accepted for compatibility; torch and CUDA own threading
        "nthreads": 0,
        "chunk": 0,
    },
    validators={
        "platform": lambda v: v in ("cuda", "cpu"),
        "mxm_strategy": lambda v: v in ("auto", "mxu", "pallas", "generic"),
    },
)


class _About(dict):
    def __repr__(self):
        return "\n".join(f"{k}: {v}" for k, v in self.items())


def _make_about():
    import torch

    import graphblas_tpu_torch

    card = torch.cuda.is_available()
    return _About(
        {
            "library_name": "graphblas_tpu_torch PyTorch engine",
            "library_version": graphblas_tpu_torch.__version__,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "platform": "cuda" if card else "cpu",
            "device_count": torch.cuda.device_count() if card else 0,
            "device_name": torch.cuda.get_device_name(0) if card else None,
        }
    )


def __getattr__(name):
    if name == "about":
        return _make_about()
    raise AttributeError(f"module 'graphblas_tpu_torch.tx' has no attribute {name!r}")


def diag(x, k=0, dtype=None, *, name=None):
    """Vector -> diagonal Matrix, or Matrix -> diagonal Vector
    (reference: gb.ss.diag, ss/_core.py:24-72)."""
    from ..core.matrix import Matrix
    from ..core.vector import Vector

    if isinstance(x, Vector):
        result = x.diag(k)
        if dtype is not None:
            result = result.dup(dtype)
        if name:
            result.name = name
        return result
    if isinstance(x, Matrix):
        result = x.diag(k, dtype)
        if name:
            result.name = name
        return result
    raise TypeError(f"diag requires a Matrix or Vector; got {type(x)}")


def concat(tiles, dtype=None, *, name=None):
    """Concatenate a 2-D grid of Matrix tiles (or a list of Vectors)
    (reference: gb.ss.concat, ss/_core.py:73-106), on the tiles' device."""
    import torch

    from ..core.matrix import Matrix
    from ..core.vector import Vector

    if not isinstance(tiles, (list, tuple)) or not tiles:
        raise TypeError("tiles argument must be a non-empty list")
    first = tiles[0]
    if isinstance(first, (list, tuple)):
        # grid of matrices
        out_dtype = _dt.lookup_dtype(dtype if dtype is not None else first[0].dtype)
        rows_v = []
        rows_s = []
        for row in tiles:
            row = [t._get_value() if hasattr(t, "_get_value") and not isinstance(t, Matrix) else t for t in row]
            rows_v.append(torch.cat([_dt.cast(t._values, t.dtype, out_dtype) for t in row], dim=1))
            rows_s.append(torch.cat([t._struct for t in row], dim=1))
        return Matrix._from_arrays(torch.cat(rows_v, dim=0), torch.cat(rows_s, dim=0), out_dtype, name=name)
    # list of vectors
    out_dtype = _dt.lookup_dtype(dtype if dtype is not None else first.dtype)
    v = torch.cat([_dt.cast(t._values, t.dtype, out_dtype) for t in tiles])
    s = torch.cat([t._struct for t in tiles])
    return Vector._from_arrays(v, s, out_dtype, name=name)


class burble:
    """Context manager toggling engine dispatch diagnostics (analogue of
    SuiteSparse burble, reference: graphblas/ss/__init__.py:1); the lines
    are printed by ``core.base._burble_call``."""

    def __init__(self):
        self._saved = None

    @property
    def is_enabled(self):
        return config["burble"]

    def __enter__(self):
        self._saved = config["burble"]
        config["burble"] = True
        return self

    def __exit__(self, *exc):
        config["burble"] = self._saved
        return False


# -- raw-buffer imports (reference: zero-copy Matrix.ss.import_* /
#    Vector.ss.import_*, core/ss/matrix.py:537-3649) -------------------------


def import_csr(*, indptr, col_indices, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    return Matrix.from_csr(indptr, col_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_csc(*, indptr, row_indices, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    return Matrix.from_csc(indptr, row_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_coo(*, rows, cols, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    return Matrix.from_coo(rows, cols, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_fullr(*, values, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    return Matrix.from_dense(values, dtype=dtype, name=name)


def _with_struct(m, bitmap):
    """``m`` with the structure ``bitmap`` (host bool), canonical (absent
    values zero), on ``m``'s device."""
    from ..ops.densemasked import canonical

    s = _dt.to_tensor(np.asarray(bitmap, bool), _dt.BOOL, m._device)
    m._set_arrays(*canonical(m._values, s))
    return m


def import_bitmapr(*, bitmap, values, dtype=None, name=None, **opts):
    from ..core.matrix import Matrix

    m = Matrix.from_dense(np.asarray(values), dtype=dtype, name=name)
    return _with_struct(m, bitmap)


def import_fullc(*, values, dtype=None, name=None, **opts):
    """Column-major full import (reference: core/ss/matrix.py import_fullc):
    ``values`` is ncols-major — transpose back to row-major storage."""
    from ..core.matrix import Matrix

    values = np.asarray(values)
    if values.ndim != 2:
        raise ValueError("fullc import requires a 2-D values array (column-major sense)")
    return Matrix.from_dense(np.ascontiguousarray(values), dtype=dtype, name=name)


def import_bitmapc(*, bitmap, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Column-major bitmap import (reference: core/ss/matrix.py
    import_bitmapc): flat/2-D arrays are in column-major (Fortran) order."""
    bitmap = np.asarray(bitmap)
    values = np.asarray(values)
    if bitmap.ndim == 1:
        # flat buffers are column-major: element (i, j) at j*nrows + i
        if nrows is None or ncols is None:
            raise ValueError("flat bitmapc import requires nrows and ncols")
        bitmap = bitmap.reshape(ncols, nrows).T
        values = values.reshape(ncols, nrows).T
    return import_bitmapr(bitmap=np.ascontiguousarray(bitmap), values=np.ascontiguousarray(values), dtype=dtype, name=name)


def import_coor(*, rows, cols, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Row-sorted COO import (reference: import_coor — same data, the sort
    order is a hint the engine does not need)."""
    return import_coo(rows=rows, cols=cols, values=values, nrows=nrows, ncols=ncols, dtype=dtype, name=name)


def import_cooc(*, rows, cols, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Column-sorted COO import (reference: import_cooc)."""
    return import_coo(rows=rows, cols=cols, values=values, nrows=nrows, ncols=ncols, dtype=dtype, name=name)


def import_hypercsr(*, rows, indptr, col_indices, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Hypersparse-CSR import (reference: core/ss/matrix.py import_hypercsr)."""
    from ..core.matrix import Matrix

    return Matrix.from_dcsr(rows, indptr, col_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_hypercsc(*, cols, indptr, row_indices, values, nrows=None, ncols=None, dtype=None, name=None, **opts):
    """Hypersparse-CSC import (reference: core/ss/matrix.py import_hypercsc)."""
    from ..core.matrix import Matrix

    return Matrix.from_dcsc(cols, indptr, row_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)


def import_any(**blob):
    """Dispatch an exported blob (or keyword buffers with ``format=``) back
    to the right importer (reference: Matrix.ss.import_any,
    core/ss/matrix.py:537+)."""
    fmt = blob.pop("format", "coo").lower()
    importers = {
        "coo": import_coo,
        "coor": import_coor,
        "cooc": import_cooc,
        "csr": import_csr,
        "csc": import_csc,
        "hypercsr": import_hypercsr,
        "hypercsc": import_hypercsc,
        "bitmapr": import_bitmapr,
        "bitmapc": import_bitmapc,
        "fullr": import_fullr,
        "fullc": import_fullc,
    }
    if fmt == "densemasked":
        from ..core.matrix import Matrix

        m = Matrix.from_dense(np.asarray(blob["values"]), dtype=blob.get("dtype"))
        return _with_struct(m, blob["struct"])
    if fmt not in importers:
        raise ValueError(f"Invalid format for import_any: {fmt}")
    return importers[fmt](**blob)


def import_sparse_vector(*, indices, values, size=None, dtype=None, name=None, **opts):
    from ..core.vector import Vector

    return Vector.from_coo(indices, values, dtype, size=size, name=name)


def deserialize(data):
    """Inverse of Matrix.tx.serialize / Vector.tx.serialize (kind-dispatching)."""
    import pickle as _pickle

    from . import _binary

    raw = _binary.decompress(data)
    if raw[:4] == _binary.MAGIC:
        kind = _binary.unpack(raw)[0]["kind"]
    else:
        kind = _pickle.loads(raw)["kind"]  # legacy pickle payloads
    if kind == "Matrix":
        from .matrix import deserialize_matrix

        return deserialize_matrix(data)
    from .vector import deserialize_vector

    return deserialize_vector(data)

"""awkward-array interop (python-graphblas: graphblas/io/_awkward.py; the
reference's ``graphblas_tpu/io/_awkward.py``).  Gated: ``awkward`` is
optional."""

import numpy as np


def to_awkward(A, format=None):
    try:
        import awkward as ak
    except ImportError:
        raise ImportError("awkward is required for to_awkward") from None
    from ..core.vector import Vector

    if isinstance(A, Vector):
        idx, vals = A.to_coo()
        return ak.Array({"indices": idx, "values": vals})
    indptr, cols, vals = A.to_csr()
    counts = np.diff(indptr.astype(np.int64))
    return ak.Array({"indices": ak.unflatten(cols, counts), "values": ak.unflatten(vals, counts)})


def from_awkward(A, *, name=None):
    try:
        import awkward as ak
    except ImportError:
        raise ImportError("awkward is required for from_awkward") from None
    from ..core.matrix import Matrix
    from ..core.vector import Vector

    if A.ndim == 1 or "indices" in A.fields and A["indices"].ndim == 1:
        idx = np.asarray(A["indices"])
        vals = np.asarray(A["values"])
        return Vector.from_coo(idx, vals, name=name)
    counts = ak.num(A["indices"])
    rows = np.repeat(np.arange(len(counts)), np.asarray(counts))
    cols = np.asarray(ak.flatten(A["indices"]))
    vals = np.asarray(ak.flatten(A["values"]))
    return Matrix.from_coo(rows, cols, vals, nrows=len(counts), name=name)

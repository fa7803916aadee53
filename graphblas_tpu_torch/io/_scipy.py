"""scipy.sparse interop (python-graphblas: graphblas/io/_scipy.py; the
reference's ``graphblas_tpu/io/_scipy.py``)."""

import numpy as np

from ..core import dtypes as _dt
from ..core.matrix import Matrix
from ..core.vector import Vector


def from_scipy_sparse(A, *, dup_op=None, name=None):
    """Create a Matrix from any scipy.sparse array/matrix."""
    import scipy.sparse as ss

    if not ss.issparse(A):
        raise TypeError(f"Input must be a scipy.sparse array or matrix; got {type(A)}")
    nrows, ncols = A.shape
    dtype = _dt.lookup_dtype(A.dtype)
    coo = A.tocoo()
    return Matrix.from_coo(coo.row, coo.col, coo.data, dtype, nrows=nrows, ncols=ncols, dup_op=dup_op, name=name)


def to_scipy_sparse(A, format="csr"):
    """Convert a Matrix (or Vector) to scipy.sparse in the given format
    ("bsr", "csr", "csc", "coo", "lil", "dia", "dok")."""
    import scipy.sparse as ss

    if isinstance(A, Vector):
        idx, vals = A.to_coo()
        rows = np.zeros_like(idx)
        result = ss.coo_array((vals, (rows.astype(np.int64), idx.astype(np.int64))), shape=(1, A.size))
    else:
        if hasattr(A, "_get_value") and not isinstance(A, Matrix):
            A = A._get_value()
        rows, cols, vals = A.to_coo()
        result = ss.coo_array((vals, (rows.astype(np.int64), cols.astype(np.int64))), shape=A.shape)
    if format == "coo":
        return result
    return result.asformat(format)

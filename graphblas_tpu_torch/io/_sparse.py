"""pydata/sparse interop (python-graphblas: graphblas/io/_sparse.py; the
reference's ``graphblas_tpu/io/_sparse.py``).  Gated: the ``sparse``
package is optional."""


def from_pydata_sparse(s, *, dup_op=None, name=None):
    try:
        import sparse
    except ImportError:
        raise ImportError("sparse is required for from_pydata_sparse") from None
    from ..core.matrix import Matrix
    from ..core.vector import Vector

    s = sparse.COO(s)
    if s.ndim == 1:
        return Vector.from_coo(s.coords[0], s.data, size=s.shape[0], dup_op=dup_op, name=name)
    if s.ndim == 2:
        return Matrix.from_coo(
            s.coords[0], s.coords[1], s.data, nrows=s.shape[0], ncols=s.shape[1], dup_op=dup_op, name=name
        )
    raise ValueError(f"m.ndim must be <= 2; got {s.ndim}")


def to_pydata_sparse(m, format="coo"):
    try:
        import sparse
    except ImportError:
        raise ImportError("sparse is required for to_pydata_sparse") from None
    from ..core.vector import Vector

    if isinstance(m, Vector):
        idx, vals = m.to_coo()
        s = sparse.COO([idx.astype("int64")], vals, shape=m.shape)
    else:
        rows, cols, vals = m.to_coo()
        s = sparse.COO([rows.astype("int64"), cols.astype("int64")], vals, shape=m.shape)
    return s.asformat(format)

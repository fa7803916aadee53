"""Matrix Market read/write (python-graphblas: graphblas/io/_matrixmarket.py;
the reference's ``graphblas_tpu/io/_matrixmarket.py``), through scipy."""


def mmread(source, engine="auto", *, dup_op=None, name=None, **kwargs):
    """Read a Matrix Market file into a Matrix."""
    from scipy.io import mmread as scipy_mmread
    from scipy.sparse import issparse

    from ..core.matrix import Matrix
    from ._scipy import from_scipy_sparse

    array = scipy_mmread(source, **kwargs)
    if issparse(array):
        return from_scipy_sparse(array, dup_op=dup_op, name=name)
    return Matrix.from_dense(array, name=name)


def mmwrite(target, matrix, engine="auto", *, comment="", field=None, precision=None, symmetry=None, **kwargs):
    """Write a Matrix to a Matrix Market file."""
    import numpy as np
    from scipy.io import mmwrite as scipy_mmwrite

    from ._scipy import to_scipy_sparse

    arr = to_scipy_sparse(matrix, "coo")
    if arr.dtype == np.bool_:
        # scipy's symmetry sniffing applies `-` to values, which numpy bools
        # reject; BOOL matrices write as 0/1 integers (as the reference:
        # Matrix Market has no bool field)
        arr = arr.astype(np.uint8)
    scipy_mmwrite(target, arr, comment=comment, precision=precision, symmetry=symmetry)

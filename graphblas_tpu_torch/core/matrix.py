"""Matrix: 2-D collection + TransposedMatrix view.

Counterpart of ``graphblas_tpu/core/matrix.py``, with its two storage
formats: dense-masked (values and structure tensors on the collections'
device, ``tx.config["platform"]``) up to ``tx.config["dense_limit"]`` cells,
and past it the sparse analyzed COO (``core.sparse.SparseMatrixData``: host
numpy COO, canonical, with device caches on the matrix's device).  A sparse
matrix materializes dense tensors on first touch of ``_values``/``_struct``
(guarded by ``tx.config["densify_limit"]``); the op layer dispatches its
sparse branches first.  A user-defined type (UDT) keeps its dense values as
a dict of field tensors and its sparse values as a structured numpy array.
"""

import numpy as np
import torch

from .. import exceptions as _exc
from ..ops import densemasked as _dm
from . import capture as _cap
from . import collection_ops as _cops
from . import dtypes as _dt
from .base import BaseExpression, BaseType, Updater
from .expr import AmbiguousAssignOrExtract, IndexerResolver
from .infixmethods import InfixMixin
from .operator import get_typed_op
from .scalar import Scalar, _as_scalar, _is_scalar_like
from .utils import (
    canonical_device,
    collection_device,
    device_asarray,
    ensure_int,
    udt_fill_dense,
    udt_struct_from_missing,
    values_to_numpy_buffer,
    zero_values,
)
from .vector import Vector, _apply_dup, _sparse_limit


def _empty_sparse(nrows, ncols, dtype):
    from .sparse import SparseMatrixData

    return SparseMatrixData(np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, dtype.np_type), nrows, ncols)


class Matrix(InfixMixin, BaseType):
    """A 2-D collection of ((row, col), value) entries over a dtype domain.

    Dense-masked (a values tensor, absent cells 0, and a bool structure
    tensor) up to ``tx.config["dense_limit"]`` cells; sparse analyzed COO
    (``_sparse``, on the device ``_sp_dev``) past it."""

    # _sparse_, _sp_dev_: capture.HeldSlot data slots, below the class;
    # _tx_config: the per-object ``A.tx.config`` (not data)
    __slots__ = ("_sparse_", "_sp_dev_", "_tx_config")
    ndim = 2
    _output_type = None

    def __init__(self, dtype=_dt.FP64, nrows=0, ncols=0, *, name=None):
        self._dtype = _dt.lookup_dtype(dtype)
        nrows = ensure_int(nrows, "nrows")
        ncols = ensure_int(ncols, "ncols")
        dev = collection_device()
        self._sparse = None
        self.name = name
        if nrows * ncols > _sparse_limit():
            self._sparse, self._sp_dev = _empty_sparse(nrows, ncols, self._dtype), dev
            return
        self._values = zero_values((nrows, ncols), self._dtype, dev)
        self._struct = _dm.s_zeros((nrows, ncols), dev)

    @classmethod
    def _from_arrays(cls, values, struct, dtype, name=None):
        obj = cls.__new__(cls)
        obj._dtype = _dt.lookup_dtype(dtype)
        obj._sparse = None
        obj._values = values
        obj._struct = struct
        obj.name = name
        return obj

    @classmethod
    def _from_sparse(cls, sp, dtype, name=None, *, device=None):
        """Wrap a SparseMatrixData as a sparse-format Matrix on ``device``
        (default: the collections' device)."""
        obj = cls.__new__(cls)
        obj._dtype = _dt.lookup_dtype(dtype)
        obj._sparse = sp
        obj._sp_dev = collection_device() if device is None else canonical_device(device)
        obj.name = name
        return obj

    def _set_storage(self, fmt):
        """Convert the storage format in place: "coo"/"sparse" or
        "densemasked" (densify, guarded by tx.config['densify_limit'])."""
        if fmt in ("coo", "sparse"):
            if self._sparse is None:
                from .sparse import SparseMatrixData

                r, c, v = self.to_coo()
                self._adopt_sparse(SparseMatrixData.from_arrays(r.astype(np.int64), c.astype(np.int64), v, self.nrows, self.ncols, sorted_dedup=True))
        elif fmt == "densemasked":
            if self._sparse is not None:
                self._values  # noqa: B018 (densify)
        else:
            raise ValueError(f"unknown storage format: {fmt!r}")

    def __getattr__(self, name):
        # sparse-format matrices leave the dense slots unset; the first dense
        # touch materializes them (guarded by tx.config['densify_limit'])
        if name in ("_values", "_struct"):
            sp = BaseType.__getattribute__(self, "_sparse")
            if sp is not None:
                v, s = sp.densify(self._sp_dev)
                self._set_arrays(_dt.cast(v, sp.dtype, self._dtype), s)
                return v if name == "_values" else s
        raise AttributeError(name)

    def _set_arrays(self, values, struct):
        self._sparse = None
        self._values = values
        self._struct = struct

    def _adopt_sparse(self, sp):
        """Switch this Matrix to sparse storage on its device (dropping dense
        tensors)."""
        dev = self._device
        for slot in ("_values", "_struct"):
            try:
                delattr(self, slot)
            except AttributeError:
                pass
        self._sparse, self._sp_dev = sp, dev

    @property
    def _device(self):
        return self._sp_dev if self._sparse is not None else self._struct.device

    # -- introspection -----------------------------------------------------------

    @property
    def nrows(self):
        sp = self._sparse
        return sp.nrows if sp is not None else self._struct.shape[0]

    @property
    def ncols(self):
        sp = self._sparse
        return sp.ncols if sp is not None else self._struct.shape[1]

    @property
    def shape(self):
        sp = self._sparse
        return (sp.nrows, sp.ncols) if sp is not None else tuple(self._struct.shape)

    @property
    def nvals(self):
        sp = self._sparse
        return sp.nvals if sp is not None else BaseType.nvals.fget(self)

    def clear(self):
        if self._sparse is not None:
            self._adopt_sparse(_empty_sparse(self.nrows, self.ncols, self._sparse.dtype))
            return
        BaseType.clear(self)

    def wait(self, how="materialize"):
        if self._sparse is not None:
            return self  # host-canonical storage has nothing pending
        return BaseType.wait(self, how)

    def isequal(self, other, *, check_dtype=False):
        if self._sparse is not None or getattr(other, "_sparse", None) is not None:
            other = self._expect_type(other, type(self), within="isequal", argname="other")
            if check_dtype and self.dtype != other.dtype:
                return False
            if self.shape != other.shape:
                return False
            r1, c1, v1 = self.to_coo()
            r2, c2, v2 = other.to_coo()
            return np.array_equal(r1, r2) and np.array_equal(c1, c2) and np.array_equal(v1, v2)
        return BaseType.isequal(self, other, check_dtype=check_dtype)

    @property
    def T(self):
        """Transpose view: no compute."""
        return TransposedMatrix(self)

    def __repr__(self):
        from .formatting import format_matrix

        return format_matrix(self)

    def _repr_html_(self):
        from .formatting import format_matrix_html

        return format_matrix_html(self)

    def __sizeof__(self):
        sp = self._sparse
        if sp is not None:
            return object.__sizeof__(self) + sp.rows.nbytes + sp.cols.nbytes + sp.vals.nbytes
        v = self._values
        vb = sum(a.nbytes for a in v.values()) if isinstance(v, dict) else v.nbytes
        return object.__sizeof__(self) + vb + self._struct.nbytes

    def _sparse_find(self, r, c):
        """Index into sparse storage for entry (r, c), or -1 (host binary search)."""
        sp = self._sparse
        lo = np.searchsorted(sp.rows, r, "left")
        hi = np.searchsorted(sp.rows, r, "right")
        j = lo + np.searchsorted(sp.cols[lo:hi], c, "left")
        if j < hi and sp.cols[j] == c:
            return int(j)
        return -1

    def __contains__(self, index):
        resolved = IndexerResolver(self, index)
        if not resolved.is_single_element:
            raise TypeError("`in` requires a single (row, col) index")
        r, c = resolved.indices
        if self._sparse is not None:
            return self._sparse_find(r.index, c.index) >= 0
        return bool(self._struct[r.index, c.index])

    def __iter__(self):
        rows, cols, _ = self.to_coo(values=False)
        return zip(rows.tolist(), cols.tolist())

    def __reduce__(self):
        rows, cols, vals = self.to_coo()
        return (
            _matrix_from_pickle,
            (rows, cols, vals, self._dtype, self.nrows, self.ncols, self.name),
        )

    # -- constructors ------------------------------------------------------------

    @classmethod
    def from_coo(cls, rows, columns, values=1.0, dtype=None, *, nrows=None, ncols=None, dup_op=None, name=None):
        """Create from (rows, cols, values) on the collections' device."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        columns = np.asarray(columns, np.int64).reshape(-1)
        if _is_scalar_like(values):
            values = np.full(rows.shape, values)
        values, dtype = values_to_numpy_buffer(values, dtype)
        values = values.reshape(-1)
        if not (rows.size == columns.size == values.size):
            raise ValueError(
                f"rows, columns, values lengths differ: {rows.size}, {columns.size}, {values.size}"
            )
        if nrows is None:
            if rows.size == 0:
                raise ValueError("No nrows given and no rows to infer it from")
            nrows = int(rows.max()) + 1
        if ncols is None:
            if columns.size == 0:
                raise ValueError("No ncols given and no columns to infer it from")
            ncols = int(columns.max()) + 1
        nrows = ensure_int(nrows, "nrows")
        ncols = ensure_int(ncols, "ncols")
        rows = np.where(rows < 0, rows + nrows, rows)
        columns = np.where(columns < 0, columns + ncols, columns)
        if rows.size and ((rows < 0).any() or (rows >= nrows).any()):
            raise _exc.IndexOutOfBound(f"row index out of range for nrows {nrows}")
        if columns.size and ((columns < 0).any() or (columns >= ncols).any()):
            raise _exc.IndexOutOfBound(f"column index out of range for ncols {ncols}")
        if nrows * ncols > _sparse_limit():
            from .sparse import SparseMatrixData

            sp = SparseMatrixData.from_arrays(rows, columns, values, nrows, ncols, dup_op)
            return cls._from_sparse(sp, dtype, name=name)
        flat = rows * ncols + columns
        if flat.size != np.unique(flat).size:
            flat, values = _apply_dup(flat, values, dup_op)
            rows, columns = flat // ncols, flat % ncols
        dense_v = np.zeros((nrows, ncols), dtype.np_type)
        dense_s = np.zeros((nrows, ncols), bool)
        dense_v[rows, columns] = values
        dense_s[rows, columns] = True
        dev = collection_device()
        return cls._from_arrays(device_asarray(dense_v, dtype, dev), _dt.to_tensor(dense_s, _dt.BOOL, dev), dtype, name=name)

    @classmethod
    def from_edgelist(cls, edgelist, values=None, dtype=None, *, nrows=None, ncols=None, dup_op=None, name=None):
        """Create from [(r, c) ...] or [(r, c, v) ...] ."""
        edges = list(edgelist)
        if edges and len(edges[0]) == 3:
            if values is not None:
                raise TypeError("edgelist contains values; cannot also pass `values`")
            rows, cols, vals = zip(*edges)
        else:
            rows, cols = zip(*edges) if edges else ((), ())
            vals = values if values is not None else 1.0
        if not _is_scalar_like(vals) and not isinstance(vals, (int, float)):
            vals = np.asarray(vals)
        return cls.from_coo(np.asarray(rows, np.int64), np.asarray(cols, np.int64), vals, dtype, nrows=nrows, ncols=ncols, dup_op=dup_op, name=name)

    @classmethod
    def from_csr(cls, indptr, col_indices, values=1.0, dtype=None, *, nrows=None, ncols=None, name=None):
        """Create from CSR arrays."""
        indptr = np.asarray(indptr, np.int64)
        col_indices = np.asarray(col_indices, np.int64)
        if nrows is None:
            nrows = len(indptr) - 1
        rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
        if ncols is None:
            ncols = int(col_indices.max()) + 1 if col_indices.size else 0
        return cls.from_coo(rows, col_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)

    @classmethod
    def from_csc(cls, indptr, row_indices, values=1.0, dtype=None, *, nrows=None, ncols=None, name=None):
        """Create from CSC arrays."""
        indptr = np.asarray(indptr, np.int64)
        row_indices = np.asarray(row_indices, np.int64)
        if ncols is None:
            ncols = len(indptr) - 1
        cols = np.repeat(np.arange(ncols, dtype=np.int64), np.diff(indptr))
        if nrows is None:
            nrows = int(row_indices.max()) + 1 if row_indices.size else 0
        return cls.from_coo(row_indices, cols, values, dtype, nrows=nrows, ncols=ncols, name=name)

    @classmethod
    def from_dcsr(cls, compressed_rows, indptr, col_indices, values=1.0, dtype=None, *, nrows=None, ncols=None, name=None):
        """Create from hypersparse-CSR."""
        compressed_rows = np.asarray(compressed_rows, np.int64)
        indptr = np.asarray(indptr, np.int64)
        col_indices = np.asarray(col_indices, np.int64)
        rows = np.repeat(compressed_rows, np.diff(indptr))
        if nrows is None:
            nrows = int(compressed_rows.max()) + 1 if compressed_rows.size else 0
        if ncols is None:
            ncols = int(col_indices.max()) + 1 if col_indices.size else 0
        return cls.from_coo(rows, col_indices, values, dtype, nrows=nrows, ncols=ncols, name=name)

    @classmethod
    def from_dcsc(cls, compressed_cols, indptr, row_indices, values=1.0, dtype=None, *, nrows=None, ncols=None, name=None):
        """Create from hypersparse-CSC."""
        compressed_cols = np.asarray(compressed_cols, np.int64)
        indptr = np.asarray(indptr, np.int64)
        row_indices = np.asarray(row_indices, np.int64)
        cols = np.repeat(compressed_cols, np.diff(indptr))
        if ncols is None:
            ncols = int(compressed_cols.max()) + 1 if compressed_cols.size else 0
        if nrows is None:
            nrows = int(row_indices.max()) + 1 if row_indices.size else 0
        return cls.from_coo(row_indices, cols, values, dtype, nrows=nrows, ncols=ncols, name=name)

    @classmethod
    def from_scalar(cls, value, nrows, ncols, dtype=None, *, name=None):
        """Dense iso-valued matrix."""
        sc = _as_scalar(value, dtype)
        dtype = _dt.lookup_dtype(dtype) if dtype is not None else sc.dtype
        nrows = ensure_int(nrows, "nrows")
        ncols = ensure_int(ncols, "ncols")
        if nrows * ncols > _sparse_limit() * 8:
            # a fully-iso matrix at huge dimensions needs an iso storage
            # format; explicit storage would allocate nrows*ncols cells
            raise _exc.OutOfMemory(
                f"from_scalar would materialize {nrows * ncols} explicit entries; "
                "iso-valued storage at this scale is not supported — build the "
                "needed region sparsely (from_coo) instead"
            )
        dev = collection_device()
        return cls._from_arrays(
            _dm.tmap(lambda a: a.expand(nrows, ncols).clone(), sc._device_value(dtype, dev)),
            _dm.s_ones((nrows, ncols), dev),
            dtype,
            name=name,
        )

    @classmethod
    def from_dense(cls, values, missing_value=None, dtype=None, *, name=None):
        """Create from a dense 2-D array."""
        values, dtype = values_to_numpy_buffer(np.asarray(values), dtype)
        if values.ndim != 2:
            raise ValueError("values must be 2-dimensional for Matrix.from_dense")
        if dtype._is_udt:
            struct = udt_struct_from_missing(values, missing_value, dtype.np_type)
            v = values.astype(dtype.np_type)
            v[~struct] = np.zeros((), dtype.np_type)
        else:
            struct = np.ones(values.shape, bool) if missing_value is None else values != missing_value
            v = np.where(struct, values, np.zeros((), dtype.np_type))
        dev = collection_device()
        return cls._from_arrays(device_asarray(v, dtype, dev), _dt.to_tensor(struct, _dt.BOOL, dev), dtype, name=name)

    @classmethod
    def from_dicts(cls, nested_dicts, dtype=None, *, order="rowwise", nrows=None, ncols=None, name=None):
        """Create from {row: {col: val}}."""
        rows, cols, vals = [], [], []
        if isinstance(nested_dicts, dict):
            items = nested_dicts.items()
        else:
            items = enumerate(nested_dicts)
        for outer, inner in items:
            for inner_key, val in inner.items():
                rows.append(outer)
                cols.append(inner_key)
                vals.append(val)
        if order == "columnwise":
            rows, cols = cols, rows
        if not rows and (nrows is None or ncols is None):
            raise ValueError("nrows and ncols must be provided for empty dicts")
        return cls.from_coo(
            np.asarray(rows, np.int64), np.asarray(cols, np.int64), np.array(vals), dtype, nrows=nrows, ncols=ncols, name=name
        )

    # -- exporters ---------------------------------------------------------------

    def to_coo(self, dtype=None, *, rows=True, columns=True, values=True, sort=True):
        """(rows, cols, values) numpy arrays, row-major sorted (one read of
        the card; the sparse format is host-canonical)."""
        sp = self._sparse
        if sp is not None:
            out_v = None
            if values:
                out_v = sp.vals.copy()
                if dtype is not None:
                    out_v = out_v.astype(_dt.lookup_dtype(dtype).np_type)
            return (
                sp.rows.astype(np.uint64) if rows else None,
                sp.cols.astype(np.uint64) if columns else None,
                out_v,
            )
        struct = self._struct.cpu().numpy()
        r, c = np.nonzero(struct)
        out_r = r.astype(np.uint64) if rows else None
        out_c = c.astype(np.uint64) if columns else None
        out_v = None
        if values:
            vals = _dt.to_numpy(self._values, self._dtype)[r, c]
            if dtype is not None:
                vals = vals.astype(_dt.lookup_dtype(dtype).np_type)
            out_v = vals
        return out_r, out_c, out_v

    def to_edgelist(self, dtype=None, *, values=True, sort=True):
        """[(r, c), ...] or ([(r, c), ...], values)."""
        r, c, v = self.to_coo(dtype, values=values, sort=sort)
        edges = np.column_stack([r, c])
        if values:
            return edges, v
        return edges

    def to_csr(self, dtype=None, *, sort=True):
        """(indptr, col_indices, values)."""
        r, c, v = self.to_coo(dtype)
        r = r.astype(np.int64)
        indptr = np.zeros(self.nrows + 1, np.uint64)
        np.add.at(indptr, r + 1, 1)
        indptr = np.cumsum(indptr).astype(np.uint64)
        return indptr, c, v

    def to_csc(self, dtype=None, *, sort=True):
        """(indptr, row_indices, values)."""
        r, c, v = self.to_coo(dtype)
        order = np.lexsort((r, c))
        r, c, v = r[order], c[order], v[order]
        indptr = np.zeros(self.ncols + 1, np.uint64)
        np.add.at(indptr, c.astype(np.int64) + 1, 1)
        indptr = np.cumsum(indptr).astype(np.uint64)
        return indptr, r, v

    def to_dcsr(self, dtype=None, *, sort=True):
        """(compressed_rows, indptr, col_indices, values)."""
        r, c, v = self.to_coo(dtype)
        r = r.astype(np.int64)
        unique_rows, counts = np.unique(r, return_counts=True)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)
        return unique_rows.astype(np.uint64), indptr, c, v

    def to_dcsc(self, dtype=None, *, sort=True):
        """(compressed_cols, indptr, row_indices, values)."""
        r, c, v = self.to_coo(dtype)
        order = np.lexsort((r, c))
        r, c, v = r[order], c[order], v[order]
        unique_cols, counts = np.unique(c.astype(np.int64), return_counts=True)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)
        return unique_cols.astype(np.uint64), indptr, r, v

    def to_dense(self, fill_value=None, dtype=None, **opts):
        """Dense numpy array."""
        if fill_value is None and self.nvals < self.nrows * self.ncols:
            raise TypeError("fill_value must be given to to_dense when not all entries are present")
        if self._dtype._is_udt:
            if dtype is not None and _dt.lookup_dtype(dtype) is not self._dtype:
                raise TypeError("to_dense cannot cast a UDT to another dtype")
            return udt_fill_dense(
                _dt.to_numpy(self._values, self._dtype), self._struct.cpu().numpy(), self._dtype.np_type, fill_value
            )
        if fill_value is None:
            fill_value = 0
        dtype = _dt.lookup_dtype(dtype) if dtype is not None else self._dtype
        v = _dt.to_numpy(self._values, self._dtype).astype(dtype.np_type)
        s = self._struct.cpu().numpy()
        return np.where(s, v, np.asarray(fill_value, dtype.np_type))

    def to_dicts(self, order="rowwise"):
        """{row: {col: val}}."""
        r, c, v = self.to_coo()
        if order == "columnwise":
            r, c = c, r
        out = {}
        for i, j, val in zip(r.tolist(), c.tolist(), v.tolist()):
            out.setdefault(i, {})[j] = val
        return out

    # -- maintenance -------------------------------------------------------------

    def build(self, rows, columns, values, *, dup_op=None, clear=False, nrows=None, ncols=None):
        """Populate from coo; must be empty unless clear=True."""
        if not clear and self.nvals > 0:
            raise _exc.OutputNotEmpty("Matrix already contains values; use clear=True")
        from ..tx import config as _txconfig

        with _txconfig.set(platform=self._device.type):
            new = Matrix.from_coo(rows, columns, values, self._dtype, nrows=nrows or self.nrows, ncols=ncols or self.ncols, dup_op=dup_op)
        if new._sparse is not None:
            self._adopt_sparse(new._sparse)
        else:
            self._set_arrays(new._values, new._struct)

    def dup(self, dtype=None, *, clear=False, mask=None, name=None, **opts):
        """Duplicate (the tensors, and a sparse matrix's host indices, are
        shared: no collection writes into its own)."""
        dtype = _dt.lookup_dtype(dtype) if dtype is not None else self._dtype
        if clear:
            return Matrix(dtype, self.nrows, self.ncols, name=name)
        if self._dtype._is_udt and dtype != self._dtype:
            raise TypeError("Cannot cast a UDT Matrix to another dtype in dup")
        if self._sparse is not None and mask is None:
            sp = self._sparse
            vals = sp.vals if dtype is self._dtype else sp.vals.astype(dtype.np_type)
            return Matrix._from_sparse(sp.copy(vals=vals.copy()), dtype, name=name, device=self._sp_dev)
        v = _dt.cast(self._values, self._dtype, dtype)
        s = self._struct
        if mask is not None:
            from .base import _check_mask

            mask = _check_mask(mask, self)
            s = s & mask._bits()
            v, s = _dm.canonical(v, s)
        return Matrix._from_arrays(v, s, dtype, name=name)

    def resize(self, nrows, ncols):
        """Grow/shrink in place (into new tensors)."""
        nrows = ensure_int(nrows, "nrows")
        ncols = ensure_int(ncols, "ncols")
        if self._sparse is not None:
            sp = self._sparse
            keep = (sp.rows < nrows) & (sp.cols < ncols)
            self._adopt_sparse(type(sp)(sp.rows[keep], sp.cols[keep], sp.vals[keep], nrows, ncols))
            return
        v, s = self._values, self._struct
        pad = torch.nn.functional.pad
        if nrows < self.nrows:
            v, s = _dm.tmap(lambda a: a[:nrows], v), s[:nrows]
        elif nrows > self.nrows:
            grow = (0, 0, 0, nrows - s.shape[0])
            v, s = _dm.tmap(lambda a: pad(a, grow), v), pad(s, grow)
        if ncols < self.ncols:
            v, s = _dm.tmap(lambda a: a[:, :ncols], v), s[:, :ncols]
        elif ncols > s.shape[1]:
            grow = (0, ncols - s.shape[1])
            v, s = _dm.tmap(lambda a: pad(a, grow), v), pad(s, grow)
        self._set_arrays(v, s)

    def get(self, row, col, default=None):
        """Element or default."""
        resolved = IndexerResolver(self, (row, col))
        r, c = resolved.indices
        if self._sparse is not None:
            j = self._sparse_find(r.index, c.index)
            return self._sparse.vals[j].item() if j >= 0 else default
        if bool(self._struct[r.index, c.index]):
            v = _dt.to_numpy(_dm.tmap(lambda a: a[r.index, c.index], self._values), self._dtype)
            return v[()] if self._dtype._is_udt else v.item()
        return default

    def diag(self, k=0, dtype=None, *, name=None):
        """Extract diagonal k as a Vector."""
        k = int(k)
        if self._sparse is not None:
            from ..tx import config as _txconfig

            sp = self._sparse
            diag_len = min(self.nrows - max(-k, 0), self.ncols - max(k, 0))
            sel = (sp.cols - sp.rows) == k
            dtype_r = _dt.lookup_dtype(dtype) if dtype is not None else self._dtype
            with _txconfig.set(platform=self._sp_dev.type):
                return Vector.from_coo(sp.rows[sel] - max(-k, 0), sp.vals[sel].astype(dtype_r.np_type), dtype_r, size=diag_len, name=name)
        v, s = _dm.diag_extract(self._values, self._struct, k)
        dtype = _dt.lookup_dtype(dtype) if dtype is not None else self._dtype
        return Vector._from_arrays(_dt.cast(v, self._dtype, dtype), s, dtype, name=name)

    def setdiag(self, values, k=0, *, mask=None, accum=None, **opts):
        """Set diagonal k from a scalar or vector."""
        k = int(k)
        diag_len = min(self.nrows - max(-k, 0), self.ncols - max(k, 0))
        if diag_len < 0:
            raise _exc.IndexOutOfBound(f"diagonal {k} out of range")
        dev = self._struct.device
        rows = torch.arange(max(-k, 0), max(-k, 0) + diag_len, dtype=torch.int64, device=dev)
        cols = torch.arange(max(k, 0), max(k, 0) + diag_len, dtype=torch.int64, device=dev)
        if _is_scalar_like(values) or isinstance(values, Scalar):
            sc = _as_scalar(values)
            vv = sc._device_value(self.dtype, dev).expand(diag_len)
            vs = _dm.s_ones((diag_len,), dev)
        else:
            if hasattr(values, "_get_value"):
                values = values._get_value()
            if values.size != diag_len:
                raise _exc.DimensionMismatch(f"setdiag vector size {values.size} != diagonal length {diag_len}")
            vv = _dt.cast(values._values, values.dtype, self.dtype)
            vs = values._struct
        mbits = None
        if mask is not None:
            # a Vector mask is diag-length; a Matrix mask must match self,
            # only its diagonal used
            mp = mask.parent
            if mp.ndim == 2:
                if mp.shape != self.shape:
                    raise _exc.DimensionMismatch(
                        f"Matrix mask in setdiag is the wrong shape; expected {self.shape}, got {mp.shape}"
                    )
                mbits = mask._bits()[rows, cols]
            else:
                if mp.shape[0] != diag_len:
                    raise _exc.DimensionMismatch(
                        f"Vector mask in setdiag is the wrong length; expected {diag_len}, got {mp.shape[0]}"
                    )
                mbits = mask._bits()
        new_v, new_s = vv, vs
        if accum is not None or mbits is not None:
            old_v = self._values[rows, cols]
            old_s = self._struct[rows, cols]
            if accum is not None:
                accum_t = get_typed_op(accum, self.dtype, kind="binary")
                both = old_s & vs
                acc = accum_t.fn(_dt.cast(old_v, self.dtype, accum_t.type_), _dt.cast(vv, self.dtype, accum_t.type2))
                new_v = torch.where(both, _dt.cast(acc, accum_t.return_type, self.dtype), torch.where(vs, vv, old_v))
                new_s = old_s | vs
            if mbits is not None:
                new_v = torch.where(mbits, new_v, old_v)
                new_s = torch.where(mbits, new_s, old_s)
        cv = self._values.clone()
        cv[rows, cols] = new_v
        cs = self._struct.clone()
        cs[rows, cols] = new_s
        self._set_arrays(*_dm.canonical(cv, cs))

    # -- indexing ----------------------------------------------------------------

    def __getitem__(self, keys):
        return AmbiguousAssignOrExtract(self, IndexerResolver(self, keys))

    def __setitem__(self, keys, value):
        Updater(self)[keys] = value

    def __delitem__(self, keys):
        resolved = IndexerResolver(self, keys)
        _cops.do_delete(self, resolved)

    def _assign(self, resolved, value, *, mask, accum, replace, is_submask):
        _cops.do_assign(self, resolved, value, mask=mask, accum=accum, replace=replace, is_submask=is_submask)

    def _delete_region(self, resolved, mask=None):
        _cops.do_delete(self, resolved, mask)

    # -- operations --------------------------------------------------------------

    def ewise_add(self, other, op="plus"):
        """Union elementwise."""
        return _cops.ewise_expr(self, other, op, "add")

    def ewise_mult(self, other, op="times"):
        """Intersection elementwise."""
        return _cops.ewise_expr(self, other, op, "mult")

    def ewise_union(self, other, op, left_default, right_default):
        """Union with defaults."""
        return _cops.ewise_expr(self, other, op, "union", left_default=left_default, right_default=right_default)

    def mxv(self, other, op="plus_times"):
        """Matrix-vector multiply."""
        other = self._expect_type(other, Vector, within="mxv", argname="other")
        return _cops.mxm_expr(self, other, op, "mxv")

    def mxm(self, other, op="plus_times"):
        """Matrix-matrix multiply."""
        other = self._expect_type(other, (Matrix, TransposedMatrix), within="mxm", argname="other")
        return _cops.mxm_expr(self, other, op, "mxm")

    def kronecker(self, other, op="times"):
        """Kronecker product."""
        other = self._expect_type(other, (Matrix, TransposedMatrix), within="kronecker", argname="other")
        return _cops.kronecker_expr(self, other, op)

    def apply(self, op, right=None, *, left=None, thunk=None):
        """Elementwise transform."""
        return _cops.apply_expr(self, op, right, left=left, thunk=thunk)

    def select(self, op, thunk=None):
        """Filter entries."""
        return _cops.select_expr(self, op, thunk)

    def reduce_rowwise(self, op="plus"):
        """Reduce each row to a Vector entry."""
        return _cops.reduce_axis_expr(self, op, 1, "reduce_rowwise")

    def reduce_columnwise(self, op="plus"):
        """Reduce each column."""
        return _cops.reduce_axis_expr(self, op, 0, "reduce_columnwise")

    def reduce_scalar(self, op="plus", *, allow_empty=True):
        """Reduce everything to a Scalar."""
        return _cops.reduce_scalar_expr(self, op, allow_empty)

    def reposition(self, row_offset, column_offset, *, nrows=None, ncols=None):
        """Shift all entries."""
        out_rows = self.nrows if nrows is None else ensure_int(nrows, "nrows")
        out_cols = self.ncols if ncols is None else ensure_int(ncols, "ncols")
        row_offset = ensure_int(row_offset, "row_offset")
        column_offset = ensure_int(column_offset, "column_offset")

        def compute():
            dev = self._struct.device
            ri = torch.arange(out_rows, device=dev)[:, None]
            ci = torch.arange(out_cols, device=dev)[None, :]
            src_r = ri - row_offset
            src_c = ci - column_offset
            valid = (src_r >= 0) & (src_r < self.nrows) & (src_c >= 0) & (src_c < self.ncols)
            src_r = src_r.clamp(0, max(self.nrows - 1, 0))
            src_c = src_c.clamp(0, max(self.ncols - 1, 0))
            vv = torch.where(valid, self._values[src_r, src_c], torch.zeros((), dtype=self._values.dtype, device=dev))
            ss = torch.where(valid, self._struct[src_r, src_c], False)
            return vv, ss

        return BaseExpression(
            "reposition", Matrix, compute, dtype=self.dtype, shape=(out_rows, out_cols), args=(self,), opname="reposition"
        )

    def power(self, n, op="plus_times"):
        """Matrix power by binary exponentiation (recipe)."""
        n = ensure_int(n, "n")
        if self.nrows != self.ncols:
            raise _exc.DimensionMismatch("power requires a square matrix")
        if n < 0:
            raise ValueError("n must be nonnegative")
        sr = get_typed_op(op, self.dtype, self.dtype, kind="semiring")

        def compute():
            dev = self._struct.device
            if n == 0:
                eye_s = torch.eye(self.nrows, dtype=torch.bool, device=dev)
                return _dt.cast(eye_s, _dt.BOOL, self.dtype), eye_s
            result = None
            base_v, base_s = _dt.cast(self._values, self.dtype, sr.binaryop.type_), self._struct
            e = n
            while e > 0:
                if e & 1:
                    if result is None:
                        result = (base_v, base_s)
                    else:
                        result = _dm.mxm(result[0], result[1], base_v, base_s, sr, sr.return_type)
                e >>= 1
                if e:
                    base_v, base_s = _dm.mxm(base_v, base_s, base_v, base_s, sr, sr.return_type)
            return result

        return BaseExpression(
            "power", Matrix, compute, op=sr, dtype=sr.return_type, shape=self.shape, args=(self,), opname=f"power[{n}]"
        )

    # -- conversions -------------------------------------------------------------

    def _as_vector(self):
        """View an n-by-1 matrix as a vector."""
        if self.ncols != 1:
            raise _exc.DimensionMismatch("Matrix must have a single column to be cast to a Vector")
        return Vector._from_arrays(_dm.tmap(lambda a: a[:, 0], self._values), self._struct[:, 0], self._dtype, name=self.name)

    @property
    def tx(self):
        from ..tx.matrix import MatrixTx

        return MatrixTx(self)

    ss = tx


_cap.hold_slots(Matrix, "_sparse", "_sp_dev")


class TransposedMatrix:
    """A no-compute transpose view."""

    __slots__ = "_matrix", "name"
    ndim = 2
    _is_scalar = False

    def __init__(self, matrix):
        self._matrix = matrix
        self.name = f"{matrix.name or 'M'}.T"

    @property
    def _output_type(self):
        return Matrix

    @property
    def T(self):
        return self._matrix

    @property
    def _values(self):
        return self._matrix._values.T

    @property
    def _struct(self):
        return self._matrix._struct.T

    @property
    def _device(self):
        return self._matrix._device

    @property
    def dtype(self):
        return self._matrix.dtype

    @property
    def nrows(self):
        return self._matrix.ncols

    @property
    def ncols(self):
        return self._matrix.nrows

    @property
    def shape(self):
        return (self._matrix.ncols, self._matrix.nrows)

    @property
    def nvals(self):
        return self._matrix.nvals

    def new(self, dtype=None, *, mask=None, name=None, **opts):
        return self._as_expression().new(dtype, mask=mask, name=name, **opts)

    dup = new

    def _as_expression(self):
        m = self._matrix

        def compute():
            return _dm.transpose(m._values, m._struct)

        sparse_compute = None
        sp = m._sparse
        if sp is not None:

            def sparse_compute():
                # the index arrays reordered, not copied per element
                return Matrix._from_sparse(sp.transposed(), m.dtype, device=m._sp_dev)

        return BaseExpression(
            "transpose", Matrix, compute, dtype=m.dtype, shape=self.shape, args=(m,), opname="transpose",
            sparse_compute=sparse_compute,
        )

    # -- zero-copy delegations (the view stays free of compute): exports and
    #    reductions swap roles on the parent instead of materializing a
    #    transposed copy ----------------------------------------------------
    def to_coo(self, dtype=None, *, rows=True, columns=True, values=True, sort=True):
        r, c, v = self._matrix.to_coo(dtype, sort=False)
        if sort:
            order = np.lexsort((r, c))
            r, c, v = r[order], c[order], v[order]
        return (
            c if rows else None,
            r if columns else None,
            v if values else None,
        )

    def to_csr(self, dtype=None, *, sort=True):
        return self._matrix.to_csc(dtype, sort=sort)

    def to_csc(self, dtype=None, *, sort=True):
        return self._matrix.to_csr(dtype, sort=sort)

    def to_dense(self, fill_value=None, dtype=None, **opts):
        return self._matrix.to_dense(fill_value, dtype, **opts).T

    def to_dicts(self, order="rowwise"):
        return self._matrix.to_dicts("columnwise" if order == "rowwise" else "rowwise")

    def to_edgelist(self, dtype=None, *, values=True, sort=True):
        r, c, v = self.to_coo(dtype, sort=sort)
        edges = np.column_stack([r, c])
        return (edges, v) if values else edges

    def get(self, row, col, default=None):
        return self._matrix.get(col, row, default)

    def __contains__(self, index):
        r, c = index
        return (c, r) in self._matrix

    def mxv(self, other, op="plus_times"):
        """A sparse parent runs the other direction of its own SpMV plan (no
        transposed copy, whose plan would be built anew each call); a dense
        one materializes the transpose, as the reference does."""
        if self._matrix._sparse is None:
            return self.new().mxv(other, op)
        other = self._matrix._expect_type(other, Vector, within="mxv", argname="other")
        return _cops.mxm_expr(self, other, op, "mxv")

    def mxm(self, other, op="plus_times"):
        if self._matrix._sparse is None:
            return self.new().mxm(other, op)
        other = self._matrix._expect_type(other, (Matrix, TransposedMatrix), within="mxm", argname="other")
        return _cops.mxm_expr(self, other, op, "mxm")

    def reduce_rowwise(self, op="plus"):
        return self._matrix.reduce_columnwise(op)

    def reduce_columnwise(self, op="plus"):
        return self._matrix.reduce_rowwise(op)

    def reduce_scalar(self, op="plus", *, allow_empty=True):
        return self._matrix.reduce_scalar(op, allow_empty=allow_empty)

    def diag(self, k=0, dtype=None, *, name=None):
        return self._matrix.diag(-k, dtype, name=name)

    # view delegates the remaining read-only API to a materialized copy
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if hasattr(Matrix, name):
            return getattr(self.new(), name)
        raise AttributeError(name)

    def __getitem__(self, keys):
        return self.new()[keys]

    def __repr__(self):
        from .formatting import format_matrix

        return format_matrix(self)

    def isequal(self, other, **kwargs):
        return self.new().isequal(other, **kwargs)

    def isclose(self, other, **kwargs):
        return self.new().isclose(other, **kwargs)


def _matrix_from_pickle(rows, cols, vals, dtype, nrows, ncols, name):
    """Unpickle onto ``tx.config["platform"]``."""
    return Matrix.from_coo(rows, cols, vals, dtype, nrows=nrows, ncols=ncols, name=name)


Matrix._output_type = Matrix

"""Indexing machinery: IndexerResolver + AmbiguousAssignOrExtract.

Counterpart of ``graphblas_tpu/core/expr.py`` (python-graphblas's
parse_index, AmbiguousAssignOrExtract and the Assigner/Updater setitem).
Indices resolve on the host to numpy index arrays; slices materialize (the
engine gathers with ``index_select``).
"""

import numpy as np
import torch

from .. import exceptions as _exc
from . import dtypes as _dt
from .base import BaseExpression, Updater, _check_mask, statement


class _DimIndex:
    __slots__ = "kind", "index", "size"

    def __init__(self, kind, index, size):
        self.kind = kind  # "int" | "array"
        self.index = index  # int | np.ndarray[int64]
        self.size = size  # None for "int", out-dim size for "array"


def _parse_one(index, dim_size, dim_name):
    from .scalar import Scalar

    if isinstance(index, Scalar):
        if index.is_empty:
            raise _exc.EmptyObject("Empty Scalar is invalid when indexing")
        if not index.dtype._is_int:
            raise TypeError(f"An integer is required for indexing; got Scalar of {index.dtype}")
        index = int(index.value)
    if isinstance(index, (int, np.integer)) and not isinstance(index, (bool, np.bool_)):
        idx = int(index)
        if idx < 0:
            idx += dim_size
        if idx < 0 or idx >= dim_size:
            raise _exc.IndexOutOfBound(f"Index out of range: index={index}, {dim_name}={dim_size}")
        return _DimIndex("int", idx, None)
    if isinstance(index, slice):
        start, stop, step = index.indices(dim_size)
        if step == 1 and start == 0 and stop == dim_size and dim_size > (1 << 26):
            # full slice of a huge (sparse) dimension: kept symbolic, as
            # GrB_ALL; an arange would allocate dim_size int64
            return _DimIndex("all", slice(None), dim_size)
        n_ix = max(0, -(-(stop - start) // step) if step > 0 else -(-(start - stop) // -step))
        if n_ix > (1 << 28):
            raise _exc.OutOfMemory(
                f"slice selects {n_ix} indices; materializing that index array is "
                "not supported — use a full slice (handled symbolically) or smaller ranges"
            )
        arr = np.arange(start, stop, step, dtype=np.int64)
        return _DimIndex("array", arr, len(arr))
    if isinstance(index, (list, tuple, np.ndarray, range)):
        if isinstance(index, (list, tuple)) and any(isinstance(ix, Scalar) for ix in index):
            # lists may mix ints with integer Scalars
            index = [
                int(_parse_one(ix, dim_size, dim_name).index) if isinstance(ix, Scalar) else ix
                for ix in index
            ]
        arr = np.asarray(index)
        if arr.size == 0:
            arr = arr.astype(np.int64)
        if arr.dtype == np.bool_:
            raise TypeError("Boolean indexing is not supported; use a mask instead")
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"{dim_name} indices must be integers, not {arr.dtype}")
        arr = arr.astype(np.int64).reshape(-1)
        neg = arr < 0
        if neg.any():
            arr = np.where(neg, arr + dim_size, arr)
        if ((arr < 0) | (arr >= dim_size)).any():
            raise _exc.IndexOutOfBound(f"Index out of range for dimension of size {dim_size}")
        return _DimIndex("array", arr, len(arr))
    # device arrays
    if hasattr(index, "__array__"):
        return _parse_one(np.asarray(index), dim_size, dim_name)
    raise TypeError(f"Invalid type for index: {type(index)}")


class IndexerResolver:
    """Parse user indices."""

    __slots__ = "parent", "indices"

    def __init__(self, parent, keys):
        self.parent = parent
        if parent.ndim == 1:
            if isinstance(keys, tuple):
                if len(keys) != 1:
                    raise TypeError(f"Index for {type(parent).__name__} cannot be a {len(keys)}-tuple")
                keys = keys[0]
            self.indices = (_parse_one(keys, parent.shape[0], "size"),)
        else:
            if not isinstance(keys, tuple):
                if keys is Ellipsis:
                    keys = (slice(None), slice(None))
                else:
                    raise TypeError(
                        "Index for Matrix must be a 2-tuple (rows, cols); "
                        f"got a single {type(keys).__name__}"
                    )
            if len(keys) != 2:
                raise TypeError(f"Index for Matrix must be a 2-tuple; got {len(keys)} items")
            rows = slice(None) if keys[0] is Ellipsis else keys[0]
            cols = slice(None) if keys[1] is Ellipsis else keys[1]
            self.indices = (
                _parse_one(rows, parent.shape[0], "nrows"),
                _parse_one(cols, parent.shape[1], "ncols"),
            )

    @property
    def out_shape(self):
        return tuple(ix.size for ix in self.indices if ix.kind in ("array", "all"))

    @property
    def is_single_element(self):
        return all(ix.kind == "int" for ix in self.indices)


class AmbiguousAssignOrExtract:
    """``C[idx]``: an extract until assigned to."""

    def __init__(self, parent, resolved_indexes, updater=None):
        self.parent = parent
        self.resolved_indexes = resolved_indexes
        self._updater = updater
        self._input_mask = None
        self._value = None

    # -- shape/type introspection ---------------------------------------------

    @property
    def shape(self):
        return self.resolved_indexes.out_shape

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def output_type(self):
        from .matrix import Matrix
        from .scalar import Scalar
        from .vector import Vector

        n = len(self.shape)
        return (Scalar, Vector, Matrix)[n]

    _output_type = output_type

    # -- extract path ----------------------------------------------------------

    def _with_input_mask(self, input_mask):
        new = AmbiguousAssignOrExtract(self.parent, self.resolved_indexes, updater=self._updater)
        new._input_mask = input_mask
        return new

    def _input_mask_to_mask(self, input_mask):
        """Translate an extract ``input_mask`` into an ordinary OUTPUT mask
        by extracting the mask collection at the same indices (python-graphblas's
        mechanism): a Vector mask on a single-row/column Matrix extract
        applies along the free axis."""
        from .matrix import Matrix, TransposedMatrix
        from .vector import Vector

        parent = self.parent
        mp = input_mask.parent
        if self.shape == ():
            raise ValueError("`input_mask` is not allowed when extracting a single element")
        if isinstance(mp, Vector) and parent.ndim == 2:
            rows, cols = self.resolved_indexes.indices
            if rows.kind == "int":
                if parent.shape[1] != mp.shape[0]:
                    raise ValueError(
                        "Size of `input_mask` Vector does not match ncols of Matrix: "
                        f"{parent.shape[1]} != {mp.shape[0]}"
                    )
                mask_value = mp[cols.index].new()
            elif cols.kind == "int":
                if parent.shape[0] != mp.shape[0]:
                    raise ValueError(
                        "Size of `input_mask` Vector does not match nrows of Matrix: "
                        f"{parent.shape[0]} != {mp.shape[0]}"
                    )
                mask_value = mp[rows.index].new()
            else:
                raise TypeError(
                    "Got Vector `input_mask` when extracting a submatrix from a Matrix.  "
                    "Vector `input_mask` with a Matrix input is only valid when "
                    "extracting from a single row or column."
                )
        elif parent.ndim == 1 and isinstance(mp, (Matrix, TransposedMatrix)):
            raise TypeError("Mask object must be type Vector when extracting from a Vector")
        elif mp.shape != parent.shape:
            attr = "size" if parent.ndim == 1 else "shape"
            raise ValueError(
                f"{attr.capitalize()} of `input_mask` does not match {attr} of input: "
                f"{parent.shape} != {mp.shape}"
            )
        elif parent.ndim == 1:
            (ix,) = self.resolved_indexes.indices
            mask_value = mp[ix.index].new()
        else:
            rows, cols = self.resolved_indexes.indices
            mask_value = mp[rows.index, cols.index].new()
        return type(input_mask)(mask_value)

    def _extract_delayed(self):
        """Return a BaseExpression computing the extraction."""
        parent = self.parent
        res = self.resolved_indexes
        out_cls = self.output_type
        input_mask = self._input_mask
        if input_mask is not None and input_mask.parent.shape != parent.shape:
            raise _exc.DimensionMismatch("input_mask shape must match the indexed collection")

        sp_parent = getattr(parent, "_sparse", None)
        if sp_parent is not None and input_mask is None:
            return self._extract_delayed_sparse(sp_parent)
        # NOTE: input_mask at the USER surface is translated to an output
        # mask in new()/_update (reference mechanism); the struct-AND path
        # below serves only internal callers of _with_input_mask.

        def compute():
            from ..ops import densemasked as _dm

            values, struct = parent._values, parent._struct
            tmap = _dm.tmap
            if input_mask is not None:
                struct = struct & input_mask._bits()
            if parent.ndim == 1:
                (ix,) = res.indices
                if ix.kind == "int":
                    return tmap(lambda a: a[ix.index][None], values), struct[ix.index][None]
                return _dm.extract_vector(values, struct, ix.index)
            rows, cols = res.indices
            if rows.kind == "int" and cols.kind == "int":
                return tmap(lambda a: a[rows.index, cols.index][None], values), struct[rows.index, cols.index][None]
            if rows.kind == "int":
                return _dm.extract_vector(tmap(lambda a: a[rows.index], values), struct[rows.index], cols.index)
            if cols.kind == "int":
                return _dm.extract_vector(tmap(lambda a: a[:, cols.index], values), struct[:, cols.index], rows.index)
            return _dm.extract_matrix(values, struct, rows.index, cols.index)

        from .scalar import Scalar

        if out_cls is Scalar:
            def compute_scalar():
                from ..ops import densemasked as _dm

                v, s = compute()
                return _dm.tmap(lambda a: a[0], v), s[0]

            return BaseExpression(
                "extract_element",
                Scalar,
                compute_scalar,
                dtype=parent.dtype,
                shape=(),
                args=(parent,),
                opname="extract_element",
            )
        return BaseExpression(
            "extract",
            out_cls,
            compute,
            dtype=parent.dtype,
            shape=self.shape,
            args=(parent,),
            opname="extract",
        )

    def _extract_delayed_sparse(self, sp):
        """Extraction over sparse storage: host pattern surgery, no densify.
        The result is sparse past ``tx.config["dense_limit"]`` cells, else
        dense on the parent's device."""
        parent = self.parent
        res = self.resolved_indexes
        out_shape = self.shape
        dev = parent._sp_dev

        from .scalar import Scalar

        if self.output_type is Scalar:

            def compute_scalar():
                if parent.ndim == 1:
                    j = parent._sparse_find(res.indices[0].index)
                else:
                    r, c = res.indices
                    j = parent._sparse_find(r.index, c.index)
                val = sp.vals[j] if j >= 0 else np.zeros((), sp.vals.dtype)
                return _dt.to_tensor(val, sp.dtype, dev), torch.full((), bool(j >= 0), dtype=torch.bool, device=dev)

            return BaseExpression(
                "extract_element", Scalar, compute_scalar, dtype=parent.dtype, shape=(), args=(parent,),
                opname="extract_element",
            )

        def build_sparse():
            from . import sparse as _sps

            if parent.ndim == 1:
                return _sps.sparse_vec_extract(sp, res.indices[0])
            rows, cols = res.indices
            if rows.kind == "int":
                return _sps.sparse_extract_row(sp, rows.index, cols)
            if cols.kind == "int":
                return _sps.sparse_extract_col(sp, cols.index, rows)
            return _sps.sparse_extract(sp, rows, cols)

        def compute():
            return build_sparse().densify(dev)

        from .sparse import _dense_limit

        sparse_compute = None
        if int(np.prod(out_shape, dtype=object)) > _dense_limit():

            def sparse_compute():
                from .matrix import Matrix
                from .sparse import SparseMatrixData
                from .vector import Vector

                out_sp = build_sparse()
                cls = Matrix if isinstance(out_sp, SparseMatrixData) else Vector
                return cls._from_sparse(out_sp, parent.dtype, device=dev)

        return BaseExpression(
            "extract", self.output_type, compute, dtype=parent.dtype, shape=out_shape, args=(parent,),
            opname="extract", sparse_compute=sparse_compute,
        )

    def new(self, dtype=None, *, mask=None, input_mask=None, name=None, **opts):
        if input_mask is not None:
            if mask is not None:
                raise TypeError("mask and input_mask arguments cannot both be given")
            mask = self._input_mask_to_mask(_check_mask(input_mask))
        expr = self._extract_delayed()
        return expr.new(dtype, mask=mask, name=name, **opts)

    dup = new

    @property
    def value(self):
        """Scalar element access (gated on autocompute like every
        value-bearing expression attribute)."""
        if self.shape != ():
            raise AttributeError("Only Scalar extracts have .value")
        self._require_autocompute("value")
        return self._get_value().value

    def _require_autocompute(self, name):
        import graphblas_tpu_torch

        if not graphblas_tpu_torch.config.get("autocompute"):
            raise TypeError(
                "AmbiguousAssignOrExtract is not computed automatically (autocompute "
                f"is off). Call .new() first to access .{name}."
            )

    def _get_value(self):
        if self._value is None:
            self._value = self.new()
        return self._value

    # -- assign path -------------------------------------------------------------

    @statement
    def update(self, value):
        """``C[idx] << value``."""
        if self._updater is not None:
            self._updater[_keys_of(self.resolved_indexes)] = value
        else:
            Updater(self.parent)[_keys_of(self.resolved_indexes)] = value

    def __lshift__(self, value):
        self.update(value)

    def __call__(self, *args, mask=None, accum=None, replace=False, **opts):
        """``C[idx](mask) << value``: subassign, the mask is region-sized
        (GxB_subassign semantics)."""
        from .. import replace as replace_singleton
        from .mask import Mask
        from .base import BaseType
        from .operator import get_typed_op

        for arg in args:
            if arg is replace_singleton or isinstance(arg, bool):
                replace = arg if isinstance(arg, bool) else True
            elif isinstance(arg, (Mask, BaseType)):
                if mask is not None:
                    raise TypeError("Got multiple masks")
                mask = arg
            else:
                if accum is not None:
                    raise TypeError("Got multiple accumulators")
                accum = arg
        if mask is not None:
            mask = _check_mask(mask)  # validated against the region at assign time
        if accum is not None:
            accum = get_typed_op(accum, self.parent.dtype, kind="binary")
        updater = Updater(self.parent, mask=mask, accum=accum, replace=replace, opts=opts, sub=True)
        return _SubAssigner(self.parent, self.resolved_indexes, updater)

    # -- autocompute delegation ----------------------------------------------

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        out_cls = self.output_type
        if hasattr(out_cls, name):
            import graphblas_tpu_torch

            if not graphblas_tpu_torch.config.get("autocompute"):
                raise TypeError(
                    "AmbiguousAssignOrExtract is not computed automatically (autocompute "
                    f"is off). Call .new() first to access .{name}."
                )
            return getattr(self._get_value(), name)
        raise AttributeError(name)

    def __repr__(self):
        return f"{type(self).__name__} {self.parent.name or type(self.parent).__name__}[...]"

    def isequal(self, other, **kwargs):
        self._require_autocompute("isequal")
        return self._get_value().isequal(other, **kwargs)

    def isclose(self, other, **kwargs):
        self._require_autocompute("isclose")
        return self._get_value().isclose(other, **kwargs)

    def __iter__(self):
        self._require_autocompute("__iter__")
        return iter(self._get_value())

    def __contains__(self, item):
        self._require_autocompute("__contains__")
        return item in self._get_value()

    def __array__(self, *args, **kwargs):
        self._require_autocompute("__array__")
        return self._get_value().__array__(*args, **kwargs)


def _keys_of(resolved):
    keys = []
    for ix in resolved.indices:
        keys.append(slice(None) if ix.kind == "all" else ix.index)
    if len(keys) == 1:
        return keys[0]
    return tuple(keys)


class _SubAssigner:
    """Target of ``C[idx](mask, accum) << value`` — subassign semantics."""

    __slots__ = "parent", "resolved", "updater"

    def __init__(self, parent, resolved, updater):
        self.parent = parent
        self.resolved = resolved
        self.updater = updater

    def __lshift__(self, value):
        self.update(value)

    @statement
    def update(self, value):
        self.parent._assign(
            self.resolved,
            value,
            mask=self.updater.mask,
            accum=self.updater.accum,
            replace=self.updater.replace,
            is_submask=True,
        )

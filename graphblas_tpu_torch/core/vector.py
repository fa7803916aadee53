"""Vector: 1-D collection.

Counterpart of ``graphblas_tpu/core/vector.py``, with its two storage
formats: dense-masked (values and structure tensors on the collections'
device) up to ``tx.config["dense_limit"]`` entries, and past it the sparse
(index, value) host arrays of ``core.sparse.SparseVectorData`` with device
caches: the scalable format for huge dimensions.
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
from .scalar import _as_scalar, _is_scalar_like
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


def _sparse_limit():
    from .sparse import _dense_limit

    return _dense_limit()


def _empty_sparse(size, dtype):
    from .sparse import SparseVectorData

    return SparseVectorData(np.empty(0, np.int64), np.empty(0, dtype.np_type), size)


def _apply_dup(rows_or_idx, values, dup_op):
    """Host-side duplicate combination for build/from_coo."""
    if dup_op is None:
        raise ValueError("Duplicate indices found; must provide dup_op to combine them")
    if isinstance(dup_op, str):
        # strings work anywhere an op does (the op-from-string DSL)
        from .operator.utils import binary_from_string

        dup_op = binary_from_string(dup_op)
    name = dup_op.name if hasattr(dup_op, "name") else None
    np_fn = {
        "plus": np.add,
        "times": np.multiply,
        "min": np.minimum,
        "max": np.maximum,
        "any": None,
        "first": None,
        "second": None,
        "lor": np.logical_or,
        "land": np.logical_and,
    }.get(name)
    order = np.argsort(rows_or_idx, kind="stable")
    sorted_idx = rows_or_idx[order]
    sorted_vals = values[order]
    unique, starts = np.unique(sorted_idx, return_index=True)
    if np_fn is not None:
        combined = np_fn.reduceat(sorted_vals, starts) if hasattr(np_fn, "reduceat") else None
        if combined is None:
            combined = np.array([np_fn.reduce(sorted_vals[s:e]) for s, e in zip(starts, list(starts[1:]) + [len(sorted_vals)])])
    elif name in {"first", "any"}:
        combined = sorted_vals[starts]
    elif name == "second":
        ends = np.append(starts[1:], len(sorted_vals)) - 1
        combined = sorted_vals[ends]
    else:
        combined = _fold_dups(sorted_vals, starts, dup_op)
    return unique, combined.astype(values.dtype)


def _fold_dups(sorted_vals, starts, dup_op):
    """Fold each run of duplicates left to right through a typed op's
    function (host tensors of the values' type)."""
    from .operator import get_typed_op as _get

    dt = _dt.lookup_dtype(sorted_vals.dtype)
    op_t = dup_op if hasattr(dup_op, "fn") and hasattr(dup_op, "type_") else _get(dup_op, dt, kind="binary")
    ends = np.append(starts[1:], len(sorted_vals))
    out = []
    for s, e in zip(starts, ends):
        acc = _dt.to_tensor(sorted_vals[s : s + 1], dt, "cpu")
        for i in range(s + 1, e):
            nxt = _dt.to_tensor(sorted_vals[i : i + 1], dt, "cpu")
            acc = _dt.cast(op_t.fn(_dt.cast(acc, dt, op_t.type_), _dt.cast(nxt, dt, op_t.type2)), op_t.return_type, dt)
        out.append(_dt.to_numpy(acc, dt)[0])
    return np.array(out, dtype=sorted_vals.dtype)


class Vector(InfixMixin, BaseType):
    """A 1-D collection of (index, value) pairs over a dtype domain.

    Dense-masked up to ``tx.config["dense_limit"]`` entries; sparse (index,
    value) host arrays (``_sparse``, on the device ``_sp_dev``) past it."""

    # _sparse_, _sp_dev_: capture.HeldSlot data slots, below the class;
    # _tx_config: the per-object ``v.tx.config`` (not data)
    __slots__ = ("_sparse_", "_sp_dev_", "_tx_config")
    ndim = 1
    _output_type = None  # set after class definition

    def __init__(self, dtype=_dt.FP64, size=0, *, name=None):
        self._dtype = _dt.lookup_dtype(dtype)
        size = ensure_int(size, "size")
        dev = collection_device()
        self._sparse = None
        self.name = name
        udt = self._dtype._is_udt
        from . import looplayout as _ll

        _llctx = _ll.active()
        if _llctx is not None and size == _llctx.n and not udt:
            # edge-layout loop body: empty n-sized vectors made inside the
            # body live in the edge layout (core/looplayout.py)
            size = _llctx.e_pad
        if size > _sparse_limit() and not udt:
            self._sparse, self._sp_dev = _empty_sparse(size, self._dtype), dev
            return
        # a UDT vector keeps the dense struct-of-arrays form at any size
        self._values = zero_values((size,), self._dtype, dev)
        self._struct = _dm.s_zeros((size,), dev)

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
    def _from_sparse(cls, sv, dtype, name=None, *, device=None):
        """Wrap a SparseVectorData as a sparse-format Vector on ``device``
        (default: the collections' device)."""
        obj = cls.__new__(cls)
        obj._dtype = _dt.lookup_dtype(dtype)
        obj._sparse = sv
        obj._sp_dev = collection_device() if device is None else canonical_device(device)
        obj.name = name
        return obj

    def _set_storage(self, fmt):
        """Convert the storage format in place: "coo"/"sparse", or
        "densemasked"/"auto" (densify, guarded by tx.config['densify_limit'])."""
        if fmt in ("coo", "sparse"):
            if self._sparse is None:
                from .sparse import SparseVectorData

                idx, vals = self.to_coo()
                self._adopt_sparse(SparseVectorData(idx.astype(np.int64), vals, self.size))
        elif fmt in ("densemasked", "auto"):
            if self._sparse is not None:
                self._values  # noqa: B018 (densify)
        else:
            raise ValueError(f"unknown storage format: {fmt!r}")

    def __getattr__(self, name):
        # sparse-format vectors leave the dense slots unset; the first dense
        # touch materializes them (guarded by tx.config['densify_limit'])
        if name in ("_values", "_struct"):
            sv = BaseType.__getattribute__(self, "_sparse")
            if sv is not None:
                v, st = sv.densify(self._sp_dev)
                self._set_arrays(_dt.cast(v, sv.dtype, self._dtype), st)
                return v if name == "_values" else st
        raise AttributeError(name)

    def _set_arrays(self, values, struct):
        self._sparse = None
        self._values = values
        self._struct = struct

    def _adopt_sparse(self, sv):
        """Switch this Vector to sparse storage on its device (dropping dense
        tensors)."""
        dev = self._device
        for slot in ("_values", "_struct"):
            try:
                delattr(self, slot)
            except AttributeError:
                pass
        self._sparse, self._sp_dev = sv, dev

    @property
    def _device(self):
        return self._sp_dev if self._sparse is not None else self._struct.device

    @property
    def size(self):
        sv = self._sparse
        return sv.size if sv is not None else self._struct.shape[0]

    @property
    def nvals(self):
        sv = self._sparse
        return sv.nvals if sv is not None else BaseType.nvals.fget(self)

    def clear(self):
        if self._sparse is not None:
            self._adopt_sparse(_empty_sparse(self.size, self._sparse.dtype))
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
            i1, v1 = self.to_coo()
            i2, v2 = other.to_coo()
            return np.array_equal(i1, i2) and np.array_equal(v1, v2)
        return BaseType.isequal(self, other, check_dtype=check_dtype)

    @property
    def shape(self):
        return (self.size,)

    def __len__(self):
        return self.nvals

    def __sizeof__(self):
        sv = self._sparse
        if sv is not None:
            return object.__sizeof__(self) + sv.idx.nbytes + sv.vals.nbytes
        v = self._values
        vb = sum(a.nbytes for a in v.values()) if isinstance(v, dict) else v.nbytes
        return object.__sizeof__(self) + vb + self._struct.nbytes

    def __repr__(self):
        from .formatting import format_vector

        return format_vector(self)

    def _repr_html_(self):
        from .formatting import format_vector_html

        return format_vector_html(self)

    def _sparse_find(self, i):
        """Index into sparse storage for entry i, or -1 (host binary search)."""
        sv = self._sparse
        j = int(np.searchsorted(sv.idx, i))
        if j < len(sv.idx) and sv.idx[j] == i:
            return j
        return -1

    def __contains__(self, index):
        idx = IndexerResolver(self, index).indices[0]
        if self._sparse is not None:
            return self._sparse_find(idx.index) >= 0
        return bool(self._struct[idx.index])

    def __iter__(self):
        idx, _ = self.to_coo(values=False)
        return iter(idx.tolist())

    def __reduce__(self):
        idx, vals = self.to_coo()
        return (_vector_from_pickle, (idx, vals, self._dtype, self.size, self.name))

    # -- constructors ------------------------------------------------------------

    @classmethod
    def from_coo(cls, indices, values=1.0, dtype=None, *, size=None, dup_op=None, name=None):
        """Create from (indices, values) on the collections' device."""
        indices = np.asarray(indices, np.int64).reshape(-1)
        if _is_scalar_like(values):
            values = np.full(indices.shape, values)
        values, dtype = values_to_numpy_buffer(values, dtype)
        values = values.reshape(-1)
        if indices.size != values.size:
            raise ValueError(f"`indices` and `values` have different lengths: {indices.size} != {values.size}")
        if size is None:
            if indices.size == 0:
                raise ValueError("No size given and no indices to infer it from")
            size = int(indices.max()) + 1
        size = ensure_int(size, "size")
        if indices.size and (indices.min() < 0 or indices.max() >= size):
            neg = indices < 0
            indices = np.where(neg, indices + size, indices)
            if indices.size and (indices.min() < 0 or indices.max() >= size):
                raise _exc.IndexOutOfBound(f"index out of range for size {size}")
        if indices.size != np.unique(indices).size:
            indices, values = _apply_dup(indices, values, dup_op)
        if size > _sparse_limit() and not dtype._is_udt:
            from .sparse import SparseVectorData

            order = np.argsort(indices, kind="stable")
            sv = SparseVectorData(indices[order], values[order].astype(dtype.np_type), size)
            return cls._from_sparse(sv, dtype, name=name)
        dense_v = np.zeros(size, dtype.np_type)
        dense_s = np.zeros(size, bool)
        dense_v[indices] = values
        dense_s[indices] = True
        dev = collection_device()
        return cls._from_arrays(device_asarray(dense_v, dtype, dev), _dt.to_tensor(dense_s, _dt.BOOL, dev), dtype, name=name)

    @classmethod
    def from_pairs(cls, pairs, dtype=None, *, size=None, dup_op=None, name=None):
        """Create from iterable of (index, value)."""
        pairs = list(pairs)
        if pairs:
            indices, values = zip(*pairs)
        else:
            indices, values = [], []
        return cls.from_coo(np.asarray(indices, np.int64), np.asarray(values), dtype, size=size, dup_op=dup_op, name=name)

    @classmethod
    def from_scalar(cls, value, size, dtype=None, *, name=None):
        """Dense iso-valued vector."""
        sc = _as_scalar(value, dtype)
        dtype = _dt.lookup_dtype(dtype) if dtype is not None else sc.dtype
        size = ensure_int(size, "size")
        dev = collection_device()
        from . import looplayout as _ll

        ctx = _ll.active()
        if ctx is not None and size == ctx.n and not dtype._is_udt:
            # edge-layout loop body: an n-sized iso vector made inside the body
            # is built in the edge layout, present exactly at the state slots
            return cls._from_arrays(
                sc._device_value(dtype, dev).expand(ctx.e_pad).clone(), ctx.universe(dev), dtype, name=name
            )
        return cls._from_arrays(
            _dm.tmap(lambda a: a.expand(size).clone(), sc._device_value(dtype, dev)), _dm.s_ones((size,), dev), dtype, name=name
        )

    @classmethod
    def from_dense(cls, values, missing_value=None, dtype=None, *, name=None):
        """Create from a dense array; missing_value marks absent entries."""
        values, dtype = values_to_numpy_buffer(np.asarray(values), dtype)
        if values.ndim != 1:
            raise ValueError("values must be 1-dimensional for Vector.from_dense")
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
    def from_dict(cls, d, dtype=None, *, size=None, name=None):
        """Create from {index: value}."""
        indices = np.fromiter(d.keys(), np.int64, count=len(d))
        values = np.array(list(d.values()))
        if size is None and len(d) == 0:
            raise ValueError("No size given and no indices to infer it from")
        return cls.from_coo(indices, values, dtype, size=size, name=name)

    # -- exporters ---------------------------------------------------------------

    def to_coo(self, dtype=None, *, indices=True, values=True, sort=True):
        """(indices, values) as numpy arrays (one read of the card; the sparse
        format is host-canonical)."""
        sv = self._sparse
        if sv is not None:
            out_vals = None
            if values:
                out_vals = sv.vals.copy()
                if dtype is not None:
                    out_vals = out_vals.astype(_dt.lookup_dtype(dtype).np_type)
            return (sv.idx.astype(np.uint64) if indices else None), out_vals
        struct = self._struct.cpu().numpy()
        idx = np.nonzero(struct)[0].astype(np.uint64)
        out_idx = idx if indices else None
        out_vals = None
        if values:
            vals = _dt.to_numpy(self._values, self._dtype)[idx.astype(np.int64)]
            if dtype is not None:
                vals = vals.astype(_dt.lookup_dtype(dtype).np_type)
            out_vals = vals
        return out_idx, out_vals

    def to_dense(self, fill_value=None, dtype=None, **opts):
        """Dense numpy array with absent entries filled."""
        if fill_value is None and self.nvals < self.size:
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

    def to_dict(self):
        idx, vals = self.to_coo()
        return dict(zip(idx.tolist(), vals.tolist()))

    # -- maintenance -------------------------------------------------------------

    def build(self, indices, values, *, dup_op=None, clear=False, size=None):
        """Populate from coo; object must be empty unless clear=True."""
        if not clear and self.nvals > 0:
            raise _exc.OutputNotEmpty("Vector already contains values; use clear=True")
        from ..tx import config as _txconfig

        with _txconfig.set(platform=self._device.type):
            new = Vector.from_coo(indices, values, self._dtype, size=size or self.size, dup_op=dup_op)
        if new.size != self.size and size is None:
            raise _exc.DimensionMismatch("built vector size does not match")
        if new._sparse is not None:
            self._adopt_sparse(new._sparse)
        else:
            self._set_arrays(new._values, new._struct)

    def dup(self, dtype=None, *, clear=False, mask=None, name=None, **opts):
        """Duplicate (the tensors, and a sparse vector's host indices, are
        shared: no collection writes into its own)."""
        dtype = _dt.lookup_dtype(dtype) if dtype is not None else self._dtype
        if clear:
            return Vector(dtype, self.size, name=name)
        if self._dtype._is_udt and dtype != self._dtype:
            raise TypeError("Cannot cast a UDT Vector to another dtype in dup")
        if self._sparse is not None and mask is None:
            sv = self._sparse
            return Vector._from_sparse(sv.copy(vals=sv.vals.astype(dtype.np_type)), dtype, name=name, device=self._sp_dev)
        v = _dt.cast(self._values, self._dtype, dtype)
        s = self._struct
        if mask is not None:
            from .base import _check_mask

            mask = _check_mask(mask, self)
            s = s & mask._bits()
            v, s = _dm.canonical(v, s)
        return Vector._from_arrays(v, s, dtype, name=name)

    def resize(self, size):
        """Grow/shrink in place (into new tensors)."""
        size = ensure_int(size, "size")
        cur = self.size
        if size == cur:
            return
        if size < cur:
            self._set_arrays(_dm.tmap(lambda a: a[:size], self._values), self._struct[:size])
        else:
            pad = torch.nn.functional.pad
            self._set_arrays(_dm.tmap(lambda a: pad(a, (0, size - cur)), self._values), pad(self._struct, (0, size - cur)))

    def get(self, index, default=None):
        """Element or default."""
        idx = IndexerResolver(self, index).indices[0]
        if self._sparse is not None:
            j = self._sparse_find(idx.index)
            return self._sparse.vals[j].item() if j >= 0 else default
        if bool(self._struct[idx.index]):
            v = _dt.to_numpy(_dm.tmap(lambda a: a[idx.index], self._values), self._dtype)
            return v[()] if self._dtype._is_udt else v.item()
        return default

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

    def vxm(self, other, op="plus_times"):
        """Vector-matrix multiply."""
        from .matrix import Matrix, TransposedMatrix

        other = self._expect_type(other, (Matrix, TransposedMatrix), within="vxm", argname="other")
        return _cops.mxm_expr(self, other, op, "vxm")

    def apply(self, op, right=None, *, left=None, thunk=None):
        """Elementwise transform."""
        return _cops.apply_expr(self, op, right, left=left, thunk=thunk)

    def select(self, op, thunk=None):
        """Filter entries."""
        return _cops.select_expr(self, op, thunk)

    def reduce(self, op="plus", *, allow_empty=True):
        """Reduce to Scalar."""
        return _cops.reduce_scalar_expr(self, op, allow_empty, "reduce")

    def inner(self, other, op="plus_times"):
        """Dot product."""
        other = self._expect_type(other, Vector, within="inner", argname="other")
        return _cops.mxm_expr(self, other, op, "inner")

    def outer(self, other, op="times"):
        """Outer product."""
        from .matrix import Matrix

        other = self._expect_type(other, Vector, within="outer", argname="other")
        op_t = get_typed_op(op, self.dtype, other.dtype, kind="binary")
        from .operator import find_opclass

        _, opclass = find_opclass(op_t)
        if opclass == "Semiring":
            op_t = op_t.binaryop

        from .base import _same_device

        _same_device(self, other, "outer")

        def compute():
            av, as_ = _dt.cast(self._values, self.dtype, op_t.type_), self._struct
            bv, bs = _dt.cast(other._values, other.dtype, op_t.type2), other._struct
            return _dm.kronecker(av[:, None], as_[:, None], bv[None, :], bs[None, :], op_t, op_t.return_type)

        return BaseExpression(
            "outer",
            Matrix,
            compute,
            op=op_t,
            dtype=op_t.return_type,
            shape=(self.size, other.size),
            args=(self, other),
            opname=f"outer[{op_t.name}]",
        )

    def reposition(self, offset, *, size=None):
        """Shift all entries by offset."""
        offset = ensure_int(offset, "offset")
        out_size = self.size if size is None else ensure_int(size, "size")

        def compute():
            dev = self._struct.device
            idx = torch.arange(out_size, device=dev)
            valid = (idx >= offset) & (idx - offset < self.size)
            src = (idx - offset).clamp(0, max(self.size - 1, 0))
            vv = torch.where(valid, self._values[src], torch.zeros((), dtype=self._values.dtype, device=dev))
            ss = torch.where(valid, self._struct[src], False)
            return vv, ss

        return BaseExpression(
            "reposition", Vector, compute, dtype=self.dtype, shape=(out_size,), args=(self,), opname="reposition"
        )

    # -- conversions -------------------------------------------------------------

    def _as_matrix(self):
        """Zero-copy view as an n-by-1 matrix."""
        from .matrix import Matrix

        return Matrix._from_arrays(_dm.tmap(lambda a: a[:, None], self._values), self._struct[:, None], self._dtype, name=self.name)

    @property
    def tx(self):
        from ..tx.vector import VectorTx

        return VectorTx(self)

    ss = tx

    def diag(self, k=0):
        """Create a matrix with this vector on diagonal k."""
        n = self.size + abs(int(k))
        v, s = _dm.diag_build(self._values, self._struct, int(k), n, n)
        from .matrix import Matrix

        return Matrix._from_arrays(v, s, self._dtype)


_cap.hold_slots(Vector, "_sparse", "_sp_dev")


def _vector_from_pickle(idx, vals, dtype, size, name):
    """Unpickle onto ``tx.config["platform"]``."""
    return Vector.from_coo(idx, vals, dtype, size=size, name=name)


Vector._output_type = Vector

"""Shared expression builders for Matrix and Vector.

Counterpart of the dense branches of ``graphblas_tpu/core/collection_ops.py``.
Each builder returns a BaseExpression whose compute closure calls the engine
(``ops.densemasked``): this is the layer where python-graphblas picks a
``cfunc_name`` (e.g. "GrB_Matrix_eWiseMult_BinaryOp"); here it binds typed
torch ops into engine closures.  Operands are read when the expression is
computed; the values handed to an op are converted to its input types
(``_cast_values``).  Where an operand is in the sparse format, the sparse
branch runs instead: ewise, apply, select and extract as host pattern work
with the values on the device, reduce as a segment reduce, ``mxv``/``vxm``
on the SpMV engine (``core.sparse.sparse_mxv``: the plan channel's kernels
or the generic gather) or, for a sparse vector or a huge output, the host
join ``sparse_mxv_sv``, ``C(M) << A.mxm(B)`` on the masked SpGEMM
(``sparse_mxm_masked``: eqjoin), an unmasked ``A.mxm(B)`` on
``sparse_spgemm_full``, and assign and delete as host pattern surgery.
Inside an engaged mesh Context (``_mesh_context``, ``parallel``) the sparse
``mxv``/``vxm`` take the sharded SpMV engine (a sparse vector densified
under ``densify_limit``), the masked SpGEMM runs by mask-row blocks, and
dense ``mxm``/``mxv``/``vxm`` run SUMMA.
"""

import numpy as np
import torch

from .. import exceptions as _exc
from ..ops import densemasked as _dm
from . import dtypes as _dt
from ..parallel import blocks as _blocks
from .base import BaseExpression, _same_device, layout_of, stored
from .operator import find_opclass, get_typed_op
from .scalar import Scalar, _as_scalar, _is_scalar_like


def _arrays_of(obj):
    return obj._values, obj._struct


def _in_layout(obj, lay):
    """(values, struct) of ``obj`` in layout ``lay`` (cut when elsewhere)."""
    return tuple(_blocks.relayout(t, lay) for t in stored(obj))


def _route(shape, objs, fn, *, offsets=False):
    """The compute closure of an elementwise family: ``fn(v0, s0, v1, s1,
    ...)`` on the operands' whole tensors, or, where any operand is placed
    (``parallel.blocks``), block by block in the result's layout (the
    reference's XLA propagation: ``blocks.merge_layouts``), the blocks'
    global offsets given as ``offset=`` when ``offsets``."""

    def compute():
        lay = _blocks.merge_layouts([layout_of(o) for o in objs], shape)
        if lay is None:
            args = [t for o in objs for t in _arrays_of(o)]
            return fn(*args, offset=None) if offsets else fn(*args)
        return _blocks.blockwise(fn, lay, *[t for o in objs for t in _in_layout(o, lay)], offsets=offsets)

    return compute


def _mesh_context():
    """The engaged parallel.Context, if any (thread-local stack)."""
    from ..parallel import current_context

    return current_context()


def _sparse_of(obj):
    """(SparseMatrixData, is_transposed) for sparse-format operands, else (None, False)."""
    from .matrix import TransposedMatrix

    m = obj._matrix if isinstance(obj, TransposedMatrix) else obj
    sp = getattr(m, "_sparse", None)
    if sp is None or m.ndim != 2:
        return None, False
    return sp, isinstance(obj, TransposedMatrix)


def _sp_nonudt(sp):
    """True for sparse data whose values support the device kernels (non-UDT)."""
    return sp is not None and sp.vals.dtype.names is None


def _vec_sparse_of(obj):
    """SparseVectorData for sparse-format Vector operands, else None."""
    return getattr(obj, "_sparse", None) if obj.ndim == 1 else None


def _to_sv(vec):
    """SparseVectorData view of any Vector (host conversion when dense)."""
    from .sparse import SparseVectorData

    sv = _vec_sparse_of(vec)
    if sv is not None:
        return sv
    idx, vals = vec.to_coo()
    return SparseVectorData(idx.astype(np.int64), vals, vec.size)


def _host_scalar(sc):
    """A Scalar's host value (a union default)."""
    return np.asarray(sc.value if hasattr(sc, "value") else sc)[()]


def _cast_values(v, dtype, to):
    """Convert engine values of ``dtype`` to an op's input type ``to``."""
    return _dt.cast(v, dtype, to)


def _check_same_shape(a, b, within):
    if a.shape != b.shape:
        raise _exc.DimensionMismatch(
            f"Dimensions not compatible in {within}: {a.shape} != {b.shape}"
        )


def ewise_expr(self, other, op, how, *, left_default=None, right_default=None):
    """eWiseAdd / eWiseMult / eWiseUnion."""
    from .matrix import Matrix, TransposedMatrix
    from .vector import Vector

    other = self._expect_type(
        other,
        (Matrix, TransposedMatrix, Vector),
        within=f"ewise_{how}",
        argname="other",
    )
    _same_device(self, other, f"ewise_{how}")
    # mixed-rank broadcast recipes (python-graphblas's _v_add_m/_v_mult_m and
    # _m_add_v/_m_mult_v): a Vector on the left broadcasts v[i] across row
    # i; on the right, v[j] across column j.
    vec_left = vec_right = False
    if other.ndim != self.ndim:
        if self.ndim == 1 and other.ndim == 2:
            if self.shape[0] != other.shape[0]:
                raise _exc.DimensionMismatch(
                    f"ewise_{how} broadcast: vector size {self.shape[0]} != nrows {other.shape[0]}"
                )
            vec_left = True
        else:
            if other.shape[0] != self.shape[1]:
                raise _exc.DimensionMismatch(
                    f"ewise_{how} broadcast: vector size {other.shape[0]} != ncols {self.shape[1]}"
                )
            vec_right = True
        out_shape = other.shape if vec_left else self.shape
    else:
        _check_same_shape(self, other, f"ewise_{how}")
        out_shape = self.shape
    op_t = get_typed_op(op, self.dtype, other.dtype, kind="binary")
    _, opclass = find_opclass(op_t)
    if opclass == "Semiring":
        # semirings work in ewise: the multiply op for mult, the add monoid
        # for add
        op_t = op_t.binaryop if how == "mult" else op_t.monoid
    out_cls = Matrix if len(out_shape) == 2 else Vector

    def _operands():
        av, as_ = _arrays_of(self)
        bv, bs = _arrays_of(other)
        av = _cast_values(av, self.dtype, op_t.type_)
        bv = _cast_values(bv, other.dtype, op_t.type2)
        if vec_left:
            av = av[:, None].expand(out_shape)
            as_ = as_[:, None].expand(out_shape)
        elif vec_right:
            bv = bv[None, :].expand(out_shape)
            bs = bs[None, :].expand(out_shape)
        return av, as_, bv, bs

    if how == "union":
        ld = _as_scalar(left_default)
        rd = _as_scalar(right_default)

        def engine(av, as_, bv, bs, op_t, offset=None):
            return _dm.ewise_union(
                av, as_, bv, bs, op_t, ld._device_value(op_t.type_, as_.device), rd._device_value(op_t.type2, as_.device),
                offset=offset,
            )

    else:
        engine = _dm.ewise_mult if how == "mult" else _dm.ewise_add

    if vec_left or vec_right:

        def compute():
            return engine(*_operands(), op_t)

    else:

        def block(av, as_, bv, bs, offset=None):
            av = _cast_values(av, self.dtype, op_t.type_)
            bv = _cast_values(bv, other.dtype, op_t.type2)
            return engine(av, as_, bv, bs, op_t, offset=offset)

        compute = _route(out_shape, (self, other), block, offsets=True)

    # sparse-sparse ewise: host merge-join + device combine, no densify
    # (keeps 2^60-scale dimensions representable)
    sparse_fn = None
    dev = self._device
    uargs = {} if how != "union" else {"ld": _host_scalar(ld), "rd": _host_scalar(rd)}
    if self.ndim == 1 and other.ndim == 1 and (_vec_sparse_of(self) is not None or _vec_sparse_of(other) is not None):

        def sparse_fn():
            from .sparse import sparse_vec_ewise

            sv2 = sparse_vec_ewise(_to_sv(self), _to_sv(other), op_t, how, op_t.return_type, device=dev, **uargs)
            return Vector._from_sparse(sv2, op_t.return_type, device=dev)

    if self.ndim == 2 and other.ndim == 2:
        a_sp, a_t = _sparse_of(self)
        b_sp, b_t = _sparse_of(other)
        if a_sp is not None and b_sp is not None:

            def sparse_fn():
                from .sparse import sparse_ewise

                asp = a_sp.transposed() if a_t else a_sp
                bsp = b_sp.transposed() if b_t else b_sp
                sp2 = sparse_ewise(asp, bsp, op_t, how, op_t.return_type, device=dev, **uargs)
                return Matrix._from_sparse(sp2, op_t.return_type, device=dev)

    return BaseExpression(
        f"ewise_{how}",
        out_cls,
        compute,
        op=op_t,
        dtype=op_t.return_type,
        shape=out_shape,
        args=(self, other),
        opname=f"ewise_{how}[{op_t.name}]",
        sparse_compute=sparse_fn,
    )


def apply_expr(self, op, right=None, *, left=None, thunk=None):
    """GrB_apply: unary / bound-binary / indexunary+thunk."""
    from .matrix import Matrix
    from .vector import Vector

    out_cls = Matrix if self.ndim == 2 else Vector
    op_resolved, opclass = find_opclass(op if not isinstance(op, str) else None)
    if isinstance(op, str):
        from .operator.utils import resolve_op_string

        # a string + second positional arg may name an indexunary op with a
        # thunk, e.g. v.apply("rowindex", 0)
        if right is not None and thunk is None:
            try:
                op = resolve_op_string(op, "indexunary")
                right, thunk = None, right
            except ValueError:
                op = get_typed_op(op, self.dtype, kind="unary|binary")
        else:
            op = get_typed_op(op, self.dtype, kind="unary|binary")
        op_resolved, opclass = find_opclass(op)

    if opclass in {"IndexUnaryOp", "SelectOp"}:
        if opclass == "SelectOp":
            # a SelectOp lifts to its IndexUnaryOp for apply
            op = op._iu if hasattr(op, "_iu") and op._iu is not None else op
        if left is not None:
            raise TypeError("left= is not allowed for IndexUnaryOp apply; pass the thunk")
        if right is not None:
            # the thunk rides the ``right`` slot for indexunary apply
            # (A.apply(indexunary.tril, 2))
            if thunk is not None:
                raise TypeError("pass the IndexUnaryOp thunk as either right or thunk, not both")
            thunk = right
        op_t = get_typed_op(op, self.dtype, kind="indexunary")
        thunk_s = _as_scalar(thunk if thunk is not None else 0, getattr(op_t.parent, "_thunk_dtype", None))

        def block(v, s, offset=None):
            v = _cast_values(v, self.dtype, op_t.type_)
            return _dm.apply_indexunary(v, s, op_t, thunk_s._device_value(device=s.device), offset)

        compute = _route(self.shape, (self,), block, offsets=True)

        sparse_fn = None
        sp, transposed = _sparse_of(self)
        sv = _vec_sparse_of(self)
        if _sp_nonudt(sp) and not transposed:

            def sparse_fn():
                from .sparse import sparse_apply_indexunary

                dev = self._device
                sp2 = sparse_apply_indexunary(sp, op_t, thunk_s._device_value(device=dev), op_t.return_type, dev)
                return Matrix._from_sparse(sp2, op_t.return_type, device=dev)

        elif sv is not None:

            def sparse_fn():
                from .sparse import sparse_vec_apply_indexunary

                dev = self._device
                sv2 = sparse_vec_apply_indexunary(sv, op_t, thunk_s._device_value(device=dev), op_t.return_type, dev)
                return Vector._from_sparse(sv2, op_t.return_type, device=dev)

        return BaseExpression(
            "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]",
            sparse_compute=sparse_fn,
        )

    if right is None and left is None and thunk is None:
        op_t = get_typed_op(op, self.dtype, kind="unary")
        _, opclass2 = find_opclass(op_t)
        if opclass2 == "BinaryOp":
            raise TypeError(
                f"Binary op {op_t.name} passed to apply without left or right; "
                "provide `left=` or `right=` to bind one argument"
            )
        sp, transposed = _sparse_of(self)
        sv = _vec_sparse_of(self)
        sparse_fn = None
        if getattr(op_t, "positional", None) is not None:

            def block(v, s, offset=None):
                return _dm.apply_positional_unary(v, s, op_t, offset)

            compute = _route(self.shape, (self,), block, offsets=True)

            if (_sp_nonudt(sp) and not transposed) or sv is not None:

                def sparse_fn():
                    from .sparse import sparse_apply_positional, sparse_vec_apply_positional

                    pos = op_t.positional
                    which, delta = pos if not isinstance(pos, str) else (pos, 0)
                    out_np = np.dtype(op_t.return_type.np_type)
                    if sv is not None:
                        return Vector._from_sparse(sparse_vec_apply_positional(sv, which, delta, out_np), op_t.return_type, device=self._device)
                    return Matrix._from_sparse(sparse_apply_positional(sp, which, delta, out_np), op_t.return_type, device=self._device)

        else:

            def block(v, s):
                return _dm.apply_unary(_cast_values(v, self.dtype, op_t.type_), s, op_t)

            compute = _route(self.shape, (self,), block)

            if (_sp_nonudt(sp) and not transposed) or sv is not None:

                def sparse_fn():
                    return _sparse_apply_values(self, sp, sv, lambda v: op_t.fn(_cast_values(v, self.dtype, op_t.type_)), op_t)

        return BaseExpression(
            "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]",
            sparse_compute=sparse_fn,
        )

    if right is not None and left is not None:
        raise TypeError("Cannot provide both `left` and `right` to apply")
    bound = right if right is not None else left
    if not _is_scalar_like(bound) and not isinstance(bound, Scalar):
        raise TypeError(f"`{'right' if right is not None else 'left'}` must be a scalar; got {type(bound)}")
    bound = _as_scalar(bound)
    if right is not None:
        op_t = get_typed_op(op, self.dtype, bound.dtype, is_right_scalar=True, kind="binary")
    else:
        op_t = get_typed_op(op, bound.dtype, self.dtype, is_left_scalar=True, kind="binary")

    def block(v, s):
        v = _cast_values(v, self.dtype, op_t.type_ if right is not None else op_t.type2)
        b = bound._device_value(op_t.type2 if right is not None else op_t.type_, s.device)
        return _dm.apply_bound(v, s, op_t, b, "right" if right is not None else "left")

    compute = _route(self.shape, (self,), block)

    sparse_fn = None
    sp, transposed = _sparse_of(self)
    sv = _vec_sparse_of(self)
    if ((_sp_nonudt(sp) and not transposed) or sv is not None) and getattr(op_t, "positional", None) is None:

        def sparse_fn():
            in_t = op_t.type_ if right is not None else op_t.type2
            b = bound._device_value(op_t.type2 if right is not None else op_t.type_, self._device)
            if right is not None:
                fn = lambda v: op_t.fn(_cast_values(v, self.dtype, in_t), b)  # noqa: E731
            else:
                fn = lambda v: op_t.fn(b, _cast_values(v, self.dtype, in_t))  # noqa: E731
            return _sparse_apply_values(self, sp, sv, fn, op_t)

    return BaseExpression(
        "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]",
        sparse_compute=sparse_fn,
    )


def _sparse_apply_values(self, sp, sv, fn, op_t):
    """``fn`` over a sparse collection's values on its device, the pattern
    unchanged."""
    from .matrix import Matrix
    from .sparse import sparse_apply_values, sparse_vec_apply_values
    from .vector import Vector

    dev = self._device
    if sv is not None:
        return Vector._from_sparse(sparse_vec_apply_values(sv, fn, op_t.return_type, op_t.return_type, dev), op_t.return_type, device=dev)
    return Matrix._from_sparse(sparse_apply_values(sp, fn, op_t.return_type, op_t.return_type, dev), op_t.return_type, device=dev)


def select_expr(self, op, thunk=None):
    """GrB_select.

    Besides SelectOps and comparison strings, accepts a Mask or a boolean
    collection/expression: entries of ``self`` are kept where the mask is
    true.
    """
    from .expr import AmbiguousAssignOrExtract
    from .mask import Mask, ValueMask
    from .matrix import Matrix, TransposedMatrix
    from .vector import Vector

    if isinstance(op, str) and any(c in op for c in "<>=!"):
        if thunk is None:
            op, thunk = _parse_select_string(op)
        else:
            op = _bare_select_op(op)
    mask_obj = None
    if isinstance(op, Mask):
        mask_obj = op
    elif isinstance(op, (BaseExpression, AmbiguousAssignOrExtract, TransposedMatrix)):
        mask_obj = ValueMask(op.new())
    elif isinstance(op, (Vector, Matrix)):
        mask_obj = ValueMask(op)
    if mask_obj is not None:
        if thunk is not None:
            raise TypeError(
                "thunk argument not None when calling select with mask or boolean object"
            )
        if mask_obj.parent.shape != self.shape:
            raise _exc.DimensionMismatch(
                f"select mask shape {mask_obj.parent.shape} != {self.shape}"
            )
        out_cls_m = Matrix if self.ndim == 2 else Vector

        def block(v, s, mv, ms):
            keep = s & _dm.mask_to_bits(mv, ms, mask_obj.complement, mask_obj.structure)
            return _dm.canonical(v, keep)

        route = _route(self.shape, (self, mask_obj.parent), block)

        def compute_mask():
            if layout_of(self) is None and layout_of(mask_obj.parent) is None:
                v, s = _arrays_of(self)
                keep = s & mask_obj._bits()
                return torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device)), keep
            return route()

        return BaseExpression(
            "select",
            out_cls_m,
            compute_mask,
            op=None,
            dtype=self.dtype,
            shape=self.shape,
            args=(self,),
            opname="select[mask]",
        )
    out_cls = Matrix if self.ndim == 2 else Vector
    op_t = get_typed_op(op, self.dtype, kind="select")
    thunk_s = _as_scalar(thunk if thunk is not None else 0, getattr(op_t.parent, "_thunk_dtype", None))

    def block(v, s, offset=None):
        return _dm.select_op(v, s, op_t, thunk_s._device_value(device=s.device), offset)

    compute = _route(self.shape, (self,), block, offsets=True)

    sparse_fn = None
    sp, transposed = _sparse_of(self)
    sv = _vec_sparse_of(self)
    if _sp_nonudt(sp) and not transposed:

        def sparse_fn():
            from .sparse import sparse_select

            dev = self._device
            return Matrix._from_sparse(sparse_select(sp, op_t, thunk_s._device_value(device=dev), dev), self.dtype, device=dev)

    elif sv is not None:

        def sparse_fn():
            from .sparse import sparse_vec_select

            dev = self._device
            return Vector._from_sparse(sparse_vec_select(sv, op_t, thunk_s._device_value(device=dev), dev), self.dtype, device=dev)

    return BaseExpression(
        "select", out_cls, compute, op=op_t, dtype=self.dtype, shape=self.shape, args=(self,), opname=f"select[{op_t.name}]",
        sparse_compute=sparse_fn,
    )


def _parse_select_string(string):
    """Support e.g. select("value <= 5") / select(">0") shorthand."""
    import re

    s = string.replace("value", "").strip()
    m = re.match(r"(==|!=|<=|>=|<|>)\s*(.+)", s)
    if m is None:
        raise ValueError(f"Invalid select string: {string!r}")
    cmp_map = {"==": "valueeq", "!=": "valuene", "<": "valuelt", "<=": "valuele", ">": "valuegt", ">=": "valuege"}
    thunk = float(m.group(2)) if "." in m.group(2) or "e" in m.group(2).lower() else int(m.group(2))
    import graphblas_tpu_torch.select as select_mod

    return getattr(select_mod, cmp_map[m.group(1)]), thunk


def _bare_select_op(string):
    """Comparison string with the thunk passed separately: select("==", 1),
    select("index<", 4), select("row<=", 2)."""
    import re

    m = re.match(r"(value|index|row|col|column)?\s*(==|!=|<=|>=|<|>)$", string.strip())
    if m is None:
        raise ValueError(f"Unknown op string for kind=select: {string!r}")
    prefix = {None: "value", "value": "value", "index": "index", "row": "row", "col": "col", "column": "col"}[m.group(1)]
    suffix = {"==": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}[m.group(2)]
    import graphblas_tpu_torch.select as select_mod

    return getattr(select_mod, prefix + suffix)


def reduce_axis_expr(self, monoid, axis, method_name):
    """reduce_rowwise/columnwise."""
    from .vector import Vector

    monoid_t, opclass = _resolve_reduce_op(monoid, self.dtype)
    out_size = self.shape[0] if axis == 1 else self.shape[1]
    if opclass == "Aggregator":
        return BaseExpression(
            method_name, Vector, None, op=monoid_t, dtype=monoid_t.return_type, shape=(out_size,), args=(self,), opname=method_name
        )

    sp, transposed = _sparse_of(self)
    if _sp_nonudt(sp):
        sp_axis = (1 - axis) if transposed else axis

        def compute():
            from .sparse import sparse_reduce_axis

            return sparse_reduce_axis(sp, monoid_t, sp_axis, self._device)

    else:

        def block(v, s):
            return _dm.reduce_axis(_cast_values(v, self.dtype, monoid_t.type_), s, monoid_t, axis)

        def compute():
            lay = layout_of(self)
            if lay is not None:
                # each block reduces along its own axis; the partials fold
                # across the reduced mesh axis in shard order
                return _blocks.reduce_axis(*stored(self), monoid_t, axis, block)
            return block(*_arrays_of(self))

    return BaseExpression(
        method_name, Vector, compute, op=monoid_t, dtype=monoid_t.return_type, shape=(out_size,), args=(self,), opname=f"{method_name}[{monoid_t.name}]"
    )


def reduce_scalar_expr(self, monoid, allow_empty, method_name="reduce_scalar"):
    """reduce to Scalar."""
    monoid_t, opclass = _resolve_reduce_op(monoid, self.dtype)
    if opclass == "Aggregator":
        return BaseExpression(
            method_name, Scalar, None, op=monoid_t, dtype=monoid_t.return_type, shape=(), args=(self,), opname=method_name
        )

    sp, _ = _sparse_of(self)
    sv = _vec_sparse_of(self)

    def compute():
        if sv is not None:
            from .sparse import sparse_vec_reduce_scalar

            val, present = sparse_vec_reduce_scalar(sv, monoid_t, self._device)
        elif _sp_nonudt(sp):
            from .sparse import sparse_reduce_scalar

            val, present = sparse_reduce_scalar(sp, monoid_t, self._device)
        elif layout_of(self) is not None:
            # each block's reduce, folded in shard order on the mesh's first device
            val, present = _blocks.reduce_all(
                *stored(self), monoid_t, lambda v, s: _dm.reduce_all(_cast_values(v, self.dtype, monoid_t.type_), s, monoid_t)
            )
        else:
            v, s = _arrays_of(self)
            v = _cast_values(v, self.dtype, monoid_t.type_)
            val, present = _dm.reduce_all(v, s, monoid_t)
        if not allow_empty:
            ident = monoid_t.identity
            if ident is not None:
                val = torch.where(present, val, _dt.scalar_tensor(ident, monoid_t.return_type, val.device))
            present = torch.ones((), dtype=torch.bool, device=val.device)
        return val, present

    return BaseExpression(
        method_name, Scalar, compute, op=monoid_t, dtype=monoid_t.return_type, shape=(), args=(self,), opname=f"{method_name}[{monoid_t.name}]"
    )


def _resolve_reduce_op(monoid, dtype):
    from .operator.agg import Aggregator, TypedAggregator

    if isinstance(monoid, (Aggregator, TypedAggregator)):
        return monoid[dtype] if isinstance(monoid, Aggregator) else monoid, "Aggregator"
    if isinstance(monoid, str):
        monoid = get_typed_op(monoid, dtype, kind="binary|aggregator")
        _, opclass = find_opclass(monoid)
        if opclass == "Aggregator":
            return monoid, "Aggregator"
    monoid_t = get_typed_op(monoid, dtype, kind="monoid")
    _, opclass = find_opclass(monoid_t)
    if opclass == "BinaryOp":
        parent_monoid = monoid_t.monoid
        if parent_monoid is None:
            raise _exc.DomainMismatch(f"BinaryOp {monoid_t.name} has no corresponding monoid for reduce")
        monoid_t = parent_monoid
        opclass = "Monoid"
    if opclass == "Aggregator":
        return monoid_t, "Aggregator"
    return monoid_t, opclass


def mxm_expr(a, b, semiring_op, method_name="mxm"):
    """GrB_mxm / mxv / vxm: the sparse engines where an operand matrix is
    sparse, else the dense-masked engine."""
    from .matrix import Matrix
    from .vector import Vector

    a_is_vec = a.ndim == 1
    b_is_vec = b.ndim == 1
    k1 = a.shape[0] if a_is_vec else a.shape[1]
    k2 = b.shape[0]
    if k1 != k2:
        raise _exc.DimensionMismatch(
            f"Dimensions not compatible for {method_name}: inner dims {k1} != {k2}"
        )
    sr = get_typed_op(semiring_op, a.dtype, b.dtype, kind="semiring")
    _, opclass = find_opclass(sr)
    if opclass == "BinaryOp":
        raise TypeError(f"{method_name} requires a Semiring; got BinaryOp {sr.name}. Maybe use a monoid_binaryop name.")
    if a_is_vec and b_is_vec:
        out_cls, shape = Scalar, ()
    elif a_is_vec:
        out_cls, shape = Vector, (b.shape[1],)
    elif b_is_vec:
        out_cls, shape = Vector, (a.shape[0],)
    else:
        out_cls, shape = Matrix, (a.shape[0], b.shape[1])
    _same_device(a, b, method_name)

    sparse = _sparse_mxm_expr(a, b, sr, method_name, out_cls, shape)
    if sparse is not None:
        return sparse

    def compute():
        from ..tx import config as _txconfig

        # read at compute time so per-call descriptor opts (applied as a
        # config context by BaseType._update) take effect
        strategy = _txconfig.get("mxm_strategy", "auto")
        # inside an engaged mesh Context, dense products run SUMMA over the
        # mesh (UDT operands never do), reading placed operands' blocks where
        # they sit; the product stays placed, Blocks P(i,)
        ctx = _mesh_context()
        if ctx is not None and not a.dtype._is_udt and not b.dtype._is_udt and not (a_is_vec and b_is_vec):
            from ..parallel import summa as _summa

            mul_parent = sr.binaryop.parent
            vxm_ok = getattr(mul_parent, "commutes_to", None) is mul_parent and sr.binaryop.positional is None
            if not a_is_vec or vxm_ok:
                (av, as_), (bv, bs) = stored(a), stored(b)
                av = _summa._cast(av, a.dtype, sr.binaryop.type_)
                bv = _summa._cast(bv, b.dtype, sr.binaryop.type2)
                if not a_is_vec and not b_is_vec:
                    return _summa.summa_mxm_arrays(av, as_, bv, bs, sr, sr.return_type, ctx.mesh)
                if b_is_vec:
                    return _summa.summa_mxv_arrays(av, as_, bv, bs, sr, sr.return_type, ctx.mesh)
                # vxm: run as mxv of B^T, exact only for a commutative, non-positional multiply
                return _summa.summa_mxv_arrays(bv.T, bs.T, av, as_, sr, sr.return_type, ctx.mesh)
        av, as_ = _arrays_of(a)
        bv, bs = _arrays_of(b)
        av = _cast_values(av, a.dtype, sr.binaryop.type_)
        bv = _cast_values(bv, b.dtype, sr.binaryop.type2)
        if a_is_vec and b_is_vec:
            cv, cs = _dm.vxm(av, as_, _dm.tmap(lambda x: x[:, None], bv), bs[:, None], sr, sr.return_type, strategy)
            return _dm.tmap(lambda x: x[0], cv), cs[0]
        if a_is_vec:
            return _dm.vxm(av, as_, bv, bs, sr, sr.return_type, strategy)
        if b_is_vec:
            return _dm.mxv(av, as_, bv, bs, sr, sr.return_type, strategy)
        return _dm.mxm(av, as_, bv, bs, sr, sr.return_type, strategy)

    return BaseExpression(
        method_name,
        out_cls,
        compute,
        op=sr,
        dtype=sr.return_type,
        shape=shape,
        args=(a, b),
        opname=f"{method_name}[{sr.name}]",
    )


def _sparse_mxm_expr(a, b, sr, method_name, out_cls, shape):
    """The expression of a product over a sparse matrix operand, or None.

    mxv/vxm run the O(E) SpMV engine (``sparse_mxv``: the plan channel or the
    generic gather + segment reduce), never densifying the matrix; with a
    sparse vector or an output past ``dense_limit``, the host join
    ``sparse_mxv_sv`` gives a sparse vector.  ``A.mxm(B)`` with a dense B
    of k columns is the engine's k-column product (``sparse_mxm_dense``).
    A product of two sparse matrices is the unmasked ``sparse_spgemm_full``
    (sparse output), and
    ``C(M) << A.mxm(B)`` hands the masked SpGEMM to ``_update``
    (``_sparse_masked_mxm``); its dense compute densifies the operands
    (guarded)."""
    from .matrix import Matrix
    from .sparse import _dense_limit
    from .vector import Vector

    a_is_vec, b_is_vec = a.ndim == 1, b.ndim == 1
    a_sp, a_t = _sparse_of(a) if not a_is_vec else (None, False)
    b_sp, b_t = _sparse_of(b) if not b_is_vec else (None, False)
    dev = a._device
    msp = vec = pull_dir = a_first = None
    if _sp_nonudt(a_sp) and b_is_vec:
        # GrB_mxv: y = A (.) x ; A.T flips to the push direction
        msp, vec, pull_dir, a_first = a_sp, b, not a_t, True
    elif _sp_nonudt(b_sp) and a_is_vec:
        # GrB_vxm: w = x (.) A ; the vector is the op's first arg
        msp, vec, pull_dir, a_first = b_sp, a, b_t, False

    if msp is not None:
        n_out = shape[0]
        out_sparse = n_out > _dense_limit()
        if _vec_sparse_of(vec) is not None or out_sparse:
            # a sparse vector operand and/or a huge output dimension: the host
            # O(E log nnz(x)) join gives a SPARSE vector, nothing densifies
            # at any dimension
            def sv_compute():
                from .sparse import SparseVectorData, _densify_limit, sparse_mxv, sparse_mxv_sv

                ctx = _mesh_context()
                if ctx is not None and vec.size <= _densify_limit() and n_out <= _densify_limit():
                    # engaged mesh Context: densify x and run the device
                    # (sharded-plan) engine, then re-sparsify the output
                    xv, xs = _to_sv(vec).densify(dev)
                    yv, ys = sparse_mxv(msp, pull_dir, a_first, xv, xs, sr, sr.return_type, x_type=vec.dtype)
                    idx = torch.nonzero(ys).reshape(-1)
                    sv2 = SparseVectorData(idx.cpu().numpy().astype(np.int64), _dt.to_numpy(yv[idx], sr.return_type), n_out)
                    return Vector._from_sparse(sv2, sr.return_type, device=dev)
                sv2 = sparse_mxv_sv(msp, pull_dir, a_first, _to_sv(vec), sr, sr.return_type, device=dev)
                return Vector._from_sparse(sv2, sr.return_type, device=dev)

            def compute_dense():
                return sv_compute()._sparse.densify(dev)

            return BaseExpression(
                method_name, out_cls, compute_dense, op=sr, dtype=sr.return_type, shape=shape, args=(a, b),
                opname=f"{method_name}[{sr.name}]", sparse_compute=sv_compute if out_sparse else None,
            )

        def sparse_mv():  # dense vector in, dense (n_out,) out: the device engine
            from .sparse import sparse_mxv

            xv, xs = _arrays_of(vec)
            return sparse_mxv(msp, pull_dir, a_first, xv, xs, sr, sr.return_type, x_type=vec.dtype)

        return BaseExpression(
            method_name, out_cls, sparse_mv, op=sr, dtype=sr.return_type, shape=shape, args=(a, b),
            opname=f"{method_name}[{sr.name}]",
        )

    if (
        _sp_nonudt(a_sp)
        and not b_is_vec
        and b_sp is None
        and not b.dtype._is_udt
        and shape[0] * shape[1] <= _dense_limit()
    ):
        # GrB_mxm of a sparse A and a dense n x k B: the SpMV engine's
        # k-column product, A never densified; C(M) << A.mxm(B) hands _update
        # the mask's bits (``_masked_compute``), and the product computes
        # only the rows they reach
        def sparse_mm(keep=None):
            from .sparse import sparse_mxm_dense

            bv, bs = _arrays_of(b)
            return sparse_mxm_dense(a_sp, not a_t, True, bv, bs, sr, sr.return_type, x_type=b.dtype, keep=keep)

        expr = BaseExpression(
            method_name, out_cls, sparse_mm, op=sr, dtype=sr.return_type, shape=shape, args=(a, b),
            opname=f"{method_name}[{sr.name}]",
        )
        expr._masked_compute = sparse_mm
        return expr

    if not (_sp_nonudt(a_sp) and _sp_nonudt(b_sp) and not a_is_vec and not b_is_vec):
        return None

    def _operand_sps():
        return (a_sp.transposed() if a_t else a_sp), (b_sp.transposed() if b_t else b_sp)

    # masked sparse SpGEMM: consumed by _update for C(M) << A.mxm(B) (the
    # masked dot method)
    def sparse_masked_mxm(mask):
        from .sparse import SparseMatrixData, sparse_mxm_masked

        mp = mask.parent
        if mp.ndim != 2 or mp.shape != shape:
            return None
        mr, mc, mv = mp.to_coo()
        if not mask.structure:
            keep = np.asarray(mv).astype(bool)
            mr, mc = mr[keep], mc[keep]
        asp, bsp = _operand_sps()
        ctx = _mesh_context()
        if ctx is not None and ctx.mesh.size > 1:
            # engaged mesh: by mask-row blocks, one plan a shard (parallel/spgemm.py)
            from ..parallel.spgemm import sharded_masked_mxm_arrays

            rows, cols, vals, _flops = sharded_masked_mxm_arrays(
                asp, bsp, mr.astype(np.int64), mc.astype(np.int64), sr, sr.return_type, ctx
            )
        else:
            rows, cols, vals, _flops = sparse_mxm_masked(
                asp, bsp, mr.astype(np.int64), mc.astype(np.int64), sr, sr.return_type, device=dev
            )
        sp = SparseMatrixData.from_arrays(rows, cols, vals, shape[0], shape[1], sorted_dedup=True)
        return Matrix._from_sparse(sp, sr.return_type, device=dev)

    # unmasked sparse x sparse: sparse OUTPUT by the host Gustavson expand-join
    # (GrB_mxm's output is always sparse)
    def sparse_full_mxm():
        from .sparse import sparse_spgemm_full

        asp, bsp = _operand_sps()
        return Matrix._from_sparse(sparse_spgemm_full(asp, bsp, sr, sr.return_type, device=dev), sr.return_type, device=dev)

    def compute_spgemm_dense():
        av, as_ = _arrays_of(a)  # densify-guarded
        bv, bs = _arrays_of(b)
        av = _cast_values(av, a.dtype, sr.binaryop.type_)
        bv = _cast_values(bv, b.dtype, sr.binaryop.type2)
        return _dm.mxm(av, as_, bv, bs, sr, sr.return_type, "auto")

    expr = BaseExpression(
        method_name, out_cls, compute_spgemm_dense, op=sr, dtype=sr.return_type, shape=shape, args=(a, b),
        opname=f"{method_name}[{sr.name}]", sparse_compute=sparse_full_mxm,
    )
    expr._sparse_masked_mxm = sparse_masked_mxm
    return expr


def kronecker_expr(a, b, op):
    from .matrix import Matrix

    op_t = get_typed_op(op, a.dtype, b.dtype, kind="binary")
    _, opclass = find_opclass(op_t)
    if opclass == "Semiring":
        op_t = op_t.binaryop
    shape = (a.shape[0] * b.shape[0], a.shape[1] * b.shape[1])
    _same_device(a, b, "kronecker")

    def compute():
        av, as_ = _arrays_of(a)
        bv, bs = _arrays_of(b)
        av = _cast_values(av, a.dtype, op_t.type_)
        bv = _cast_values(bv, b.dtype, op_t.type2)
        return _dm.kronecker(av, as_, bv, bs, op_t, op_t.return_type)

    return BaseExpression(
        "kronecker", Matrix, compute, op=op_t, dtype=op_t.return_type, shape=shape, args=(a, b), opname=f"kronecker[{op_t.name}]"
    )


# ---------------------------------------------------------------------------
# Assign machinery (python-graphblas's _prep_for_assign)
# ---------------------------------------------------------------------------


def do_assign(self, resolved, value, *, mask, accum, replace, is_submask):
    """Single sink for C(mask, accum)[idx] = value.

    Constructs Z = "C with the region replaced/merged", then applies the
    mask/replace merge:
    - GrB_assign: mask is C-shaped; replace clears anywhere outside the mask.
    - GxB_subassign (is_submask=True): mask is region-shaped; mask/replace
      effects are confined to the region.
    """
    from .base import BaseExpression as _BE
    from .base import record_call
    from .expr import AmbiguousAssignOrExtract
    from .infix import InfixExprBase

    record_call("subassign" if is_submask else "assign", self, value)
    from .matrix import TransposedMatrix

    if isinstance(value, AmbiguousAssignOrExtract) or isinstance(value, InfixExprBase):
        value = value.new()
    elif isinstance(value, _BE):
        value = value.new()
    elif isinstance(value, TransposedMatrix):
        value = value.new()

    if hasattr(value, "_device") and not isinstance(value, Scalar):
        _same_device(self, value, "assign")

    # -- sparse-storage assign: host pattern surgery, no densify (a masked
    # assign into sparse storage takes the dense path, densify-guarded) -----
    if self._sparse is not None and mask is None:
        if _sparse_do_assign(self, resolved, value, accum=accum):
            return

    indices = resolved.indices
    region_shape = tuple(1 if ix.kind == "int" else ix.size for ix in indices)
    out_shape = resolved.out_shape  # squeezed

    # -- build region (av, as_), av in C's type --------------------------------
    from .matrix import Matrix
    from .vector import Vector

    cv, cs = self._values, self._struct
    dev = cs.device
    deleting = False
    tmap = _dm.tmap
    if self.dtype._is_udt and isinstance(value, (tuple, list, dict)):
        # a UDT element given by its fields
        sc = Scalar(self.dtype)
        sc.value = value
        value = sc
    elif isinstance(value, (list, tuple, np.ndarray)):
        # dense array assignment: v[[0, 1]] = [31, 32], built on C's device
        from ..tx import config as _txconfig

        arr = np.asarray(value)
        if arr.ndim not in (1, 2):
            raise TypeError(f"Bad type for assignment value: {type(value)}")
        with _txconfig.set(platform=dev.type):
            value = (Vector if arr.ndim == 1 else Matrix).from_dense(arr, dtype=self.dtype)
    if _is_scalar_like(value) or isinstance(value, Scalar):
        sc = _as_scalar(value)
        if sc.is_empty:
            deleting = True
            av = tmap(lambda c: torch.zeros(region_shape, dtype=c.dtype, device=dev), cv)
            as_ = _dm.s_zeros(region_shape, dev)
        else:
            av = tmap(lambda a: a.expand(region_shape), sc._device_value(self.dtype, dev))
            as_ = _dm.s_ones(region_shape, dev)
    elif isinstance(value, Vector):
        if len(out_shape) != 1 or out_shape[0] != value.shape[0]:
            raise _exc.DimensionMismatch(
                f"shapes not compatible for assign: value {value.shape} into region {out_shape}"
            )
        av = tmap(lambda a: a.reshape(region_shape), _dt.cast(value._values, value.dtype, self.dtype))
        as_ = value._struct.reshape(region_shape)
    elif isinstance(value, Matrix):
        if out_shape != value.shape:
            raise _exc.DimensionMismatch(
                f"shapes not compatible for assign: value {value.shape} into region {out_shape}"
            )
        av = _dt.cast(value._values, value.dtype, self.dtype)
        as_ = value._struct
    else:
        raise TypeError(f"Bad type for assignment value: {type(value)}")

    # -- scatter into C-shape ----------------------------------------------------
    if self.ndim == 1:
        idx = np.atleast_1d(indices[0].index)
        start = _dm._contig_start(idx, self.shape[0])
        if start is not None:
            # slice-shaped region: slice copies instead of an index scatter
            sv, ss, rsel = _dm.scatter_region_vector_contig(cv, cs, tmap(lambda a: a.reshape(-1), av), as_.reshape(-1), start=start)
        else:
            sv, ss, rsel = _dm.scatter_region_vector(cv, cs, idx, tmap(lambda a: a.reshape(-1), av), as_.reshape(-1))
    else:
        rows = np.atleast_1d(indices[0].index)
        cols = np.atleast_1d(indices[1].index)
        rstart = _dm._contig_start(rows, self.shape[0])
        cstart = _dm._contig_start(cols, self.shape[1])
        av2 = tmap(lambda a: a.reshape(len(rows), len(cols)), av)
        as2 = as_.reshape(len(rows), len(cols))
        if rstart is not None and cstart is not None:
            sv, ss, rsel = _dm.scatter_region_matrix_contig(cv, cs, av2, as2, rstart=rstart, cstart=cstart)
        else:
            sv, ss, rsel = _dm.scatter_region_matrix(cv, cs, rows, cols, av2, as2)

    if accum is not None and not deleting:
        # union-merge within the region instead of pattern replacement
        scattered_s = _dm.s_and(rsel, ss)
        both = _dm.s_and(cs, scattered_s)
        acc = accum.fn(_dt.cast(cv, self.dtype, accum.type_), _dt.cast(sv, self.dtype, accum.type2))
        zv = tmap(
            lambda a, z, c: torch.where(both, a, torch.where(scattered_s, z, c)),
            _dt.cast(acc, accum.return_type, self.dtype), sv, cv,
        )
        zs = _dm.s_or(cs, scattered_s)
    else:
        zv, zs = sv, ss

    # -- mask / replace merge ----------------------------------------------------
    types = {"c_type": self.dtype, "z_type": self.dtype}
    if mask is None:
        ncv, ncs = _dm.masked_merge(cv, cs, zv, zs, None, None, False, False, **types)
        self._set_arrays(ncv, ncs)
        return

    mask_bits = mask._bits()
    if is_submask or mask.parent.shape != self.shape:
        # region-shaped mask: scatter its bits into C-shape
        expected = out_shape if out_shape else region_shape
        if mask.parent.shape != expected and mask.parent.shape != region_shape:
            raise _exc.DimensionMismatch(
                f"mask shape {mask.parent.shape} does not match region {out_shape} or output {self.shape}"
            )
        mb = mask_bits.reshape(region_shape)
        full_bits = _dm.s_zeros(self.shape, dev)
        if self.ndim == 1:
            full_bits[_dm._index(idx, dev)] = mb.reshape(-1)
        else:
            full_bits[_dm._index(rows, dev)[:, None], _dm._index(cols, dev)[None, :]] = mb.reshape(len(rows), len(cols))
        ncv, ncs = _dm.masked_merge(cv, cs, zv, zs, full_bits, None, bool(replace), True, region=rsel, **types)
    else:
        ncv, ncs = _dm.masked_merge(cv, cs, zv, zs, mask_bits, None, bool(replace), True, **types)
    self._set_arrays(ncv, ncs)


def _map_positions(pos, ix):
    """Map value positions within a region dim to parent coordinates."""
    if ix.kind == "int":
        return np.full(len(pos), ix.index, np.int64)
    if ix.kind == "all":
        return np.asarray(pos, np.int64)
    return np.atleast_1d(np.asarray(ix.index, np.int64))[np.asarray(pos, np.int64)]


def _region_targets(ix):
    return np.asarray([ix.index], np.int64) if ix.kind == "int" else _map_positions(np.arange(ix.size), ix)


def _sparse_do_assign(self, resolved, value, *, accum):
    """Assign into sparse storage.  Returns True when handled; False falls
    back to the (densify-guarded) dense path."""
    from .matrix import Matrix
    from .sparse import _SCALAR_FILL_LIMIT, sparse_assign, sparse_delete_region, sparse_vec_assign, sparse_vec_delete_region
    from .vector import Vector

    indices = resolved.indices
    dt = self.dtype
    np_dtype = np.dtype(dt.np_type)
    sp = self._sparse
    dev = self._device

    if _is_scalar_like(value) or isinstance(value, Scalar):
        sc = _as_scalar(value)
        if sc.is_empty:
            if self.ndim == 1:
                self._adopt_sparse(sparse_vec_delete_region(sp, indices[0]))
            else:
                self._adopt_sparse(sparse_delete_region(sp, indices))
            return True
        cells = 1
        for ix in indices:
            cells *= 1 if ix.kind == "int" else ix.size
        if cells > _SCALAR_FILL_LIMIT:
            raise _exc.OutOfMemory(
                f"scalar assign would create {cells} entries "
                f"(> {_SCALAR_FILL_LIMIT}); iso-valued regions of that size are "
                "not supported on sparse storage"
            )
        val = np.asarray(sc.value, np_dtype)
        if self.ndim == 1:
            tgt = _region_targets(indices[0])
            self._adopt_sparse(sparse_vec_assign(sp, indices[0], tgt, np.full(len(tgt), val, np_dtype), accum, dt, dev))
            return True
        tr, tc = _region_targets(indices[0]), _region_targets(indices[1])
        rr, cc = np.repeat(tr, len(tc)), np.tile(tc, len(tr))
        self._adopt_sparse(sparse_assign(sp, indices, rr, cc, np.full(len(rr), val, np_dtype), accum, dt, dev))
        return True

    if isinstance(value, (list, tuple, np.ndarray)):
        from ..tx import config as _txconfig

        arr = np.asarray(value)
        if arr.ndim in (1, 2):
            with _txconfig.set(platform=dev.type):
                value = (Vector if arr.ndim == 1 else Matrix).from_dense(arr, dtype=dt)

    if self.ndim == 1:
        if not isinstance(value, Vector):
            return False
        ix = indices[0]
        expected = 1 if ix.kind == "int" else ix.size
        if value.size != expected:
            raise _exc.DimensionMismatch(f"shapes not compatible for assign: value {value.shape} into region ({expected},)")
        vi, vv = value.to_coo()
        tgt = _map_positions(vi.astype(np.int64), ix)
        self._adopt_sparse(sparse_vec_assign(sp, ix, tgt, np.asarray(vv), accum, dt, dev))
        return True

    rix, cix = indices
    if isinstance(value, Vector):
        vi, vv = value.to_coo()
        vi = vi.astype(np.int64)
        if rix.kind == "int":
            if value.size != cix.size:
                raise _exc.DimensionMismatch(f"shapes not compatible for assign: value {value.shape} into region ({cix.size},)")
            rr, cc = np.full(len(vi), rix.index, np.int64), _map_positions(vi, cix)
        elif cix.kind == "int":
            if value.size != rix.size:
                raise _exc.DimensionMismatch(f"shapes not compatible for assign: value {value.shape} into region ({rix.size},)")
            rr, cc = _map_positions(vi, rix), np.full(len(vi), cix.index, np.int64)
        else:
            return False  # broadcast vector assign: the dense path
        self._adopt_sparse(sparse_assign(sp, indices, rr, cc, np.asarray(vv), accum, dt, dev))
        return True
    if isinstance(value, Matrix):
        expected = (1 if rix.kind == "int" else rix.size, 1 if cix.kind == "int" else cix.size)
        if value.shape != expected:
            raise _exc.DimensionMismatch(f"shapes not compatible for assign: value {value.shape} into region {expected}")
        vr, vc, vv = value.to_coo()
        rr = _map_positions(vr.astype(np.int64), rix)
        cc = _map_positions(vc.astype(np.int64), cix)
        self._adopt_sparse(sparse_assign(sp, indices, rr, cc, np.asarray(vv), accum, dt, dev))
        return True
    return False


def do_delete(self, resolved, mask=None):
    """del C[idx]: remove entries in the region."""
    from .base import record_call

    if mask is not None:
        # Masked delete == masked assign of an empty scalar: only masked
        # positions within the region are cleared (records itself as
        # "assign")
        empty = Scalar(self.dtype)
        return do_assign(self, resolved, empty, mask=mask, accum=None, replace=False, is_submask=False)
    record_call("delete", self)
    indices = resolved.indices
    if self._sparse is not None:
        from .sparse import sparse_delete_region, sparse_vec_delete_region

        if self.ndim == 1:
            self._adopt_sparse(sparse_vec_delete_region(self._sparse, indices[0]))
        else:
            self._adopt_sparse(sparse_delete_region(self._sparse, indices))
        return
    cv, cs = self._values, self._struct
    dev = cs.device
    if self.ndim == 1:
        where = (_dm._index(np.atleast_1d(indices[0].index), dev),)
    else:
        rows = _dm._index(np.atleast_1d(indices[0].index), dev)
        cols = _dm._index(np.atleast_1d(indices[1].index), dev)
        where = (rows[:, None], cols[None, :])
    cs = cs.clone()
    cs[where] = False
    self._set_arrays(_dm.tmap(lambda a: _dm._set_copy(a, where, 0), cv), cs)

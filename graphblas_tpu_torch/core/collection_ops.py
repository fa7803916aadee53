"""Shared expression builders for Matrix and Vector.

Counterpart of the dense branches of ``graphblas_tpu/core/collection_ops.py``.
Each builder returns a BaseExpression whose compute closure calls the engine
(``ops.densemasked``): this is the layer where python-graphblas picks a
``cfunc_name`` (e.g. "GrB_Matrix_eWiseMult_BinaryOp"); here it binds typed
torch ops into engine closures.  Operands are read when the expression is
computed; the values handed to an op are converted to its input types
(``_cast_values``).  The sparse branches come with the sparse format
(ROADMAP.md, queue 4), SUMMA under a mesh with queue 8, and the edge-layout
loop body with the compiled loops (queue 5).
"""

import numpy as np
import torch

from .. import exceptions as _exc
from ..ops import densemasked as _dm
from . import dtypes as _dt
from .base import BaseExpression, _same_device
from .operator import find_opclass, get_typed_op
from .scalar import Scalar, _as_scalar, _is_scalar_like


def _arrays_of(obj):
    return obj._values, obj._struct


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

        def compute():
            av, as_, bv, bs = _operands()
            return _dm.ewise_union(
                av, as_, bv, bs, op_t, ld._device_value(op_t.type_, av.device), rd._device_value(op_t.type2, av.device)
            )

    else:
        engine = _dm.ewise_mult if how == "mult" else _dm.ewise_add

        def compute():
            av, as_, bv, bs = _operands()
            return engine(av, as_, bv, bs, op_t)

    return BaseExpression(
        f"ewise_{how}",
        out_cls,
        compute,
        op=op_t,
        dtype=op_t.return_type,
        shape=out_shape,
        args=(self, other),
        opname=f"ewise_{how}[{op_t.name}]",
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

        def compute():
            v, s = _arrays_of(self)
            v = _cast_values(v, self.dtype, op_t.type_)
            return _dm.apply_indexunary(v, s, op_t, thunk_s._device_value(device=v.device))

        return BaseExpression(
            "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]"
        )

    if right is None and left is None and thunk is None:
        op_t = get_typed_op(op, self.dtype, kind="unary")
        _, opclass2 = find_opclass(op_t)
        if opclass2 == "BinaryOp":
            raise TypeError(
                f"Binary op {op_t.name} passed to apply without left or right; "
                "provide `left=` or `right=` to bind one argument"
            )
        if getattr(op_t, "positional", None) is not None:

            def compute():
                v, s = _arrays_of(self)
                return _dm.apply_positional_unary(v, s, op_t, 0)

        else:

            def compute():
                v, s = _arrays_of(self)
                v = _cast_values(v, self.dtype, op_t.type_)
                return _dm.apply_unary(v, s, op_t)

        return BaseExpression(
            "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]"
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

    def compute():
        v, s = _arrays_of(self)
        v = _cast_values(v, self.dtype, op_t.type_ if right is not None else op_t.type2)
        b = bound._device_value(op_t.type2 if right is not None else op_t.type_, v.device)
        return _dm.apply_bound(v, s, op_t, b, "right" if right is not None else "left")

    return BaseExpression(
        "apply", out_cls, compute, op=op_t, dtype=op_t.return_type, shape=self.shape, args=(self,), opname=f"apply[{op_t.name}]"
    )


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

        def compute_mask():
            v, s = _arrays_of(self)
            keep = s & mask_obj._bits()
            return torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device)), keep

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

    def compute():
        v, s = _arrays_of(self)
        return _dm.select_op(v, s, op_t, thunk_s._device_value(device=v.device))

    return BaseExpression(
        "select", out_cls, compute, op=op_t, dtype=self.dtype, shape=self.shape, args=(self,), opname=f"select[{op_t.name}]"
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

    def compute():
        v, s = _arrays_of(self)
        v = _cast_values(v, self.dtype, monoid_t.type_)
        return _dm.reduce_axis(v, s, monoid_t, axis)

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

    def compute():
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
    """GrB_mxm / mxv / vxm on the dense-masked engine."""
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

    def compute():
        from ..tx import config as _txconfig

        # read at compute time so per-call descriptor opts (applied as a
        # config context by BaseType._update) take effect
        strategy = _txconfig.get("mxm_strategy", "auto")
        av, as_ = _arrays_of(a)
        bv, bs = _arrays_of(b)
        av = _cast_values(av, a.dtype, sr.binaryop.type_)
        bv = _cast_values(bv, b.dtype, sr.binaryop.type2)
        if a_is_vec and b_is_vec:
            cv, cs = _dm.vxm(av, as_, bv[:, None], bs[:, None], sr, sr.return_type, strategy)
            return cv[0], cs[0]
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

    if hasattr(value, "_struct") and not isinstance(value, Scalar):
        _same_device(self, value, "assign")
    indices = resolved.indices
    region_shape = tuple(1 if ix.kind == "int" else ix.size for ix in indices)
    out_shape = resolved.out_shape  # squeezed

    # -- build region (av, as_), av in C's type --------------------------------
    from .matrix import Matrix
    from .vector import Vector

    cv, cs = self._values, self._struct
    dev = cs.device
    deleting = False
    if isinstance(value, (list, tuple, np.ndarray)):
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
            av = torch.zeros(region_shape, dtype=cv.dtype, device=dev)
            as_ = _dm.s_zeros(region_shape, dev)
        else:
            av = sc._device_value(self.dtype, dev).expand(region_shape)
            as_ = _dm.s_ones(region_shape, dev)
    elif isinstance(value, Vector):
        if len(out_shape) != 1 or out_shape[0] != value.shape[0]:
            raise _exc.DimensionMismatch(
                f"shapes not compatible for assign: value {value.shape} into region {out_shape}"
            )
        av = _dt.cast(value._values, value.dtype, self.dtype).reshape(region_shape)
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
            sv, ss, rsel = _dm.scatter_region_vector_contig(cv, cs, av.reshape(-1), as_.reshape(-1), start=start)
        else:
            sv, ss, rsel = _dm.scatter_region_vector(cv, cs, idx, av.reshape(-1), as_.reshape(-1))
    else:
        rows = np.atleast_1d(indices[0].index)
        cols = np.atleast_1d(indices[1].index)
        rstart = _dm._contig_start(rows, self.shape[0])
        cstart = _dm._contig_start(cols, self.shape[1])
        av2 = av.reshape(len(rows), len(cols))
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
        zv = torch.where(both, _dt.cast(acc, accum.return_type, self.dtype), torch.where(scattered_s, sv, cv))
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
    cv = cv.clone()
    cv[where] = 0
    self._set_arrays(cv, cs)

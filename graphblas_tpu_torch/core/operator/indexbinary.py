"""IndexBinaryOp: f(x, ix, jx, y, iy, jy, theta).

Counterpart of ``graphblas_tpu/core/operator/indexbinary.py``, a copy
(SuiteSparse 9.4+ GxB_IndexBinaryOp; no builtins).  Calling the op with a theta value
produces a bound op usable as the multiply of a semiring.
"""

from .. import dtypes as _dt
from . import base as _b
from .base import OpBase, ParameterizedUdf, TypedIndexBinaryOp
from .unary import _dotted_set


class _BoundIndexBinaryOp:
    """An IndexBinaryOp with theta bound; acts like a BinaryOp whose fn also
    receives positional indices (reference: indexbinary.py:62-104)."""

    opclass = "BinaryOp"
    is_positional = True
    positional = "indexbinary"

    def __init__(self, parent, theta):
        self.parent = parent
        self.theta = theta
        self.name = f"{parent.name}(theta={theta})"
        self._monoid = None
        self._needs_safe_fill = False

    def __getitem__(self, type_):
        dtype = _dt.lookup_dtype(type_)
        typed_parent = self.parent[dtype]
        theta = self.theta

        def fn(x, ix, jx, y, iy, jy):
            return typed_parent.fn(x, ix, jx, y, iy, jy, theta)

        typed = _b.TypedBinaryOp(self, self.name, dtype, typed_parent.return_type, fn)
        return typed

    @property
    def types(self):
        return self.parent.types

    @property
    def coercions(self):
        return self.parent.coercions

    def __repr__(self):
        return f"indexbinary.{self.name}"


class IndexBinaryOp(OpBase):
    _typed_class = TypedIndexBinaryOp
    _modname = "indexbinary"
    _nargs = 2
    positional = None

    def __call__(self, theta):
        return _BoundIndexBinaryOp(self, theta)

    def _compile_dtype(self, dtype):
        if self.orig_func is None:
            return None
        ret = _b._output_dtype_of(
            self.orig_func, dtype, _dt.INT64, _dt.INT64, dtype, _dt.INT64, _dt.INT64, dtype
        )
        typed = TypedIndexBinaryOp(self, self.name, dtype, ret, _b.udf_fn(self.orig_func, ret, [dtype, _dt.INT64, _dt.INT64, dtype, _dt.INT64, _dt.INT64, dtype]))
        self._add(typed)
        return typed

    @classmethod
    def register_anonymous(cls, func, name=None, *, parameterized=False, is_udt=False):
        if parameterized:
            return ParameterizedUdf(name or "indexbinary.anonymous", func, True, cls.register_anonymous)
        op = cls(name or getattr(func, "__name__", "indexbinary.anonymous"), anonymous=True)
        op.orig_func = func
        for dtype in _b.ALL:
            try:
                ret = _b._output_dtype_of(func, dtype, _dt.INT64, _dt.INT64, dtype, _dt.INT64, _dt.INT64, dtype)
            except Exception:
                continue
            op._add(TypedIndexBinaryOp(op, op.name, dtype, ret, _b.udf_fn(func, ret, [dtype, _dt.INT64, _dt.INT64, dtype, _dt.INT64, _dt.INT64, dtype])))
        return op

    @classmethod
    def register_new(cls, name, func, *, parameterized=False, is_udt=False, lazy=False):
        import graphblas_tpu_torch.indexbinary as ib_module

        if parameterized:
            op = ParameterizedUdf(name, func, False, cls.register_anonymous)
        else:
            op = cls.register_anonymous(func, name.rsplit(".", 1)[-1], is_udt=is_udt)
            op._anonymous = False
        _dotted_set(ib_module, name, op)
        return op


def _initialize(module):
    module._ops = {}
    return module._ops

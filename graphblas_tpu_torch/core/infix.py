"""Infix expression objects for ``|``, ``&``, ``@``.

Counterpart of ``graphblas_tpu/core/infix.py``: ``A | B`` holds an op-less
ewise-add until an operator is applied (``binary.plus(A | B)``) or it
auto-computes with the defaults (BOOL-only lor/land; plus_times for ``@``).
"""

from .. import exceptions as _exc
from . import dtypes as _dt
from .infixmethods import InfixMixin


class InfixExprBase(InfixMixin):
    """Pending infix op: holds (left, right, kind)."""

    __slots__ = "left", "right", "_value"

    def __init__(self, left, right):
        self.left = left
        self.right = right
        self._value = None

    @property
    def dtype(self):
        return _dt.unify(self.left.dtype, self.right.dtype)

    def _to_expr(self, op=None):
        raise NotImplementedError

    def _apply_op(self, op, left_default=None, right_default=None):
        if left_default is not None or right_default is not None:
            return self._to_union_expr(op, left_default, right_default)
        return self._to_expr(op)

    def new(self, dtype=None, *, mask=None, name=None, **opts):
        return self._to_expr().new(dtype, mask=mask, name=name, **opts)

    dup = new

    def _get_value(self):
        if self._value is None:
            self._value = self.new()
        return self._value

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        out_cls = self._out_cls()
        if hasattr(out_cls, name):
            import graphblas_tpu_torch

            if not graphblas_tpu_torch.config.get("autocompute"):
                raise TypeError(
                    f"{type(self).__name__} is not computed automatically (autocompute is off). "
                    f"Apply an operator (e.g. binary.plus(x | y)) or call .new()."
                )
            return getattr(self._get_value(), name)
        raise AttributeError(name)

    def _out_cls(self):
        from .matrix import Matrix
        from .scalar import Scalar
        from .vector import Vector

        return (Scalar, Vector, Matrix)[self.ndim]

    @property
    def _output_type(self):
        return self._out_cls()

    def _require_autocompute(self, name):
        import graphblas_tpu_torch

        if not graphblas_tpu_torch.config.get("autocompute"):
            raise TypeError(
                f"{type(self).__name__} is not computed automatically (autocompute is off). "
                f"Call .new() first to access .{name}."
            )

    def isequal(self, other, **kwargs):
        self._require_autocompute("isequal")
        return self._get_value().isequal(other, **kwargs)

    def isclose(self, other, **kwargs):
        self._require_autocompute("isclose")
        return self._get_value().isclose(other, **kwargs)

    # numeric dunders bypass __getattr__ (type-level lookup); scalar-output
    # infix expressions (v @ v) mirror them like BaseExpression does
    # (the generated automethods on ScalarMatMulExpr)
    def _scalar_dunder(self, kind, conv):
        from .scalar import Scalar

        if self._out_cls() is not Scalar:
            raise TypeError(f"{kind} not defined for objects of type {type(self).__name__}")
        self._require_autocompute(kind)
        return conv(self._get_value())

    def __float__(self):
        return self._scalar_dunder("__float__", float)

    def __int__(self):
        return self._scalar_dunder("__int__", int)

    def __index__(self):
        return self._scalar_dunder("__index__", lambda v: v.__index__())

    def __complex__(self):
        return self._scalar_dunder("__complex__", complex)

    def __bool__(self):
        from .scalar import Scalar

        if self._out_cls() is Scalar:
            return self._scalar_dunder("__bool__", bool)
        raise TypeError(
            f"__bool__ not defined for objects of type {type(self).__name__}; "
            "materialize with .new() and compare explicitly"
        )

    def __iter__(self):
        self._require_autocompute("__iter__")
        return iter(self._get_value())

    def __contains__(self, item):
        self._require_autocompute("__contains__")
        return item in self._get_value()

    def __array__(self, *args, **kwargs):
        self._require_autocompute("__array__")
        return self._get_value().__array__(*args, **kwargs)

    def __repr__(self):
        # a one-line functional header naming the operands (never their
        # nested reprs), then the computed value when autocompute is on
        def nm(x):
            n = getattr(x, "name", None)
            return n or type(x).__name__

        header = f"{type(self).__name__}: {nm(self.left)} {self._symbol} {nm(self.right)}"
        import graphblas_tpu_torch

        if graphblas_tpu_torch.config.get("autocompute"):
            try:
                return (
                    header
                    + "\n\nComputed result (autocompute is enabled):\n"
                    + repr(self._get_value())
                )
            except Exception:
                pass
        return header


class EwiseInfixExpr(InfixExprBase):
    """``A | B`` / ``A & B`` (python-graphblas's VectorEwiseAddExpr etc.)."""

    __slots__ = ("how",)

    def __init__(self, left, right, how):
        super().__init__(left, right)
        self.how = how

    @property
    def _symbol(self):
        return "|" if self.how == "add" else "&"

    @property
    def ndim(self):
        return self.left.ndim

    @property
    def shape(self):
        return self.left.shape

    def _to_expr(self, op=None):
        if op is None:
            # default ops only exist for BOOL
            if self.left.dtype is _dt.BOOL and self.right.dtype is _dt.BOOL:
                op = "lor" if self.how == "add" else "land"
            else:
                raise TypeError(
                    f"Automatic computation of `x {self._symbol} y` is only defined for BOOL; "
                    f"apply a binary operator, e.g. binary.plus(x {self._symbol} y)"
                )
        if self.how == "add":
            return self.left.ewise_add(self.right, op)
        return self.left.ewise_mult(self.right, op)

    def _to_union_expr(self, op, left_default, right_default):
        return self.left.ewise_union(self.right, op, left_default, right_default)


class MatMulExpr(InfixExprBase):
    """``A @ B`` defaults to plus_times."""

    __slots__ = ()
    _symbol = "@"

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def shape(self):
        l_vec = self.left.ndim == 1
        r_vec = self.right.ndim == 1
        if l_vec and r_vec:
            return ()
        if l_vec:
            return (self.right.shape[1],)
        if r_vec:
            return (self.left.shape[0],)
        return (self.left.shape[0], self.right.shape[1])

    def _out_cls(self):
        from .matrix import Matrix
        from .scalar import Scalar
        from .vector import Vector

        n = self.ndim
        return (Scalar, Vector, Matrix)[n]

    def _to_expr(self, op=None):
        from . import collection_ops as _cops

        if op is None:
            if self.left.dtype is _dt.BOOL and self.right.dtype is _dt.BOOL:
                op = "lor_land"
            else:
                op = "plus_times"
        return _cops.mxm_expr(self.left, self.right, op, "mxm")


def _normalize_operand(x):
    from .base import BaseExpression, BaseType
    from .expr import AmbiguousAssignOrExtract
    from .matrix import TransposedMatrix

    if isinstance(x, (BaseType, TransposedMatrix)):
        return x
    if isinstance(x, (BaseExpression, AmbiguousAssignOrExtract, InfixExprBase)):
        # materializing an expression operand is an autocompute (the
        # automethods gate __or__/__and__/__matmul__ the same way)
        import graphblas_tpu_torch

        if not graphblas_tpu_torch.config.get("autocompute"):
            raise TypeError(
                f"{type(x).__name__} is not computed automatically (autocompute is off). "
                "Call .new() first to use it as an infix operand."
            )
        return x._get_value()
    raise TypeError(f"Bad operand type for infix expression: {type(x)}")


def ewise_infix(left, right, how):
    left = _normalize_operand(left)
    right = _normalize_operand(right)
    if left.shape != right.shape:
        # mixed-rank vector<->matrix broadcast is handled by ewise_expr
        compatible = (
            left.ndim == 1 and right.ndim == 2 and left.shape[0] == right.shape[0]
        ) or (left.ndim == 2 and right.ndim == 1 and left.shape[1] == right.shape[0])
        if not compatible:
            raise _exc.DimensionMismatch(f"shapes do not match for infix: {left.shape} != {right.shape}")
    return EwiseInfixExpr(left, right, how)


def matmul_infix(left, right):
    left = _normalize_operand(left)
    right = _normalize_operand(right)
    k1 = left.shape[0] if left.ndim == 1 else left.shape[1]
    if k1 != right.shape[0]:
        raise _exc.DimensionMismatch(f"inner dimensions do not match for @: {left.shape} x {right.shape}")
    return MatMulExpr(left, right)

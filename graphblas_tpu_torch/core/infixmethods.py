"""Arithmetic/infix dunder methods for collections and expressions.

Counterpart of ``graphblas_tpu/core/infixmethods.py``: maps
``+ - * / // % ** ^ ~ abs`` onto apply/ewise calls, and ``|``, ``&``, ``@``
onto infix expression objects.
"""


def _is_scalar(x):
    from .scalar import Scalar, _is_scalar_like

    return _is_scalar_like(x) or isinstance(x, Scalar)


class InfixMixin:
    """Mixin shared by Matrix, Vector, and expression classes."""

    __slots__ = ()

    # -- GraphBLAS infix: | & @ ---------------------------------------------

    def __or__(self, other):
        from .infix import ewise_infix

        return ewise_infix(self, other, "add")

    def __ror__(self, other):
        from .infix import ewise_infix

        return ewise_infix(other, self, "add")

    def __and__(self, other):
        from .infix import ewise_infix

        return ewise_infix(self, other, "mult")

    def __rand__(self, other):
        from .infix import ewise_infix

        return ewise_infix(other, self, "mult")

    def __matmul__(self, other):
        from .infix import matmul_infix

        return matmul_infix(self, other)

    def __rmatmul__(self, other):
        from .infix import matmul_infix

        return matmul_infix(other, self)

    # -- arithmetic dunders ---------------------------------------------------

    def _arith(self, other, opname, reflected=False):
        import graphblas_tpu_torch.binary as binary

        op = getattr(binary, opname)
        if _is_scalar(other):
            if reflected:
                return self.apply(op, left=other)
            return self.apply(op, right=other)
        if reflected:
            how = "mult" if opname in {"times", "truediv", "cdiv", "floordiv", "pow", "fmod"} else "add"
            return other.ewise_add(self, op) if how == "add" else other.ewise_mult(self, op)
        if opname in {"plus", "minus", "lxor"}:
            return self.ewise_add(other, op)
        return self.ewise_mult(other, op)

    def __add__(self, other):
        return self._arith(other, "plus")

    def __radd__(self, other):
        return self._arith(other, "plus", reflected=True)

    def __sub__(self, other):
        return self._arith(other, "minus")

    def __rsub__(self, other):
        return self._arith(other, "rminus")

    def __mul__(self, other):
        return self._arith(other, "times")

    def __rmul__(self, other):
        return self._arith(other, "times", reflected=True)

    def __truediv__(self, other):
        return self._arith(other, "truediv")

    def __rtruediv__(self, other):
        return self._arith(other, "rtruediv")

    def __floordiv__(self, other):
        return self._arith(other, "floordiv")

    def __rfloordiv__(self, other):
        return self._arith(other, "rfloordiv")

    def __mod__(self, other):
        return self._arith(other, "fmod")

    def __pow__(self, other):
        return self._arith(other, "pow")

    def __rpow__(self, other):
        return self._arith(other, "rpow")

    def __xor__(self, other):
        return self._arith(other, "lxor")

    # -- comparison dunders: elementwise BOOL expressions (use
    #    isequal/isclose for whole-collection equality) -------------------

    def __lt__(self, other):
        return self._arith(other, "lt")

    def __le__(self, other):
        return self._arith(other, "le")

    def __gt__(self, other):
        return self._arith(other, "gt")

    def __ge__(self, other):
        return self._arith(other, "ge")

    def __eq__(self, other):
        return self._arith(other, "eq")

    def __ne__(self, other):
        return self._arith(other, "ne")

    # defining __eq__ would otherwise clear hashability; collections hash by
    # identity
    __hash__ = object.__hash__

    def __neg__(self):
        import graphblas_tpu_torch.unary as unary

        return self.apply(unary.ainv)

    def __abs__(self):
        import graphblas_tpu_torch.unary as unary

        return self.apply(unary.abs)

    def __invert__(self):
        import graphblas_tpu_torch.unary as unary

        from . import dtypes as _dt

        if self.dtype is not _dt.BOOL:
            raise TypeError("The invert operator, `~`, is only supported for BOOL collections")
        return self.apply(unary.lnot)

"""Scalar: a 0-dim collection that may be empty.

Counterpart of ``graphblas_tpu/core/scalar.py``.  The value lives on the
host (a numpy scalar of the type); ``_device_value`` puts it on a device as
a 0-d carrier tensor for the engine, and a computed value is read back from
the card (``_set_value_from_device``).  Inside a compiled loop
(``core/capture.py``) a computed value stays a 0-d carrier tensor on the
device and its presence is structural, as the reference keeps a traced
value; reading it on the host there raises ``TracerError``.  Outside, a
device value is read back on first use.  ``is_cscalar`` is kept for API
parity.  A UDT Scalar holds a structured numpy scalar on the host and goes
to a device as a dict of 0-d field tensors.
"""

import numpy as np
import torch

from .. import exceptions as _exc
from . import capture as _cap
from . import dtypes as _dt
from .base import BaseExpression, BaseType
from .infixmethods import InfixMixin
from .operator import get_typed_op


def _is_scalar_like(x):
    if isinstance(x, (int, float, complex, bool, np.number, np.bool_, np.void)):
        return True
    if isinstance(x, Scalar):
        return True
    if isinstance(x, np.ndarray) and x.ndim == 0:
        return True
    return False


def _as_scalar(value, dtype=None, *, is_cscalar=False):
    """Coerce to Scalar.  Scalar-valued
    expressions (e.g. composite aggregator finalizers) are materialized."""
    if isinstance(value, BaseExpression):
        if value._output_type is not Scalar:
            raise TypeError(f"Cannot coerce {value._output_type.__name__} expression to Scalar")
        value = value.new()
    if isinstance(value, Scalar):
        if dtype is not None and value.dtype != _dt.lookup_dtype(dtype):
            return value.dup(dtype)
        return value
    return Scalar.from_value(value, dtype, is_cscalar=is_cscalar)


class Scalar(InfixMixin, BaseType):
    # arithmetic/comparison dunders come from InfixMixin, as in python-graphblas
    # (core/infixmethods.py applies every operation to Scalar EXCEPT
    # __eq__/__ne__ — ours below override the mixin's elementwise forms
    # with value equality, matching that carve-out)
    __slots__ = "_empty_", "_is_cscalar"  # _empty: capture.HeldSlot, below the class
    ndim = 0
    shape = ()
    _is_scalar = True
    _name_counter = [0]

    def __init__(self, dtype=_dt.FP64, *, is_cscalar=False, name=None):
        self._dtype = _dt.lookup_dtype(dtype)
        self._empty = True
        self._values = np.zeros((), self._dtype.np_type)[()]
        self._struct = False
        self._is_cscalar = bool(is_cscalar)
        self.name = name

    @classmethod
    def from_value(cls, value, dtype=None, *, is_cscalar=False, name=None):
        """Create a Scalar from a Python/numpy value."""
        if isinstance(value, Scalar):
            return value.dup(dtype, name=name)
        if dtype is None:
            if isinstance(value, (bool, np.bool_)):
                dtype = _dt.BOOL
            elif isinstance(value, (int, np.integer)):
                dtype = _dt.INT64
            elif isinstance(value, (float, np.floating)):
                dtype = _dt.FP64
            elif isinstance(value, (complex, np.complexfloating)):
                dtype = _dt.FC64
            else:
                dtype = _dt.lookup_dtype(np.asarray(value).dtype)
        sc = cls(dtype, is_cscalar=is_cscalar, name=name)
        sc.value = value
        return sc

    # -- value access -----------------------------------------------------------

    @property
    def value(self):
        if self._empty:
            return None
        return self._host_values()

    def _host_values(self):
        """The value on the host: a device value (a compiled loop's result)
        is read back once; inside a compiled loop body that read raises."""
        v = self._values
        if isinstance(v, torch.Tensor):
            if _cap.active() is not None:
                raise _exc.TracerError(
                    "a Scalar's value is read on the host inside a compiled loop body; "
                    "it is abstract there (docs/compile.md)"
                )
            self._set_value_from_device(v, self._dtype)
            v = self._values
        return v

    @value.setter
    def value(self, val):
        if val is None or (isinstance(val, Scalar) and val.is_empty):
            self.clear()
            return
        if isinstance(val, Scalar):
            val = val.value
        if self._dtype._is_udt:
            # dict, tuple or np.void field fills
            from .utils import _udt_scalar

            self._values = _udt_scalar(val, self._dtype.np_type)
        else:
            self._values = np.asarray(val, self._dtype.np_type)[()]
        self._struct = True
        self._empty = False

    def _set_value_from_device(self, device_val, dtype):
        """Read a 0-d carrier tensor of ``dtype`` back (from the card),
        converted to this Scalar's type as numpy converts."""
        self._values = np.asarray(_dt.to_numpy(device_val, dtype), self._dtype.np_type)[()]
        self._struct = True
        self._empty = False

    def _device_value(self, dtype=None, device=None):
        """The value as a 0-d carrier tensor of ``dtype`` (default: its own
        type; converted as numpy converts) on ``device`` (default: the
        collections' device)."""
        from .utils import device_asarray

        dtype = self._dtype if dtype is None else dtype
        if isinstance(self._values, torch.Tensor):
            v = _dt.cast(self._values, self._dtype, _dt.lookup_dtype(dtype))
            return v if device is None or v.device == torch.device(device) else v.to(device)
        return device_asarray(self._values, dtype, device)

    @property
    def is_empty(self):
        return self._empty

    @property
    def is_cscalar(self):
        return self._is_cscalar

    @property
    def is_grbscalar(self):
        return not self._is_cscalar

    @property
    def nvals(self):
        return 0 if self._empty else 1

    def clear(self):
        self._empty = True
        self._struct = False
        self._values = np.zeros((), self._dtype.np_type)[()]

    def dup(self, dtype=None, *, clear=False, is_cscalar=None, name=None):
        dtype = self._dtype if dtype is None else _dt.lookup_dtype(dtype)
        sc = Scalar(dtype, is_cscalar=self._is_cscalar if is_cscalar is None else is_cscalar, name=name)
        if not clear and not self._empty:
            if isinstance(self._values, torch.Tensor) and _cap.active() is not None:
                sc._set_device_value(self._device_value(dtype))
            else:
                sc.value = np.asarray(self._host_values()).astype(dtype.np_type)[()]
        return sc

    new = dup

    def get(self, default=None):
        if self._empty:
            return default
        v = self._host_values()
        return v.item() if hasattr(v, "item") else v

    def wait(self, how="materialize"):
        return self

    def __reduce__(self):
        value = self.value
        return (_scalar_from_pickle, (self._dtype, None if value is None else np.asarray(value), self._is_cscalar, self.name))

    # -- update sinks (called from BaseType._update) ------------------------------

    def _update_scalar_value(self, value, accum):
        if accum is not None and not self._empty and value is not None and not (
            isinstance(value, Scalar) and value.is_empty
        ):
            other = value.value if isinstance(value, Scalar) else value
            self._apply_accum(accum, _dt.scalar_tensor(other, self._dtype, _device()))
        else:
            self.value = value

    def _apply_accum(self, accum, other):
        """self = accum(self, other), ``other`` a 0-d carrier tensor of this
        Scalar's type."""
        a = _dt.cast(self._device_value(device=other.device), self._dtype, accum.type_)
        b = _dt.cast(other, self._dtype, accum.type2)
        if _cap.active() is not None:
            self._set_device_value(_dt.cast(accum.fn(a, b), accum.return_type, self._dtype))
            return
        self._set_value_from_device(accum.fn(a, b), accum.return_type)

    def _set_device_value(self, t):
        """Keep a 0-d carrier tensor of this Scalar's type as the value (a
        compiled loop's abstract value: present, as the reference's)."""
        self._values = t
        self._struct = True
        self._empty = False

    def _update_from_expr(self, expr, accum):
        v, s = expr._compute()
        if _cap.active() is not None:
            # inside a compiled loop: keep the device value; presence is
            # structural (an absent reduce already yields its identity)
            v = _dt.cast(v, expr.dtype, self._dtype)
            if accum is not None and not self._empty:
                self._apply_accum(accum, v)
            else:
                self._set_device_value(v)
            return
        present = bool(s)
        if not present:
            if accum is None:
                self.clear()
            return
        if accum is not None and not self._empty:
            self._apply_accum(accum, _dt.cast(v, expr.dtype, self._dtype))
        else:
            self._set_value_from_device(v, expr.dtype)

    def _arith(self, other, opname, reflected=False):
        # Scalar op anything-scalar is the EWISE recipe, not an apply-bound
        # thunk (python-graphblas's call_op), so `s * empty_scalar` is
        # empty, not 0
        import graphblas_tpu_torch.binary as binary

        op = getattr(binary, opname)
        how_add = opname in {"plus", "minus", "lxor"}
        if reflected:
            o = _as_scalar(other)
            return o.ewise_add(self, op) if how_add else o.ewise_mult(self, op)
        return self.ewise_add(other, op) if how_add else self.ewise_mult(other, op)

    def _as_expression(self):
        """Wrap as an identity expression: the host value as a 0-d tensor."""

        def compute():
            dev = _device()
            return self._device_value(device=dev), _present(not self._empty, dev)

        return BaseExpression("identity", Scalar, compute, dtype=self.dtype, shape=(), args=(self,))

    # -- comparisons ------------------------------------------------------------

    def isequal(self, other, *, check_dtype=False):
        if not isinstance(other, Scalar):
            if other is None:
                return self._empty
            if not _is_scalar_like(other):
                raise TypeError(f"Bad type in isequal: {type(other)}")
            other = _as_scalar(other)
        if check_dtype and self.dtype != other.dtype:
            return False
        if self._empty or other._empty:
            return self._empty and other._empty
        return bool(np.asarray(self._host_values()) == np.asarray(other._host_values()))

    def isclose(self, other, *, rel_tol=1e-7, abs_tol=0.0, check_dtype=False):
        if not isinstance(other, Scalar):
            if other is None:
                return self._empty
            other = _as_scalar(other)
        if check_dtype and self.dtype != other.dtype:
            return False
        if self._empty or other._empty:
            return self._empty and other._empty
        a, b = float(np.real(self._host_values())), float(np.real(other._host_values()))
        return abs(a - b) <= max(rel_tol * max(abs(a), abs(b)), abs_tol)

    def __eq__(self, other):
        try:
            return self.isequal(other)
        except TypeError:
            return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        if result is NotImplemented:
            return result
        return not result

    def __hash__(self):
        raise TypeError("Scalar objects are mutable and cannot be hashed")

    def __bool__(self):
        if self._empty:
            return False
        return bool(self._host_values())

    def __int__(self):
        if self._empty:
            raise _exc.EmptyObject("Scalar is empty")
        return int(self._host_values())

    def __float__(self):
        if self._empty:
            raise _exc.EmptyObject("Scalar is empty")
        return float(self._host_values())

    def __complex__(self):
        if self._empty:
            raise _exc.EmptyObject("Scalar is empty")
        return complex(self._host_values())

    __index__ = __int__

    def __neg__(self):
        import graphblas_tpu_torch.unary as unary

        return self.apply(unary.ainv).new()

    def __invert__(self):
        import graphblas_tpu_torch.unary as unary

        if self._dtype is not _dt.BOOL:
            raise TypeError("The invert operator, `~`, is not supported for non-BOOL Scalars")
        return self.apply(unary.lnot).new()

    def __abs__(self):
        import graphblas_tpu_torch.unary as unary

        return self.apply(unary.abs).new()

    def __repr__(self):
        from .formatting import format_scalar

        return format_scalar(self)

    def _repr_html_(self):
        return f"<pre>{self!r}</pre>"

    # -- operations (python-graphblas's recipes through 1-length casts;
    #    direct closures here) ----------------------------------------------------

    def apply(self, op, right=None, *, left=None, thunk=None):
        expr_dtype, compute = _scalar_apply_closure(self, op, right, left, thunk)
        return BaseExpression("apply", Scalar, compute, op=op, dtype=expr_dtype, shape=(), args=(self,))

    def ewise_add(self, other, op="plus"):
        return self._ewise(other, op, "add")

    def ewise_mult(self, other, op="times"):
        return self._ewise(other, op, "mult")

    def ewise_union(self, other, op, left_default, right_default):
        other = _as_scalar(other)
        op_t = get_typed_op(op, self.dtype, other.dtype, kind="binary")
        ld = _as_scalar(left_default)
        rd = _as_scalar(right_default)

        def compute():
            dev = _device()
            a = (ld if self._empty else self)._device_value(op_t.type_, dev)
            b = (rd if other._empty else other)._device_value(op_t.type_, dev)
            present = not (self._empty and other._empty)
            return op_t.fn(a, b), _present(present, dev)

        return BaseExpression("ewise_union", Scalar, compute, op=op_t, dtype=op_t.return_type, shape=(), args=(self, other))

    def _ewise(self, other, op, how):
        other = _as_scalar(other)
        op_t = get_typed_op(op, self.dtype, other.dtype, kind="binary")

        def compute():
            dev = _device()
            a = self._device_value(op_t.type_, dev)
            b = other._device_value(op_t.type_, dev)
            if how == "mult":
                present = not self._empty and not other._empty
                return op_t.fn(a, b), _present(present, dev)
            present = not self._empty or not other._empty
            if self._empty:
                return _dt.cast(b, op_t.type_, op_t.return_type), _present(present, dev)
            if other._empty:
                return _dt.cast(a, op_t.type_, op_t.return_type), _present(present, dev)
            return op_t.fn(a, b), _present(present, dev)

        return BaseExpression(f"ewise_{how}", Scalar, compute, op=op_t, dtype=op_t.return_type, shape=(), args=(self, other))

    def select(self, op, thunk=None):
        if isinstance(op, str) and any(c in op for c in "<>=!"):
            # comparison-string shorthand, same as Matrix/Vector.select
            from .collection_ops import _bare_select_op, _parse_select_string

            if thunk is None:
                op, thunk = _parse_select_string(op)
            else:
                op = _bare_select_op(op)
        op_t = get_typed_op(op, self.dtype, kind="select")
        thunk_s = _as_scalar(thunk if thunk is not None else False)

        def compute():
            dev = _device()
            if self._empty:
                return self._device_value(device=dev), _present(False, dev)
            v = self._device_value(op_t.type_, dev)
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            keep = op_t.fn(v, zero, zero, thunk_s._device_value(device=dev))
            return self._device_value(device=dev), keep

        return BaseExpression("select", Scalar, compute, op=op_t, dtype=self.dtype, shape=(), args=(self,))

    @property
    def _carg(self):
        return self.name or "scalar"


_cap.hold_slots(Scalar, "_empty")


def _scalar_apply_closure(sc, op, right, left, thunk):
    from .operator import find_opclass

    op_resolved, opclass = find_opclass(op)
    if opclass in {"IndexUnaryOp", "SelectOp"} or thunk is not None:
        op_t = get_typed_op(op, sc.dtype, kind="indexunary")
        thunk_s = _as_scalar(thunk if thunk is not None else 0)

        def compute():
            dev = _device()
            v = sc._device_value(op_t.type_, dev)
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            out = op_t.fn(v, zero, zero, thunk_s._device_value(device=dev))
            return out, _present(not sc._empty, dev)

        return op_t.return_type, compute
    if right is None and left is None:
        op_t = get_typed_op(op, sc.dtype, kind="unary")

        def compute():
            dev = _device()
            out = op_t.fn(sc._device_value(op_t.type_, dev))
            return out, _present(not sc._empty, dev)

        return op_t.return_type, compute
    if right is not None and left is not None:
        raise TypeError("Cannot provide both `left` and `right` to apply")
    bound = _as_scalar(right if right is not None else left)
    op_t = get_typed_op(op, sc.dtype, bound.dtype, kind="binary")

    def compute():
        dev = _device()
        v = sc._device_value(op_t.type_, dev)
        b = bound._device_value(op_t.type_, dev)
        out = op_t.fn(v, b) if right is not None else op_t.fn(b, v)
        return out, _present(not sc._empty, dev)

    return op_t.return_type, compute


def _device():
    from .utils import collection_device

    return collection_device()


def _present(flag, device):
    return torch.full((), bool(flag), dtype=torch.bool, device=device)


def _scalar_from_pickle(dtype, value, is_cscalar, name):
    sc = Scalar(dtype, is_cscalar=is_cscalar, name=name)
    if value is not None:
        sc.value = value[()]
    return sc

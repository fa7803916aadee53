"""Operator registry backbone.

Counterpart of ``graphblas_tpu/core/operator/base.py``.  Every typed op holds
a **torch function on carrier tensors** (``core.dtypes``) plus dtype
metadata; builtin tables are generated from declarative specs in the
per-kind modules.  A UDF is a plain Python function of tensors.  Its return
type comes from evaluating it on one-element CPU tensors of the input
carriers that carry their type (``_Typed``; dicts of field tensors for
UDTs).  It runs with float64 as torch's default dtype, so a Python float
promotes as it does in the reference under x64 (``lambda x: x * 1.5`` on
INT32 is FP64 in both), and its result is converted to that return type.
"""

import contextlib
import functools
import itertools

import numpy as np
import torch

from .. import dtypes as _dt
from ... import exceptions as _exc

# ---------------------------------------------------------------------------
# Dtype groups used by the builtin spec tables
# ---------------------------------------------------------------------------

BOOLS = (_dt.BOOL,)
SINTS = (_dt.INT8, _dt.INT16, _dt.INT32, _dt.INT64)
UINTS = (_dt.UINT8, _dt.UINT16, _dt.UINT32, _dt.UINT64)
INTS = SINTS + UINTS
FPS = (_dt.FP32, _dt.FP64)
FCS = (_dt.FC32, _dt.FC64)
NUMS = INTS + FPS
NUMS_FC = NUMS + FCS
ALL = BOOLS + NUMS_FC
ALL_NOFC = BOOLS + NUMS

_POSITIONAL_NAMES = frozenset(
    [
        "firsti",
        "firsti1",
        "firstj",
        "firstj1",
        "secondi",
        "secondi1",
        "secondj",
        "secondj1",
        "positioni",
        "positioni1",
        "positionj",
        "positionj1",
        # index-unary positional
        "rowindex",
        "colindex",
        "diagindex",
        "tril",
        "triu",
        "diag",
        "offdiag",
        "colle",
        "colgt",
        "rowle",
        "rowgt",
        "indexle",
        "indexgt",
    ]
)


@contextlib.contextmanager
def x64():
    """Run with float64 as torch's default dtype (Python floats and integer
    true division then promote as JAX does under x64)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


_CASTS = frozenset(
    getattr(torch.Tensor, name)
    for name in ("to", "type", "long", "int", "short", "char", "byte", "bool", "float", "double", "half", "bfloat16")
)


def _funcs(*names):
    """The callables torch hands ``__torch_function__`` for these ops: the
    TensorBase methods, the Tensor dunders and the torch functions."""
    out = set()
    for name in names:
        for owner in (torch._C.TensorBase, torch.Tensor, torch):
            f = getattr(owner, name, None)
            if f is not None:
                out.add(f)
    return frozenset(out)


_COMPARE = {
    f: cmp
    for cmp, names in (
        ("lt", ("lt", "less", "__lt__")),
        ("le", ("le", "less_equal", "__le__")),
        ("gt", ("gt", "greater", "__gt__")),
        ("ge", ("ge", "greater_equal", "__ge__")),
    )
    for f in _funcs(*names)
}
_ABS = _funcs("abs", "__abs__", "absolute")
_MINMAX = {**dict.fromkeys(_funcs("minimum"), "lt"), **dict.fromkeys(_funcs("maximum"), "gt")}
_TRUEDIV = _funcs("div", "true_divide", "__truediv__", "__rtruediv__", "divide")
_ARITH = _TRUEDIV | _funcs("add", "sub", "rsub", "mul", "multiply", "pow", "__add__", "__radd__", "__sub__", "__rsub__")
_ARITH |= _funcs("__mul__", "__rmul__", "__pow__", "__rpow__")
_SUB = _funcs("sub", "rsub", "subtract", "__sub__", "__rsub__")
_FLOORDIV = {**dict.fromkeys(_funcs("floor_divide", "__floordiv__"), False), **dict.fromkeys(_funcs("__rfloordiv__"), True)}
_MOD = {**dict.fromkeys(_funcs("remainder", "__mod__"), False), **dict.fromkeys(_funcs("__rmod__"), True)}


def _u64_operand(a):
    """An operand of a UINT64 op as int64 bits (a Python int wraps)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.tensor(int(a) - (1 << 64) if int(a) >= 1 << 63 else int(a), dtype=torch.int64)


def _special(func, args, tags):
    """The reference's semantics where torch's differ for the carriers: UINT64
    compares, orders, divides and converts to float unsigned; complex values
    compare lexicographically (numpy's order); a bool operand of a
    subtraction promotes.  None where torch's op is right as it is."""
    from . import _math as _m

    u64 = any(t is not None and t.np_type == np.uint64 for t in tags)
    cplx = any(isinstance(a, torch.Tensor) and a.is_complex() for a in args)
    if func in _SUB and any(t is not None and t._is_bool for t in tags):
        # JAX promotes a bool operand of a subtraction; torch refuses it
        other = next((a for a in args if not (isinstance(a, torch.Tensor) and a.dtype == torch.bool)), None)
        if other is not None:
            target = other.dtype if isinstance(other, torch.Tensor) else torch.get_default_dtype() if isinstance(other, float) else torch.int64
            conv = [a.to(target) if isinstance(a, torch.Tensor) and a.dtype == torch.bool else a for a in args]
            return lambda *_: func(*conv)
    if func in _COMPARE and (u64 or cplx):
        cmp = _COMPARE[func]
        if u64:
            return lambda a, b: _m.compare(cmp, _dt.UINT64)(_u64_operand(a), _u64_operand(b))
        gt = lambda x, y: (x.real > y.real) | ((x.real == y.real) & (x.imag > y.imag))  # noqa: E731
        x, y = (torch.as_tensor(a) for a in args[:2])
        out = {"gt": gt(x, y), "lt": gt(y, x), "ge": ~gt(y, x), "le": ~gt(x, y)}[cmp]
        return lambda *_: out
    if not u64:
        return None
    if func in _ABS:
        return lambda a: a
    if func in _MINMAX:
        lt = _m.compare(_MINMAX[func], _dt.UINT64)
        return lambda a, b: torch.where(lt(_u64_operand(b), _u64_operand(a)), _u64_operand(b), _u64_operand(a))
    floaty = any(isinstance(a, float) or (isinstance(a, torch.Tensor) and a.is_floating_point()) for a in args)
    if func in _ARITH and (floaty or func in _TRUEDIV):
        conv = [
            _dt.cast(a, _dt.UINT64, _dt.FP64) if t is not None and t.np_type == np.uint64 else a for a, t in zip(args, tags)
        ]
        return lambda *_: func(*conv)
    for table, op in ((_FLOORDIV, _m.idiv(_dt.UINT64)), (_MOD, _m.irem(_dt.UINT64))):
        if func in table:
            a, b = (_u64_operand(x) for x in args[:2])
            return (lambda *_: op(b, a)) if table[func] else (lambda *_: op(a, b))
    return None


class _Typed(torch.Tensor):
    """A tensor that carries its DataType through a UDF: the probe that
    types a UDF's result, and the inputs of a UDF over UINT16, UINT32,
    UINT64 or complex values at run time.  An integer result is typed by the
    promotion of the typed tensors it was computed from, where that
    promotion rides the result's carrier (UINT32 + UINT32 in int64 is
    UINT32) or is a float (UINT64 + INT64 is FP64), and by its torch dtype
    after an explicit conversion or anywhere else.  UINT16 and UINT32
    results are masked to their width after every op; UINT64, complex and
    bool operands follow ``_special``."""

    _gb = None

    @staticmethod
    def tag(t, gb):
        r = t.as_subclass(_Typed)
        r._gb = gb
        return r

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tags = []

        def unwrap(a):
            if isinstance(a, torch.Tensor):
                tags.append(a._gb if isinstance(a, _Typed) and a._gb is not None else _dt.lookup_dtype(a.dtype))
                return a.as_subclass(torch.Tensor)
            if isinstance(a, (list, tuple)):
                return type(a)(unwrap(x) for x in a)
            return a

        arg_tags = [a._gb if isinstance(a, _Typed) else None for a in args]
        args = unwrap(args)
        kwargs = {k: unwrap(v) for k, v in kwargs.items()}
        with torch._C.DisableTorchFunctionSubclass():
            special = None if kwargs else _special(func, args, arg_tags)
            out = special(*args) if special is not None else func(*args, **kwargs)
        cast = func in _CASTS or "dtype" in kwargs
        return _retag(out, tags, cast)


def _retag(out, tags, cast):
    if isinstance(out, (list, tuple)):
        return type(out)(_retag(o, tags, cast) for o in out)
    if not isinstance(out, torch.Tensor):
        return out
    gb = _dt.lookup_dtype(out.dtype)
    if gb._is_int and tags and not cast:
        promoted = functools.reduce(_dt._promote, [t for t in tags if not t._is_udt] or [gb])
        # UINT64 with a signed type promotes to FP64, in JAX as in numpy
        if promoted.carrier == out.dtype or promoted._is_float:
            gb = promoted
    return _Typed.tag(_dt.wrap(out, gb) if gb._masked and gb.carrier == out.dtype else out, gb)


def _probe(dt):
    """A one-element CPU tensor of ``dt``'s carrier (a dict of them for UDTs)."""
    if dt._is_udt:
        return {f: _probe(_dt.lookup_dtype(dt.np_type[f])) for f in dt.np_type.names}
    return _Typed.tag(torch.ones(1, dtype=dt.carrier), dt)


def _result_type(out):
    """The DataType of a UDF's result (see ``_Typed``)."""
    if isinstance(out, dict):
        fields = [(name, _result_type(v).np_type) for name, v in out.items()]
        return _dt.register_anonymous(np.dtype(fields))
    if isinstance(out, (bool, np.bool_)):
        return _dt.BOOL
    if isinstance(out, (int, float, complex)):
        return _dt.lookup_dtype(type(out))
    if isinstance(out, (np.ndarray, np.generic)):
        return _dt.lookup_dtype(out.dtype)
    if isinstance(out, _Typed) and out._gb is not None:
        return out._gb
    return _dt.lookup_dtype(out.dtype)


def _output_dtype_of(fn, *input_dtypes):
    """Discover the output dtype of a scalar function by evaluating it on
    one-element tensors.  UDT arguments are passed as dicts of field tensors
    (SoA convention); a dict output means a UDT of those fields."""
    try:
        with x64():
            out = fn(*(_probe(dt) for dt in input_dtypes))
        return _result_type(out)
    except Exception as exc:
        raise _exc.UdfParseError(f"unable to evaluate user-defined function: {exc}") from exc


def _coerce(out, ret, like):
    """A UDF's result as carrier tensors of ``ret``, of ``like``'s shape."""
    if ret._is_udt:
        return {f: _coerce(out[f], _dt.lookup_dtype(ret.np_type[f]), like) for f in ret.np_type.names}
    if not isinstance(out, torch.Tensor):
        out = torch.as_tensor(np.asarray(out)) if isinstance(out, (np.ndarray, np.generic)) else torch.tensor(out)
    if like is not None and out.shape != like.shape:
        out = out.to(like.device).expand(torch.broadcast_shapes(out.shape, like.shape))
    return _dt.cast(out, _dt.lookup_dtype(out.dtype), ret)


def _first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, dict):
            return _first_tensor(a.values())
    return None


def _tagged(a, dt):
    """``a`` as a ``_Typed`` of ``dt`` (dicts of fields for UDTs)."""
    if isinstance(a, dict):
        return {f: _tagged(v, _dt.lookup_dtype(dt.np_type[f])) for f, v in a.items()}
    return _Typed.tag(a, dt) if isinstance(a, torch.Tensor) else a


def _needs_tags(dtypes):
    return any(t._is_complex or t._is_bool or (t._is_unsigned_int and t._bits > 8) for t in _leaf_types(dtypes))


def _leaf_types(dtypes):
    out = []
    for dt in dtypes:
        if dt._is_udt:
            out += _leaf_types([_dt.lookup_dtype(dt.np_type[f]) for f in dt.np_type.names])
        else:
            out.append(dt)
    return out


def _plain(out):
    if isinstance(out, dict):
        return {k: _plain(v) for k, v in out.items()}
    return out.as_subclass(torch.Tensor) if isinstance(out, _Typed) else out


def udf_fn(func, ret, input_dtypes=()):
    """The typed op function of a UDF: ``func`` under float64 defaults (on
    typed tensors where the inputs are BOOL, UINT16/32/64 or complex), its
    result converted to ``ret``."""
    tagged = _needs_tags(input_dtypes)

    def fn(*args):
        call = args
        if tagged:
            call = [_tagged(a, dt) for a, dt in zip(args, input_dtypes)] + list(args[len(input_dtypes) :])
        with x64():
            out = _plain(func(*call))
        return _coerce(out, ret, _first_tensor(args))

    fn.__name__ = getattr(func, "__name__", "udf")
    return fn


# ---------------------------------------------------------------------------
# Typed ops: an op specialized to concrete input dtype(s)
# ---------------------------------------------------------------------------


class TypedOpBase:
    __slots__ = ("parent", "name", "type_", "type2", "return_type", "fn", "_custom")

    def __init__(self, parent, name, type_, return_type, fn, type2=None):
        self.parent = parent
        self.name = name
        self.type_ = type_
        self.type2 = type2 if type2 is not None else type_
        self.return_type = return_type
        self.fn = fn

    @property
    def opclass(self):
        return type(self).__name__.removeprefix("Typed")

    @property
    def _carg(self):  # parity shim; identifies the op
        return f"{self.parent!r}[{self.type_.name}]"

    def __repr__(self):
        return f"{self.parent!r}[{self.type_.name}]"

    def __reduce__(self):
        return (_deserialize_typed, (self.parent, self.type_.name))

    # positional metadata proxied from the parent
    @property
    def positional(self):
        return getattr(self.parent, "positional", None)

    @property
    def is_positional(self):
        return self.positional is not None


def _deserialize_typed(parent, typename):
    return parent[typename]


class TypedUnaryOp(TypedOpBase):
    __slots__ = ()

    def __call__(self, val):
        return _call_op(self, val)


class TypedBinaryOp(TypedOpBase):
    __slots__ = ()

    @property
    def monoid(self):
        m = self.parent.monoid
        if m is not None and self.type_ in m.types:
            return m[self.type_]
        return None

    @property
    def commutes_to(self):
        c = self.parent.commutes_to
        return c[self.type_] if c is not None and self.type_ in c.types else None

    def __call__(self, left, right=None, *, left_default=None, right_default=None):
        return _call_op(self, left, right, left_default=left_default, right_default=right_default)


class TypedMonoid(TypedOpBase):
    __slots__ = ("binaryop", "identity")

    def __init__(self, parent, name, type_, return_type, fn, binaryop, identity):
        super().__init__(parent, name, type_, return_type, fn, type2=type_)
        self.binaryop = binaryop
        self.identity = identity

    @property
    def is_idempotent(self):
        return self.parent.is_idempotent

    def __call__(self, left, right=None):
        return _call_op(self, left, right)


class TypedSemiring(TypedOpBase):
    __slots__ = ("monoid", "binaryop")

    def __init__(self, parent, name, type_, return_type, monoid, binaryop, type2=None):
        super().__init__(parent, name, type_, return_type, None, type2=type2)
        self.monoid = monoid
        self.binaryop = binaryop

    @property
    def is_positional(self):
        return self.binaryop.is_positional

    def __call__(self, left, right=None):
        return _call_op(self, left, right)


class TypedIndexUnaryOp(TypedOpBase):
    """fn signature: fn(value, row, col, thunk) -> value."""

    __slots__ = ()

    def __call__(self, val, thunk=None):
        return _call_op(self, val, thunk=thunk)


class TypedSelectOp(TypedOpBase):
    """Same as TypedIndexUnaryOp but return type is always BOOL."""

    __slots__ = ()

    def __call__(self, val, thunk=None):
        return _call_op(self, val, thunk=thunk)


class TypedIndexBinaryOp(TypedOpBase):
    """fn signature: fn(x, ix, jx, y, iy, jy, theta) -> value."""

    __slots__ = ()


def _call_op(op, left, right=None, *, thunk=None, left_default=None, right_default=None):
    """Make typed/untyped ops callable on collections & infix expressions:
    ``unary.abs(A)`` is ``A.apply(unary.abs)``, ``binary.plus(A | B)`` an
    ewise expression, ``binary.plus(A, 1)`` a bound apply."""
    from ..infix import InfixExprBase
    from ..base import BaseType

    opclass = op.opclass
    if opclass in {"UnaryOp"}:
        return left.apply(op)
    if opclass in {"IndexUnaryOp", "SelectOp"}:
        if opclass == "SelectOp":
            return left.select(op, thunk)
        return left.apply(op, thunk=thunk)
    if right is None:
        if isinstance(left, InfixExprBase):
            return left._apply_op(op, left_default=left_default, right_default=right_default)
        raise TypeError(
            f"Bad type when calling {op!r}.\n    - Expected an infix expression like"
            f" (A | B) or (A & B) or (A @ B)\n    - Got {type(left)}"
        )
    # op(left, right) where one side may be a scalar -> bound apply
    if isinstance(left, BaseType) or isinstance(right, BaseType):
        from ..scalar import _is_scalar_like

        if _is_scalar_like(right):
            return left.apply(op, right=right)
        if _is_scalar_like(left):
            return right.apply(op, left=left)
        raise TypeError(
            f"Bad types when calling {op!r}. When two arguments are given, one must be a scalar.\n"
            f"    - Got {type(left)} and {type(right)}"
        )
    raise TypeError(f"Bad types when calling {op!r}: {type(left)}, {type(right)}")


# ---------------------------------------------------------------------------
# Untyped ops: name -> {dtype: typed op}
# ---------------------------------------------------------------------------


class OpBase:
    _typed_class = None
    _modname = "op"

    def __init__(self, name, *, anonymous=False):
        self.name = name
        self._anonymous = anonymous
        self._typed_ops = {}
        self.types = {}  # input DataType -> return DataType
        self.coercions = {}  # input DataType -> DataType actually used
        self.orig_func = None
        self._udt_cache = {}

    # -- registry access ----------------------------------------------------

    def __getitem__(self, type_):
        dtype = _dt.lookup_dtype(type_)
        if dtype in self._typed_ops:
            return self._typed_ops[dtype]
        if dtype in self.coercions:
            return self._typed_ops[self.coercions[dtype]]
        typed = self._compile_dtype(dtype)
        if typed is not None:
            return typed
        raise KeyError(f"{self.name} does not work with {dtype}")

    def _compile_dtype(self, dtype):
        """Build a typed op on demand for a new dtype (UDTs, unusual dtypes)
        from the generic Python function."""
        if self.orig_func is None:
            return None
        if dtype in self._udt_cache:
            return self._udt_cache[dtype]
        nargs = getattr(self, "_nargs", 1)
        ret = _output_dtype_of(self.orig_func, *([dtype] * nargs))
        typed = self._typed_class(self, self.name, dtype, ret, udf_fn(self.orig_func, ret, [dtype] * nargs))
        self._udt_cache[dtype] = typed
        self.types[dtype] = ret
        self._typed_ops[dtype] = typed
        return typed

    def __contains__(self, type_):
        try:
            self[type_]
        except (TypeError, KeyError, ValueError, _exc.UdfParseError):
            return False
        return True

    def __repr__(self):
        return f"{self._modname}.{self.name}"

    def __reduce__(self):
        if self._anonymous:
            if self.orig_func is not None:
                return (self.register_anonymous, (self.orig_func, self.name))
            raise NotImplementedError("Cannot pickle this anonymous operator")
        name = f"{self._modname}.{self.name}"
        return (_deserialize_op_by_name, (name,))

    def _add(self, typed_op, dtype=None):
        dtype = typed_op.type_ if dtype is None else dtype
        self._typed_ops[dtype] = typed_op
        self.types[dtype] = typed_op.return_type

    positional = None  # overridden per-instance by positional ops

    @property
    def opclass(self):
        return type(self).__name__

    @property
    def is_positional(self):
        return self.positional is not None


def _deserialize_op_by_name(qualname):
    import importlib

    modname, opname = qualname.rsplit(".", 1)
    module = importlib.import_module(f"graphblas_tpu_torch.{modname}")
    return getattr(module, opname)


class ParameterizedUdf:
    """An operator factory: calling it with parameters yields a concrete op."""

    def __init__(self, name, func, anonymous, register, *, is_udt=False):
        self.name = name
        self.func = func
        self._anonymous = anonymous
        self._register = register
        self._cache = {}

    def __call__(self, *args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        try:
            if key in self._cache:
                return self._cache[key]
        except TypeError:
            key = None
        inner = self.func(*args, **kwargs)
        op = self._register(inner, f"{self.name}({', '.join(map(repr, args))})")
        if key is not None:
            self._cache[key] = op
        return op

    def __repr__(self):
        return f"ParameterizedUdf<{self.name}>"


def find_opclass(op):
    """Return (op, opclass_name)."""
    from .agg import Aggregator, TypedAggregator

    if isinstance(op, OpBase):
        return op, op.opclass
    if isinstance(op, TypedOpBase):
        return op, op.opclass
    if isinstance(op, (Aggregator, TypedAggregator)):
        return op, "Aggregator"
    if isinstance(op, ParameterizedUdf):
        return op, "ParameterizedUdf"
    if callable(op):
        return op, "UserDefined"
    return op, "UnknownOpClass"


def _all_pairs(domains):
    return itertools.product(domains, repeat=2)

"""Operator dispatch: dtype unification, string DSL, semiring composition.

Counterpart of ``graphblas_tpu/core/operator/utils.py`` (python-graphblas's
get_typed_op, get_semiring and the from-string DSL).
"""

from .. import dtypes as _dt
from ... import exceptions as _exc
from .base import OpBase, ParameterizedUdf, TypedOpBase, find_opclass

_SYMBOL_MAP = {
    "+": "plus",
    "-": "minus",
    "*": "times",
    "/": "truediv",
    "//": "floordiv",
    "%": "fmod",
    "**": "pow",
    "==": "eq",
    "!=": "ne",
    "<": "lt",
    ">": "gt",
    "<=": "le",
    ">=": "ge",
    "&": "land",
    "|": "lor",
    "^": "lxor",
    "~": "lnot",
}


def _parse_string(string):
    """Split 'name[dtype]' -> (name, dtype or None)."""
    string = string.strip()
    dtype = None
    if string.endswith("]") and "[" in string:
        string, _, dt_str = string[:-1].partition("[")
        dtype = _dt.lookup_dtype(dt_str.strip())
    name = _SYMBOL_MAP.get(string.strip(), string.strip())
    return name, dtype


def _namespace(kind):
    import importlib

    return importlib.import_module(f"graphblas_tpu_torch.{kind}")


def _from_string(string, kind):
    name, dtype = _parse_string(string)
    module = _namespace(kind)
    target = module
    for part in name.split("."):
        target = getattr(target, part, None)
        if target is None:
            raise ValueError(f"Unknown {kind} string: {string!r}")
    if dtype is not None:
        return target[dtype]
    return target


def unary_from_string(string):
    return _from_string(string, "unary")


def binary_from_string(string):
    return _from_string(string, "binary")


def monoid_from_string(string):
    return _from_string(string, "monoid")


def semiring_from_string(string):
    return _from_string(string, "semiring")


def indexunary_from_string(string):
    return _from_string(string, "indexunary")


def select_from_string(string):
    return _from_string(string, "select")


def aggregator_from_string(string):
    return _from_string(string, "agg")


def op_from_string(string):
    """Resolve a string searching all op namespaces."""
    for kind in ("unary", "binary", "monoid", "semiring", "indexunary", "select", "agg"):
        try:
            return _from_string(string, kind)
        except (ValueError, AttributeError):
            continue
    raise ValueError(f"Unknown op string: {string!r}")


_STRING_KINDS = {
    "unary": (unary_from_string,),
    "binary": (binary_from_string, monoid_from_string),
    "monoid": (monoid_from_string, binary_from_string),
    "semiring": (semiring_from_string,),
    "indexunary": (indexunary_from_string, select_from_string),
    "select": (select_from_string, indexunary_from_string),
    "unary|binary": (unary_from_string, binary_from_string),
    "binary|aggregator": (binary_from_string, monoid_from_string, aggregator_from_string),
    None: (op_from_string,),
}


def resolve_op_string(string, kind=None):
    errors = []
    for parser in _STRING_KINDS.get(kind, (op_from_string,)):
        try:
            return parser(string)
        except (ValueError, AttributeError) as exc:
            errors.append(exc)
    raise ValueError(f"Unknown op string for kind={kind}: {string!r}")


def get_typed_op(op, dtype, dtype2=None, *, is_left_scalar=False, is_right_scalar=False, kind=None):
    """Resolve op (object, typed op, string, or raw function) to a typed op for
    the given input dtype(s)."""
    from .agg import Aggregator, TypedAggregator

    if isinstance(op, str):
        op = resolve_op_string(op, kind)
    if isinstance(op, ParameterizedUdf):
        op = op()  # default parameters
    if isinstance(op, TypedOpBase):
        # an explicitly-typed op stays pinned to its dtype
        return op
    if isinstance(op, TypedAggregator):
        op = op.parent
    if isinstance(op, Aggregator):
        return op[dtype]
    if not isinstance(op, OpBase) and not hasattr(op, "__getitem__"):
        if callable(op):
            # raw Python function: auto-register, memoized per function object
            # (a fresh op per call would grow the registry)
            cached = _autoreg_cache.get(op)
            if cached is not None:
                op = cached
            else:
                from .binary import BinaryOp
                from .unary import UnaryOp

                func = op
                nargs = _count_args(func)
                if nargs == 1:
                    op = UnaryOp.register_anonymous(func, getattr(func, "__name__", None))
                elif nargs == 2:
                    op = BinaryOp.register_anonymous(func, getattr(func, "__name__", None))
                else:
                    raise TypeError(f"Unable to auto-register function with {nargs} args as an operator")
                try:
                    _autoreg_cache[func] = op
                except TypeError:
                    pass
        else:
            raise TypeError(f"Unable to get typed operator from object with type {type(op)}")

    from .semiring import Semiring

    if isinstance(op, Semiring):
        if dtype2 is None:
            dtype2 = dtype
        return op._typed(dtype, dtype2)
    if dtype2 is not None:
        try:
            dtype = _dt.unify(dtype, dtype2, is_left_scalar=is_left_scalar, is_right_scalar=is_right_scalar)
        except _exc.DomainMismatch:
            if getattr(op, "is_positional", False):
                dtype = _dt.INT64
            else:
                raise
    return op[dtype]


def _count_args(func):
    import inspect

    try:
        sig = inspect.signature(func)
    except (TypeError, ValueError):
        return -1
    return sum(
        1
        for p in sig.parameters.values()
        if p.kind in {p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD} and p.default is p.empty
    )


import weakref

_autoreg_cache = weakref.WeakKeyDictionary()
_semiring_cache = {}


def get_semiring(monoid, binaryop, name=None):
    """Compose (and cache) a Semiring from a Monoid and BinaryOp."""
    from .monoid import Monoid
    from .binary import BinaryOp
    from .semiring import Semiring

    monoid, mon_class = find_opclass(monoid)
    binaryop, bin_class = find_opclass(binaryop)
    if isinstance(monoid, TypedOpBase):
        monoid = monoid.parent
    if isinstance(binaryop, TypedOpBase):
        binaryop = binaryop.parent
    if mon_class == "BinaryOp" and isinstance(monoid, BinaryOp):
        if monoid.monoid is None:
            raise TypeError(f"monoid argument must be a Monoid; {monoid.name} has no monoid")
        monoid = monoid.monoid
    if not isinstance(monoid, Monoid):
        raise TypeError(f"monoid argument must be a Monoid; got {type(monoid)}")
    from .indexbinary import _BoundIndexBinaryOp

    if not isinstance(binaryop, (BinaryOp, _BoundIndexBinaryOp)):
        raise TypeError(f"binaryop argument must be a BinaryOp; got {type(binaryop)}")
    key = (id(monoid), id(binaryop))
    if key in _semiring_cache:
        sr = _semiring_cache[key]
        if name is not None and sr.name != name:
            sr = Semiring(name, monoid, binaryop)
            return sr
        return sr
    if name is None:
        name = f"{monoid.name}_{binaryop.name}"
    sr = Semiring(name, monoid, binaryop)
    _semiring_cache[key] = sr
    return sr

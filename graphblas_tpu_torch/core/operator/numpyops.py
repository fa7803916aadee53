"""The numpy-named operators of ``unary.numpy`` and ``binary.numpy`` as
torch functions.

The reference takes each one by ``getattr(jnp, name)`` and types it by
tracing; here each name has an explicit entry: the input types it takes, the
type it returns (JAX's: integer and bool inputs of a float function compute
in FP32, 64-bit ones in FP64; bool inputs of an arithmetic one in INT32),
and its function on carriers.  Where torch has no function of that name,
one is composed from torch ops.  With ``config["mapnumpy"]`` on (the
default) the names that have a builtin equivalent alias it instead, and only
the rest come from here.
"""

import numpy as np
import torch

from .. import dtypes as _dt
from . import _math as _m
from .base import ALL, BOOLS, INTS, NUMS, NUMS_FC, TypedBinaryOp, TypedUnaryOp

REAL = BOOLS + NUMS


def inexact(dt):
    """The type JAX computes a float function of ``dt`` in."""
    if dt._is_float or dt._is_complex:
        return dt
    return _dt.FP64 if dt._bits == 64 else _dt.FP32


def numeric(dt):
    """The type JAX computes an arithmetic function of ``dt`` in (bool -> INT32)."""
    return _dt.INT32 if dt._is_bool else dt


def _via(target, make):
    """A factory computing ``make(t)`` after converting the inputs to ``target(dt)``."""

    def factory(dt):
        t = target(dt)
        fn = make(t)
        return lambda *xs: fn(*(_dt.cast(x, dt, t) for x in xs))

    return factory


def _greater(dt):
    if dt._is_complex:
        return lambda x, y: (x.real > y.real) | ((x.real == y.real) & (x.imag > y.imag))
    return _m.compare("gt", dt)


def _less(dt):
    gt = _greater(dt)
    return lambda x, y: gt(y, x)


def _jnp_rem(t):
    """lax.rem: the sign of x; x rem 0 is x; INT_MIN rem -1 is 0."""
    if t._is_float:
        return _m.fmod
    div = _m.idiv(t)

    def f(x, y):
        safe = torch.where(y == 0, _m.const(y, 1), y)
        r = _dt.wrap(x - div(x, safe) * safe, t)
        return torch.where(y == 0, x, r)

    return f


def _atan2_complex(x, y):
    """XLA's complex atan2: -i log((y + i x) / sqrt(y^2 + x^2))."""
    return -1j * torch.log((y + 1j * x) / torch.sqrt(y * y + x * x))


def _fmod(t):
    """jnp.fmod: lax.rem, an integer y of 0 reading as 1 (bool inputs, which
    promote to INT32, are not replaced)."""
    rem = _jnp_rem(t)
    if t._is_float:
        return rem
    return lambda x, y: rem(x, torch.where(y == 0, _m.const(y, 1), y))


def _remainder(t):
    """jnp.remainder: the sign of y; an integer y of 0 reads as 1."""
    rem = _jnp_rem(t)
    neg = (lambda a: a < 0) if not t._is_unsigned_int else (lambda a: torch.zeros_like(a, dtype=torch.bool))

    def f(x, y):
        if t._is_int:
            y = torch.where(y == 0, _m.const(y, 1), y)
        r = rem(x, y)
        plus = (r != 0) & (neg(r) != neg(y))
        return torch.where(plus, _dt.wrap(r + y, t), r)

    return f


def _floor_divide(t):
    if t._is_float:
        return _m.float_divmod
    div = _m.idiv(t)
    if t._is_unsigned_int:
        return div
    rem = _jnp_rem(t)

    def f(x, y):
        q = div(x, y)
        sel = (torch.sign(x) != torch.sign(y)) & (rem(x, y) != 0)
        return torch.where(sel, q - 1, q)

    return f


def _power(t):
    if t._is_int:
        return _m.ipow(t)
    return torch.pow


def _gcd(t):
    """jnp.gcd: Euclid on |x|, |y| until every y is 0, the larger first."""
    rem = _jnp_rem(t)
    absf = _m.iabs(t)
    lt = _m.compare("lt", t)

    def f(x, y):
        a, b = absf(x), absf(y)
        # Euclid ends within 1.5 x bits steps; the bound ends the loop where
        # |INT_MIN| wraps negative (the reference's loop does not end there)
        for _ in range(2 * t._bits):
            if not bool((b != 0).any()):
                break
            nz = b != 0
            a, b = torch.where(nz, b, a), torch.where(nz, rem(a, torch.where(nz, b, _m.const(b, 1))), torch.zeros_like(b))
            swap = lt(a, b)
            a, b = torch.where(swap, b, a), torch.where(swap, a, b)
        return a

    return f


def _lcm(t):
    """jnp.lcm: |x| * (|y| // gcd), wrapping."""
    gcd = _gcd(t)
    fdiv = _floor_divide(t)
    absf = _m.iabs(t)

    def f(x, y):
        a, b = absf(x), absf(y)
        d = gcd(a, b)
        q = fdiv(b, torch.where(d == 0, _m.const(d, 1), d))
        return torch.where(d == 0, torch.zeros_like(a), _dt.wrap(a * q, t))

    return f


def _shift(t, left):
    bits = t._bits

    def f(x, y):
        k = _dt.cast(y, t, _dt.INT64)
        k = torch.where(k < 0, _m.const(k, bits), k)  # XLA reads the amount unsigned
        big = k >= bits
        kc = torch.clamp(k, 0, bits - 1)
        if left:
            return torch.where(big, torch.zeros_like(x), _dt.wrap(x << kc.to(x.dtype), t))
        if t._is_signed_int:
            return x >> torch.where(big, _m.const(kc, bits - 1), kc).to(x.dtype)
        if t.np_type == np.uint64:
            shifted = torch.where(kc > 0, (x >> kc) & ((torch.ones_like(x) << (64 - kc)) - 1), x)
        else:
            shifted = x >> kc.to(x.dtype)
        return torch.where(big, torch.zeros_like(x), shifted)

    return f


def _logaddexp(base):
    """jax.lax's logaddexp / logaddexp2: amax + log1p(exp(-|x - y|)); NaN
    or same-signed infinities give x + y; complex inputs wrap the phase."""
    exp = torch.exp2 if base == 2 else torch.exp
    scale = 1 / np.log(2) if base == 2 else 1.0

    def make(t):
        if t._is_complex:
            gt = _greater(t)
            period = np.pi / np.log(2) if base == 2 else np.pi

            def fc(x, y):
                amax = torch.where(gt(y, x), y, x)
                out = amax + scale * torch.log1p(exp((x + y) - amax * 2))
                im = torch.remainder(out.imag + period, 2 * period) - period
                return torch.complex(out.real, im)

            return fc

        def f(x, y):
            delta = x - y
            amax = torch.maximum(x, y)
            return torch.where(torch.isnan(delta), x + y, amax + scale * torch.log1p(exp(-delta.abs())))

        return f

    return make


def _fmax_fmin(which):
    def factory(dt):
        if dt._is_bool:
            return (lambda x, y: x | y) if which == "max" else (lambda x, y: x & y)
        cmp = _greater(dt) if which == "max" else _less(dt)
        if dt._is_float or dt._is_complex:
            return lambda x, y: torch.where(torch.isnan(y) | cmp(x, y), x, y)
        return lambda x, y: torch.where(cmp(x, y), x, y)

    return factory


def _maxmin(which):
    def factory(dt):
        if dt._is_bool:
            return (lambda x, y: x | y) if which == "max" else (lambda x, y: x & y)
        if dt._is_complex:
            cmp = _greater(dt) if which == "max" else _less(dt)
            return lambda x, y: torch.where(torch.isnan(x) | cmp(x, y), x, y)
        return _m.maximum(dt) if which == "max" else _m.minimum(dt)

    return factory


def _same(fn):
    return lambda dt: fn


def _arith(op):
    def factory(dt):
        if dt._is_bool:
            return {"add": lambda x, y: x | y, "multiply": lambda x, y: x & y}[op]
        f = {"add": lambda x, y: x + y, "subtract": lambda x, y: x - y, "multiply": lambda x, y: x * y}[op]
        return lambda x, y: _dt.wrap(f(x, y), dt)

    return factory


def _heaviside(x, y):
    return torch.where(x < 0, _m.const(x, 0), torch.where(x > 0, _m.const(x, 1), y))


def _bool_of(fn):
    return lambda dt: (lambda x, y: fn(x != 0, y != 0))


def _ldexp_factory(dt):
    """The reference's ldexp: a float exponent truncates toward zero."""
    from .binary import ldexp

    t = inexact(dt)
    return lambda x, y: ldexp(_dt.cast(x, dt, t), _dt.cast(y, dt, _dt.INT32))


_SAME, _BOOL, _INEXACT, _NUMERIC = (lambda dt: dt), (lambda dt: _dt.BOOL), inexact, numeric

# name -> (domains, return rule, factory(dt) -> fn on dt's carrier)
BINARY = {
    "add": (ALL, _SAME, _arith("add")),
    "arctan2": (ALL, _INEXACT, _via(inexact, lambda t: _atan2_complex if t._is_complex else torch.atan2)),
    "bitwise_and": (BOOLS + INTS, _SAME, _same(lambda x, y: x & y)),
    "bitwise_or": (BOOLS + INTS, _SAME, _same(lambda x, y: x | y)),
    "bitwise_xor": (BOOLS + INTS, _SAME, _same(lambda x, y: x ^ y)),
    "copysign": (REAL, _INEXACT, _via(inexact, lambda t: torch.copysign)),
    "divide": (ALL, _INEXACT, _via(inexact, lambda t: torch.true_divide)),
    "equal": (ALL, _BOOL, _same(lambda x, y: x == y)),
    "float_power": (ALL, _INEXACT, _via(inexact, lambda t: torch.pow)),
    "floor_divide": (REAL, _NUMERIC, _via(numeric, _floor_divide)),
    "fmax": (ALL, _SAME, _fmax_fmin("max")),
    "fmin": (ALL, _SAME, _fmax_fmin("min")),
    "fmod": (REAL, _NUMERIC, lambda dt: _via(numeric, _fmod if not dt._is_bool else _jnp_rem)(dt)),
    "gcd": (INTS, _SAME, _gcd),
    "greater": (ALL, _BOOL, lambda dt: _greater(dt)),
    "greater_equal": (ALL, _BOOL, lambda dt: (lambda x, y, lt=_less(dt): ~lt(x, y) & (x == x) & (y == y))),
    "heaviside": (REAL, _INEXACT, _via(inexact, lambda t: _heaviside)),
    "hypot": (REAL, _INEXACT, _via(inexact, lambda t: torch.hypot)),
    "lcm": (INTS, _SAME, _lcm),
    "ldexp": (REAL, _INEXACT, _ldexp_factory),
    "left_shift": (BOOLS + INTS, _NUMERIC, _via(numeric, lambda t: _shift(t, True))),
    "less": (ALL, _BOOL, lambda dt: _less(dt)),
    "less_equal": (ALL, _BOOL, lambda dt: (lambda x, y, gt=_greater(dt): ~gt(x, y) & (x == x) & (y == y))),
    "logaddexp": (ALL, _INEXACT, _via(inexact, _logaddexp(np.e))),
    "logaddexp2": (ALL, _INEXACT, _via(inexact, _logaddexp(2))),
    "logical_and": (ALL, _BOOL, _bool_of(lambda a, b: a & b)),
    "logical_or": (ALL, _BOOL, _bool_of(lambda a, b: a | b)),
    "logical_xor": (ALL, _BOOL, _bool_of(lambda a, b: a ^ b)),
    "maximum": (ALL, _SAME, _maxmin("max")),
    "minimum": (ALL, _SAME, _maxmin("min")),
    "mod": (REAL, _NUMERIC, _via(numeric, _remainder)),
    "multiply": (ALL, _SAME, _arith("multiply")),
    "nextafter": (REAL, _INEXACT, _via(inexact, lambda t: torch.nextafter)),
    "not_equal": (ALL, _BOOL, _same(lambda x, y: x != y)),
    "power": (ALL, _NUMERIC, _via(numeric, _power)),
    "remainder": (REAL, _NUMERIC, _via(numeric, _remainder)),
    "right_shift": (BOOLS + INTS, _NUMERIC, _via(numeric, lambda t: _shift(t, False))),
    "subtract": (NUMS_FC, _SAME, _arith("subtract")),
    "true_divide": (ALL, _INEXACT, _via(inexact, lambda t: torch.true_divide)),
}


def _u(fn):
    return _via(inexact, lambda t: fn)


def _abs_factory(dt):
    return _m.iabs(dt)


def _abs_ret(dt):
    return {_dt.FC32: _dt.FP32, _dt.FC64: _dt.FP64}.get(dt, dt)


def _sign(dt):
    if dt._is_complex:
        return torch.sgn
    return _m.fsign if dt._is_float else _m.isign(dt)


def _rint_ret(dt):
    return dt if dt._is_float or dt._is_complex else _dt.FP64


def _rint(dt):
    t = _rint_ret(dt)
    if t._is_complex:
        return lambda x: torch.complex(torch.round(x.real), torch.round(x.imag))
    return lambda x: torch.round(_dt.cast(x, dt, t))


def _spacing(x):
    """np.spacing: the distance to the next float away from zero."""
    away = torch.copysign(_m.const(x, np.inf), x)
    return torch.nextafter(x, away) - x


def _square(dt):
    t = numeric(dt)
    return lambda x: _dt.wrap(_dt.cast(x, dt, t) * _dt.cast(x, dt, t), t)


def _cbrt(t):
    from .unary import _cbrt as cbrt

    return cbrt


def _asinh(x):
    from .unary import _asinh as asinh

    return asinh(x)


def _integral_identity(fn):
    """ceil/floor/trunc: integers and bool pass through."""
    return lambda dt: (lambda x: x) if not dt._is_float else fn


_DEG = float(180 / np.pi)
_RAD = float(np.pi / 180)

UNARY = {
    "abs": (ALL, _abs_ret, _abs_factory),
    "absolute": (ALL, _abs_ret, _abs_factory),
    "arccos": (ALL, _INEXACT, _u(torch.arccos)),
    "arccosh": (ALL, _INEXACT, _u(torch.arccosh)),
    "arcsin": (ALL, _INEXACT, _u(torch.arcsin)),
    "arcsinh": (ALL, _INEXACT, _u(_asinh)),
    "arctan": (ALL, _INEXACT, _u(torch.arctan)),
    "arctanh": (ALL, _INEXACT, _u(torch.arctanh)),
    "cbrt": (REAL, _INEXACT, _via(inexact, _cbrt)),
    "ceil": (REAL, _SAME, _integral_identity(torch.ceil)),
    "conjugate": (ALL, _SAME, lambda dt: torch.conj_physical if dt._is_complex else (lambda x: x)),
    "cos": (ALL, _INEXACT, _u(torch.cos)),
    "cosh": (ALL, _INEXACT, _u(torch.cosh)),
    "deg2rad": (ALL, _INEXACT, _u(lambda x: x * _RAD)),
    "degrees": (ALL, _INEXACT, _u(lambda x: x * _DEG)),
    "exp": (ALL, _INEXACT, _u(torch.exp)),
    "exp2": (ALL, _INEXACT, _u(torch.exp2)),
    "expm1": (ALL, _INEXACT, _u(torch.expm1)),
    "fabs": (REAL, _INEXACT, _u(torch.abs)),
    "floor": (REAL, _SAME, _integral_identity(torch.floor)),
    "invert": (BOOLS + INTS, _SAME, lambda dt: (lambda x: _dt.wrap(~x, dt))),
    "isfinite": (ALL, _BOOL, lambda dt: torch.isfinite),
    "isinf": (ALL, _BOOL, lambda dt: torch.isinf),
    "isnan": (ALL, _BOOL, lambda dt: torch.isnan),
    "log": (ALL, _INEXACT, _u(torch.log)),
    "log10": (ALL, _INEXACT, _u(torch.log10)),
    "log1p": (ALL, _INEXACT, _u(torch.log1p)),
    "log2": (ALL, _INEXACT, _u(torch.log2)),
    "logical_not": (ALL, _BOOL, lambda dt: (lambda x: x == 0)),
    "negative": (NUMS_FC, _SAME, lambda dt: (lambda x: _dt.wrap(-x, dt))),
    "positive": (ALL, _SAME, lambda dt: (lambda x: x)),
    "rad2deg": (ALL, _INEXACT, _u(lambda x: x * _DEG)),
    "radians": (ALL, _INEXACT, _u(lambda x: x * _RAD)),
    "reciprocal": (ALL, _INEXACT, _u(lambda x: 1 / x)),
    "rint": (ALL, _rint_ret, _rint),
    "sign": (NUMS_FC, _SAME, _sign),
    "signbit": (REAL, _BOOL, lambda dt: torch.signbit if dt._is_float else (lambda x: _dt.ordered(x, dt) < 0 if dt._is_signed_int else torch.zeros_like(x, dtype=torch.bool))),
    "sin": (ALL, _INEXACT, _u(torch.sin)),
    "sinh": (ALL, _INEXACT, _u(torch.sinh)),
    "spacing": (REAL, _INEXACT, _u(_spacing)),
    "sqrt": (ALL, _INEXACT, _u(torch.sqrt)),
    "square": (ALL, numeric, _square),
    "tan": (ALL, _INEXACT, _u(torch.tan)),
    "tanh": (ALL, _INEXACT, _u(torch.tanh)),
    "trunc": (REAL, _SAME, _integral_identity(torch.trunc)),
}


def build(op, table, typed_class):
    """Fill ``op`` (an anonymous UnaryOp or BinaryOp named numpy.<name>)
    with the typed ops of its table entry."""
    domains, ret_rule, factory = table[op.name.removeprefix("numpy.")]
    for dt in domains:
        op._add(typed_class(op, op.name, dt, ret_rule(dt), factory(dt)))
    return op


def build_binary(op):
    return build(op, BINARY, TypedBinaryOp)


def build_unary(op):
    return build(op, UNARY, TypedUnaryOp)


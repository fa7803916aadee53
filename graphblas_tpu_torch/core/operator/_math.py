"""Carrier-aware elementwise math shared by the builtin operator tables.

Each helper computes what the reference's ``jnp``/``lax`` expression
computes, on the carrier tensors of ``core.dtypes``, without leaning on
torch where torch differs (integer division by 0 or of INT_MIN by -1,
``torch.sign`` of NaN and -0.0, half-to-even ``torch.round`` where XLA rounds
away from zero) or has no kernel (the unsigned types past 8 bits).
"""

import torch

from .. import dtypes as _dt
from ...kernels.segscan import _maximum, _minimum


def const(x, value):
    """A 0-d tensor of ``value`` in ``x``'s dtype and device."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def ordered(dt):
    return lambda t: _dt.ordered(t, dt)


def compare(name, dt):
    """``lt``/``le``/``gt``/``ge`` in ``dt``'s order (unsigned for UINT64)."""
    o = ordered(dt)
    return {
        "lt": lambda x, y: o(x) < o(y),
        "le": lambda x, y: o(x) <= o(y),
        "gt": lambda x, y: o(x) > o(y),
        "ge": lambda x, y: o(x) >= o(y),
    }[name]


def minimum(dt):
    """jnp.minimum: NaN propagates, -0.0 below +0.0; unsigned order."""
    if dt._is_float:
        return _minimum
    lt = compare("lt", dt)
    return lambda x, y: torch.where(lt(y, x), y, x)


def maximum(dt):
    if dt._is_float:
        return _maximum
    gt = compare("gt", dt)
    return lambda x, y: torch.where(gt(y, x), y, x)


def fsign(x):
    """lax.sign of floats: NaN stays NaN and signed zeros keep their sign."""
    return torch.where(x > 0, const(x, 1), torch.where(x < 0, const(x, -1), x))


def isign(dt):
    """lax.sign of integers (unsigned: 0 or 1)."""
    if dt._is_unsigned_int:
        return lambda x: (x != 0).to(x.dtype)
    return torch.sign


def round_away(x):
    """lax.round's default: halves away from zero."""
    t = x.trunc()
    return torch.where((x - t).abs() >= 0.5, t + fsign(x), t)


def _udiv64(x, y):
    """Unsigned 64-bit x // y of int64 bits, y != 0: halve x (logically),
    divide, double, and correct the one step the halving can lose."""
    big = y < 0  # y >= 2^63: the quotient is 0 or 1
    yp = torch.where(big, const(y, 1), y)
    q = torch.div(_dt.lshr(x, 1, 64), yp, rounding_mode="trunc") << 1
    r = x - q * yp
    q = torch.where(_dt.ordered(r, _dt.UINT64) >= _dt.ordered(yp, _dt.UINT64), q + 1, q)
    ge = (_dt.ordered(x, _dt.UINT64) >= _dt.ordered(y, _dt.UINT64)).to(x.dtype)
    return torch.where(big, ge, q)


def idiv(dt):
    """lax.div of integers: truncating; x / 0 is all ones (XLA), INT_MIN / -1
    wraps to INT_MIN."""
    if dt.np_type.kind == "u":
        if dt.np_type.itemsize == 8:
            div = _udiv64
        else:
            div = lambda x, y: torch.div(x, y, rounding_mode="trunc")  # noqa: E731

        def f(x, y):
            zero = y == 0
            q = div(x, torch.where(zero, const(y, 1), y))
            return torch.where(zero, _dt.wrap(torch.full_like(q, -1), dt), q)

        return f

    def g(x, y):
        special = (y == 0) | (y == -1)
        q = torch.div(x, torch.where(special, const(y, 1), y), rounding_mode="trunc")
        q = torch.where(y == -1, -x, q)
        return torch.where(y == 0, torch.full_like(q, -1), q)

    return g


def irem(dt):
    """lax.rem of integers (sign of x), for y != 0."""
    div = idiv(dt)
    return lambda x, y: _dt.wrap(x - div(x, y) * y, dt)


def fmod(x, y):
    """C fmod, exact: float32 goes through float64 (torch's vectorized CPU
    fmod returns NaN for float32 where x / y overflows)."""
    if x.dtype == torch.float32:
        return torch.fmod(x.double(), y.double()).float()
    return torch.fmod(x, y)


def float_divmod(x, y):
    """jnp's float floor division, CPython's float_divmod as JAX writes it."""
    mod = fmod(x, y)
    div = (x - mod) / y
    ind = (mod != 0) & (fsign(y) != fsign(mod))
    return round_away(torch.where(ind, div - 1, div))


def ipow(dt):
    """jnp.power of integers: six steps of binary exponentiation on the
    exponent's bits, shifted logically (a negative exponent's low bits)."""
    bits = dt._bits

    def f(x, y):
        one = const(y, 1)
        acc = torch.where((x == 0) & (y != 0), torch.zeros_like(x), torch.ones_like(x))
        for _ in range(6):
            acc = torch.where((y & one) != 0, _dt.wrap(acc * x, dt), acc)
            x = _dt.wrap(x * x, dt)
            y = _dt.lshr(y, 1, bits) if not dt._masked else y >> 1
        return acc

    return f


def iabs(dt):
    """jnp.abs: identity on bool and unsigned types."""
    if dt._is_bool or dt._is_unsigned_int:
        return lambda x: x
    return torch.abs

"""BinaryOp: typed elementwise functions of two values.

Counterpart of ``graphblas_tpu/core/operator/binary.py``: the same builtin
table, commutes table and coercions, with SuiteSparse's BOOL-arithmetic
identities (PLUS=LOR, TIMES=LAND, MINUS=LXOR, ...), written in torch on the
carriers of ``core.dtypes``.  Integer division computes the reference's
values without torch's: truncating ``cdiv`` gives 0 for y == 0 and INT_MIN
for INT_MIN / -1; UINT64 divides, compares and orders unsigned.
"""

import numpy as np
import torch

from .. import dtypes as _dt
from . import _math as _m
from . import base as _b
from .base import (
    ALL,
    BOOLS,
    FCS,
    FPS,
    INTS,
    NUMS,
    OpBase,
    ParameterizedUdf,
    TypedBinaryOp,
)
from .unary import _dotted_set


class BinaryOp(OpBase):
    _typed_class = TypedBinaryOp
    _modname = "binary"
    _nargs = 2
    positional = None

    def __init__(self, name, *, anonymous=False):
        super().__init__(name, anonymous=anonymous)
        self._monoid = None
        self._commutes_to_name = None
        # values are substituted with 1 at absent positions before applying
        # (guards int division-by-zero on dense-masked storage)
        self._needs_safe_fill = False

    @property
    def monoid(self):
        """The Monoid this BinaryOp drives, if any."""
        if self._monoid is None:
            # back-links are installed by monoid registration; force the lazy
            # builtin-monoid namespace
            import graphblas_tpu_torch.monoid  # noqa: F401
        return self._monoid

    @property
    def commutes_to(self):
        if self._commutes_to_name is None:
            return None
        import graphblas_tpu_torch.binary as binmod

        return getattr(binmod, self._commutes_to_name, None)

    def __call__(self, left, right=None, *, left_default=None, right_default=None):
        return _b._call_op(self, left, right, left_default=left_default, right_default=right_default)

    @classmethod
    def register_anonymous(cls, func, name=None, *, parameterized=False, is_udt=False):
        if parameterized:
            return ParameterizedUdf(name or "binary.anonymous", func, True, cls.register_anonymous)
        op = cls(name or getattr(func, "__name__", "binary.anonymous"), anonymous=True)
        op.orig_func = func
        _build_from_func(op, func)
        return op

    @classmethod
    def register_new(cls, name, func, *, parameterized=False, is_udt=False, lazy=False):
        import graphblas_tpu_torch.binary as binary_module

        if parameterized:
            op = ParameterizedUdf(name, func, False, cls.register_anonymous)
        else:
            op = cls(name.rsplit(".", 1)[-1], anonymous=False)
            op.orig_func = func
            _build_from_func(op, func)
        _dotted_set(binary_module, name, op)
        return op

    def _compile_dtype(self, dtype):
        if self.orig_func is None:
            return None
        if dtype in self._udt_cache:
            return self._udt_cache[dtype]
        ret = _b._output_dtype_of(self.orig_func, dtype, dtype)
        typed = TypedBinaryOp(self, self.name, dtype, ret, _b.udf_fn(self.orig_func, ret, [dtype, dtype]))
        self._udt_cache[dtype] = typed
        self.types[dtype] = ret
        self._typed_ops[dtype] = typed
        return typed


def _build_from_func(op, func, domains=ALL):
    for dtype in domains:
        try:
            ret = _b._output_dtype_of(func, dtype, dtype)
        except Exception:
            continue
        op._add(TypedBinaryOp(op, op.name, dtype, ret, _b.udf_fn(func, ret, [dtype, dtype])))
    return op


class PositionalBinaryOp(BinaryOp):
    """firsti/firstj/secondi/secondj[1]: value-ignoring index producers.

    In an eWise/apply context, "first" and "second" refer to the same (i, j);
    in an mxm context a(i,k)*b(k,j): firsti->i, firstj->k, secondi->k,
    secondj->j.
    """

    def __init__(self, name):
        super().__init__(name)
        which = name.rstrip("1")
        offset = 1 if name.endswith("1") else 0
        self.positional = (which, offset)
        for dtype in (_dt.INT32, _dt.INT64):
            self._add(TypedBinaryOp(self, name, dtype, dtype, None))
        self.coercions.update(dict.fromkeys([d for d in ALL if d not in (_dt.INT32, _dt.INT64)], _dt.INT64))


_COMMUTES = {
    "plus": "plus",
    "times": "times",
    "any": "any",
    "pair": "pair",
    "oneb": "oneb",
    "min": "min",
    "max": "max",
    "first": "second",
    "second": "first",
    "minus": "rminus",
    "rminus": "minus",
    "div": "rdiv",
    "rdiv": "div",
    "cdiv": "rdiv",
    "truediv": "rtruediv",
    "rtruediv": "truediv",
    "floordiv": "rfloordiv",
    "rfloordiv": "floordiv",
    "pow": "rpow",
    "rpow": "pow",
    "gt": "lt",
    "lt": "gt",
    "ge": "le",
    "le": "ge",
    "eq": "eq",
    "ne": "ne",
    "iseq": "iseq",
    "isne": "isne",
    "isgt": "islt",
    "islt": "isgt",
    "isge": "isle",
    "isle": "isge",
    "land": "land",
    "lor": "lor",
    "lxor": "lxor",
    "lxnor": "lxnor",
    "bor": "bor",
    "band": "band",
    "bxor": "bxor",
    "bxnor": "bxnor",
    "hypot": "hypot",
    "absfirst": "abssecond",
    "abssecond": "absfirst",
    "firsti": "secondi",
    "firsti1": "secondi1",
    "firstj": "secondj",
    "firstj1": "secondj1",
    "secondi": "firsti",
    "secondi1": "firsti1",
    "secondj": "firstj",
    "secondj1": "firstj1",
}

_SAFE_FILL = frozenset("div cdiv rdiv truediv rtruediv floordiv rfloordiv fmod remainder pow rpow binom".split())

_FP_COERCIBLE = frozenset("atan2 hypot fmod remainder ldexp copysign truediv rtruediv".split())


def ldexp(x, e):
    """jnp.ldexp(x, e) for an int32 exponent, JAX's recipe: split off x's
    exponent so that neither factor overflows early (exponents add in x's
    float type, as there)."""
    m, ex = torch.frexp(x)
    ex = ex.to(x.dtype) + e.to(x.dtype)
    m = torch.where(ex > 0, m * 2, m)
    ex = torch.where(ex > 0, ex - 1, ex)
    y = m * torch.pow(_m.const(x, 2.0), ex)
    return torch.where(torch.isinf(x) | (x == 0), x, y)


def _specs():
    def truthy(x):
        return x != 0

    # --- arithmetic with SuiteSparse BOOL identities -------------------------
    def plus(dt):
        if dt._is_bool:
            return lambda x, y: x | y
        return lambda x, y: _dt.wrap(x + y, dt)

    def minus(dt):
        if dt._is_bool:
            return lambda x, y: x ^ y
        return lambda x, y: _dt.wrap(x - y, dt)

    def rminus(dt):
        if dt._is_bool:
            return lambda x, y: x ^ y
        return lambda x, y: _dt.wrap(y - x, dt)

    def times(dt):
        if dt._is_bool:
            return lambda x, y: x & y
        return lambda x, y: _dt.wrap(x * y, dt)

    def cdiv(dt):
        if dt._is_bool:
            return lambda x, y: x  # DIV_BOOL = FIRST
        if dt._is_int:
            div = _m.idiv(dt)
            return lambda x, y: torch.where(y == 0, torch.zeros_like(x), div(x, y))
        return lambda x, y: x / y

    def rdiv(dt):
        inner = cdiv(dt)
        if dt._is_bool:
            return lambda x, y: y
        return lambda x, y: inner(y, x)

    def truediv(dt):
        return lambda x, y: x / y

    def rtruediv(dt):
        return lambda x, y: y / x

    def floordiv(dt):
        if dt._is_int:
            div = _m.idiv(dt)
            if dt._is_unsigned_int:
                fdiv = div
            else:
                rem = _m.irem(dt)

                def fdiv(x, y):
                    q = div(x, y)
                    sel = (torch.sign(x) != torch.sign(y)) & (rem(x, y) != 0)
                    return torch.where(sel, q - 1, q)

            return lambda x, y: torch.where(y == 0, torch.zeros_like(x), fdiv(x, torch.where(y == 0, _m.const(y, 1), y)))
        return _m.float_divmod

    def rfloordiv(dt):
        inner = floordiv(dt)
        return lambda x, y: inner(y, x)

    def pow_(dt):
        if dt._is_bool:
            return lambda x, y: x | ~y
        if dt._is_int:
            return _m.ipow(dt)
        return torch.pow

    def rpow(dt):
        inner = pow_(dt)
        return lambda x, y: inner(y, x)

    def min_(dt):
        if dt._is_bool:
            return lambda x, y: x & y
        return _m.minimum(dt)

    def max_(dt):
        if dt._is_bool:
            return lambda x, y: x | y
        return _m.maximum(dt)

    def binom(dt):
        # binomial coefficient C(x, y), in float64 through lgamma
        def f(x, y):
            xf = _dt.cast(x, dt, _dt.FP64)
            yf = _dt.cast(y, dt, _dt.FP64)
            lg = torch.special.gammaln
            res = torch.exp(lg(xf + 1) - lg(yf + 1) - lg(xf - yf + 1))
            res = torch.where((yf < 0) | (yf > xf), _m.const(res, 0.0), res)
            return _dt.cast(torch.round(res), _dt.FP64, dt)

        return f

    def absf(dt, which):
        a = _m.iabs(dt)
        return (lambda x, y: a(x)) if which == 0 else (lambda x, y: a(y))

    # --- logical over all numeric (nonzero = true, result same dtype) -------
    def L(op):
        def factory(dt):
            if dt._is_bool:
                return {
                    "land": lambda x, y: x & y,
                    "lor": lambda x, y: x | y,
                    "lxor": lambda x, y: x ^ y,
                    "lxnor": lambda x, y: x == y,
                }[op]
            return {
                "land": lambda x, y: (truthy(x) & truthy(y)).to(x.dtype),
                "lor": lambda x, y: (truthy(x) | truthy(y)).to(x.dtype),
                "lxor": lambda x, y: (truthy(x) ^ truthy(y)).to(x.dtype),
                "lxnor": lambda x, y: (truthy(x) == truthy(y)).to(x.dtype),
            }[op]

        return factory

    # --- comparisons (is*: same dtype, else BOOL) ---------------------------
    def cmp(name):
        def factory(dt):
            if name in ("eq", "ne"):
                f = (lambda x, y: x == y) if name == "eq" else (lambda x, y: x != y)
            else:
                f = _m.compare(name, dt)
            return f

        return factory

    def IS(op):
        def factory(dt):
            f = cmp(op[2:])(dt)
            return lambda x, y: f(x, y).to(x.dtype)

        return factory

    # --- bitwise --------------------------------------------------------------
    def shift_amount(y, dt):
        return _dt.cast(y, dt, _dt.INT64)

    def bget(dt):
        n = dt._bits

        def f(x, y):
            k = shift_amount(y, dt)
            ok = (k >= 1) & (k <= n)
            kk = torch.clamp(k - 1, 0, n - 1).to(x.dtype)
            return torch.where(ok, (x >> kk) & _m.const(x, 1), torch.zeros_like(x))

        return f

    def bset(dt):
        n = dt._bits

        def f(x, y):
            k = shift_amount(y, dt)
            ok = (k >= 1) & (k <= n)
            kk = torch.clamp(k - 1, 0, n - 1).to(x.dtype)
            return torch.where(ok, _dt.wrap(x | (torch.ones_like(x) << kk), dt), x)

        return f

    def bclr(dt):
        n = dt._bits

        def f(x, y):
            k = shift_amount(y, dt)
            ok = (k >= 1) & (k <= n)
            kk = torch.clamp(k - 1, 0, n - 1).to(x.dtype)
            return torch.where(ok, x & ~(torch.ones_like(x) << kk), x)

        return f

    def bshift(dt):
        n = dt._bits
        signed = dt._is_signed_int
        logical = dt.np_type == np.uint64

        def f(x, y):
            k = shift_amount(y, dt)
            kl = torch.clamp(k, 0, n - 1).to(x.dtype)
            kr = torch.clamp(-k, 0, n - 1)
            left = torch.where(k >= n, torch.zeros_like(x), _dt.wrap(x << kl, dt))
            if logical:
                rshifted = torch.where(kr > 0, (x >> kr) & ((torch.ones_like(x) << (64 - kr)) - 1), x)
            else:
                rshifted = x >> kr.to(x.dtype)
            if signed:
                fill = torch.where(x < 0, _m.const(x, -1), _m.const(x, 0))
            else:
                fill = torch.zeros_like(x)
            right = torch.where(-k >= n, fill, rshifted)
            return torch.where(k >= 0, left, right)

        return f

    # --- float math -----------------------------------------------------------
    def remainder(dt):
        # C remainder(): x - round(x/y)*y with round-half-even
        return lambda x, y: x - torch.round(x / y) * y

    def cmplx_ret(dt):
        return _dt.FC32 if dt is _dt.FP32 else _dt.FC64

    def cmplx(dt):
        # x + 1j * y as the reference computes it: (0 + 1j)(y + 0j) added to x
        return lambda x, y: torch.complex(x + (0.0 * y - 0.0), 0.0 + (0.0 + y))

    specs = [
        # (name, domains, ret_rule, fn_factory)
        ("first", ALL, "same", lambda dt: (lambda x, y: x)),
        ("second", ALL, "same", lambda dt: (lambda x, y: y)),
        ("any", ALL, "same", lambda dt: (lambda x, y: x)),
        ("pair", ALL, "same", lambda dt: (lambda x, y: torch.ones_like(x))),
        ("oneb", ALL, "same", lambda dt: (lambda x, y: torch.ones_like(x))),
        ("plus", ALL, "same", plus),
        ("minus", ALL, "same", minus),
        ("rminus", ALL, "same", rminus),
        ("times", ALL, "same", times),
        ("cdiv", ALL, "same", cdiv),
        ("rdiv", ALL, "same", rdiv),
        ("truediv", FPS + FCS, "same", truediv),
        ("rtruediv", FPS + FCS, "same", rtruediv),
        ("floordiv", NUMS, "same", floordiv),
        ("rfloordiv", NUMS, "same", rfloordiv),
        ("pow", ALL, "same", pow_),
        ("rpow", ALL, "same", rpow),
        ("min", BOOLS + NUMS, "same", min_),
        ("max", BOOLS + NUMS, "same", max_),
        ("binom", INTS, "same", binom),
        ("absfirst", BOOLS + NUMS, "same", lambda dt: absf(dt, 0)),
        ("abssecond", BOOLS + NUMS, "same", lambda dt: absf(dt, 1)),
        ("land", BOOLS + NUMS, "same", L("land")),
        ("lor", BOOLS + NUMS, "same", L("lor")),
        ("lxor", BOOLS + NUMS, "same", L("lxor")),
        ("lxnor", BOOLS + NUMS, "same", L("lxnor")),
        ("iseq", BOOLS + NUMS, "same", IS("iseq")),
        ("isne", BOOLS + NUMS, "same", IS("isne")),
        ("isgt", BOOLS + NUMS, "same", IS("isgt")),
        ("islt", BOOLS + NUMS, "same", IS("islt")),
        ("isge", BOOLS + NUMS, "same", IS("isge")),
        ("isle", BOOLS + NUMS, "same", IS("isle")),
        ("eq", ALL, lambda dt: _dt.BOOL, cmp("eq")),
        ("ne", ALL, lambda dt: _dt.BOOL, cmp("ne")),
        ("gt", BOOLS + NUMS, lambda dt: _dt.BOOL, cmp("gt")),
        ("lt", BOOLS + NUMS, lambda dt: _dt.BOOL, cmp("lt")),
        ("ge", BOOLS + NUMS, lambda dt: _dt.BOOL, cmp("ge")),
        ("le", BOOLS + NUMS, lambda dt: _dt.BOOL, cmp("le")),
        ("bor", INTS, "same", lambda dt: (lambda x, y: x | y)),
        ("band", INTS, "same", lambda dt: (lambda x, y: x & y)),
        ("bxor", INTS, "same", lambda dt: (lambda x, y: x ^ y)),
        ("bxnor", INTS, "same", lambda dt: (lambda x, y: _dt.wrap(~(x ^ y), dt))),
        ("bget", INTS, "same", bget),
        ("bset", INTS, "same", bset),
        ("bclr", INTS, "same", bclr),
        ("bshift", INTS, "same", bshift),
        ("atan2", FPS, "same", lambda dt: torch.atan2),
        ("hypot", FPS, "same", lambda dt: torch.hypot),
        ("fmod", FPS, "same", lambda dt: _m.fmod),
        ("remainder", FPS, "same", remainder),
        ("ldexp", FPS, "same", lambda dt: (lambda x, y: ldexp(x, _dt.cast(y, dt, _dt.INT32)))),
        ("copysign", FPS, "same", lambda dt: torch.copysign),
        ("cmplx", FPS, cmplx_ret, cmplx),
    ]
    return specs


def _isclose(rel_tol=1e-7, abs_tol=0.0):
    """Parameterized isclose."""

    def inner(x, y):
        return (x - y).abs() <= torch.clamp(rel_tol * torch.maximum(x.abs(), y.abs()), min=abs_tol)

    return inner


_POSITIONAL_BINARY = [
    "firsti",
    "firsti1",
    "firstj",
    "firstj1",
    "secondi",
    "secondi1",
    "secondj",
    "secondj1",
]


def _initialize(module):
    ops = {}
    for name, domains, ret_rule, fn_factory in _specs():
        op = BinaryOp(name)
        for dtype in domains:
            if ret_rule == "same":
                ret = dtype
            elif callable(ret_rule):
                ret = ret_rule(dtype)
            else:
                ret = ret_rule
            op._add(TypedBinaryOp(op, name, dtype, ret, fn_factory(dtype)))
        if name in _FP_COERCIBLE:
            for dtype in BOOLS + INTS:
                if dtype not in op.types:
                    op.coercions[dtype] = _dt.FP64
        op._commutes_to_name = _COMMUTES.get(name)
        op._needs_safe_fill = name in _SAFE_FILL
        ops[name] = op
    # `div` is C-style truncated division, aliased as the reference renames
    # *_div -> *_cdiv
    ops["div"] = ops["cdiv"]
    for name in _POSITIONAL_BINARY:
        ops[name] = PositionalBinaryOp(name)
    ops["isclose"] = ParameterizedUdf("isclose", _isclose, False, BinaryOp.register_anonymous)
    for name, op in ops.items():
        setattr(module, name, op)
    module._ops = ops
    return ops

"""UnaryOp: typed elementwise functions of one value.

Counterpart of ``graphblas_tpu/core/operator/unary.py``: the same builtin
table (names, domains, return types, coercions), its functions written in
torch on the carriers of ``core.dtypes``.  ``jax.scipy.special`` becomes
``torch.special``; ``cbrt`` and ``tgamma``, which torch lacks, are composed
from torch ops.
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
    TypedUnaryOp,
)


class UnaryOp(OpBase):
    _typed_class = TypedUnaryOp
    _modname = "unary"
    _nargs = 1
    positional = None

    def __call__(self, val):
        return _b._call_op(self, val)

    @classmethod
    def register_anonymous(cls, func, name=None, *, parameterized=False, is_udt=False):
        """Register a unary op from a Python function of tensors without
        installing it into the ``unary`` namespace."""
        if parameterized:
            return ParameterizedUdf(name or "unary.anonymous", func, True, cls.register_anonymous)
        op = cls(name or getattr(func, "__name__", "unary.anonymous"), anonymous=True)
        op.orig_func = func
        _build_from_func(op, func)
        return op

    @classmethod
    def register_new(cls, name, func, *, parameterized=False, is_udt=False, lazy=False):
        """Register a unary op and install it as ``graphblas_tpu_torch.unary.<name>``."""
        import graphblas_tpu_torch.unary as unary_module

        if parameterized:
            op = ParameterizedUdf(name, func, False, cls.register_anonymous)
        else:
            op = cls(name.rsplit(".", 1)[-1], anonymous=False)
            op.orig_func = func
            _build_from_func(op, func)
            op._modname = "unary"
        _dotted_set(unary_module, name, op)
        return op


def _dotted_set(module, name, value):
    """Install ``value`` at a possibly dotted path under ``module``
    (e.g. register_new("x.y.plus_one"))."""
    import types

    parts = name.split(".")
    target = module
    for part in parts[:-1]:
        nxt = getattr(target, part, None)
        if nxt is None:
            nxt = types.SimpleNamespace()
            setattr(target, part, nxt)
        target = nxt
    # use __dict__ (not hasattr) so lazy module __getattr__ hooks don't
    # fabricate a conflicting attribute during the check
    existing = getattr(target, "__dict__", {}).get(parts[-1])
    if existing is not None and not isinstance(existing, types.SimpleNamespace):
        raise AttributeError(f"{name} is already defined")
    setattr(target, parts[-1], value)


def _build_from_func(op, func, domains=ALL):
    """Specialize ``func`` for each builtin dtype it evaluates on."""
    for dtype in domains:
        try:
            ret = _b._output_dtype_of(func, dtype)
        except Exception:
            continue
        op._add(TypedUnaryOp(op, op.name, dtype, ret, _b.udf_fn(func, ret, [dtype])))
    return op


# ---------------------------------------------------------------------------
# Builtin table.  Each entry: (name, domains, ret_rule, fn_factory)
#   ret_rule: "same" | DataType | callable(dtype)->DataType
#   fn_factory: callable(dtype) -> torch function on dtype's carrier
# Float-domain ops get coercions BOOL/INT -> FP64.
# ---------------------------------------------------------------------------


def _cbrt(x):
    """Real cube root: a pow estimate refined by one Newton step."""
    a = x.abs()
    r = a.pow(1.0 / 3.0)
    r = torch.where((r > 0) & torch.isfinite(r), r - (r * r * r - a) / (3 * r * r), r)
    return torch.copysign(r, x)


def _asinh(x):
    """asinh; for complex x a -0.0 real part reads as +0.0 on the branch cut,
    as XLA's does."""
    if x.is_complex():
        x = torch.complex(x.real + 0.0, x.imag)
    return torch.arcsinh(x)


def _gamma(x):
    """jax.scipy.special.gamma: sign * exp(gammaln(x)); +-inf at +-0, NaN at
    the negative integers and -inf."""
    odd = torch.fmod(torch.floor(x), 2) != 0
    sign = torch.where((x < 0) & odd, _m.const(x, -1), _m.const(x, 1))
    g = sign * torch.exp(torch.lgamma(x))
    g = torch.where((x < 0) & (x == torch.floor(x)), _m.const(x, np.nan), g)
    return torch.where(x == 0, torch.copysign(_m.const(x, np.inf), x), g)


def _specs():
    def const(fn):
        return lambda dtype: fn

    def identity_fn(dtype):
        return lambda x: x

    def ainv(dtype):
        if dtype._is_bool:
            return lambda x: x  # SuiteSparse: AINV_BOOL is identity
        return lambda x: _dt.wrap(-x, dtype)

    def minv(dtype):
        if dtype._is_bool:
            return lambda x: x  # MINV_BOOL is identity
        if dtype._is_int:
            div = _m.idiv(dtype)
            return lambda x: div(torch.ones_like(x), x)
        return lambda x: 1 / x

    def one_fn(dtype):
        return lambda x: torch.ones_like(x)

    def abs_fn(dtype):
        return _m.iabs(dtype)

    def lnot(dtype):
        if dtype._is_bool:
            return lambda x: ~x
        return lambda x: (x == 0).to(x.dtype)

    def bnot(dtype):
        return lambda x: _dt.wrap(~x, dtype)

    def signum(dtype):
        return _m.fsign if dtype._is_float else _m.isign(dtype)

    def c_round(dtype):
        # C round(): half away from zero (differs from numpy banker's rounding)
        return lambda x: _m.fsign(x) * torch.floor(x.abs() + 0.5)

    def frexpx(dtype):
        return lambda x: torch.frexp(x)[0]

    def frexpe(dtype):
        return lambda x: torch.frexp(x)[1].to(x.dtype)

    FP_RULE = "same"

    specs = [
        ("identity", ALL, "same", identity_fn),
        ("ainv", ALL, "same", ainv),
        ("minv", ALL, "same", minv),
        ("one", ALL, "same", one_fn),
        ("abs", ALL, lambda dt: {_dt.FC32: _dt.FP32, _dt.FC64: _dt.FP64}.get(dt, dt), abs_fn),
        ("lnot", BOOLS + NUMS, "same", lnot),
        ("bnot", INTS, "same", bnot),
        ("signum", NUMS, "same", signum),
    ]

    # float (and complex where meaningful) math ops
    def F(name, fn, domains=FPS + FCS, ret=FP_RULE):
        specs.append((name, domains, ret, const(fn)))

    F("sqrt", torch.sqrt)
    F("log", torch.log)
    F("exp", torch.exp)
    F("log2", torch.log2)
    F("sin", torch.sin)
    F("cos", torch.cos)
    F("tan", torch.tan)
    F("acos", torch.arccos)
    F("asin", torch.arcsin)
    F("atan", torch.arctan)
    F("sinh", torch.sinh)
    F("cosh", torch.cosh)
    F("tanh", torch.tanh)
    F("acosh", torch.arccosh)
    F("asinh", _asinh)
    F("atanh", torch.arctanh)
    F("ceil", torch.ceil, FPS)
    F("floor", torch.floor, FPS)
    F("trunc", torch.trunc, FPS)
    F("exp2", torch.exp2)
    F("expm1", torch.expm1)
    F("log10", torch.log10)
    F("log1p", torch.log1p)
    F("lgamma", torch.special.gammaln, FPS)
    F("erf", torch.special.erf, FPS)
    F("erfc", torch.special.erfc, FPS)
    F("cbrt", _cbrt, FPS)
    specs.append(("tgamma", FPS, "same", const(_gamma)))
    specs.append(("round", FPS, "same", c_round))
    specs.append(("frexpx", FPS, "same", frexpx))
    specs.append(("frexpe", FPS, "same", frexpe))

    # complex ops
    specs.append(("conj", FCS, "same", const(lambda x: torch.conj_physical(x))))
    cplx_ret = lambda dt: _dt.FP32 if dt is _dt.FC32 else _dt.FP64  # noqa: E731
    specs.append(("creal", FCS, cplx_ret, const(lambda x: x.real.contiguous())))
    specs.append(("cimag", FCS, cplx_ret, const(lambda x: x.imag.contiguous())))
    specs.append(("carg", FCS, cplx_ret, const(torch.angle)))

    # classification -> BOOL
    specs.append(("isinf", FPS + FCS, lambda dt: _dt.BOOL, const(torch.isinf)))
    specs.append(("isnan", FPS + FCS, lambda dt: _dt.BOOL, const(torch.isnan)))
    specs.append(("isfinite", FPS + FCS, lambda dt: _dt.BOOL, const(torch.isfinite)))
    return specs


_FP_COERCIBLE = frozenset(
    "sqrt log exp log2 sin cos tan acos asin atan sinh cosh tanh acosh asinh atanh "
    "exp2 expm1 log10 log1p lgamma tgamma erf erfc cbrt ceil floor round trunc "
    "frexpx frexpe isinf isnan isfinite".split()
)

_POSITIONAL_UNARY = {
    # name -> (which index, offset); used by apply() with index injection
    "positioni": ("i", 0),
    "positioni1": ("i", 1),
    "positionj": ("j", 0),
    "positionj1": ("j", 1),
}


class PositionalUnaryOp(UnaryOp):
    def __init__(self, name, which, offset):
        super().__init__(name)
        self.positional = (which, offset)
        for dtype in (_dt.INT32, _dt.INT64):
            self._add(TypedUnaryOp(self, name, dtype, dtype, None))
        self.coercions.update(dict.fromkeys([d for d in ALL if d not in (_dt.INT32, _dt.INT64)], _dt.INT64))


def _initialize(module):
    """Populate the ``graphblas_tpu_torch.unary`` namespace with builtins."""
    ops = {}
    for name, domains, ret_rule, fn_factory in _specs():
        op = UnaryOp(name)
        for dtype in domains:
            if ret_rule == "same":
                ret = dtype
            elif callable(ret_rule):
                ret = ret_rule(dtype)
            else:
                ret = ret_rule
            op._add(TypedUnaryOp(op, name, dtype, ret, fn_factory(dtype)))
        if name in _FP_COERCIBLE:
            # ints/bool compute in FP64
            for dtype in BOOLS + INTS:
                if dtype not in op.types:
                    op.coercions[dtype] = _dt.FP64
        ops[name] = op
    for name, (which, offset) in _POSITIONAL_UNARY.items():
        ops[name] = PositionalUnaryOp(name, which, offset)
    for name, op in ops.items():
        setattr(module, name, op)
    module._ops = ops
    return ops

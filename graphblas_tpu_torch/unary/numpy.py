"""``graphblas_tpu_torch.unary.numpy``: numpy-ufunc-named unary operators.

Counterpart of the JAX package's module (python-graphblas: graphblas/unary/numpy.py) — registers numba UDFs
named after numpy ufuncs, aliased to builtins when the ``mapnumpy`` config is
on.  Here they are the torch functions of ``core.operator.numpyops``.
"""

import sys

from ..core.operator.unary import UnaryOp

_delayed = {}

_UFUNC_NAMES = [
    "abs",
    "absolute",
    "arccos",
    "arccosh",
    "arcsin",
    "arcsinh",
    "arctan",
    "arctanh",
    "cbrt",
    "ceil",
    "conjugate",
    "cos",
    "cosh",
    "deg2rad",
    "degrees",
    "exp",
    "exp2",
    "expm1",
    "fabs",
    "floor",
    "invert",
    "isfinite",
    "isinf",
    "isnan",
    "log",
    "log10",
    "log1p",
    "log2",
    "logical_not",
    "negative",
    "positive",
    "rad2deg",
    "radians",
    "reciprocal",
    "rint",
    "sign",
    "signbit",
    "sin",
    "sinh",
    "spacing",
    "sqrt",
    "square",
    "tan",
    "tanh",
    "trunc",
]

# numpy name -> builtin graphblas name when mapnumpy is on
# (reference: unary/numpy.py:1-80)
_MAPNUMPY = {
    "abs": "abs",
    "absolute": "abs",
    "arccos": "acos",
    "arccosh": "acosh",
    "arcsin": "asin",
    "arcsinh": "asinh",
    "arctan": "atan",
    "arctanh": "atanh",
    "cbrt": "cbrt",
    "ceil": "ceil",
    "conjugate": "conj",
    "cos": "cos",
    "cosh": "cosh",
    "exp": "exp",
    "exp2": "exp2",
    "expm1": "expm1",
    "floor": "floor",
    "invert": "bnot",
    "isfinite": "isfinite",
    "isinf": "isinf",
    "isnan": "isnan",
    "log": "log",
    "log10": "log10",
    "log1p": "log1p",
    "log2": "log2",
    "logical_not": "lnot",
    "negative": "ainv",
    "sign": "signum",
    "sin": "sin",
    "sinh": "sinh",
    "sqrt": "sqrt",
    "tan": "tan",
    "tanh": "tanh",
    "trunc": "trunc",
}

_this = sys.modules[__name__]


def _build(name):
    import graphblas_tpu_torch

    if graphblas_tpu_torch.config.get("mapnumpy") and name in _MAPNUMPY:
        import graphblas_tpu_torch.unary as unary

        return getattr(unary, _MAPNUMPY[name])
    from ..core.operator import numpyops

    if name not in numpyops.UNARY:
        raise AttributeError(name)
    op = numpyops.build_unary(UnaryOp(f"numpy.{name}", anonymous=True))
    op._modname = "unary.numpy"
    return op


def __getattr__(name):
    if name in _UFUNC_NAMES:
        op = _build(name)
        setattr(_this, name, op)
        return op
    raise AttributeError(f"module 'graphblas_tpu_torch.unary.numpy' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_UFUNC_NAMES))

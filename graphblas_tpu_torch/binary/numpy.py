"""``graphblas_tpu_torch.binary.numpy``: numpy-ufunc-named binary operators.

Counterpart of the JAX package's module (python-graphblas: graphblas/binary/numpy.py).
"""

import sys

from ..core.operator.binary import BinaryOp

_UFUNC_NAMES = [
    "add",
    "arctan2",
    "bitwise_and",
    "bitwise_or",
    "bitwise_xor",
    "copysign",
    "divide",
    "equal",
    "float_power",
    "floor_divide",
    "fmax",
    "fmin",
    "fmod",
    "gcd",
    "greater",
    "greater_equal",
    "heaviside",
    "hypot",
    "lcm",
    "ldexp",
    "left_shift",
    "less",
    "less_equal",
    "logaddexp",
    "logaddexp2",
    "logical_and",
    "logical_or",
    "logical_xor",
    "maximum",
    "minimum",
    "mod",
    "multiply",
    "nextafter",
    "not_equal",
    "power",
    "remainder",
    "right_shift",
    "subtract",
    "true_divide",
]

_MAPNUMPY = {
    "add": "plus",
    "arctan2": "atan2",
    "bitwise_and": "band",
    "bitwise_or": "bor",
    "bitwise_xor": "bxor",
    "copysign": "copysign",
    "divide": "truediv",
    "equal": "eq",
    "floor_divide": "floordiv",
    "fmax": "max",
    "fmin": "min",
    "fmod": "fmod",
    "greater": "gt",
    "greater_equal": "ge",
    "hypot": "hypot",
    "ldexp": "ldexp",
    "less": "lt",
    "less_equal": "le",
    "logical_and": "land",
    "logical_or": "lor",
    "logical_xor": "lxor",
    "maximum": "max",
    "minimum": "min",
    "multiply": "times",
    "not_equal": "ne",
    "power": "pow",
    "subtract": "minus",
    "true_divide": "truediv",
}

_this = sys.modules[__name__]


def _build(name):
    import graphblas_tpu_torch

    if graphblas_tpu_torch.config.get("mapnumpy") and name in _MAPNUMPY:
        import graphblas_tpu_torch.binary as binary

        return getattr(binary, _MAPNUMPY[name])
    from ..core.operator import numpyops

    if name not in numpyops.BINARY:
        raise AttributeError(name)
    op = numpyops.build_binary(BinaryOp(f"numpy.{name}", anonymous=True))
    op._modname = "binary.numpy"
    return op


def __getattr__(name):
    if name in _UFUNC_NAMES:
        op = _build(name)
        setattr(_this, name, op)
        return op
    raise AttributeError(f"module 'graphblas_tpu_torch.binary.numpy' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_UFUNC_NAMES))

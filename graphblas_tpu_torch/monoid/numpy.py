"""``graphblas_tpu_torch.monoid.numpy``: numpy-ufunc-named monoids.

Counterpart of the JAX package's module (python-graphblas: graphblas/monoid/numpy.py) (identity table :27-120,
mapnumpy aliasing :138-151, idempotent set :155-164).  Each monoid is built
from the matching ``binary.numpy`` UDF plus the identity below; when the
``mapnumpy`` config is on and a builtin equivalent exists, the builtin monoid
is aliased instead (exactly the reference's behavior).
"""

import sys

import numpy as _np

_FLOATS = ("FP32", "FP64")
_INTS = ("INT8", "UINT8", "INT16", "UINT16", "INT32", "UINT32", "INT64", "UINT64")
_BOOL_INTS = ("BOOL",) + _INTS
_SIGNED_MINS = {
    "INT8": _np.iinfo(_np.int8).min,
    "INT16": _np.iinfo(_np.int16).min,
    "INT32": _np.iinfo(_np.int32).min,
    "INT64": _np.iinfo(_np.int64).min,
}
_UNSIGNED_MAXS = {
    "UINT8": _np.iinfo(_np.uint8).max,
    "UINT16": _np.iinfo(_np.uint16).max,
    "UINT32": _np.iinfo(_np.uint32).max,
    "UINT64": _np.iinfo(_np.uint64).max,
}
_INT_MINS = {**_SIGNED_MINS, **dict.fromkeys(_UNSIGNED_MAXS, 0)}
_INT_MAXS = {
    **{k: -v - 1 for k, v in _SIGNED_MINS.items()},
    **_UNSIGNED_MAXS,
}

# numpy monoid name -> identity (scalar = every dtype; dict = restricted
# domain, keyed by dtype name).  Mirrors reference monoid/numpy.py:27-120
# (fmax/fmin get the full int domain unconditionally here: there is no
# numba-0.56 bug to work around in a jnp-traced UDF).
_monoid_identities = {
    "add": 0,
    "multiply": 1,
    "logaddexp": dict.fromkeys(_FLOATS, -_np.inf),
    "logaddexp2": dict.fromkeys(_FLOATS, -_np.inf),
    "gcd": dict.fromkeys(_INTS, 0),
    "hypot": dict.fromkeys(_FLOATS, 0.0),
    # all-ones identity: -1 for signed, dtype max for unsigned (numpy 2
    # rejects out-of-range python ints at the declared dtype)
    "bitwise_and": {
        "BOOL": True,
        **{d: -1 for d in _INTS if not d.startswith("U")},
        **_UNSIGNED_MAXS,
    },
    "bitwise_or": dict.fromkeys(_BOOL_INTS, 0),
    "bitwise_xor": dict.fromkeys(_BOOL_INTS, 0),
    "equal": {"BOOL": True},
    "logical_and": {"BOOL": True},
    "logical_or": {"BOOL": False},
    "logical_xor": {"BOOL": False},
    "maximum": {"BOOL": False, **_INT_MINS, **dict.fromkeys(_FLOATS, -_np.inf)},
    "minimum": {"BOOL": True, **_INT_MAXS, **dict.fromkeys(_FLOATS, _np.inf)},
    "fmax": {"BOOL": False, **_INT_MINS, **dict.fromkeys(_FLOATS, -_np.inf)},
    "fmin": {"BOOL": True, **_INT_MAXS, **dict.fromkeys(_FLOATS, _np.inf)},
}

# numpy name -> builtin monoid when mapnumpy is on (reference :138-151)
_MAPNUMPY = {
    "add": "plus",
    "bitwise_and": "band",
    "bitwise_or": "bor",
    "bitwise_xor": "bxor",
    "equal": "eq",
    "fmax": "max",  # ignores nan
    "fmin": "min",  # ignores nan
    "logical_and": "land",
    "logical_or": "lor",
    "logical_xor": "lxor",
    "multiply": "times",
}

# monoid(x, x) == x (reference :155-164)
_idempotent = {
    "bitwise_and",
    "bitwise_or",
    "fmax",
    "fmin",
    "gcd",
    "logical_and",
    "logical_or",
    "maximum",
    "minimum",
}

__all__ = sorted(_monoid_identities)

_this = sys.modules[__name__]


def _build(name):
    import graphblas_tpu_torch

    if graphblas_tpu_torch.config.get("mapnumpy") and name in _MAPNUMPY:
        import graphblas_tpu_torch.monoid as monoid

        return getattr(monoid, _MAPNUMPY[name])
    import graphblas_tpu_torch.binary as binary

    from ..core.operator.monoid import Monoid

    func = getattr(binary.numpy, name)
    op = Monoid.register_anonymous(
        func,
        _monoid_identities[name],
        f"numpy.{name}",
        is_idempotent=name in _idempotent,
    )
    op._anonymous = False
    op._modname = "monoid.numpy"
    return op


def __getattr__(name):
    if name in _monoid_identities:
        op = _build(name)
        setattr(_this, name, op)
        return op
    raise AttributeError(f"module 'graphblas_tpu_torch.monoid.numpy' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_monoid_identities))

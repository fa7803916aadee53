"""``graphblas_tpu_torch.semiring.numpy``: semirings composed from numpy monoids
and numpy binary ops.

Counterpart of the JAX package's module (python-graphblas: graphblas/semiring/numpy.py) (name product :21-26,
incompatible-domain exclusions :28-117, lazy composition :146-181).  Every
``<numpy monoid>_<numpy binaryop>`` name resolves lazily to
``get_semiring(monoid.numpy.<m>, binary.numpy.<b>)``.
"""

import itertools as _itertools
import sys

from ..binary.numpy import _UFUNC_NAMES as _binary_names
from ..monoid.numpy import _monoid_identities

_this = sys.modules[__name__]

_semiring_names = {
    f"{m}_{b}" for m, b in _itertools.product(_monoid_identities, _binary_names)
}

# Remove domain-incompatible combinations (reference semiring/numpy.py:28-117)
# <non-int monoid>_<int binary>
_semiring_names -= {
    f"{m}_{b}"
    for m, b in _itertools.product(
        {"equal", "hypot", "logaddexp", "logaddexp2"},
        {"gcd", "lcm", "left_shift", "right_shift"},
    )
}
# <non-float monoid>_<float binary>
_semiring_names -= {
    f"{m}_{b}"
    for m, b in _itertools.product(
        {"bitwise_and", "bitwise_or", "bitwise_xor", "equal", "gcd"},
        {
            "arctan2",
            "copysign",
            "divide",
            "float_power",
            "hypot",
            "ldexp",
            "logaddexp2",
            "logaddexp",
            "nextafter",
            "true_divide",
        },
    )
}
# <float monoid>_<non-float binary>
_semiring_names -= {
    f"{m}_{b}"
    for m, b in _itertools.product(
        {"hypot", "logaddexp", "logaddexp2"},
        {"bitwise_and", "bitwise_or", "bitwise_xor"},
    )
}
# <bool monoid>_<non-bool binary>
_semiring_names -= {
    f"{m}_{b}"
    for m, b in _itertools.product(
        {"equal"},
        {"floor_divide", "fmod", "mod", "power", "remainder", "subtract"},
    )
}
# <non-bool monoid>_<bool binary>
_semiring_names -= {
    f"{m}_{b}"
    for m, b in _itertools.product(
        {"gcd", "hypot", "logaddexp", "logaddexp2"},
        {"equal", "greater", "greater_equal", "less", "less_equal", "not_equal"},
    )
}

__all__ = sorted(_semiring_names)


def _split(name):
    """Split ``<monoid>_<binary>`` where both halves may contain underscores
    (reference semiring/numpy.py:168-175)."""
    words = name.split("_")
    for i in range(1, len(words)):
        m = "_".join(words[:i])
        if m not in _monoid_identities:
            continue
        b = "_".join(words[i:])
        if b in _binary_names:
            return m, b
    raise AttributeError(name)


def __getattr__(name):
    if name in _semiring_names:
        import graphblas_tpu_torch.binary as binary
        import graphblas_tpu_torch.monoid as monoid

        from ..core.operator.utils import get_semiring

        m, b = _split(name)
        sr = get_semiring(
            getattr(monoid.numpy, m), getattr(binary.numpy, b), name=f"numpy.{name}"
        )
        setattr(_this, name, sr)
        return sr
    raise AttributeError(f"module 'graphblas_tpu_torch.semiring.numpy' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _semiring_names)

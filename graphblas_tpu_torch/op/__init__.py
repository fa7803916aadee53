"""``graphblas_tpu_torch.op``: combined operator namespace.

Counterpart of the JAX package's namespace (python-graphblas:
graphblas/op/__init__.py): resolves any operator name by searching unary,
binary, monoid, semiring (binary shadows monoid for shared names like
``plus``).
"""

import sys

from ..core.operator.utils import op_from_string as from_string

_SEARCH_ORDER = ("unary", "binary", "monoid", "semiring", "indexunary", "select", "agg")


def __getattr__(name):
    import importlib

    for kind in _SEARCH_ORDER:
        module = importlib.import_module(f"graphblas_tpu_torch.{kind}")
        value = getattr(module, name, None)
        if value is not None:
            setattr(sys.modules[__name__], name, value)
            return value
    raise AttributeError(f"module 'graphblas_tpu_torch.op' has no attribute {name!r}")


def __dir__():
    import importlib

    names = set(globals())
    for kind in _SEARCH_ORDER:
        try:
            module = importlib.import_module(f"graphblas_tpu_torch.{kind}")
        except ImportError:
            continue
        names.update(getattr(module, "_ops", {}))
    return sorted(names)

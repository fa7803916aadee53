"""``graphblas_tpu_torch.unary``: builtin and user-registered unary operators.

Counterpart of the JAX package's namespace (python-graphblas: graphblas/unary/__init__.py).  Positional
ops (positioni, ...) live both here and under ``unary.tx`` (the reference
moved them to ``unary.ss``).
"""

import sys
import types

from ..core.operator import unary as _core
from ..core.operator.unary import UnaryOp
from ..core.operator.utils import unary_from_string as from_string

_this = sys.modules[__name__]
_core._initialize(_this)

register_new = UnaryOp.register_new
register_anonymous = UnaryOp.register_anonymous

# tx extension namespace (reference: graphblas/unary/ss.py)
tx = types.SimpleNamespace(
    positioni=_this.positioni,
    positioni1=_this.positioni1,
    positionj=_this.positionj,
    positionj1=_this.positionj1,
)
ss = tx


def __getattr__(name):
    if name == "numpy":
        import importlib

        module = importlib.import_module("graphblas_tpu_torch.unary.numpy")
        setattr(_this, "numpy", module)
        return module
    raise AttributeError(f"module 'graphblas_tpu_torch.unary' has no attribute {name!r}")

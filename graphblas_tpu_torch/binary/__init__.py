"""``graphblas_tpu_torch.binary``: builtin and user-registered binary operators.

Counterpart of the JAX package's namespace (python-graphblas: graphblas/binary/__init__.py).
"""

import sys
import types

from ..core.operator import binary as _core
from ..core.operator.binary import BinaryOp
from ..core.operator.utils import binary_from_string as from_string

_this = sys.modules[__name__]
_core._initialize(_this)

register_new = BinaryOp.register_new
register_anonymous = BinaryOp.register_anonymous

# tx extension namespace (reference moved positional + is* ops to binary.ss)
tx = types.SimpleNamespace(
    firsti=_this.firsti,
    firsti1=_this.firsti1,
    firstj=_this.firstj,
    firstj1=_this.firstj1,
    secondi=_this.secondi,
    secondi1=_this.secondi1,
    secondj=_this.secondj,
    secondj1=_this.secondj1,
)
ss = tx


def __getattr__(name):
    if name == "numpy":
        import importlib

        module = importlib.import_module("graphblas_tpu_torch.binary.numpy")
        setattr(_this, "numpy", module)
        return module
    raise AttributeError(f"module 'graphblas_tpu_torch.binary' has no attribute {name!r}")

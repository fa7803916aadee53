"""``graphblas_tpu_torch.semiring``: semirings.

Counterpart of the JAX package's namespace (python-graphblas: graphblas/semiring/__init__.py).  Any
``<monoid>_<binaryop>`` name resolves lazily (the reference pre-registers a
large regex-parsed list; the effective surface here is a superset).
"""

import sys
import types

import graphblas_tpu_torch.binary as _binary
import graphblas_tpu_torch.monoid as _monoid

from ..core.operator import semiring as _core
from ..core.operator.semiring import Semiring
from ..core.operator.utils import get_semiring, semiring_from_string as from_string

_this = sys.modules[__name__]
_core._initialize(_this, _monoid, _binary)

register_new = Semiring.register_new
register_anonymous = Semiring.register_anonymous

tx = types.SimpleNamespace()
ss = tx


def __getattr__(name):
    if "_" in name and not name.startswith("_"):
        add_name, mul_name = name.split("_", 1)
        monoid_op = getattr(_monoid, add_name, None)
        binop = getattr(_binary, mul_name, None)
        if monoid_op is not None and binop is not None:
            sr = get_semiring(monoid_op, binop, name=name)
            setattr(_this, name, sr)
            _this._ops[name] = sr
            return sr
    raise AttributeError(f"module 'graphblas_tpu_torch.semiring' has no attribute {name!r}")

"""``graphblas_tpu_torch.monoid``: builtin and user-registered monoids.

Counterpart of the JAX package's namespace (python-graphblas: graphblas/monoid/__init__.py).
"""

import sys
import types

import graphblas_tpu_torch.binary as _binary

from ..core.operator import monoid as _core
from ..core.operator.monoid import Monoid
from ..core.operator.utils import monoid_from_string as from_string

_this = sys.modules[__name__]
_core._initialize(_this, _binary)

register_new = Monoid.register_new
register_anonymous = Monoid.register_anonymous

tx = types.SimpleNamespace()
ss = tx


def __getattr__(name):
    raise AttributeError(f"module 'graphblas_tpu_torch.monoid' has no attribute {name!r}")

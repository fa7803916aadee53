"""``graphblas_tpu_torch.select``: BOOL-returning index-aware ops for Matrix/Vector.select.

Counterpart of the JAX package's namespace (python-graphblas: graphblas/select/__init__.py).
"""

import sys
import types

import graphblas_tpu_torch.indexunary as _indexunary

from ..core.operator import select as _core
from ..core.operator.select import SelectOp
from ..core.operator.utils import select_from_string as from_string

_this = sys.modules[__name__]
_core._initialize(_this, _indexunary)

register_new = SelectOp.register_new
register_anonymous = SelectOp.register_anonymous

tx = types.SimpleNamespace()
ss = tx

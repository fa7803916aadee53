"""``graphblas_tpu_torch.indexunary``: index-aware unary operators f(val, i, j, thunk).

Counterpart of the JAX package's namespace (python-graphblas: graphblas/indexunary/__init__.py).
"""

import sys
import types

from ..core.operator import indexunary as _core
from ..core.operator.indexunary import IndexUnaryOp
from ..core.operator.utils import indexunary_from_string as from_string

_this = sys.modules[__name__]
_core._initialize(_this)

register_new = IndexUnaryOp.register_new
register_anonymous = IndexUnaryOp.register_anonymous

tx = types.SimpleNamespace()
ss = tx

"""``graphblas_tpu_torch.indexbinary``: index-aware binary operators
f(x, ix, jx, y, iy, jy, theta).

Counterpart of the JAX package's namespace (python-graphblas: graphblas/indexbinary/__init__.py).
(SuiteSparse 9.4+ extension; no builtins).
"""

import sys
import types

from ..core.operator import indexbinary as _core
from ..core.operator.indexbinary import IndexBinaryOp

_this = sys.modules[__name__]
_core._initialize(_this)

register_new = IndexBinaryOp.register_new
register_anonymous = IndexBinaryOp.register_anonymous

tx = types.SimpleNamespace()
ss = tx

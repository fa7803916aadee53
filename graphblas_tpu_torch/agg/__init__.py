"""``graphblas_tpu_torch.agg``: aggregators (multi-step reductions).

Counterpart of the JAX package's namespace (python-graphblas: graphblas/agg/__init__.py).
"""

import sys
import types

from ..core.operator import agg as _core
from ..core.operator.agg import Aggregator
from ..core.operator.utils import aggregator_from_string as from_string

_this = sys.modules[__name__]
_core._initialize(_this)

# order/position-based aggregators live in the extension namespace too
# (the reference exposes them as agg.ss.*, core/operator/agg.py:535-758)
tx = types.SimpleNamespace(
    first=_this.first,
    last=_this.last,
    first_index=_this.first_index,
    last_index=_this.last_index,
    argmin=_this.argmin,
    argmax=_this.argmax,
)
ss = tx

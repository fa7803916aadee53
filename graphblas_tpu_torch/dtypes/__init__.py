"""``graphblas_tpu_torch.dtypes``: the datatype namespace.

Counterpart of the JAX package's namespace (python-graphblas: graphblas/dtypes/__init__.py).
"""

import sys as _sys

from ..core import dtypes as _core
from ..core.dtypes import (  # noqa: F401
    BOOL,
    FC32,
    FC64,
    FP32,
    FP64,
    INT8,
    INT16,
    INT32,
    INT64,
    UINT8,
    UINT16,
    UINT32,
    UINT64,
    DataType,
    _INDEX,
    lookup_dtype,
    register_anonymous,
    register_new,
    unify,
)

if _core.BF16 is not None:
    BF16 = _core.BF16

_core._MODULE = _sys.modules[__name__]

# tx extension namespace (reference: graphblas/dtypes/ss.py registers dtypes
# from raw C typedefs; here TPU-extension dtypes such as BF16 live here)
import types as _types

tx = _types.SimpleNamespace(BF16=_core.BF16, register_new=register_new)
ss = tx

"""Host-side sorting for the plan build.

Counterpart of ``counting_sort`` in ``graphblas_tpu/native/__init__.py``.  The
JAX package sorts with a C++ counting sort; ``np.argsort(kind="stable")`` is
the same stable order (it is that module's own fallback), so every slot
layout of the port matches the reference's.
"""

import numpy as np


def counting_sort(keys, n):
    """Stable sort permutation of int keys in [0, n) (int64)."""
    keys = np.ascontiguousarray(keys, np.int32)
    if len(keys) and (int(keys.min()) < 0 or int(keys.max()) >= n):
        raise IndexError(
            f"counting_sort keys out of range [0, {n}): min={int(keys.min())}, max={int(keys.max())}"
        )
    return np.argsort(keys, kind="stable").astype(np.int64)

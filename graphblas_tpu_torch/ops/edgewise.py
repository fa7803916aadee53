"""Edge-list helpers.  Counterpart of ``pad_edges`` in
``graphblas_tpu/ops/edgewise.py`` (host-side numpy, unchanged)."""

import numpy as np


def pad_edges(src, dst, w=None, *, pad_to=None):
    """Pad a COO edge list to a static length with invalid edges (host-side)."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    e = len(src)
    if pad_to is None:
        pad_to = max(1, 1 << (e - 1).bit_length()) if e else 1
    pad = pad_to - e
    valid = np.zeros(pad_to, bool)
    valid[:e] = True
    src = np.pad(src, (0, pad))
    dst = np.pad(dst, (0, pad))
    if w is not None:
        w = np.pad(np.asarray(w), (0, pad))
    return src, dst, w, valid

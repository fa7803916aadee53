"""Segmented scans of the SpMV pipeline.

Counterpart of ``graphblas_tpu/ops/pallas_scan.py``.  The four entry points
keep the JAX signatures, less the interpret flag; the fill tables become one
global int32 ``fill_src`` array.  ``segmented_scan_contrib_gather`` is the
contrib scan with its value channel gathered by index (no JAX counterpart:
the TPU pipeline routes x instead), and ``segmented_spmm`` its k-column
form.  Each dispatches to its Hopper kernel
(``kernels.gather`` for the fill, ``kernels.segscan`` for the scans), or to
the kernel's plain version inside ``kernels.plain_versions()``.
"""

import numpy as np

from .. import kernels
from ..kernels import gather as _gather
from ..kernels import segscan as _segscan
from ..kernels.segscan import STATE_BIG, _combine, _ident  # noqa: F401  (the module's API)


def build_fill_tables(flags):
    """Host-side analysis for ``segmented_fill_static``: ``fill_src[p]`` is
    the latest flagged slot at or before ``p``, or -1 (int32 numpy array)."""
    flags = np.asarray(flags, bool)
    marked = np.where(flags, np.arange(len(flags), dtype=np.int64), -1)
    return np.maximum.accumulate(marked).astype(np.int32) if len(flags) else np.zeros(0, np.int32)


def segmented_scan(values, flags, op):
    """Inclusive segmented scan over a flat array whose length is a multiple
    of 128.  ``flags`` marks segment starts; op in {"fill", "add", "min",
    "max"}; a fill before the first flag reads 0."""
    fn = _segscan.segscan_plain if kernels.plain_requested() else _segscan.segscan
    return fn(values, flags, op)


def segmented_fill_static(values, fill_src):
    """Segmented forward fill with static flags: each slot takes the value at
    the latest flagged slot at or before it, or 0 if there is none."""
    fn = _gather.gather_plain if kernels.plain_requested() else _gather.gather
    return fn(values, fill_src, "fill")


def segmented_scan_contrib(xe, w, valid, flags, op, mul, wrap=None):
    """Fused per-edge multiply + mask + segmented inclusive scan.  ``w`` may be
    None (contribution is x); ``wrap=(bits, signed)`` truncates integer
    contributions to a narrow width after the multiply."""
    fn = _segscan.segscan_contrib_plain if kernels.plain_requested() else _segscan.segscan_contrib
    return fn(xe, w, valid, flags, op, mul, wrap)


def segmented_scan_contrib_gather(x, idx, w, valid, flags, op, mul, wrap=None):
    """``segmented_scan_contrib(x[idx], w, valid, flags, op, mul, wrap)`` with
    the gather fused into the scan: x is read by index inside its tiles, and
    no ``x[idx]`` is made."""
    fn = _segscan.segscan_contrib_gather_plain if kernels.plain_requested() else _segscan.segscan_contrib_gather
    return fn(x, idx, w, valid, flags, op, mul, wrap)


def segmented_spmm(x, xs, idx, w, valid, flags, seg_vertex, n_out, op, mul, tile_base=None, keep=None, rows=None):
    """The k-column product over a plan's dst-order slots: (values, structure)
    of Y (n_out x k), each dst segment's scan of ``x[idx] MUL w`` written at
    its row ``seg_vertex[o]`` (``kernels.segscan.segscan_spmm``); with the
    mask bits ``keep``, only the rows they reach (``rows``: the layout's
    ``SpmmRows``)."""
    fn = _segscan.segscan_spmm_plain if kernels.plain_requested() else _segscan.segscan_spmm
    return fn(x, xs, idx, w, valid, flags, seg_vertex, n_out, op, mul, tile_base, keep, rows)


def segmented_scan_state(mode, xe, w, valid, flags, is_last, state, depth, fr_reduce=False):
    """One fused pass: segmented reduce of dst-sorted contributions + the
    BFS/SSSP state update read at segment-last slots.

    mode="bfs": state is levels (int32); returns (new_levels, frontier f32).
    mode="sssp": state is dist (f32); returns (new_dist, changed f32), or with
    ``fr_reduce`` (new_dist, one int32 flag: 1 if any slot changed)."""
    fn = _segscan.segscan_state_plain if kernels.plain_requested() else _segscan.segscan_state
    return fn(mode, xe, w, valid, flags, is_last, state, depth, fr_reduce)

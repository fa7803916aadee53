"""Edge-wise (COO segment) operations: the O(E) semiring SpMV of the generic
graph models, in plain torch.

Counterpart of ``graphblas_tpu/ops/edgewise.py``: gather x at the edge
sources, apply the semiring multiply per edge, and reduce into the edge
destinations with the semiring add (``index_add_`` / ``scatter_reduce_``
into a tensor that starts at the monoid's identity).  These are XLA
operations in the reference, not Pallas kernels.  The reductions give what
``jax.ops.segment_sum/min/max`` give: an empty segment holds 0, the type's
largest value (min) or its smallest (max), a segment holding a NaN is NaN,
and a tie of zeros is -0.0 for min (+0.0 for max) when the segment holds one
(``_jax_extreme_fix``; torch leaves both to the reduction's order).  Edges
are padded to a static length with invalid edges (``pad_edges``).
"""

import numpy as np
import torch


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


def _jax_extreme_fix(y, c, valid, ids, n, is_min):
    """jax.ops.segment_min/max's answers where torch's scatter reductions
    leave the order of the reduction to decide: a segment holding a NaN is
    NaN, and a tie of zeros is -0.0 for min (+0.0 for max) when the segment
    holds one.  ``valid`` marks the contributions of ``c`` that count."""

    def seg_any(m):
        hits = torch.zeros(n, dtype=torch.int32, device=y.device)
        return hits.index_add_(0, ids, (valid & m).to(torch.int32)) > 0

    neg = torch.signbit(c)
    tie = seg_any((c == 0) & (neg if is_min else ~neg))
    zero = torch.where(tie, -0.0 if is_min else 0.0, 0.0 if is_min else -0.0).to(y.dtype)
    y = torch.where(y == 0, zero, y)
    return torch.where(seg_any(torch.isnan(c)), torch.full_like(y, float("nan")), y)


def _extreme(dtype, largest):
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def segment_sum(data, ids, n):
    """jax.ops.segment_sum: y[k] = sum of data where ids == k (0 if none)."""
    return torch.zeros(n, dtype=data.dtype, device=data.device).index_add_(0, ids.long(), data)


def _segment_extreme(data, ids, n, is_min):
    ids = ids.long()
    y = torch.full((n,), _extreme(data.dtype, is_min), dtype=data.dtype, device=data.device)
    y = y.scatter_reduce_(0, ids, data, "amin" if is_min else "amax")
    if data.dtype.is_floating_point:
        y = _jax_extreme_fix(y, data, torch.ones_like(data, dtype=torch.bool), ids, n, is_min)
    return y


def segment_min(data, ids, n):
    """jax.ops.segment_min: the type's largest value for an empty segment."""
    return _segment_extreme(data, ids, n, True)


def segment_max(data, ids, n):
    """jax.ops.segment_max: the type's smallest value for an empty segment."""
    return _segment_extreme(data, ids, n, False)


def spmv_plus_times(src, dst, w, valid, x, n):
    """y[j] = sum over edges (i->j) of w * x[i]."""
    contrib = w * x[src.long()]
    return segment_sum(torch.where(valid, contrib, torch.zeros((), dtype=contrib.dtype, device=contrib.device)), dst, n)


def spmv_plus_first(src, dst, valid, x, n):
    """y[j] = sum over edges (i->j) of x[i] (structure-only weights)."""
    xs = x[src.long()]
    return segment_sum(torch.where(valid, xs, torch.zeros((), dtype=xs.dtype, device=xs.device)), dst, n)


def spmv_min_plus(src, dst, w, valid, x, n, *, big):
    """y[j] = min over edges (i->j) of (x[i] + w); absent encoded as ``big``."""
    xs = x[src.long()]
    big = torch.as_tensor(big, dtype=xs.dtype, device=xs.device)
    contrib = torch.where(valid, xs + w, big)
    contrib = torch.where(xs >= big, big, contrib)  # absent source annihilates
    return segment_min(contrib, dst, n)


def spmv_any_reach(src, dst, valid, frontier, n):
    """Boolean any_pair: y[j] = OR over edges (i->j) of frontier[i]."""
    contrib = (valid & frontier[src.long()]).to(torch.int32)
    return segment_max(contrib, dst, n) > 0


def spmv_any_parent(src, dst, valid, frontier, n):
    """any_firsti-style: y[j] = some source i with frontier[i]; -1 if none.
    Backs parent BFS."""
    contrib = torch.where(valid & frontier[src.long()], src, torch.full_like(src, -1))
    return segment_max(contrib, dst, n)


def spmv_min_second(src, dst, valid, x, n, *, big):
    """y[j] = min over edges (i->j) of x[i] (min_second semiring; FastSV)."""
    xs = x[src.long()]
    return segment_min(torch.where(valid, xs, torch.as_tensor(big, dtype=xs.dtype, device=xs.device)), dst, n)


def degrees(dst, valid, n):
    """Edges per vertex of ``dst`` (int32)."""
    return segment_sum(valid.to(torch.int32), dst, n)

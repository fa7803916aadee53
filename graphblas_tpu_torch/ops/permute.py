"""Static permutations as one composed gather.

Counterpart of ``graphblas_tpu/ops/permute.py``.  The JAX package realises
each static permutation as a network of 128-lane shuffles, transposes and row
selects, because a general gather was slow on the TPU.  On Hopper the gather
is the native primitive, so a route is one int32 index array and
``apply_perm`` is one launch of Kernel G.  The Euler-colouring router and the
network builder have no counterpart here.
"""

import numpy as np

from .. import kernels
from ..kernels import gather as _gather


def padded_size(e):
    """Smallest admissible network size >= e (unchanged from the JAX package,
    so ``e_pad`` and every slot layout match it).  Admissible: rows
    r = m * 128^L with 1 <= m <= 128, size = r * 128."""
    r0 = max(1, -(-e // 128))
    L = 0
    while 128 ** (L + 1) < r0:
        L += 1
    m = -(-r0 // (128**L))
    return m * (128**L) * 128


def apply_perm(x, idx, epilogue=None, aux=None, scalar=None):
    """``out[p] = x[idx[p]]`` over one composed int32 index array, then the
    optional fused epilogue: ``"pagerank"`` gives ``y / a`` where
    ``a = aux[p] > 0`` and ``scalar / -a`` elsewhere (the PageRank postlude of
    graphblas_tpu/models/fast.py).  Replaces ``apply_plan``."""
    fn = _gather.gather_plain if kernels.plain_requested() else _gather.gather
    return fn(x, idx, epilogue or "none", aux, scalar)


def compose_reference_network(stages, e_pad):
    """The int32 index array of a JAX-package network: its stages (S, T, RSEL
    and ROWSEL, as ``graphblas_tpu/ops/fastspmv.py:_unpack_network`` decodes
    them) applied in numpy to ``arange(e_pad)``, exactly as the non-Pallas
    branch of ``apply_plan`` applies them to data."""
    x = np.arange(e_pad, dtype=np.int64)
    for stage in stages:
        kind = stage[0]
        if kind == "S":
            idx = np.asarray(stage[1]).astype(np.int64)
            x = np.take_along_axis(x.reshape(e_pad // 128, 128), idx, axis=1).reshape(-1)
        elif kind == "T":
            M = 128 ** stage[1]
            q = e_pad // (128 * M * 128)
            x = x.reshape(q, 128, M, 128).transpose(0, 3, 2, 1).reshape(-1)
        elif kind == "RSEL":  # m-way row select: out[g, s, l] = x[st[g, s, l], s, l]
            src_top, m = np.asarray(stage[1]).astype(np.int64), stage[2]
            x = np.take_along_axis(x.reshape(m, src_top.shape[1], 128), src_top, axis=0).reshape(-1)
        elif kind == "ROWSEL":  # rotate m onto lanes, per-row shuffle, rotate back
            shuf, m = np.asarray(stage[1]).astype(np.int64), stage[2]
            if m > 1:
                s2 = e_pad // (128 * m)
                t = x.reshape(m, s2, 128).transpose(1, 2, 0).reshape(-1, 128)
                t = np.take_along_axis(t, shuf, axis=1)
                x = t.reshape(s2, 128, m).transpose(2, 0, 1).reshape(-1)
        else:
            raise ValueError(f"unknown network stage {kind!r}")
    return x.astype(np.int32)

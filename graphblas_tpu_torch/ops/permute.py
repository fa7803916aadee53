"""Static permutations as one composed gather.

Counterpart of ``graphblas_tpu/ops/permute.py``.  The JAX package realises
each static permutation as a network of 128-lane shuffles, transposes and row
selects, because a general gather was slow on the TPU.  On Hopper the gather
is the native primitive, so a route is one int32 index array and
``apply_perm`` is one launch of Kernel G, whatever stages the network had
(lane shuffles, transposes, row selects).  The Euler-colouring router and
the network builder have no counterpart here.
"""

import numpy as np
import torch

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


def _table(t, device):
    """A stage's table as an int64 tensor on ``device`` (numpy, torch or any
    array numpy can read)."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.to(device=device, dtype=torch.int64)


def apply_network_plain(x, stages):
    """Apply a JAX-package network stage by stage, as the non-Pallas branch
    of ``graphblas_tpu/ops/permute.py:apply_plan`` does: S (per-row 128-lane
    shuffle), T (digit-swap transpose), RSEL (m-way row select) and ROWSEL
    (m rotated onto lanes, a per-row shuffle, rotated back) stages, as
    ``graphblas_tpu/ops/fastspmv.py:_unpack_network`` decodes them.  The
    plain counterpart of Kernel G over the network's composed index."""
    n = x.shape[0]
    for stage in stages:
        kind = stage[0]
        if kind == "S":
            x = torch.gather(x.reshape(n // 128, 128), 1, _table(stage[1], x.device)).reshape(-1)
        elif kind == "T":
            M = 128 ** stage[1]
            q = n // (128 * M * 128)
            x = x.reshape(q, 128, M, 128).permute(0, 3, 2, 1).reshape(-1)
        elif kind == "RSEL":  # out[g, s, l] = x[st[g, s, l], s, l]
            src_top, m = _table(stage[1], x.device), stage[2]
            x = torch.gather(x.reshape(m, src_top.shape[1], 128), 0, src_top).reshape(-1)
        elif kind == "ROWSEL":
            m = stage[2]
            if m > 1:
                s2 = n // (128 * m)
                t = x.reshape(m, s2, 128).permute(1, 2, 0).reshape(-1, 128)
                t = torch.gather(t, 1, _table(stage[1], x.device))
                x = t.reshape(s2, 128, m).permute(2, 0, 1).reshape(-1)
        else:
            raise ValueError(f"unknown network stage {kind!r}")
    return x


def compose_reference_network(stages, e_pad):
    """The int32 index array of a JAX-package network: the network applied
    to ``arange(e_pad)`` (numpy)."""
    idx = apply_network_plain(torch.arange(e_pad, dtype=torch.int64), stages)
    return idx.to(torch.int32).numpy()

"""Collectives over the shards of a mesh, in one process.

The JAX package leaves these to XLA (``lax.psum``, ``pmin``, ``pmax``,
``all_gather`` inside ``shard_map``).  Here a collective takes one tensor per
shard, copies each to one named device, and folds them there in shard order
0, 1, ..., P-1, so a float sum is the same on every run.  min and max follow
``jnp.minimum``/``jnp.maximum``: NaN propagates, -0.0 is below +0.0.  The
result lands on ``device`` only; a caller that needs it elsewhere copies it.
"""

import torch

from ..kernels.segscan import _maximum, _minimum


def _to(parts, device):
    return [p.to(device) for p in parts]


def _fold(parts, device, fn):
    parts = _to(parts, device)
    acc = parts[0]
    for p in parts[1:]:
        acc = fn(acc, p)
    return acc


def psum(parts, device):
    """Sum of the shards' tensors on ``device``, in shard order."""
    return _fold(parts, device, torch.add)


def pmin(parts, device):
    """Elementwise min of the shards' tensors on ``device`` (``jnp.minimum``)."""
    return _fold(parts, device, _minimum)


def pmax(parts, device):
    """Elementwise max of the shards' tensors on ``device`` (``jnp.maximum``;
    for bool tensors, or: a structure present on any shard)."""
    if parts[0].dtype == torch.bool:
        return _fold(parts, device, torch.logical_or)
    return _fold(parts, device, _maximum)


def all_gather(parts, device):
    """The shards' tensors stacked on a new leading axis, on ``device``."""
    return torch.stack(_to(parts, device))


def combine(parts, add, device):
    """The add-monoid's collective: plus by ``psum``, min by ``pmin``, max and
    any by ``pmax`` (``graphblas_tpu/parallel/fastspmv.py:_combine``)."""
    if add == "plus":
        return psum(parts, device)
    if add == "min":
        return pmin(parts, device)
    return pmax(parts, device)

"""The port's device mesh: a grid of shards, each on a ``torch.device``.

Counterpart of the ``jax.sharding.Mesh`` that the JAX package's ``parallel``
layer builds and reads.  The whole mesh lives in one process: a shard is a
place where per-shard work runs, and one device may hold several shards
(eight shards on one card, or on the CPU), so one card runs the same mesh
program as a host with several.  Collectives are copies to one device and a
fold in shard order (``parallel/_collectives.py``).

``default_devices`` is the rule that ``Context`` and
``build_sharded_spmv_plan`` apply when they are given no devices: on
``tx.config["platform"] == "cuda"`` (the default) the cards that
``torch.cuda.device_count()`` reports, on ``"cpu"`` as many CPU shards as
asked, 8 when nothing asks (the counterpart of the JAX tests'
``--xla_force_host_platform_device_count=8``).
"""

import weakref

import numpy as np
import torch

from ..core.utils import canonical_device, collection_device

CPU_SHARDS = 8


def _device_array(devices, shape=None):
    """A numpy object array of canonical ``torch.device``s."""
    src = np.asarray(devices, dtype=object) if not isinstance(devices, np.ndarray) else devices
    flat = [canonical_device(d) for d in src.reshape(-1)]
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    return arr.reshape(src.shape if shape is None else shape)


class Mesh:
    """Shards on torch devices, shaped like the mesh.

    ``devices``: a numpy object array of ``torch.device`` (a device may appear
    more than once); ``axis_names``: one name per axis; ``shape``: a dict from
    axis name to size, as ``jax.sharding.Mesh.shape``."""

    def __init__(self, devices, axis_names):
        self.devices = _device_array(devices)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"Mesh: {len(self.axis_names)} axis names for a {self.devices.ndim}-D device array")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def device_list(self):
        """The shards' devices in mesh order (row-major), repeats included."""
        return list(self.devices.reshape(-1))

    def key(self):
        """A cache key: the device list, repeats included."""
        return tuple(str(d) for d in self.device_list())

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list()]})"


def default_devices(count=None):
    """The devices of a mesh that names none: on ``tx.config["platform"] ==
    "cuda"`` every card (``count`` is the caller's to check against them),
    else ``count`` CPU shards (8 by default)."""
    dev = collection_device()
    if dev.type == "cuda":
        return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    return [dev] * (CPU_SHARDS if count is None else int(count))


def squarest(n):
    """The 2-D factorization (pi, pj) of n with pi the largest divisor <= sqrt(n)."""
    pi = int(n**0.5)
    while n % pi:
        pi -= 1
    return pi, n // pi


# ---------------------------------------------------------------------------
# placement: which mesh and spec a collection was put on
# ---------------------------------------------------------------------------

_PLACED = {}  # id(sparse collection) -> (weakref to it, mesh, spec, its sparse data)


def record(x, mesh, spec):
    """Note the placement of a sparse-format collection (a dense one keeps
    its ``parallel.blocks.Blocks`` in its data slots instead)."""
    key = id(x)
    _PLACED[key] = (weakref.ref(x, lambda _r, key=key: _PLACED.pop(key, None)), mesh, tuple(spec), x._sparse)


def placement(x):
    """(mesh, spec) of a placed collection: the layout of the blocks its data
    slots hold, or a sparse collection's last ``shard_vector`` /
    ``replicate`` while it holds the sparse data that was placed; else None
    (a later statement gave it whole tensors or new storage)."""
    from ..core.base import layout_of

    sp = getattr(x, "_sparse", None)
    if sp is None:
        lay = layout_of(x)
        return None if lay is None else (lay.mesh, lay.spec)
    rec = _PLACED.get(id(x))
    if rec is None or rec[0]() is not x or rec[3] is not sp:
        return None
    return rec[1], rec[2]

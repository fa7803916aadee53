"""Multi-device distribution: mesh contexts and sharded collections.

Counterpart of ``graphblas_tpu/parallel/__init__.py``.  A ``Context`` scopes a
mesh of shards on torch devices (``parallel.mesh.Mesh``, the counterpart of
``jax.sharding.Mesh``): inside an engaged Context the DSL's sparse
``mxv``/``vxm`` run the sharded SpMV engine (``fastspmv``), ``C(M) <<
A.mxm(B)`` on sparse operands the masked SpGEMM by mask-row blocks
(``spgemm``), and dense ``mxm``/``mxv``/``vxm`` SUMMA (``summa``).  ``shard_matrix``,
``shard_vector`` and ``replicate`` keep a dense collection's blocks on the
shards' devices (``blocks``), and the ewise, apply, select, merge and reduce
families run on placed operands block by block, their outputs placed with
the reference's specs.  The mesh lives in one process; one device may hold
several shards, so eight shards on one card run the same program as eight
cards would.

Which devices a Context takes when it is given none: on
``tx.config["platform"] == "cuda"`` (the default) the cards
``torch.cuda.device_count()`` reports, and a ``shape`` whose size differs
from their number raises, as in the JAX package; on ``"cpu"`` as many CPU
shards as ``shape`` asks, 8 when ``shape`` is None.  ``devices=[...]`` names
the shards' devices, repeats allowed (``devices=["cuda:0"] * 8, shape=(2,
4)`` is a 2 x 4 mesh on one card).
"""

import math
import threading

from .fastspmv import (  # noqa: F401
    build_sharded_spmv_plan,
    sharded_bfs_level,
    sharded_pagerank,
    sharded_spmv,
    sharded_spmv_masked,
    sharded_sssp,
)
from .mesh import Mesh as _Mesh
from .mesh import _device_array
from .mesh import default_devices as _default_devices
from .mesh import record as _record
from .mesh import squarest as _squarest
from .summa import (  # noqa: F401
    sharded_spmv_step,
    summa_mxm,
    summa_mxm_arrays,
    summa_mxv,
    summa_mxv_arrays,
)

_threadlocal = threading.local()


class Context:
    """Scope a device mesh for sharded execution.

    Engage / disengage with a thread-local stack, usable as a context
    manager.  ``mesh``: a ``parallel.mesh.Mesh``; else one is built over
    ``devices`` (default: see the module's docstring) in ``shape`` (default:
    the squarest 2-D factorization) with ``axis_names``."""

    def __init__(self, mesh=None, *, shape=None, axis_names=("i", "j"), devices=None):
        if mesh is None:
            if devices is None:
                # on the CPU platform shape's size CPU shards; on the cards, all of them
                devices = _default_devices(None if shape is None else math.prod(shape))
            if not len(devices):
                raise ValueError("Context: no devices for the mesh")
            shape = _squarest(len(devices)) if shape is None else tuple(int(s) for s in shape)
            if math.prod(shape) != len(devices):
                raise ValueError(
                    f"Context: cannot shape {len(devices)} devices as {shape} "
                    "(name the shards' devices, repeats allowed, with devices=[...])"
                )
            mesh = _Mesh(_device_array(devices, shape), axis_names)
        self.mesh = mesh
        self.axis_names = mesh.axis_names

    def engage(self):
        stack = getattr(_threadlocal, "stack", None)
        if stack is None:
            stack = _threadlocal.stack = []
        stack.append(self)
        return self

    def disengage(self):
        stack = getattr(_threadlocal, "stack", [])
        if stack and stack[-1] is self:
            stack.pop()

    def __enter__(self):
        return self.engage()

    def __exit__(self, *exc):
        self.disengage()
        return False

    def __repr__(self):
        return f"parallel.Context(mesh={tuple(self.mesh.shape.items())})"


def current_context():
    stack = getattr(_threadlocal, "stack", [])
    return stack[-1] if stack else None


def _engaged(context):
    ctx = context or current_context()
    if ctx is None:
        raise ValueError("No mesh Context engaged; pass context= or use `with Context():`")
    return ctx


def _place(x, mesh, spec):
    """Cut a collection's storage into blocks over the mesh under ``spec``
    (``parallel.blocks``): each shard's block on its device, the blocks in
    the collection's data slots.  Raises ValueError where a dimension is not
    divisible by its mesh axis, as the reference's ``device_put`` does.  A
    sparse-format collection moves to the mesh's first device and its
    placement is noted; its paths split it themselves."""
    if getattr(x, "_sparse", None) is not None:
        x._sp_dev = mesh.device_list()[0]
        _record(x, mesh, spec)
        return x
    from ..core.base import store, stored
    from . import blocks as _b

    v, s = stored(x)
    lay = _b.Layout(mesh, spec, tuple(s.shape))
    store(x, *(t if _b.is_blocks(t) and t.layout == lay else _b.cut(_b.whole(t) if _b.is_blocks(t) else t, lay) for t in (v, s)))
    return x


def shard_matrix(A, context=None, *, spec=None):
    """Shard a dense-format Matrix as 2-D blocks over the mesh (in place).

    The reference's user-level block decomposition hooks are
    ``Matrix.ss.split`` / ``gb.ss.concat``; here the blocks sit on the
    shards' devices (``parallel.blocks``, spec ``('i', 'j')`` or ``spec=``),
    and the ewise, apply, select, merge and reduce families and SUMMA run
    them block by block."""
    ctx = _engaged(context)
    if getattr(A, "_sparse", None) is not None:
        # never densify a sparse operand onto the mesh; sparse collections
        # distribute through their own paths, which an engaged Context routes
        raise TypeError(
            "shard_matrix expects a dense-format Matrix; sparse matrices "
            "distribute without densifying: masked mxm partitions by "
            "mask-row blocks (parallel.spgemm, used automatically by "
            "C(M) << A.mxm(B) inside an engaged Context) and SpMV uses "
            "per-shard plans (parallel.build_sharded_spmv_plan)"
        )
    return _place(A, ctx.mesh, spec or ctx.axis_names)


def shard_vector(v, context=None, *, axis=None):
    """Shard a Vector over one mesh axis (default: last)."""
    ctx = _engaged(context)
    return _place(v, ctx.mesh, (axis or ctx.axis_names[-1],))


def replicate(x, context=None):
    """Replicate a collection on every device of the mesh."""
    ctx = _engaged(context)
    return _place(x, ctx.mesh, ())

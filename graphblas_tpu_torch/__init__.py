"""graphblas_tpu_torch: the PyTorch + CUDA port of graphblas_tpu.

The python-graphblas object model and DSL on the dense-masked engine::

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix, Vector, binary, semiring

    A = Matrix.from_coo(r, c, v, nrows=n, ncols=n)
    w(mask.S, accum=binary.min, replace=True) << A.T.mxv(v, semiring.min_plus)

``Matrix``, ``Vector`` and ``Scalar`` (and ``Recorder``) load on first
access, as the JAX package loads them.  A collection's tensors live on
``tx.config["platform"]``: "cuda" (the default; with no card, building a
collection raises, as PyTorch does) or "cpu"; every operation runs on its
operands' device.  ``ops.densemasked`` is the engine; on CUDA tensors its
tropical matmul runs the Hopper kernel ``gb_tropical`` (``kernels``).

It also carries the SpMV engine: a graph is analyzed once into an
``ops.fastspmv.SpmvPlan`` (saved and loaded with ``save_spmv_plan`` /
``load_spmv_plan``), ``ops.fastspmv.spmv`` and ``spmv_masked`` multiply on
it, and ``models.fast`` runs PageRank, level and parent BFS and SSSP.  It
carries the operator system (the namespaces ``unary``, ``binary``,
``monoid``, ``semiring``, ``indexunary``, ``indexbinary``, ``select``,
``op``, ``agg`` and ``dtypes``, loaded on first access; ``unary.numpy``,
``binary.numpy``, ``monoid.numpy`` and ``semiring.numpy`` by their own
import) and the typed entry points of the sparse engine (``core.sparse``:
``SparseMatrixData``, ``sparse_mxv``, ``sparse_spgemm_analyze`` /
``sparse_spgemm_execute``, ``sparse_mxm_masked``).  The builders put their
tensors on the card unless given ``device="cpu"``.  On CUDA tensors the
engines run through the hand-written Hopper kernels of ``kernels`` (built
with nvcc on first use); on CPU tensors they run their plain PyTorch
versions.  The package imports torch and numpy only.

Past ``tx.config["dense_limit"]`` cells a collection takes the sparse
format (host COO with device caches; ``A.mxv(x)`` runs the SpMV engine).
A user-defined type (UDT) collection keeps its values as a dict of field
tensors (struct of arrays) and runs every engine family with user
operators.  ``compile``, ``loop``, ``until``, ``loop_runner`` and
``until_runner`` (``core.compiler``) run a loop of DSL statements as one
CUDA graph on the card (eagerly on the CPU, holding the closed-over
operands of the first call), with structure hoisting; ``models.dsl``
holds the DSL recipes written with them.  ``models`` also carries the dense
n x n models (triangle count, k-truss, maximal matching, betweenness
centrality, Louvain).

Interop and the extension namespace: ``io`` (scipy.sparse, networkx,
Matrix Market, pydata sparse, awkward), ``viz`` (``draw``, ``spy``,
``datashade``), ``tx`` (aliased ``ss``: ``diag``, ``concat``, ``burble``,
the ``import_*`` functions, ``deserialize``; ``Matrix.tx``/``Vector.tx``:
scan, sort, selectk, compactify, split, flatten, reshape, GBTX
``serialize``, ``export``), and pickle of ``Matrix``, ``Vector`` and
``Scalar``.  Each constructor among them puts its result on
``tx.config["platform"]``.

The mesh layer, ``parallel``: a ``Context`` scopes a mesh of shards on torch
devices (the cards, or 8 CPU shards on the CPU platform; one card may hold
several shards), and inside it the sparse ``mxv``/``vxm`` run the sharded
SpMV engine, ``C(M) << A.mxm(B)`` the masked SpGEMM by mask-row blocks and
dense products SUMMA; ``parallel.build_sharded_spmv_plan`` and its
``sharded_*`` loops drive the sharded engine directly.
"""

import importlib as _importlib

from . import core, exceptions, kernels, models, ops
from .core.config import Config as _Config

__version__ = "0.1.0"

__all__ = ["core", "exceptions", "kernels", "models", "ops", "config", "init", "replace"]


class replace:
    """Singleton to indicate ``replace=True`` when used in an updater call."""

    def __new__(cls):
        return cls

    def __reduce__(self):
        return "replace"

    def __repr__(self):
        return "graphblas_tpu_torch.replace"


# Library-level config (python-graphblas: graphblas/__init__.py and graphblas.yaml)
config = _Config(
    "graphblas_tpu_torch",
    defaults={
        # When True, expression objects auto-compute when used as values
        "autocompute": True,
        # When True, *.numpy operator namespaces alias numpy-named ops to builtins
        "mapnumpy": True,
    },
)

_NAMESPACES = frozenset(
    ["dtypes", "unary", "binary", "monoid", "semiring", "indexunary", "indexbinary", "select", "op", "agg", "tx", "io", "viz", "parallel"]
)

_CLASS_HOMES = {
    "Matrix": "graphblas_tpu_torch.core.matrix",
    "Vector": "graphblas_tpu_torch.core.vector",
    "Scalar": "graphblas_tpu_torch.core.scalar",
    "Recorder": "graphblas_tpu_torch.core.recorder",
    # compiled loops: a loop of DSL statements as one CUDA graph
    "compile": "graphblas_tpu_torch.core.compiler",
    "loop": "graphblas_tpu_torch.core.compiler",
    "until": "graphblas_tpu_torch.core.compiler",
    "loop_runner": "graphblas_tpu_torch.core.compiler",
    "until_runner": "graphblas_tpu_torch.core.compiler",
}

is_blocking = False
backend = None
_initialized = False


def init(backend_name="torch", blocking=None):
    """Initialize the engine (API parity with ``gb.init``).

    API errors (dimension/type/domain/index) always raise at the offending
    statement.  CUDA launches are asynchronous; ``blocking=True``
    additionally synchronizes the card after every mutating statement
    (device faults surface at the statement), while the default surfaces
    them at ``wait()`` or the first value read.  Re-initializing with a
    different mode raises."""
    global _initialized, backend, is_blocking
    if _initialized:
        if backend_name != backend:
            raise exceptions.GraphblasException(
                f"graphblas_tpu_torch is already initialized with backend {backend!r}; "
                f"init() with {backend_name!r} is not allowed"
            )
        if blocking is not None and bool(blocking) != is_blocking:
            raise exceptions.GraphblasException(
                f"graphblas_tpu_torch is already initialized with blocking={is_blocking}; "
                "it cannot be re-initialized with a different mode"
            )
        return
    if backend_name != "torch":
        raise exceptions.GraphblasException(f"unknown backend {backend_name!r}; the port's backend is 'torch'")
    if blocking is not None:
        is_blocking = bool(blocking)
    backend = backend_name
    _initialized = True


def __getattr__(name):
    """Load the collections and the operator namespaces on first access."""
    if name in _CLASS_HOMES:
        value = getattr(_importlib.import_module(_CLASS_HOMES[name]), name)
    elif name in _NAMESPACES:
        value = _importlib.import_module(f"graphblas_tpu_torch.{name}")
    elif name == "ss":  # alias of the tx extension namespace, as in the reference
        value = _importlib.import_module("graphblas_tpu_torch.tx")
    elif name == "MAX_SIZE":
        value = 2**62  # the largest dimension the index space supports (int64 indices)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(globals().keys() | _NAMESPACES | set(_CLASS_HOMES) | {"MAX_SIZE", "ss"})

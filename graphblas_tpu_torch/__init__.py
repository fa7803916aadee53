"""graphblas_tpu_torch: the PyTorch + CUDA port of graphblas_tpu.

It carries the SpMV engine: a graph is analyzed once into an
``ops.fastspmv.SpmvPlan`` (saved and loaded with ``save_spmv_plan`` /
``load_spmv_plan``), ``ops.fastspmv.spmv`` and ``spmv_masked`` multiply on
it, and ``models.fast`` runs PageRank, level and parent BFS and SSSP.  It
carries the operator system (the namespaces ``unary``, ``binary``,
``monoid``, ``semiring``, ``indexunary``, ``indexbinary``, ``select``,
``op``, ``agg`` and ``dtypes``, loaded on first access as the JAX package
loads them; ``unary.numpy``, ``binary.numpy``, ``monoid.numpy`` and
``semiring.numpy`` by their own import) and the typed entry points of the
sparse engine (``core.sparse``: ``SparseMatrixData``, ``sparse_mxv``,
``sparse_spgemm_analyze`` / ``sparse_spgemm_execute``,
``sparse_mxm_masked``), and the dense tropical matmul (``ops.mxm``).  The
builders put their tensors on the card unless given ``device="cpu"``.  On
CUDA tensors the engine runs through the hand-written Hopper kernels of
``kernels`` (built with nvcc on first use); on CPU tensors it runs their
plain PyTorch versions.  The package imports torch and numpy only.
"""

import importlib as _importlib

from . import core, exceptions, kernels, models, ops
from .core.config import Config as _Config

__all__ = ["core", "exceptions", "kernels", "models", "ops", "config"]

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
    ["dtypes", "unary", "binary", "monoid", "semiring", "indexunary", "indexbinary", "select", "op", "agg", "tx"]
)


def __getattr__(name):
    """Load the operator namespaces on first access."""
    if name in _NAMESPACES:
        module = _importlib.import_module(f"graphblas_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(globals().keys() | _NAMESPACES)

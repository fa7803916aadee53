"""graphblas_tpu_torch: the PyTorch + CUDA port of graphblas_tpu.

It carries the SpMV engine: a graph is analyzed once into an
``ops.fastspmv.SpmvPlan`` (saved and loaded with ``save_spmv_plan`` /
``load_spmv_plan``), ``ops.fastspmv.spmv`` and ``spmv_masked`` multiply on
it, and ``models.fast`` runs PageRank, level and parent BFS and SSSP.  It
also carries the masked SpGEMM (``core.sparse``: ``SparseMatrixData``,
``sparse_spgemm_analyze`` / ``sparse_spgemm_execute``, ``sparse_mxm_masked``)
and the dense tropical matmul (``ops.mxm``).  The builders put their tensors
on the card unless given ``device="cpu"``.  On
CUDA tensors the engine runs through the hand-written Hopper kernels of
``kernels`` (built with nvcc on first use); on CPU tensors it runs their
plain PyTorch versions.  The package imports torch and numpy only.
"""

from . import core, kernels, models, ops

__all__ = ["core", "kernels", "models", "ops"]

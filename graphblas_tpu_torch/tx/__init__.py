"""``graphblas_tpu_torch.tx``: the engine config.

Counterpart of the config of ``graphblas_tpu/tx/__init__.py``, with the keys
that ``core.sparse`` reads.  The rest of the extension namespace (free
functions, ``About``) comes with ROADMAP.md's queue 7.
"""

from ..core.config import Config

config = Config(
    "graphblas_tpu_torch.tx",
    defaults={
        # matrices above this many cells store as analyzed-COO sparse
        # (analogue of SuiteSparse sparsity_control / hyper_switch)
        "dense_limit": 1 << 24,
        # hard guard: densifying a sparse matrix past this many cells raises
        "densify_limit": 1 << 26,
        # sparse mxv/vxm lowering: auto | plan (SpmvPlan engine) | generic
        "mxv_strategy": "auto",
    },
)

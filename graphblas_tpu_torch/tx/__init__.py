"""``graphblas_tpu_torch.tx``: the engine config.

Counterpart of the config of ``graphblas_tpu/tx/__init__.py``, with the keys
that ``core.sparse``, the collections and the dense-masked engine read.  The
rest of the extension namespace (free functions, ``About``, ``Matrix.tx``)
comes with ROADMAP.md's queue 7.
"""

from ..core.config import Config

config = Config(
    "graphblas_tpu_torch.tx",
    defaults={
        # dense mxm lowering: "auto" takes the matmul forms where one applies,
        # then the tropical kernel; "mxu" the matmul forms only; "pallas" the
        # tropical kernel (also off float32 and below 128 x 128 outputs);
        # "generic" the chunked semiring contraction
        "mxm_strategy": "auto",
        # the device of new collections: "cuda" (the card) or "cpu"
        "platform": "cuda",
        # print engine dispatch diagnostics (analogue of SuiteSparse burble)
        "burble": False,
        # matrices above this many cells store as analyzed-COO sparse
        # (analogue of SuiteSparse sparsity_control / hyper_switch)
        "dense_limit": 1 << 24,
        # hard guard: densifying a sparse matrix past this many cells raises
        "densify_limit": 1 << 26,
        # sparse mxv/vxm lowering: auto | plan (SpmvPlan engine) | generic
        "mxv_strategy": "auto",
    },
    validators={
        "platform": lambda v: v in ("cuda", "cpu"),
        "mxm_strategy": lambda v: v in ("auto", "mxu", "pallas", "generic"),
    },
)

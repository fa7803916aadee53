"""Counterpart of ``graphblas_tpu/ops`` (the SpMV engine's part, eqjoin and
the tropical matmul).

The engine: routes (``permute``), scans (``scan``), the analyzed-COO SpMV
(``fastspmv``) and edge-list helpers (``edgewise``); the masked-SpGEMM inner
loop (``eqjoin``) and the dense tropical matmul (``mxm``)."""

from . import edgewise, eqjoin, fastspmv, mxm, permute, scan

__all__ = ["edgewise", "eqjoin", "fastspmv", "mxm", "permute", "scan"]

"""Counterpart of ``graphblas_tpu/ops`` (the SpMV engine's part).

The engine: routes (``permute``), scans (``scan``), the analyzed-COO SpMV
(``fastspmv``) and edge-list helpers (``edgewise``)."""

from . import edgewise, fastspmv, permute, scan

__all__ = ["edgewise", "fastspmv", "permute", "scan"]

"""Counterpart of ``graphblas_tpu/core`` (the sparse container and the masked
SpGEMM)."""

from . import sparse

__all__ = ["sparse"]

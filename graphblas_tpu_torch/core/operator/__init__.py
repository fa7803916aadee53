"""Operator system (counterpart of ``graphblas_tpu/core/operator``)."""

from .base import OpBase, ParameterizedUdf, TypedOpBase, find_opclass  # noqa: F401
from .utils import get_semiring, get_typed_op  # noqa: F401

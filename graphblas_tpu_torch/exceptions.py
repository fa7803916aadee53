"""Typed exception hierarchy for graphblas_tpu_torch (a copy of
graphblas_tpu/exceptions.py).

Mirrors the GraphBLAS error-code model of the reference implementation
(python-graphblas, graphblas/exceptions.py) without the C error-string
plumbing: in this engine errors are raised eagerly at dispatch time with a
Python message, so there is no ``GrB_*_error`` retrieval step.
"""


class GraphblasException(Exception):
    """Base class for every graphblas_tpu_torch error."""


class NoValue(GraphblasException):
    """Attempted to read an element that is not present in the collection."""


class UninitializedObject(GraphblasException):
    """Object was used before being initialized."""


class InvalidObject(GraphblasException):
    """One of the collections involved is in an invalid state."""


class NullPointer(GraphblasException):
    """A required argument was None."""


class InvalidValue(GraphblasException):
    """An argument had an invalid value."""


class InvalidIndex(GraphblasException):
    """An index is out of range (reference: exceptions.py:44-49)."""


class DomainMismatch(GraphblasException):
    """The domains (dtypes) of the operator and collections are incompatible."""


class DimensionMismatch(GraphblasException):
    """Shapes of the collections are incompatible for this operation."""


class OutputNotEmpty(GraphblasException):
    """Attempted to ``build`` a collection that already contains entries."""


class OutOfMemory(GraphblasException):
    """The engine ran out of device or host memory."""


class IndexOutOfBound(GraphblasException):
    """An index is outside the allowed range (execution-time error)."""


class EmptyObject(GraphblasException):
    """An empty Scalar was used where a value is required
    (reference: exceptions.py:83-90)."""


class NotImplementedException(GraphblasException):
    """The requested feature is valid GraphBLAS but not implemented yet."""


class UdfParseError(GraphblasException):
    """A user-defined function could not be evaluated on torch tensors
    (reference analogue: exceptions.py:93-104, numba parse failure)."""


# -- Warnings -----------------------------------------------------------------


class GraphblasWarning(UserWarning):
    """Base warning class."""


class PerformanceWarning(GraphblasWarning):
    """Operation falls back to a slow path (e.g. un-jitted host loop)."""

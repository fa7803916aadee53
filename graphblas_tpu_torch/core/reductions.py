"""Order/position-based aggregation kernels wrapped into collections.

Counterpart of ``graphblas_tpu/core/reductions.py``: backs
agg.argmin/argmax/first/last/first_index/last_index as direct engine
reductions (python-graphblas's recipes use positional semirings and
compactify).
"""

from ..ops import densemasked as _dm
from . import dtypes as _dt


def _wrap_vector(v, s, dtype, name):
    from .vector import Vector

    return Vector._from_arrays(v, s, dtype, name=name)


def _wrap_scalar(v, present, dtype, name):
    from .scalar import Scalar

    sc = Scalar(dtype, name=name)
    if bool(present):
        sc._set_value_from_device(v, dtype)
    return sc


def agg_argminmax(parent, axis, which, out_kind):
    """argmin/argmax along an axis (or flattened for scalar reduce)."""
    values, struct = parent._values, parent._struct
    if parent.ndim == 1:
        if axis == "all" or axis == "row":
            idx, s = _dm.argminmax_axis(values, struct, which, 0, parent.dtype)
            if axis == "all":
                return _wrap_scalar(idx, s, _dt.INT64, f"{which}_scalar")
            return _wrap_scalar(idx, s, _dt.INT64, f"arg{which}")
        raise ValueError(f"Bad axis for vector argminmax: {axis}")
    if axis == "row":
        idx, s = _dm.argminmax_axis(values, struct, which, 1, parent.dtype)
        return _wrap_vector(idx, s, _dt.INT64, f"arg{which}_rowwise")
    if axis == "col":
        idx, s = _dm.argminmax_axis(values, struct, which, 0, parent.dtype)
        return _wrap_vector(idx, s, _dt.INT64, f"arg{which}_columnwise")
    # scalar: index into flattened row-major order
    flat_v, flat_s = _dm.flatten_matrix(values, struct)
    idx, s = _dm.argminmax_axis(flat_v, flat_s, which, 0, parent.dtype)
    return _wrap_scalar(idx, s, _dt.INT64, f"arg{which}")


def agg_firstlast(parent, axis, which, out_kind):
    """first/last (value or index) along an axis."""
    values, struct = parent._values, parent._struct
    if parent.ndim == 1:
        vals, idx, s = _dm.firstlast_axis(values, struct, which, 0)
        out = idx if out_kind == "index" else vals
        dtype = _dt.INT64 if out_kind == "index" else parent.dtype
        if axis == "all":
            return _wrap_scalar(out, s, dtype, which)
        return _wrap_scalar(out, s, dtype, which)
    if axis in {"row", "col"}:
        ax = 1 if axis == "row" else 0
        vals, idx, s = _dm.firstlast_axis(values, struct, which, ax)
        out = idx if out_kind == "index" else vals
        dtype = _dt.INT64 if out_kind == "index" else parent.dtype
        return _wrap_vector(out, s, dtype, f"{which}_{axis}wise")
    flat_v, flat_s = _dm.flatten_matrix(values, struct)
    vals, idx, s = _dm.firstlast_axis(flat_v, flat_s, which, 0)
    out = idx if out_kind == "index" else vals
    dtype = _dt.INT64 if out_kind == "index" else parent.dtype
    return _wrap_scalar(out, s, dtype, which)

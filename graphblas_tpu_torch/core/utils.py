"""Shared helpers (counterpart of ``graphblas_tpu/core/utils.py``).

numpy index and value normalization, documentation helpers, and the device
rule of the collections: ``collection_device`` names the device of new
collections (``tx.config["platform"]``: "cuda", the default, or "cpu"), and
``device_asarray`` puts host values there as the carrier tensor of their
type.  The reference's routing of complex values to the host
(``device_asarray``'s TPU branch) is not ported: CUDA computes in complex.
The UDT helpers build and read the struct-of-arrays form of a
user-defined type: a dict of field tensors under one structure.
"""

import numpy as np
import torch

from .. import exceptions as _exc


def wrapdoc(func_with_doc):
    """Decorator to copy the docstring from another function."""

    def inner(func):
        func.__doc__ = func_with_doc.__doc__
        return func

    return inner


def output_type(val):
    """Return the class used to dispatch on a (possibly expression) object."""
    return getattr(val, "_output_type", type(val))


def ints_to_numpy_buffer(array, dtype, *, name="array", copy=False, ownable=False, order="C"):
    """Normalize an int sequence to a numpy array, checking integrality."""
    if (
        isinstance(array, np.ndarray)
        and not np.issubdtype(array.dtype, np.integer)
        and not np.issubdtype(array.dtype, np.bool_)
    ):
        raise ValueError(f"{name} must be integers, not {array.dtype.name}")
    return np.array(array, dtype=dtype, copy=copy or None, order=order).reshape(-1)


def values_to_numpy_buffer(array, dtype=None, *, copy=False, subarray_after=None):
    """Normalize a value sequence to a numpy array + resolved DataType."""
    from . import dtypes as _dtypes

    if dtype is not None:
        dtype = _dtypes.lookup_dtype(dtype)
        array = np.array(array, dtype=dtype.np_type, copy=copy or None)
    else:
        is_input_np = isinstance(array, np.ndarray)
        array = np.array(array, copy=copy or None)
        if array.dtype.hasobject:
            raise ValueError("object dtype for values is not allowed")
        if not is_input_np and array.dtype == np.int32:
            # normalize platform-dependent default int
            array = array.astype(np.int64)
        dtype = _dtypes.lookup_dtype(array.dtype)
    return array, dtype


def get_shape(nrows, ncols, dtype=None, **arrays):
    """Infer (nrows, ncols) from provided arrays when not given explicitly."""
    if nrows is None or ncols is None:
        arr = next((a for a in arrays.values() if a is not None and getattr(a, "ndim", 0) == 2), None)
        if arr is not None:
            if nrows is None:
                nrows = arr.shape[0]
            if ncols is None:
                ncols = arr.shape[1]
        if nrows is None or ncols is None:
            raise ValueError("No way to determine the shape; please provide nrows and ncols")
    return int(nrows), int(ncols)


def normalize_chunks(chunks, shape):
    """Normalize a chunks argument (dask-like) into a list of per-dimension
    block sizes (used by ``Matrix.tx.split`` in the reference).

    Accepts: int (same for all dims), tuple/list of per-dim spec where each is
    int, None (whole dim), or a collection of explicit sizes.
    """
    if isinstance(chunks, (int, np.integer)) or chunks is None:
        chunks = (chunks,) * len(shape)
    if len(chunks) != len(shape):
        raise ValueError(f"chunks argument must be of length {len(shape)} (one per dimension)")
    chunksizes = []
    for size, chunk in zip(shape, chunks):
        if chunk is None:
            cur = [size]
        elif isinstance(chunk, (int, np.integer)):
            if chunk <= 0:
                raise ValueError(f"Chunksize must be greater than 0; got: {chunk}")
            div, mod = divmod(size, chunk)
            cur = [chunk] * div
            if mod:
                cur.append(mod)
            if not cur:
                cur = [0] if size == 0 else [size]
        else:
            cur = [int(c) for c in chunk]
            total = sum(c for c in cur if c >= 0)
            negs = [i for i, c in enumerate(cur) if c < 0]
            if len(negs) > 1:
                raise ValueError("only one -1 wildcard allowed in chunk sizes")
            if negs:
                cur[negs[0]] = size - total
                if cur[negs[0]] < 0:
                    raise ValueError(f"chunks are too large for dimension of size {size}")
            elif total != size:
                raise ValueError(f"chunks {cur} do not add up to dimension size {size}")
        chunksizes.append(cur)
    return chunksizes


def ensure_int(x, name="argument"):
    if isinstance(x, (bool, np.bool_)) or not isinstance(x, (int, np.integer)):
        raise TypeError(f"{name} must be an integer; got {type(x).__name__}")
    return int(x)


def check_index(idx, size, name="index"):
    idx = ensure_int(idx, name)
    if idx < 0:
        idx += size
    if idx < 0 or idx >= size:
        raise _exc.IndexOutOfBound(f"{name} {idx} out of range for dimension of size {size}")
    return idx


class class_property:
    """Descriptor: class-level property (used for default names etc.)."""

    def __init__(self, fget):
        self.fget = fget

    def __get__(self, obj, objtype=None):
        return self.fget(objtype)


def _udt_scalar(value, np_type):
    """Coerce a tuple / dict / structured scalar to a 0-d structured scalar."""
    if isinstance(value, np.void):
        return value
    if isinstance(value, dict):
        value = tuple(value[f] for f in np_type.names)
    elif not isinstance(value, (tuple, list)):
        value = tuple(value for _ in np_type.names)
    return np.asarray(tuple(value), np_type)[()]


def udt_struct_from_missing(values, missing_value, np_type):
    """Present-mask for a dense structured array: absent where every field
    equals missing_value (GxB import semantics for UDTs)."""
    if missing_value is None:
        return np.ones(values.shape, bool)
    mv = _udt_scalar(missing_value, np_type)
    eq = np.logical_and.reduce([values[f] == mv[f] for f in np_type.names])
    return ~eq


def udt_fill_dense(values, struct, np_type, fill_value):
    """Dense structured array from SoA host values; absent entries get
    fill_value."""
    out = np.zeros(struct.shape, np_type)
    for f in np_type.names:
        out[f] = np.asarray(values[f])
    if fill_value is not None:
        out[~struct] = _udt_scalar(fill_value, np_type)
    return out


def fill_dense(values, struct, dtype, fill_value, out_dtype):
    """The host array of a dense collection's carrier ``values`` (``dtype``)
    with the entries absent from ``struct`` set to ``fill_value``, as
    ``out_dtype``.  Without a cast the fill runs on the values' device and
    one copy reaches the host; with one, the values and the structure come
    to the host and numpy casts and fills."""
    from . import dtypes as _dt
    from . import telemetry as _telemetry

    if out_dtype is dtype:
        fill = _dt.scalar_tensor(fill_value, dtype, values.device)
        filled = torch.where(struct, values, fill)
        with _telemetry.host_read("to_dense"):
            return _dt.host_array(filled, dtype)
    v = _dt.to_numpy(values, dtype).astype(out_dtype.np_type)
    with _telemetry.host_read("to_dense"):
        s = struct.cpu().numpy()
    return np.where(s, v, np.asarray(fill_value, out_dtype.np_type))


def zero_values(shape, dtype, device):
    """All-zero values of ``dtype`` on ``device``: the carrier tensor, or a
    dict of field tensors for a UDT."""
    from . import dtypes as _dt

    if dtype._is_udt:
        return {f: zero_values(shape, _dt.lookup_dtype(dtype.np_type[f]), device) for f in dtype.np_type.names}
    return torch.zeros(shape, dtype=dtype.carrier, device=device)


def canonical_device(device):
    """``device`` with its index (a CUDA device without one is the current
    card), so that it equals the device of the tensors made on it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def collection_device():
    """The device of new collections: ``tx.config["platform"]``."""
    from ..tx import config as _txconfig

    return canonical_device(_txconfig["platform"])


def device_asarray(x, dtype, device=None):
    """Host values -> the carrier tensor of ``dtype`` (numpy's conversion)
    on ``device`` (default: ``collection_device()``)."""
    from . import dtypes as _dt

    dtype = _dt.lookup_dtype(dtype)
    return _dt.to_tensor(np.asarray(x, dtype.np_type), dtype, collection_device() if device is None else device)

"""DataType registry on top of numpy dtypes, with the torch dtype each type
computes in.

Counterpart of ``graphblas_tpu/core/dtypes.py``: 13 builtin types plus an
index type, ``lookup_dtype`` resolution from many spellings, ``unify`` by
numpy promotion, and user-defined types (UDTs) registered from numpy
structured dtypes.  Each builtin type also has a *carrier*, the torch dtype
its device values are held in:

- every type torch computes in natively is its own carrier;
- UINT16 rides int32 and UINT32 rides int64, masked to their width after
  each arithmetic op (``wrap``);
- UINT64 rides int64 bit for bit: + - * and the bitwise ops are the same
  bits, and compare, min, max, division and conversion are done unsigned
  here (``ordered``, ``cast``) and in the operator modules;
- a UDT has no carrier: its values are dicts of field tensors (struct of
  arrays, as the reference stores them).

Values cross to numpy as the reference's dtype, bit for bit (``to_tensor``,
``to_numpy``).  Conversions follow the reference (XLA): float to integer
truncates and saturates, NaN converts to 0, integers wrap.
"""

import numpy as np
import torch

from .. import exceptions as _exc
from . import telemetry as _telemetry

_registry = {}  # many-spellings -> DataType

_CARRIERS = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.uint64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


class DataType:
    """A registered element type.

    Attributes
    ----------
    name : canonical python-graphblas name (e.g. ``"FP64"``)
    gb_name : GraphBLAS C API name (e.g. ``"GrB_FP64"``) or None for UDTs
    np_type : the numpy dtype of host values
    carrier : the torch dtype of device values (None for UDTs)
    """

    __slots__ = "name", "gb_name", "np_type", "_anonymous", "carrier"

    def __init__(self, name, gb_name, np_type, *, anonymous=False, carrier=None):
        self.name = name
        self.gb_name = gb_name
        self.np_type = np.dtype(np_type)
        self._anonymous = anonymous
        self.carrier = carrier if carrier is not None else _CARRIERS.get(self.np_type)

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        if type(other) is DataType:
            return self.name == other.name and self.np_type == other.np_type
        try:
            other = lookup_dtype(other)
        except ValueError:
            raise TypeError(f"Invalid or unknown datatype: {other!r}") from None
        return self.name == other.name and self.np_type == other.np_type

    def __hash__(self):
        return hash((self.name, self.np_type))

    def __reduce__(self):
        if self._is_udt:
            return (_string_to_dtype, (_dtype_to_string(self.np_type),))
        return self.name

    @property
    def _is_udt(self):
        return self.gb_name is None

    @property
    def _is_anonymous(self):
        return self._anonymous

    @property
    def _is_bool(self):
        return self.np_type == np.bool_

    @property
    def _is_int(self):
        return self.np_type.kind in "iu"

    @property
    def _is_signed_int(self):
        return self.np_type.kind == "i"

    @property
    def _is_unsigned_int(self):
        return self.np_type.kind == "u"

    @property
    def _is_float(self):
        return self.np_type.kind == "f"

    @property
    def _is_complex(self):
        return self.np_type.kind == "c"

    @property
    def _bits(self):
        return self.np_type.itemsize * 8

    @property
    def _masked(self):
        """Rides a wider carrier and is masked to its width (UINT16, UINT32)."""
        return self._is_unsigned_int and 8 < self._bits < 64


def register_new(name, dtype_spec):
    """Register a user-defined type under ``graphblas_tpu_torch.dtypes.<name>``."""
    if not name.isidentifier():
        raise ValueError(f"`name` argument must be a valid Python identifier; got: {name!r}")
    if _MODULE is None:  # lazily materialize the dtypes namespace
        import importlib

        importlib.import_module("graphblas_tpu_torch.dtypes")
    if name in _registry or hasattr(_MODULE, name):
        raise ValueError(f"{name!r} name for dtype is unavailable")
    rv = register_anonymous(dtype_spec, name)
    _registry[name] = rv
    setattr(_MODULE, name, rv)
    return rv


def register_anonymous(dtype_spec, name=None):
    """Register a UDT without a module-level name."""
    try:
        dtype = np.dtype(dtype_spec)
    except TypeError:
        if isinstance(dtype_spec, dict):
            # Allow e.g. {"x": int, "y": float}
            dtype = np.dtype([(key, lookup_dtype(val).np_type) for key, val in dtype_spec.items()])
        else:
            raise
    if dtype in _registry:
        rv = _registry[dtype]
        if name is not None and rv.name != name:
            raise ValueError(f"dtype {dtype} is already registered as {rv.name}")
        return rv
    if dtype.hasobject:
        raise ValueError("dtype must not allow Python objects")
    rv = DataType(name if name is not None else f"UDT{dtype}", None, dtype, anonymous=name is None)
    _registry[dtype] = rv
    _registry[dtype.str] = rv
    return rv


BOOL = DataType("BOOL", "GrB_BOOL", np.bool_)
INT8 = DataType("INT8", "GrB_INT8", np.int8)
INT16 = DataType("INT16", "GrB_INT16", np.int16)
INT32 = DataType("INT32", "GrB_INT32", np.int32)
INT64 = DataType("INT64", "GrB_INT64", np.int64)
UINT8 = DataType("UINT8", "GrB_UINT8", np.uint8)
UINT16 = DataType("UINT16", "GrB_UINT16", np.uint16)
UINT32 = DataType("UINT32", "GrB_UINT32", np.uint32)
UINT64 = DataType("UINT64", "GrB_UINT64", np.uint64)
FP32 = DataType("FP32", "GrB_FP32", np.float32)
FP64 = DataType("FP64", "GrB_FP64", np.float64)
FC32 = DataType("FC32", "GxB_FC32", np.complex64)
FC64 = DataType("FC64", "GxB_FC64", np.complex128)
# Index type used for positional ops and index extraction
_INDEX = DataType("UINT64", "GrB_Index", np.uint64)

# bfloat16, the reference's extension type, where numpy can name it
try:  # pragma: no cover - availability depends on ml_dtypes
    import ml_dtypes as _ml_dtypes

    BF16 = DataType("BF16", "GxB_BF16", np.dtype(_ml_dtypes.bfloat16), carrier=torch.bfloat16)
except ImportError:  # pragma: no cover
    _ml_dtypes = None
    BF16 = None

_BUILTINS = [BOOL, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64, FP32, FP64, FC32, FC64]

for _dt in _BUILTINS + ([BF16] if BF16 is not None else []):
    _registry[_dt.name] = _dt
    _registry[_dt.name.lower()] = _dt
    _registry[_dt.gb_name] = _dt
    _registry[_dt.np_type] = _dt
    _registry[_dt.np_type.name] = _dt
    _registry[_dt.np_type.str] = _dt
    _registry[_dt.np_type.type] = _dt

# Common aliases
for _alias, _dt in [
    (bool, BOOL),
    (int, INT64),
    (float, FP64),
    (complex, FC64),
    ("bool_", BOOL),
    ("int", INT64),
    ("float", FP64),
    ("complex", FC64),
    ("byte", INT8),
    ("ubyte", UINT8),
    ("intc", INT32),
    ("uintc", UINT32),
    ("longlong", INT64),
    ("ulonglong", UINT64),
    ("single", FP32),
    ("double", FP64),
    ("csingle", FC32),
    ("cdouble", FC64),
    ("half", FP32),  # fp16 maps up to FP32 for storage
]:
    _registry.setdefault(_alias, _dt)

# torch dtypes name the type they carry natively
_FROM_TORCH = {
    torch.bool: BOOL,
    torch.int8: INT8,
    torch.int16: INT16,
    torch.int32: INT32,
    torch.int64: INT64,
    torch.uint8: UINT8,
    torch.float32: FP32,
    torch.float64: FP64,
    torch.complex64: FC32,
    torch.complex128: FC64,
}
if BF16 is not None:
    _FROM_TORCH[torch.bfloat16] = BF16
for _td, _dt in _FROM_TORCH.items():
    _registry.setdefault(_td, _dt)


def lookup_dtype(key, value=None):
    """Resolve many spellings of a dtype to a registered DataType.

    Unknown numpy dtypes (e.g. structured dtypes) are auto-registered as
    anonymous UDTs.  A torch dtype names the type it carries natively."""
    if key is None:
        if value is not None:
            if isinstance(value, torch.Tensor):
                return lookup_dtype(value.dtype)
            return lookup_dtype(np.asarray(value).dtype)
        raise TypeError("Bad dtype: None")
    if type(key) is DataType:
        return key
    try:
        hashable = True
        if key in _registry:
            return _registry[key]
    except TypeError:
        hashable = False
    if isinstance(key, str):
        upper = key.upper()
        if upper in _registry:
            return _registry[upper]
    try:
        np_type = np.dtype(key)
    except Exception:
        np_type = None
    if np_type is not None:
        if np_type in _registry:
            rv = _registry[np_type]
            if hashable:
                _registry[key] = rv
            return rv
        # auto-register unknown (e.g. structured) dtype
        return register_anonymous(np_type)
    raise ValueError(f"Unknown dtype: {key!r}")


def unify(type1, type2, *, is_left_scalar=False, is_right_scalar=False):
    """Numpy-style promotion of two DataTypes."""
    if type1 is type2 or type1 == type2:
        return type1
    if type1._is_udt or type2._is_udt:
        if type1._is_udt and type2._is_udt and type1.np_type == type2.np_type:
            return type1
        raise _exc.DomainMismatch(f"Cannot unify UDTs {type1.name} and {type2.name}")
    return _promote(type1, type2)


def _promote(type1, type2):
    return lookup_dtype(np.promote_types(type1.np_type, type2.np_type))


def executes_64bit():
    """True: device tensors carry 64-bit types at full width (the reference's
    CPU runs also enable x64)."""
    return True


def default_float():
    return FP64


def default_int():
    return INT64


def executed_np(np_type):
    """The numpy dtype of host values of ``np_type`` (full width here)."""
    return np.dtype(np_type)


def _supports_complex():
    return True


# --- carriers: host <-> device, wrap, order, conversion ----------------------

_I64_MIN = -(1 << 63)


def to_tensor(values, dtype, device):
    """Host values (numpy) -> a tensor of ``dtype``'s carrier on ``device``
    (``dtype`` None: the values' own type); a UDT gives a dict of field
    tensors.  The caller names the device: nothing here picks one."""
    arr = np.asarray(values)
    dtype = lookup_dtype(arr.dtype) if dtype is None else lookup_dtype(dtype)
    scalar = arr.ndim == 0
    if dtype._is_udt:
        # each field copied out of the records (a field view's strides need
        # not be a multiple of its item size)
        return {f: to_tensor(np.array(arr[f]), None, device) for f in dtype.np_type.names}
    shape = arr.shape
    arr = np.ascontiguousarray(arr.astype(dtype.np_type, copy=False))
    if dtype.np_type == np.uint64:
        t = torch.from_numpy(arr.view(np.int64))
    elif dtype.carrier == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif dtype._masked:
        t = torch.from_numpy(arr.astype(np.int64 if dtype._bits == 32 else np.int32))
    else:
        t = torch.from_numpy(arr)
    from . import capture as _cap

    # the input's own shape: np.ascontiguousarray makes a 0-d array 1-d
    t = t.reshape(shape)
    if _cap.active() is not None:
        if scalar:
            # a constant scalar inside a compiled loop: a fill on the device,
            # which a CUDA graph captures (a host-to-device copy it cannot)
            with _cap.constants():
                value = t.item()
            return _cap.fill(value, t.dtype, device)
        return _cap.upload(t, device)
    return t.to(device)


def to_numpy(t, dtype):
    """A carrier tensor of ``dtype`` -> numpy of the reference's dtype, bit
    for bit (a dict of field tensors for a UDT).  One host read
    (``core.telemetry.host_read``)."""
    with _telemetry.host_read("to_numpy"):
        return host_array(t, dtype)


def host_array(t, dtype):
    """``to_numpy`` without its count: for a caller that counts the read."""
    dtype = lookup_dtype(dtype)
    if dtype._is_udt:
        first = next(iter(t.values()))
        out = np.empty(first.shape, dtype.np_type)
        for f in dtype.np_type.names:
            out[f] = host_array(t[f], lookup_dtype(dtype.np_type[f]))
        return out
    t = t.detach().cpu()
    if dtype.carrier == torch.bfloat16:
        return t.view(torch.int16).numpy().view(dtype.np_type)
    arr = t.numpy()
    if dtype.np_type == np.uint64:
        return arr.view(np.uint64)
    return arr.astype(dtype.np_type, copy=False)


def scalar_tensor(value, dtype, device):
    """A 0-d carrier tensor of a host scalar of ``dtype``."""
    return to_tensor(np.asarray(value, dtype.np_type), dtype, device).reshape(())


def wrap(t, dtype):
    """Carrier values reduced to ``dtype``'s width (UINT16, UINT32)."""
    if dtype._masked:
        return t & ((1 << dtype._bits) - 1)
    return t


def ordered(t, dtype):
    """Values whose signed order is ``dtype``'s order: UINT64 with its sign
    bit flipped (its own inverse); every other carrier as it is."""
    if dtype.np_type == np.uint64:
        return t ^ _I64_MIN
    return t


def lshr(t, k, bits):
    """Logical right shift of two's complement ``bits``-wide values."""
    return (t >> k) & ((1 << (bits - k)) - 1) if k else t


def _uint64_to_float(t, carrier):
    """int64 bits read as uint64 -> float, rounded once: values past 2^63
    are halved keeping the lost bit sticky, converted, then doubled."""
    halved = lshr(t, 1, 64) | (t & 1)
    return torch.where(t < 0, halved.to(carrier) * 2, t.to(carrier))


def _float_to_int(x, dtype):
    """Truncate toward zero, saturate at ``dtype``'s range, NaN -> 0 (XLA)."""
    x = torch.nan_to_num(x.double().trunc(), nan=0.0, posinf=np.inf, neginf=-np.inf)
    two63, below = 2.0**63, 2.0**63 - 1024  # the largest double under 2^63
    if dtype.np_type == np.uint64:
        big = x >= two63
        v = torch.where(big, x - two63, x).clamp(0, below).to(torch.int64)
        v = torch.where(big, v + _I64_MIN, v)
        return torch.where(x >= 2 * two63, torch.full_like(v, -1), v)
    info = np.iinfo(dtype.np_type)
    if dtype.np_type == np.int64:
        v = x.clamp(-two63, below).to(torch.int64)
        return torch.where(x >= two63, torch.full_like(v, info.max), v)
    return x.clamp(float(info.min), float(info.max)).to(torch.int64).to(dtype.carrier)


def cast(t, src, dst):
    """Convert a carrier tensor of type ``src`` to ``dst``'s carrier, as the
    reference's ``astype`` converts."""
    if src == dst:
        return t
    if src._is_udt or dst._is_udt:
        raise _exc.DomainMismatch(f"Cannot convert {src.name} to {dst.name}")
    if dst._is_bool:
        return t != 0
    if src._is_complex and not dst._is_complex:
        t, src = t.real, (FP32 if src == FC32 else FP64)
    if dst._is_int:
        if src._is_float:
            return wrap(_float_to_int(t, dst), dst)
        return wrap(t.to(dst.carrier), dst)
    # to a float or complex type
    if src.np_type == np.uint64:
        real = _uint64_to_float(t, torch.float64 if dst.carrier in (torch.float64, torch.complex128) else torch.float32)
        return real.to(dst.carrier)
    return t.to(dst.carrier)


# --- UDT string serialization ------------------------------------------------


def _dtype_to_string(np_type):
    """Convert a numpy dtype to a string eval-able back to the same dtype."""
    if np_type in _registry and not _registry[np_type]._is_udt:
        return repr(_registry[np_type].name)
    s = str(np_type)
    try:
        if np.dtype(eval(s, {}, {})) == np_type:  # noqa: S307
            return s
    except Exception:
        pass
    return repr(s)


def _string_to_dtype(s):
    """Inverse of _dtype_to_string."""
    try:
        return lookup_dtype(s)
    except ValueError:
        pass
    try:
        obj = eval(s, {}, {})  # noqa: S307
    except Exception as exc:
        raise ValueError(f"Unknown dtype: {s!r}") from exc
    try:
        return lookup_dtype(obj)
    except ValueError:
        return lookup_dtype(np.dtype(obj))


_MODULE = None  # set by the graphblas_tpu_torch.dtypes package at import

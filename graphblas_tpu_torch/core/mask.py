"""The four GraphBLAS mask types.

Counterpart of ``graphblas_tpu/core/mask.py``.  python-graphblas combines
masks through a 16-case recipe table; the dense-masked engine resolves any
mask to a bool tensor (``ops.densemasked.mask_to_bits``), so combining two
masks is one elementwise op.
"""

from .. import exceptions as _exc


class Mask:
    __slots__ = "parent", "name"
    complement = False
    structure = False
    value = False

    def __init__(self, mask, name=None):
        self.parent = mask
        self.name = name

    def __eq__(self, other):
        raise TypeError(f"__eq__ not defined for objects of type {type(self)}")

    def __bool__(self):
        raise TypeError(f"__bool__ not defined for objects of type {type(self)}")

    def __repr__(self):
        from .formatting import format_mask

        return format_mask(self)

    def _repr_html_(self):
        from .formatting import format_matrix_html, format_vector_html

        if self.parent.ndim == 2:
            return format_matrix_html(self.parent, mask=self)
        return format_vector_html(self.parent, mask=self)

    @property
    def _carg(self):
        return self.parent.name or "M"

    def _bits(self):
        """Resolve to a dense bool tensor on the parent's device."""
        from ..ops import densemasked as _dm

        bits = _dm.mask_to_bits(self.parent._values, self.parent._struct, self.complement, self.structure)
        if self.complement:
            bits = _edge_guard(bits)
        return bits

    def new(self, dtype=None, *, complement=False, mask=None, name=None, **opts):
        """Materialize the mask pattern as a collection of True values."""
        from . import dtypes as _dt

        bits = self._bits()
        if complement:
            bits = _edge_guard(~bits)
        if mask is not None:
            if not isinstance(mask, Mask):
                raise TypeError("Mask must be a Mask object")
            bits = bits & mask._bits()
        dtype = _dt.lookup_dtype(dtype) if dtype is not None else _dt.BOOL
        cls = type(self.parent)
        vals = _dt.cast(bits, _dt.BOOL, dtype)
        return cls._from_arrays(vals, bits, dtype, name=name)

    def _combine(self, other, op):
        """mask & mask / mask | mask -> new structural mask (in place of the
        recipe tables)."""
        from . import dtypes as _dt

        if not isinstance(other, Mask):
            raise TypeError(f"Expected Mask; got {type(other)}")
        if self.parent.shape != other.parent.shape:
            raise _exc.DimensionMismatch("Mask shapes do not match")
        bits = op(self._bits(), other._bits())
        cls = type(self.parent)
        collection = cls._from_arrays(bits, bits, _dt.BOOL)
        return StructuralMask(collection)

    def __and__(self, other):
        return self._combine(other, lambda a, b: a & b)

    def __or__(self, other):
        return self._combine(other, lambda a, b: a | b)

    __rand__ = __and__
    __ror__ = __or__


def _edge_guard(bits):
    """In an edge-layout loop body a complemented mask's universe is the
    state slots, never the other slots (core/looplayout.py)."""
    from . import looplayout as _ll

    ctx = _ll.active()
    if ctx is not None and bits.dim() == 1 and bits.shape[0] == ctx.e_pad:
        return ctx.guard_universe(bits)
    return bits


class StructuralMask(Mask):
    __slots__ = ()
    complement = False
    structure = True

    def __invert__(self):
        return ComplementedStructuralMask(self.parent)

    @property
    def name(self):
        return f"{self.parent.name or 'M'}.S"

    @name.setter
    def name(self, value):
        pass


class ValueMask(Mask):
    __slots__ = ()
    complement = False
    value = True

    def __invert__(self):
        return ComplementedValueMask(self.parent)

    @property
    def name(self):
        return f"{self.parent.name or 'M'}.V"

    @name.setter
    def name(self, value):
        pass


class ComplementedStructuralMask(Mask):
    __slots__ = ()
    complement = True
    structure = True

    def __invert__(self):
        return StructuralMask(self.parent)

    @property
    def name(self):
        return f"~{self.parent.name or 'M'}.S"

    @name.setter
    def name(self, value):
        pass


class ComplementedValueMask(Mask):
    __slots__ = ()
    complement = True
    value = True

    def __invert__(self):
        return ValueMask(self.parent)

    @property
    def name(self):
        return f"~{self.parent.name or 'M'}.V"

    @name.setter
    def name(self, value):
        pass

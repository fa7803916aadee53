"""Semiring: a Monoid (add) combined with a BinaryOp (multiply).

Counterpart of ``graphblas_tpu/core/operator/semiring.py``, a copy.
python-graphblas registers hundreds of names by regexing C symbols; here any ``<monoid>_<binaryop>`` name resolves lazily via
``get_semiring``, with a curated popular set registered eagerly.
"""

from .. import dtypes as _dt
from . import base as _b
from .base import OpBase, TypedSemiring


class Semiring(OpBase):
    _typed_class = TypedSemiring
    _modname = "semiring"
    positional = None

    def __init__(self, name, monoid=None, binaryop=None, *, anonymous=False):
        super().__init__(name, anonymous=anonymous)
        self.monoid = monoid
        self.binaryop = binaryop

    @property
    def is_positional(self):
        return self.binaryop.is_positional

    def __call__(self, left, right=None):
        return _b._call_op(self, left, right)

    def __getitem__(self, type_):
        dtype = _dt.lookup_dtype(type_)
        return self._typed(dtype, dtype)

    def _typed(self, dt1, dt2):
        key = (dt1, dt2)
        if key in self._typed_ops:
            return self._typed_ops[key]
        mul = _lookup_with_coercion(self.binaryop, _dt.unify(dt1, dt2) if dt1 != dt2 else dt1)
        add = _lookup_with_coercion(self.monoid, mul.return_type)
        typed = TypedSemiring(self, self.name, mul.type_, add.return_type, add, mul, type2=mul.type2)
        self._typed_ops[key] = typed
        if dt1 is dt2 or dt1 == dt2:
            # only homogeneous lookups define the public per-dtype table; a
            # mixed (dt1, dt2) lookup unifies dtypes and must NOT overwrite
            # types[dt1] (one mixed call would corrupt the table process-wide;
            # reference keeps coercions separate: core/operator/semiring.py:424-588)
            self.types[dt1] = add.return_type
        return typed

    def __contains__(self, type_):
        try:
            self[type_]
        except (TypeError, KeyError, ValueError):
            return False
        return True

    @classmethod
    def register_anonymous(cls, monoid, binaryop, name=None):
        from .utils import get_semiring

        return get_semiring(monoid, binaryop, name=name)

    @classmethod
    def register_new(cls, name, monoid, binaryop, *, lazy=False):
        import graphblas_tpu_torch.semiring as semiring_module

        from .unary import _dotted_set
        from .utils import get_semiring

        sr = get_semiring(monoid, binaryop, name=name.rsplit(".", 1)[-1])
        sr._anonymous = False
        _dotted_set(semiring_module, name, sr)
        return sr


def _lookup_with_coercion(op, dtype):
    try:
        return op[dtype]
    except KeyError:
        # positional-mul semirings take any input dtype
        if getattr(op, "is_positional", False):
            return op[_dt.INT64]
        raise


# Curated popular set registered eagerly for dir()/docs; every other
# `<monoid>_<binaryop>` combination resolves lazily through the namespace's
# __getattr__ (see graphblas_tpu_torch/semiring/__init__.py).
_EAGER = [
    "plus_times",
    "plus_plus",
    "plus_min",
    "plus_max",
    "plus_first",
    "plus_second",
    "plus_pair",
    "plus_oneb",
    "plus_land",
    "plus_lor",
    "min_plus",
    "min_times",
    "min_first",
    "min_second",
    "min_max",
    "min_min",
    "min_secondi",
    "min_firsti",
    "max_plus",
    "max_times",
    "max_first",
    "max_second",
    "max_min",
    "max_max",
    "max_secondi",
    "times_plus",
    "times_times",
    "any_pair",
    "any_first",
    "any_second",
    "any_secondi",
    "any_secondi1",
    "any_firsti",
    "any_firstj",
    "any_secondj",
    "any_times",
    "any_plus",
    "lor_land",
    "land_lor",
    "lxor_land",
    "lxnor_lxnor",
    "eq_eq",
    "lor_first",
    "lor_second",
    "lor_pair",
    "band_bor",
    "bor_band",
    "plus_pow",
    "min_truediv",
    "plus_truediv",
]


def _initialize(module, monoid_module, binary_module):
    from .utils import get_semiring

    ops = {}
    for name in _EAGER:
        add_name, mul_name = name.split("_", 1)
        monoid = getattr(monoid_module, add_name)
        binop = getattr(binary_module, mul_name)
        ops[name] = get_semiring(monoid, binop, name=name)
    for name, op in ops.items():
        setattr(module, name, op)
    module._ops = ops
    return ops

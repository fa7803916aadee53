"""Monoid: an associative+commutative BinaryOp with an identity.

Counterpart of ``graphblas_tpu/core/operator/monoid.py``, a copy: identities
are numpy scalars of the monoid's type, as there.
"""

import numpy as np

from .. import dtypes as _dt
from ... import exceptions as _exc
from . import base as _b
from .base import BOOLS, FCS, NUMS, SINTS, UINTS, OpBase, TypedMonoid
from .binary import BinaryOp


class Monoid(OpBase):
    _typed_class = TypedMonoid
    _modname = "monoid"
    _nargs = 2
    positional = None

    def __init__(self, name, binaryop=None, identity_spec=None, *, anonymous=False, is_idempotent=False):
        super().__init__(name, anonymous=anonymous)
        self.binaryop = binaryop
        self._identity_spec = identity_spec
        self.is_idempotent = is_idempotent
        if binaryop is not None:
            binaryop._monoid = self

    @property
    def identities(self):
        return {dtype: op.identity for dtype, op in self._typed_ops.items()}

    def __call__(self, left, right=None):
        return _b._call_op(self, left, right)

    def __getitem__(self, type_):
        dtype = _dt.lookup_dtype(type_)
        if dtype in self._typed_ops:
            return self._typed_ops[dtype]
        if dtype in self.coercions:
            return self._typed_ops[self.coercions[dtype]]
        # build on demand from the binaryop (covers UDTs and unusual dtypes)
        if self.binaryop is not None:
            try:
                typed_bin = self.binaryop[dtype]
            except (KeyError, _exc.UdfParseError):
                typed_bin = None
            if typed_bin is not None and (
                typed_bin.return_type == dtype
                or (dtype._is_udt and typed_bin.return_type._is_udt)
            ):
                identity = _resolve_identity(self._identity_spec, dtype)
                if (
                    identity is None
                    and isinstance(self._identity_spec, dict)
                    and not dtype._is_udt
                ):
                    # per-dtype identity dict restricts the monoid's domain
                    # (reference: monoid/numpy.py identity tables limit e.g.
                    # logical_and to BOOL, hypot to floats)
                    raise KeyError(f"{self.name} does not work with {dtype}")
                typed = TypedMonoid(self, self.name, dtype, dtype, typed_bin.fn, typed_bin, identity)
                self._add(typed)
                return typed
        raise KeyError(f"{self.name} does not work with {dtype}")

    @classmethod
    def register_anonymous(cls, binaryop, identity, name=None, *, is_idempotent=False):
        """Create a Monoid from a BinaryOp and identity (reference: monoid.py:309-360)."""
        binaryop, opclass = _b.find_opclass(binaryop)
        if opclass == "UserDefined" or callable(binaryop) and not isinstance(binaryop, OpBase):
            binaryop = BinaryOp.register_anonymous(binaryop)
        monoid = cls(
            name or f"monoid.{binaryop.name}", binaryop, identity, anonymous=True, is_idempotent=is_idempotent
        )
        _populate_from_binary(monoid, binaryop, identity)
        return monoid

    @classmethod
    def register_new(cls, name, binaryop, identity, *, is_idempotent=False, lazy=False):
        import graphblas_tpu_torch.monoid as monoid_module

        from .unary import _dotted_set

        monoid = cls.register_anonymous(binaryop, identity, name.rsplit(".", 1)[-1], is_idempotent=is_idempotent)
        monoid._anonymous = False
        _dotted_set(monoid_module, name, monoid)
        return monoid


def _resolve_identity(spec, dtype):
    if callable(spec):
        return spec(dtype)
    if dtype._is_udt:
        # for UDTs a dict spec gives per-field identity values; the generic
        # present-aware reduce doesn't consult it, so keep it raw
        return spec
    if isinstance(spec, dict):
        spec = spec.get(dtype, spec.get(dtype.name))
    if spec is None:
        return None
    return np.asarray(spec, dtype.np_type)[()]


def _populate_from_binary(monoid, binaryop, identity_spec):
    for dtype, ret in binaryop.types.items():
        if ret != dtype:
            continue  # monoid domain must be closed
        identity = _resolve_identity(identity_spec, dtype)
        if identity is None and isinstance(identity_spec, dict) and not dtype._is_udt:
            continue  # per-dtype identity dict restricts the domain
        typed_bin = binaryop[dtype]
        monoid._add(TypedMonoid(monoid, monoid.name, dtype, dtype, typed_bin.fn, typed_bin, identity))
    monoid.coercions.update(binaryop.coercions)


# --- builtin identities ------------------------------------------------------


def _max_value(dtype):
    if dtype._is_bool:
        return np.bool_(True)
    if dtype._is_int:
        return np.asarray(np.iinfo(dtype.np_type).max, dtype.np_type)[()]
    return np.asarray(np.inf, dtype.np_type)[()]


def _min_value(dtype):
    if dtype._is_bool:
        return np.bool_(False)
    if dtype._is_int:
        return np.asarray(np.iinfo(dtype.np_type).min, dtype.np_type)[()]
    return np.asarray(-np.inf, dtype.np_type)[()]


def _all_ones(dtype):
    return np.asarray(~np.asarray(0, dtype.np_type), dtype.np_type)[()]


def _initialize(module, binary_module):
    """Populate the ``graphblas_tpu_torch.monoid`` namespace
    (reference monoid list: core/operator/monoid.py:239-256)."""
    b = binary_module
    ops = {}

    def make(name, binaryop, identity, domains=None, *, idempotent=False):
        monoid = Monoid(name, binaryop, identity, is_idempotent=idempotent)
        for dtype, ret in binaryop.types.items():
            if domains is not None and dtype not in domains:
                continue
            if ret != dtype:
                continue
            typed_bin = binaryop[dtype]
            monoid._add(
                TypedMonoid(
                    monoid, name, dtype, dtype, typed_bin.fn, typed_bin, _resolve_identity(identity, dtype)
                )
            )
        ops[name] = monoid
        return monoid

    make("min", b.min, _max_value, idempotent=True)
    make("max", b.max, _min_value, idempotent=True)
    make("plus", b.plus, 0, BOOLS + NUMS + FCS)
    make("times", b.times, 1, BOOLS + NUMS + FCS)
    make("any", b.any, None, idempotent=True)
    land = make("land", b.land, True, BOOLS, idempotent=True)
    lor = make("lor", b.lor, False, BOOLS, idempotent=True)
    lxor = make("lxor", b.lxor, False, BOOLS)
    lxnor = make("lxnor", b.lxnor, True, BOOLS)
    eq = make("eq", b.eq, True, BOOLS)
    # numeric inputs coerce to BOOL for the logical monoids (reference installs
    # identical coercions when regex-parsing the C symbols)
    for monoid in (land, lor, lxor, lxnor, eq):
        for dtype in NUMS:
            monoid.coercions[dtype] = _dt.BOOL
    band = make("band", b.band, _all_ones, UINTS, idempotent=True)
    bor = make("bor", b.bor, 0, UINTS, idempotent=True)
    bxor = make("bxor", b.bxor, 0, UINTS)
    bxnor = make("bxnor", b.bxnor, _all_ones, UINTS)
    for monoid in (band, bor, bxor, bxnor):
        for sdtype, udtype in zip(SINTS, UINTS):
            monoid.coercions[sdtype] = udtype

    for name, op in ops.items():
        setattr(module, name, op)
    module._ops = ops
    return ops

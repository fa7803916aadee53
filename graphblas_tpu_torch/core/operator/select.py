"""SelectOp: a BOOL-returning IndexUnaryOp used by Matrix/Vector.select.

Counterpart of ``graphblas_tpu/core/operator/select.py``, a copy: a SelectOp
shares the underlying op with the IndexUnaryOp registry.
"""

from .. import dtypes as _dt
from . import base as _b
from .base import OpBase, ParameterizedUdf, TypedSelectOp
from .indexunary import IndexUnaryOp
from .unary import _dotted_set


class SelectOp(OpBase):
    _typed_class = TypedSelectOp
    _modname = "select"
    _nargs = 1

    def __init__(self, name, *, anonymous=False):
        super().__init__(name, anonymous=anonymous)
        self._iu = None  # backing IndexUnaryOp
        self.positional = None
        self._thunk_dtype = None

    def __call__(self, val, thunk=None):
        return _b._call_op(self, val, thunk=thunk)

    @classmethod
    def _from_indexunary(cls, iu):
        sel = cls(iu.name, anonymous=iu._anonymous)
        sel._iu = iu
        sel.positional = iu.positional
        sel._thunk_dtype = iu._thunk_dtype
        sel.orig_func = iu.orig_func
        for dtype, ret in iu.types.items():
            if ret is not _dt.BOOL:
                raise ValueError("SelectOp must return BOOL")
            typed_iu = iu[dtype]
            sel._add(TypedSelectOp(sel, sel.name, dtype, _dt.BOOL, typed_iu.fn))
        sel.coercions.update(iu.coercions)
        return sel

    def _compile_dtype(self, dtype):
        if self._iu is None:
            return None
        typed_iu = self._iu[dtype]
        if typed_iu.return_type is not _dt.BOOL:
            raise KeyError(f"{self.name} does not return BOOL for {dtype}")
        typed = TypedSelectOp(self, self.name, dtype, _dt.BOOL, typed_iu.fn)
        self._add(typed)
        return typed

    @classmethod
    def register_anonymous(cls, func, name=None, *, parameterized=False, is_udt=False):
        if parameterized:
            return ParameterizedUdf(name or "select.anonymous", func, True, cls.register_anonymous)
        iu = IndexUnaryOp.register_anonymous(func, name, is_udt=is_udt)
        bad = {dt: ret for dt, ret in iu.types.items() if ret is not _dt.BOOL}
        for dt in bad:
            del iu.types[dt]
            del iu._typed_ops[dt]
        if not iu.types:
            raise ValueError("SelectOp function must return BOOL")
        return cls._from_indexunary(iu)

    @classmethod
    def register_new(cls, name, func, *, parameterized=False, is_udt=False, lazy=False):
        import graphblas_tpu_torch.indexunary as iu_module
        import graphblas_tpu_torch.select as select_module

        if parameterized:
            op = ParameterizedUdf(name, func, False, cls.register_anonymous)
            _dotted_set(select_module, name, op)
            return op
        sel = cls.register_anonymous(func, name.rsplit(".", 1)[-1], is_udt=is_udt)
        sel._anonymous = False
        sel._iu._anonymous = False
        _dotted_set(select_module, name, sel)
        _dotted_set(iu_module, name, sel._iu)
        return sel


def _initialize(module, indexunary_module):
    """Bool-returning builtin IndexUnaryOps are mirrored here
    (reference: select.py:119-160)."""
    ops = {}
    for name, iu in indexunary_module._ops.items():
        if all(ret is _dt.BOOL for ret in iu.types.values()):
            ops[name] = SelectOp._from_indexunary(iu)
    for name, op in ops.items():
        setattr(module, name, op)
    module._ops = ops
    return ops

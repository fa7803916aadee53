"""IndexUnaryOp: f(value, row, col, thunk).

Counterpart of ``graphblas_tpu/core/operator/indexunary.py``, its builtins
written in torch.  For vectors, col is 0.  Bool-returning ops are lifted into
SelectOp as well.
"""

from .. import dtypes as _dt
from . import _math as _m
from . import base as _b
from .base import ALL, BOOLS, NUMS, OpBase, ParameterizedUdf, TypedIndexUnaryOp
from .unary import _dotted_set


class IndexUnaryOp(OpBase):
    _typed_class = TypedIndexUnaryOp
    _modname = "indexunary"
    _nargs = 1
    positional = None

    def __init__(self, name, *, anonymous=False):
        super().__init__(name, anonymous=anonymous)
        self._thunk_dtype = None  # None -> same as value dtype

    def __call__(self, val, thunk=None):
        return _b._call_op(self, val, thunk=thunk)

    def _compile_dtype(self, dtype):
        if self.orig_func is None:
            return None
        ret = _b._output_dtype_of(
            lambda v, i, j, t: self.orig_func(v, i, j, t),
            dtype,
            _dt.INT64,
            _dt.INT64,
            dtype,
        )
        typed = TypedIndexUnaryOp(self, self.name, dtype, ret, _b.udf_fn(self.orig_func, ret, [dtype, _dt.INT64, _dt.INT64, dtype]))
        self._typed_ops[dtype] = typed
        self.types[dtype] = ret
        return typed

    @classmethod
    def register_anonymous(cls, func, name=None, *, parameterized=False, is_udt=False):
        if parameterized:
            return ParameterizedUdf(name or "indexunary.anonymous", func, True, cls.register_anonymous)
        op = cls(name or getattr(func, "__name__", "indexunary.anonymous"), anonymous=True)
        op.orig_func = func
        _build_from_func(op, func)
        return op

    @classmethod
    def register_new(cls, name, func, *, parameterized=False, is_udt=False, lazy=False):
        import graphblas_tpu_torch.indexunary as iu_module

        if parameterized:
            op = ParameterizedUdf(name, func, False, cls.register_anonymous)
            _dotted_set(iu_module, name, op)
            return op
        op = cls(name.rsplit(".", 1)[-1], anonymous=False)
        op.orig_func = func
        _build_from_func(op, func)
        _dotted_set(iu_module, name, op)
        # bool-returning ops also become SelectOps
        if all(ret is _dt.BOOL for ret in op.types.values()) and op.types:
            from .select import SelectOp
            import graphblas_tpu_torch.select as select_module

            sel = SelectOp._from_indexunary(op)
            _dotted_set(select_module, name, sel)
        return op


def _build_from_func(op, func, domains=ALL):
    for dtype in domains:
        try:
            ret = _b._output_dtype_of(func, dtype, _dt.INT64, _dt.INT64, dtype)
        except Exception:
            continue
        op._add(TypedIndexUnaryOp(op, op.name, dtype, ret, _b.udf_fn(func, ret, [dtype, _dt.INT64, _dt.INT64, dtype])))
    return op


def _specs():
    def const(fn):
        return lambda dtype: fn

    def value_cmp(name):
        return lambda dt: (lambda v, i, j, t, c=_m.compare(name, dt): c(v, t))

    INT_RET = lambda dt: _dt.INT64  # noqa: E731
    BOOL_RET = lambda dt: _dt.BOOL  # noqa: E731

    return [
        # positional producing indices
        ("rowindex", ALL, INT_RET, const(lambda v, i, j, t: i + t), "int"),
        ("colindex", ALL, INT_RET, const(lambda v, i, j, t: j + t), "int"),
        ("diagindex", ALL, INT_RET, const(lambda v, i, j, t: j - i + t), "int"),
        # positional predicates
        ("tril", ALL, BOOL_RET, const(lambda v, i, j, t: j <= i + t), "int"),
        ("triu", ALL, BOOL_RET, const(lambda v, i, j, t: j >= i + t), "int"),
        ("diag", ALL, BOOL_RET, const(lambda v, i, j, t: j == i + t), "int"),
        ("offdiag", ALL, BOOL_RET, const(lambda v, i, j, t: j != i + t), "int"),
        ("colle", ALL, BOOL_RET, const(lambda v, i, j, t: j <= t), "int"),
        ("colgt", ALL, BOOL_RET, const(lambda v, i, j, t: j > t), "int"),
        ("rowle", ALL, BOOL_RET, const(lambda v, i, j, t: i <= t), "int"),
        ("rowgt", ALL, BOOL_RET, const(lambda v, i, j, t: i > t), "int"),
        ("indexle", ALL, BOOL_RET, const(lambda v, i, j, t: i <= t), "int"),
        ("indexgt", ALL, BOOL_RET, const(lambda v, i, j, t: i > t), "int"),
        # value predicates (thunk has the value dtype)
        ("valueeq", ALL, BOOL_RET, const(lambda v, i, j, t: v == t), "same"),
        ("valuene", ALL, BOOL_RET, const(lambda v, i, j, t: v != t), "same"),
        ("valuelt", BOOLS + NUMS, BOOL_RET, value_cmp("lt"), "same"),
        ("valuele", BOOLS + NUMS, BOOL_RET, value_cmp("le"), "same"),
        ("valuegt", BOOLS + NUMS, BOOL_RET, value_cmp("gt"), "same"),
        ("valuege", BOOLS + NUMS, BOOL_RET, value_cmp("ge"), "same"),
    ]


_POSITIONAL = frozenset(
    "rowindex colindex diagindex tril triu diag offdiag colle colgt rowle rowgt indexle indexgt".split()
)


def _initialize(module):
    ops = {}
    for name, domains, ret_rule, fn_factory, thunk_kind in _specs():
        op = IndexUnaryOp(name)
        op._thunk_dtype = _dt.INT64 if thunk_kind == "int" else None
        if name in _POSITIONAL:
            op.positional = name
        for dtype in domains:
            ret = ret_rule(dtype)
            op._add(TypedIndexUnaryOp(op, name, dtype, ret, fn_factory(dtype)))
        ops[name] = op
    for name, op in ops.items():
        setattr(module, name, op)
    module._ops = ops
    return ops

"""Aggregator: multi-step reduction recipes (not a single monoid).

Counterpart of ``graphblas_tpu/core/operator/agg.py``: the same recipes
(pre-apply unary + monoid reduce + finalize, composites over
sub-aggregators, and engine-level positional reductions) and the same
registry, with torch finalizers.  The recipes run on collections,
dispatched from their ``_update`` when ``op.opclass == "Aggregator"``.
"""

import torch

from .. import dtypes as _dt


def _float_ret(dtype):
    if dtype is _dt.FP32:
        return _dt.FP32
    if dtype._is_complex:
        return dtype
    return _dt.FP64


def _same_ret(dtype):
    return dtype


def _int64_ret(dtype):
    return _dt.INT64


class Aggregator:
    opclass = "Aggregator"
    is_positional = False

    def __init__(
        self,
        name,
        *,
        monoid=None,
        pre=None,  # callable(parent_expr_dtype) -> (unary typed-op or fn) applied before reduce
        finalize=None,  # callable applied elementwise after reduce (torch fn)
        composite=None,  # list of sub-aggregator names
        finalize_composite=None,  # callable(*sub_results_exprs) -> expression
        custom=None,  # callable(parent, axis) -> collection  (engine-level)
        rettype=_same_ret,
        types_filter=None,
    ):
        self.name = name
        self._monoid_name = monoid
        self._pre = pre
        self._finalize = finalize
        self._composite = composite
        self._finalize_composite = finalize_composite
        self._custom = custom
        self._rettype = rettype
        self._types_filter = types_filter
        self._anonymous = False

    def __repr__(self):
        return f"agg.{self.name}"

    def __reduce__(self):
        return (_deserialize_agg, (self.name,))

    def __getitem__(self, type_):
        dtype = _dt.lookup_dtype(type_)
        if self._types_filter is not None and not self._types_filter(dtype):
            raise KeyError(f"{self.name} does not work with {dtype}")
        return TypedAggregator(self, dtype)

    def __contains__(self, type_):
        try:
            self[type_]
        except (KeyError, TypeError):
            return False
        return True

    @property
    def types(self):
        from .base import ALL

        return {dt: self._rettype(dt) for dt in ALL if dt in self}

    def __call__(self, val, *, rowwise=False, columnwise=False):
        """Reduce a collection (``val.reduce*(self)``)."""
        from ..vector import Vector

        typ = type(val)
        if typ is Vector or getattr(val, "_output_type", None) is Vector:
            return val.reduce(self)
        if rowwise:
            return val.reduce_rowwise(self)
        if columnwise:
            return val.reduce_columnwise(self)
        return val.reduce_scalar(self)

    # ---- recipe execution ---------------------------------------------------

    def _new(self, updater, expr):
        """Execute the aggregation recipe and feed the result to the updater.

        ``expr`` is the delayed reduce expression; expr.args[0] is the parent
        collection and expr.method_name identifies the axis.
        """
        parent = expr.args[0]
        method = expr.method_name
        if method in {"reduce_rowwise", "reduce"}:
            axis = "row"
        elif method == "reduce_columnwise":
            axis = "col"
        else:
            axis = "all"
        result = self._compute(parent, axis, expr.dtype)
        updater << result

    def _compute(self, parent, axis, out_dtype):
        import graphblas_tpu_torch.monoid as monoid_mod

        if self._custom is not None:
            return self._custom(parent, axis)
        if self._composite is not None:
            import graphblas_tpu_torch.agg as agg_mod

            subs = []
            for sub_name in self._composite:
                sub = getattr(agg_mod, sub_name)
                sub_result = sub._compute(parent, axis, None)
                subs.append(sub_result.new() if hasattr(sub_result, "new") else sub_result)
            return self._finalize_composite(*subs)
        # monoid family: optional pre-apply, reduce, optional finalize
        target = parent
        if self._pre is not None:
            pre_op = self._pre(parent.dtype)
            target = parent.apply(pre_op).new()
        monoid = getattr(monoid_mod, self._monoid_name)
        if axis == "row":
            if target.ndim == 1:
                result = target.reduce(monoid, allow_empty=True)
            else:
                result = target.reduce_rowwise(monoid)
        elif axis == "col":
            result = target.reduce_columnwise(monoid)
        else:
            result = target.reduce_scalar(monoid, allow_empty=True)
        if self._finalize is not None:
            fin = self._finalize
            result = result.new().apply(fin)
        return result


class TypedAggregator:
    opclass = "Aggregator"
    is_positional = False

    def __init__(self, parent, dtype):
        self.parent = parent
        self.name = parent.name
        self.type_ = dtype
        self.return_type = parent._rettype(dtype)

    def __repr__(self):
        return f"agg.{self.name}[{self.type_.name}]"

    def __getitem__(self, type_):
        return self.parent[type_]

    def _new(self, updater, expr):
        return self.parent._new(updater, expr)

    def __call__(self, val, **kwargs):
        return self.parent(val, **kwargs)


def _deserialize_agg(name):
    import graphblas_tpu_torch.agg as agg_mod

    return getattr(agg_mod, name)


# ---------------------------------------------------------------------------
# Builtin aggregators (python-graphblas's list: graphblas/agg/__init__.py)
# ---------------------------------------------------------------------------


import functools as _ft


@_ft.lru_cache(maxsize=None)
def _cached_unary(name, fn_key):
    """One registered op per (name): re-registering per call would grow the
    registry."""
    from .unary import UnaryOp

    fn = _CACHED_FNS[fn_key]
    return UnaryOp.register_anonymous(fn, name)


_CACHED_FNS = {}


def _register_cached(name, fn):
    if name not in _CACHED_FNS:
        _CACHED_FNS[name] = fn
    return _cached_unary(name, name)


def _u(name, dtype_rule=None):
    """Pre-apply factory returning a typed builtin unary op for the parent dtype."""

    def pre(dtype):
        import graphblas_tpu_torch.unary as unary

        op = getattr(unary, name)
        if dtype_rule is not None:
            return op[dtype_rule(dtype)]
        return op[dtype]

    return pre


def _square(dtype):
    # x -> x*x, computed in the promoted dtype
    target = _dt.INT64 if dtype._is_int or dtype._is_bool else dtype
    return _register_cached("square", lambda x: x * x)[target]


def _count_pre(dtype):
    return _register_cached("one_int64", lambda x: torch.ones_like(x, dtype=torch.int64))[_dt.INT64]


def _nonzero_pre(dtype):
    return _register_cached("nonzero_int64", lambda x: (x != 0).to(torch.int64))[dtype]


def _zero_pre(dtype):
    return _register_cached("zero_int64", lambda x: (x == 0).to(torch.int64))[dtype]


def _inv_pre(dtype):
    target = _float_ret(dtype)
    return _register_cached("inv_float", lambda x: 1.0 / x)[target]


def _abs_pre(dtype):
    import graphblas_tpu_torch.unary as unary

    return unary.abs[dtype]


def _log_pre(dtype):
    import graphblas_tpu_torch.unary as unary

    return unary.log[_float_ret(dtype)]


def _exp_pre(dtype):
    import graphblas_tpu_torch.unary as unary

    return unary.exp[_float_ret(dtype)]


def _exp2_pre(dtype):
    import graphblas_tpu_torch.unary as unary

    return unary.exp2[_float_ret(dtype)]


@_ft.lru_cache(maxsize=None)
def _fin(fn_name):
    """The elementwise finalizer ``torch.<fn_name>``."""

    def fin(x):
        return getattr(torch, fn_name)(x)

    fin.__name__ = f"agg_{fn_name}"
    return fin


def _not_complex(dtype):
    return not dtype._is_complex


def _initialize(module):
    import graphblas_tpu_torch.binary as binary

    aggs = {}

    def make(name, **kwargs):
        aggs[name] = Aggregator(name, **kwargs)

    # --- monoid-only ("monoid family")
    make("sum", monoid="plus")
    make("prod", monoid="times")
    make("all", monoid="land", rettype=lambda dt: _dt.BOOL, types_filter=_not_complex)
    make("any", monoid="lor", rettype=lambda dt: _dt.BOOL, types_filter=_not_complex)
    make("min", monoid="min", types_filter=_not_complex)
    make("max", monoid="max", types_filter=_not_complex)
    make("any_value", monoid="any")
    make("bitwise_all", monoid="band", types_filter=lambda dt: dt._is_int)
    make("bitwise_any", monoid="bor", types_filter=lambda dt: dt._is_int)
    make("exists", monoid="any", pre=_count_pre, rettype=_int64_ret)
    # --- python-graphblas's semiring-with-init family; here pre+reduce
    make("count", monoid="plus", pre=_count_pre, rettype=_int64_ret)
    make("count_nonzero", monoid="plus", pre=_nonzero_pre, rettype=_int64_ret)
    make("count_zero", monoid="plus", pre=_zero_pre, rettype=_int64_ret)
    make("sum_of_squares", monoid="plus", pre=lambda dt: _square(dt), rettype=lambda dt: _dt.INT64 if dt._is_int or dt._is_bool else dt)
    make("sum_of_inverses", monoid="plus", pre=_inv_pre, rettype=_float_ret)
    make("hypot", monoid="plus", pre=lambda dt: _square(_float_dt(dt)), finalize=_fin("sqrt"), rettype=_float_ret, types_filter=_not_complex)
    make("logaddexp", monoid="plus", pre=_exp_pre, finalize=_fin("log"), rettype=_float_ret, types_filter=_not_complex)
    make("logaddexp2", monoid="plus", pre=_exp2_pre, finalize=_fin("log2"), rettype=_float_ret, types_filter=_not_complex)
    make("L0norm", monoid="plus", pre=_nonzero_pre, rettype=_int64_ret)
    make("L1norm", monoid="plus", pre=_abs_pre, rettype=lambda dt: _dt.INT64 if dt._is_int or dt._is_bool else dt, types_filter=_not_complex)
    make("L2norm", monoid="plus", pre=lambda dt: _square(_float_dt(dt)), finalize=_fin("sqrt"), rettype=_float_ret, types_filter=_not_complex)
    make("Linfnorm", monoid="max", pre=_abs_pre, types_filter=_not_complex)

    # --- composite multi-pass
    def _div(total, n):
        import graphblas_tpu_torch.binary as b

        return total.ewise_mult(n, b.truediv)

    make("mean", composite=["sum", "count"], finalize_composite=lambda s, n: _div(s, n), rettype=_float_ret, types_filter=_not_complex)
    make(
        "peak_to_peak",
        composite=["max", "min"],
        finalize_composite=lambda mx, mn: mx.ewise_mult(mn, binary.minus),
        types_filter=_not_complex,
    )

    def _varp_fin(n, s, sos):
        import graphblas_tpu_torch.binary as b

        mean_sq = _div(s, n).new().apply(_pow2)
        return _div(sos, n).new().ewise_mult(mean_sq, b.minus)

    def _vars_fin(n, s, sos):
        import graphblas_tpu_torch.binary as b

        # (sos - s^2/n) / (n-1)
        s2n = _div(s.apply(_pow2).new(), n)
        num = sos.ewise_mult(s2n.new(), b.minus)
        nm1 = n.apply(b.minus, right=1)
        return _div(num.new(), nm1.new())

    def _pow2(x):
        return x * x

    make("varp", composite=["count", "sum", "sum_of_squares"], finalize_composite=_varp_fin, rettype=_float_ret, types_filter=_not_complex)
    make("vars", composite=["count", "sum", "sum_of_squares"], finalize_composite=_vars_fin, rettype=_float_ret, types_filter=_not_complex)
    make(
        "stdp",
        composite=["count", "sum", "sum_of_squares"],
        finalize_composite=lambda n, s, sos: _varp_fin(n, s, sos).new().apply(_fin("sqrt")),
        rettype=_float_ret,
        types_filter=_not_complex,
    )
    make(
        "stds",
        composite=["count", "sum", "sum_of_squares"],
        finalize_composite=lambda n, s, sos: _vars_fin(n, s, sos).new().apply(_fin("sqrt")),
        rettype=_float_ret,
        types_filter=_not_complex,
    )
    make(
        "geometric_mean",
        composite=["count", "logsum"],
        finalize_composite=lambda n, ls: _div(ls, n).new().apply(_fin("exp")),
        rettype=_float_ret,
        types_filter=_not_complex,
    )
    make("logsum", monoid="plus", pre=_log_pre, rettype=_float_ret, types_filter=_not_complex)
    make(
        "harmonic_mean",
        composite=["count", "sum_of_inverses"],
        finalize_composite=lambda n, si: _rdiv_cols(n, si),
        rettype=_float_ret,
        types_filter=_not_complex,
    )
    make(
        "root_mean_square",
        composite=["count", "sum_of_squares"],
        finalize_composite=lambda n, sos: _div(sos, n).new().apply(_fin("sqrt")),
        rettype=_float_ret,
        types_filter=_not_complex,
    )

    def _rdiv_cols(n, si):
        import graphblas_tpu_torch.binary as b

        return n.ewise_mult(si, b.truediv)

    # --- positional / order-based (agg.ss in python-graphblas): engine-level
    # reductions of the collections
    from ..reductions import agg_argminmax, agg_firstlast

    make("argmin", custom=lambda parent, axis: agg_argminmax(parent, axis, "min", "index"), rettype=_int64_ret, types_filter=_not_complex)
    make("argmax", custom=lambda parent, axis: agg_argminmax(parent, axis, "max", "index"), rettype=_int64_ret, types_filter=_not_complex)
    make("first", custom=lambda parent, axis: agg_firstlast(parent, axis, "first", "value"))
    make("last", custom=lambda parent, axis: agg_firstlast(parent, axis, "last", "value"))
    make("first_index", custom=lambda parent, axis: agg_firstlast(parent, axis, "first", "index"), rettype=_int64_ret)
    make("last_index", custom=lambda parent, axis: agg_firstlast(parent, axis, "last", "index"), rettype=_int64_ret)

    for name, agg_ in aggs.items():
        setattr(module, name, agg_)
    module._ops = aggs
    return aggs


def _float_dt(dtype):
    return _float_ret(dtype)

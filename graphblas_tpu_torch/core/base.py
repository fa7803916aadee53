"""BaseType + update protocol + delayed expressions.

Counterpart of ``graphblas_tpu/core/base.py``.  Every mutating operation
funnels through one sink, ``BaseType._update``: it resolves the mask to a
bool tensor, evaluates the delayed expression on the dense-masked engine,
and applies the one mask/accum/replace merge (``ops.densemasked.masked_merge``).
The merge returns new tensors: a collection never writes into the tensors it
holds, so ``dup()``, masks and expression operands may share them.  Two
sparse sinks come first: ``C(M) << A.mxm(B)`` over sparse operands into an
empty target adopts the masked SpGEMM's sparse result, and a sparse producer
into an unmasked, unaccumulated target is adopted wholesale; everything else
merges densely (a sparse target densifies, guarded by
``tx.config["densify_limit"]``).
"""

import numpy as np
import torch

from .. import exceptions as _exc
from . import capture as _cap
from . import dtypes as _dt
from . import recorder as _recorder
from .mask import Mask, StructuralMask, ValueMask
from .operator import find_opclass, get_typed_op
from .utils import zero_values


def _get_config():
    import graphblas_tpu_torch

    return graphblas_tpu_torch.config


def _engine_opts_ctx(opts):
    """Apply per-call descriptor opts (SuiteSparse descriptor settings like
    ``nthreads``/``axb_method`` threaded through ``**opts``) as a tx-config
    context around one expression evaluation.  Unknown keys raise; known-but-non-engine keys
    (sort, compression, ...) are accepted and ignored like the reference."""
    import contextlib

    if not opts:
        return contextlib.nullcontext()
    from ..tx import config as _txconfig
    from .descriptor import _VALID_OPTS

    unknown = set(opts) - _VALID_OPTS
    if unknown:
        raise ValueError(f"Unknown descriptor option(s): {sorted(unknown)}")
    engine = {k: v for k, v in opts.items() if k in _txconfig}
    if not engine:
        return contextlib.nullcontext()
    return _txconfig.set(engine)


def _maybe_block(obj):
    """Blocking mode: synchronize the card after a mutating statement
    (error-timing spec, see graphblas_tpu_torch.init).  Inside a compiled
    loop there is nothing to synchronize."""
    import graphblas_tpu_torch as _gb

    if _gb.is_blocking and _cap.active() is None and getattr(obj, "_sparse", None) is None and obj._struct.is_cuda:
        torch.cuda.synchronize(obj._struct.device)


def record_call(opname, *args):
    def describe(a):
        if isinstance(a, BaseType):
            return a.name or type(a).__name__
        # never repr expressions here: that would trigger autocompute
        name = getattr(a, "opname", None)
        return name if isinstance(name, str) else type(a).__name__

    _recorder.record(opname, ", ".join(describe(a) for a in args))
    _burble_call(opname, args)


def _burble_call(opname, args):
    """Engine dispatch diagnostics (analogue of SuiteSparse burble).  Prints
    one line per engine op with operand storage formats when enabled via
    ``gb.tx.config['burble']``."""
    from ..tx import config as _txconfig

    if not _txconfig.get("burble"):
        return

    def describe(a):
        if isinstance(a, BaseType):
            nm = a.name or type(a).__name__
            fmt = "sparse" if getattr(a, "_sparse", None) is not None else "dense"
            shape = "x".join(str(s) for s in getattr(a, "shape", ()))
            return f"{nm}<{fmt} {shape or 'scalar'} {a.dtype.name}>"
        if isinstance(a, BaseExpression):
            inner = ", ".join(describe(x) for x in a.args if isinstance(x, (BaseType, BaseExpression)))
            return f"{a.opname or a.method_name}({inner})"
        name = getattr(a, "opname", None)
        return name if isinstance(name, str) else type(a).__name__

    print(f"[burble] {opname}({', '.join(describe(a) for a in args)})")


class BaseType:
    # _values and _struct are stored in _values_ and _struct_ and read through
    # capture.HeldSlot (below the class)
    __slots__ = "_values_", "_struct_", "_dtype", "name", "_nvals_cache", "__weakref__"
    _is_scalar = False

    # ------------------------------------------------------------------
    # updater protocol: C(mask, accum, replace) << expr
    # ------------------------------------------------------------------

    def __call__(self, *optional_mask_accum_replace, mask=None, accum=None, replace=False, input_mask=None, **opts):
        """Parse positional (mask, accum, replace) flexibly."""
        from .. import replace as replace_singleton

        for arg in optional_mask_accum_replace:
            if arg is replace_singleton or isinstance(arg, bool):
                replace = arg if isinstance(arg, bool) else True
            elif isinstance(arg, Mask) or isinstance(arg, BaseType):
                if mask is not None:
                    raise TypeError("Got multiple masks")
                mask = arg
            else:
                _, opclass = find_opclass(arg)
                if opclass in {"BinaryOp", "Monoid"} or isinstance(arg, str):
                    if accum is not None:
                        raise TypeError("Got multiple accumulators")
                    accum = arg
                else:
                    raise TypeError(f"Invalid item found in output params: {type(arg)}")
        # shape validation is deferred: assign allows region-shaped masks
        # (e.g. a vector mask on C(vmask)[i, :] = v — GrB_Row_assign)
        mask = _check_mask(mask, None) if mask is not None else None
        if input_mask is not None:
            if mask is not None:
                raise TypeError("mask and input_mask arguments cannot both be given")
            input_mask = _check_mask(input_mask, None)
        if accum is not None:
            accum = get_typed_op(accum, self.dtype, kind="binary")
        return Updater(self, mask=mask, accum=accum, replace=replace, input_mask=input_mask, opts=opts)

    def __lshift__(self, expr):
        self._update(expr)
        return self  # allow chaining in scripts; discarded in statements

    def update(self, expr, **opts):
        """``C << expr`` is sugar for this."""
        self._update(expr, opts=opts)

    def _update(self, expr, mask=None, accum=None, replace=False, input_mask=None, opts=None):
        from .infix import InfixExprBase
        from .expr import AmbiguousAssignOrExtract

        if replace and mask is None:
            raise ValueError("replace=True requires a mask")

        # -- normalize RHS to a BaseExpression or plain collection ---------
        if isinstance(expr, AmbiguousAssignOrExtract):
            if input_mask is not None:
                # translate to an ordinary output mask by extracting the
                # mask at the same indices
                if mask is not None:
                    raise TypeError("mask and input_mask arguments cannot both be given")
                mask = expr._input_mask_to_mask(_check_mask(input_mask, None))
                input_mask = None
            expr = expr._extract_delayed()
        elif input_mask is not None:
            raise TypeError("input_mask is only allowed for extract (C[idx]) expressions")
        if isinstance(expr, InfixExprBase):
            expr = expr._to_expr()

        from .matrix import TransposedMatrix

        if isinstance(expr, TransposedMatrix):
            expr = expr._as_expression()

        if isinstance(expr, BaseType):
            if expr.ndim != self.ndim:
                raise TypeError(f"Bad value for update; got {type(expr).__name__}, expected {type(self).__name__}")
            expr = expr._as_expression()

        if not isinstance(expr, BaseExpression):
            if self._is_scalar:
                return self._update_scalar_value(expr, accum)
            from .scalar import _is_scalar_like

            if _is_scalar_like(expr):
                raise TypeError(
                    "Bad type for update; a bare scalar cannot update a Matrix/Vector. "
                    "Use C[...] = scalar for assignment."
                )
            raise TypeError(f"Bad type for argument to update: {type(expr)}")

        # -- aggregator branch -----------------------------------------------
        op, opclass = find_opclass(expr.op) if expr.op is not None else (None, None)
        if opclass == "Aggregator":
            updater = Updater(self, mask=mask, accum=accum, replace=replace, opts=opts or {})
            return op._new(updater, expr)

        if expr.output_type is not type(self):
            raise TypeError(
                f"Expression of type {expr.output_type.__name__} cannot update {type(self).__name__}"
            )
        if expr.shape != self.shape:
            raise _exc.DimensionMismatch(f"shapes do not match: {expr.shape} != {self.shape}")

        record_call(expr.opname, self, expr)

        if self._is_scalar:
            return self._update_from_expr(expr, accum)

        # masked sparse SpGEMM: C(M) << A.mxm(B) over sparse operands with an
        # empty target adopts the dot-method result directly
        if (
            mask is not None
            and accum is None
            and not mask.complement
            and getattr(expr, "_sparse_masked_mxm", None) is not None
            and self.nvals == 0
        ):
            with _engine_opts_ctx(opts):
                result = expr._sparse_masked_mxm(mask)
            if result is not None:
                self._adopt_sparse(_retyped(result._sparse, self.dtype))
                return

        # sparse-format producer into an unmasked, unaccumulated target:
        # adopt the sparse result wholesale (no densify anywhere)
        if expr._sparse_compute is not None and mask is None and accum is None:
            with _engine_opts_ctx(opts):
                result = expr._sparse_compute()
            self._adopt_sparse(_retyped(result._sparse, self.dtype))
            return

        with _engine_opts_ctx(opts):
            zv, zs = expr._compute()
        from ..ops import densemasked as _dm

        mask_bits = mask._bits() if mask is not None else None
        if mask is not None and mask.parent.shape != self.shape:
            raise _exc.DimensionMismatch("mask shape does not match output shape")
        cv, cs = _dm.masked_merge(
            self._values,
            self._struct,
            zv,
            zs,
            mask_bits,
            accum,
            bool(replace),
            mask_bits is not None,
            c_type=self.dtype,
            z_type=expr.dtype,
        )
        self._set_arrays(cv, cs)
        _maybe_block(self)

    # ------------------------------------------------------------------
    # plumbing shared by Matrix/Vector (Scalar overrides)
    # ------------------------------------------------------------------

    @property
    def dtype(self):
        return self._dtype

    def _set_arrays(self, values, struct):
        self._values = values
        self._struct = struct

    def _as_expression(self):
        """Wrap a plain collection as an identity expression."""
        sparse_compute = None
        sp0 = getattr(self, "_sparse", None)
        if sp0 is not None:

            def sparse_compute(sp=sp0, dev=self._sp_dev):
                return type(self)._from_sparse(sp.copy(vals=sp.vals.copy()), self.dtype, device=dev)

        return BaseExpression(
            "identity",
            type(self),
            lambda: (self._values, self._struct),
            op=None,
            dtype=self.dtype,
            shape=self.shape,
            args=(self,),
            sparse_compute=sparse_compute,
        )

    @property
    def nvals(self):
        """Number of stored values.

        The count is one read of the card; it is cached, keyed on the struct
        tensor and its version counter: every mutation funnels through
        ``_update``/``_set_arrays`` and installs a NEW struct tensor, and the
        version catches an in-place write all the same."""
        s = self._struct
        cache = getattr(self, "_nvals_cache", None)
        if cache is not None and cache[0] is s and cache[1] == s._version:
            return cache[2]
        if _cap.active() is not None:
            # inside a compiled loop: a constant structure counts on the host;
            # a traced one cannot be read (TracerError)
            h = _cap.host_of(s)
            if h is None:
                raise _exc.TracerError(".nvals reads a traced structure inside a compiled loop body")
            return int(h.sum())
        n = int(s.sum())
        self._nvals_cache = (s, s._version, n)
        return n

    def clear(self):
        """Remove all stored values."""
        self._set_arrays(torch.zeros_like(self._values), torch.zeros_like(self._struct))

    def wait(self, how="materialize"):
        """Block until pending device computation completes: asynchronous
        CUDA launches are the analogue of GraphBLAS non-blocking mode."""
        if self._struct.is_cuda and _cap.active() is None:
            torch.cuda.synchronize(self._struct.device)
        return self

    # -- comparison helpers ------------------------------------------------

    def isequal(self, other, *, check_dtype=False):
        """Pattern and values exactly equal (one read of the card)."""
        other = self._expect_type(other, type(self), within="isequal", argname="other")
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.shape != other.shape:
            return False
        _same_device(self, other, "isequal")
        if not bool(torch.equal(self._struct, other._struct)):
            return False
        a, b = self._values, other._values
        if isinstance(a, dict) or isinstance(b, dict):  # UDT: field by field
            if not (isinstance(a, dict) and isinstance(b, dict)) or set(a) != set(b):
                return False
            return all(bool(torch.where(self._struct, a[f] == b[f], True).all()) for f in a)
        b = _dt.cast(b, other.dtype, self.dtype)
        return bool(torch.where(self._struct, a == b, True).all())

    def isclose(self, other, *, rel_tol=1e-7, abs_tol=0.0, check_dtype=False):
        """Pattern equal and values close (one read of the card)."""
        other = self._expect_type(other, type(self), within="isclose", argname="other")
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.shape != other.shape:
            return False
        _same_device(self, other, "isclose")
        if not bool(torch.equal(self._struct, other._struct)):
            return False
        ft = _dt.default_float()

        def close(a, at, b, bt):
            a, b = _dt.cast(a, at, ft), _dt.cast(b, bt, ft)
            ok = torch.abs(a - b) <= torch.clamp(rel_tol * torch.maximum(torch.abs(a), torch.abs(b)), min=abs_tol)
            return bool(torch.where(self._struct, ok, True).all())

        a, b = self._values, other._values
        if isinstance(a, dict) or isinstance(b, dict):  # UDT: field by field
            if not (isinstance(a, dict) and isinstance(b, dict)) or set(a) != set(b):
                return False
            ta, tb = self.dtype.np_type, other.dtype.np_type
            return all(close(a[f], _dt.lookup_dtype(ta[f]), b[f], _dt.lookup_dtype(tb[f])) for f in a)
        return close(a, self.dtype, b, other.dtype)

    # -- error machinery ------------------------------------------------------

    def _expect_type(self, x, types, *, within="", argname="", extra_message=""):
        if not isinstance(types, tuple):
            types = (types,)
        from .utils import output_type

        if isinstance(x, types) or output_type(x) in types:
            if hasattr(x, "_get_value") and not isinstance(x, BaseType):
                # auto-compute expressions when used as plain arguments
                if _get_config().get("autocompute"):
                    return x._get_value()
                raise TypeError(
                    f"{type(x).__name__} is not computed automatically (autocompute is off); "
                    "call .new() to compute it"
                )
            return x
        expected = ", ".join(t.__name__ for t in types)
        raise TypeError(
            f"Bad type {within}, argument {argname}: expected ({expected}), got {type(x).__name__}."
            + (f" {extra_message}" if extra_message else "")
        )

    # -- masks ---------------------------------------------------------------

    @property
    def S(self):
        return StructuralMask(self)

    @property
    def V(self):
        return ValueMask(self)

    def __array__(self, *args, **kwargs):
        raise TypeError(
            f"{type(self).__name__} can't be directly converted to a numpy array; "
            "perhaps use `.to_coo()` or `.to_dense()`"
        )

    def __bool__(self):
        raise TypeError(
            f"__bool__ not defined for objects of type {type(self).__name__}; "
            "perhaps use .nvals attribute instead"
        )

    # infix operators are attached by infixmethods


def _retyped(sp, dtype):
    """Sparse storage with its values in ``dtype`` (a new container when they
    convert, as numpy converts)."""
    if sp.vals.dtype == np.dtype(dtype.np_type):
        return sp
    return sp.copy(vals=sp.vals.astype(dtype.np_type))


def _same_device(a, b, within):
    """Operands of one operation live on one device (torch would copy a 0-d
    tensor across devices silently, and raise for the rest)."""
    da, db = a._device, b._device
    if da != db:
        raise ValueError(f"{within}: operands on {da} and {db}; an operation runs on one device")


def _check_mask(mask, output=None):
    """Normalize mask argument (bool collections lift to ValueMask)."""
    if isinstance(mask, Mask):
        pass
    elif isinstance(mask, BaseType):
        if mask.dtype != _dt.BOOL:
            raise TypeError("Mask must be boolean (or use .S/.V to indicate structure/value)")
        mask = ValueMask(mask)
    elif hasattr(mask, "_get_value"):
        mask = ValueMask(mask._get_value())
    else:
        raise TypeError(f"Invalid mask: {type(mask)}")
    if output is not None and mask.parent.shape != output.shape:
        raise _exc.DimensionMismatch(
            f"mask shape {mask.parent.shape} does not match output shape {output.shape}"
        )
    return mask

_cap.hold_slots(BaseType, "_values", "_struct")


class Updater:
    """Carries (mask, accum, replace) until `<<`/`[...]=` fires."""

    __slots__ = "parent", "mask", "accum", "replace", "input_mask", "opts", "_is_sub"

    def __init__(self, parent, *, mask=None, accum=None, replace=False, input_mask=None, opts=None, sub=False):
        self.parent = parent
        self.mask = mask
        self.accum = accum
        self.replace = replace
        self.input_mask = input_mask
        self.opts = opts or {}
        self._is_sub = sub

    def __lshift__(self, expr):
        self.update(expr)

    def update(self, expr):
        self.parent._update(
            expr,
            mask=self.mask,
            accum=self.accum,
            replace=self.replace,
            input_mask=self.input_mask,
            opts=self.opts,
        )

    def __getitem__(self, keys):
        from .expr import AmbiguousAssignOrExtract, IndexerResolver

        resolved = IndexerResolver(self.parent, keys)
        return AmbiguousAssignOrExtract(self.parent, resolved, updater=self)

    def __setitem__(self, keys, value):
        from .expr import IndexerResolver

        resolved = IndexerResolver(self.parent, keys)
        self.parent._assign(
            resolved,
            value,
            mask=self.mask,
            accum=self.accum,
            replace=self.replace,
            is_submask=self._is_sub,
        )

    def __delitem__(self, keys):
        from .expr import IndexerResolver

        resolved = IndexerResolver(self.parent, keys)
        self.parent._delete_region(resolved, mask=self.mask)


from .infixmethods import InfixMixin as _InfixMixin


class BaseExpression(_InfixMixin):
    """A delayed operation: carries the method name, operands, typed op, and a
    compute closure (python-graphblas's (cfunc_name, args) bundle)."""

    output_type = None  # set per-instance

    def __init__(
        self,
        method_name,
        output_cls,
        compute,
        *,
        op=None,
        dtype=None,
        shape=None,
        args=(),
        opname=None,
        sparse_compute=None,
    ):
        self.method_name = method_name
        self.output_type = output_cls
        self._compute_fn = compute
        self.op = op
        self._dtype = _dt.lookup_dtype(dtype) if dtype is not None else None
        self._shape = shape
        self.args = args
        self.opname = opname or method_name
        self._value = None  # autocompute cache
        # optional sparse-format producer: () -> a collection with sparse
        # storage (used when operands are sparse so results never densify)
        self._sparse_compute = sparse_compute

    # -- introspection -------------------------------------------------------

    @property
    def dtype(self):
        return self._dtype

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def nrows(self):
        return self._shape[0]

    @property
    def ncols(self):
        return self._shape[1]

    @property
    def size(self):
        return self._shape[0]

    @property
    def _output_type(self):
        return self.output_type

    def _compute(self):
        return self._compute_fn()

    # -- materialization -----------------------------------------------------

    def new(self, dtype=None, *, mask=None, name=None, **opts):
        """Compute the expression into a new collection (with output-mask
        fusion)."""
        out_dtype = _dt.lookup_dtype(dtype) if dtype is not None else self.dtype
        if self.op is not None and find_opclass(self.op)[1] == "Aggregator":
            out = self._empty_output(out_dtype, name)
            upd = Updater(out, mask=_check_mask(mask, out) if mask is not None else None, opts=opts)
            self.op._new(upd, self)
            return out
        if self._sparse_compute is not None and mask is None:
            out = self._sparse_compute()
            if dtype is not None and out_dtype != out.dtype:
                out._sparse = _retyped(out._sparse, out_dtype)
                out._dtype = out_dtype
            out.name = name
            return out
        out = self._empty_output(out_dtype, name)
        out._update(self, mask=_check_mask(mask, out) if mask is not None else None, opts=opts)
        return out

    dup = new

    def _empty_output(self, dtype, name):
        """An empty collection for the result, on the operands' device (the
        collections' device where no operand has one): sparse past
        ``tx.config["dense_limit"]`` cells."""
        if self.output_type.ndim == 0:
            return self.output_type(dtype, name=name)
        dev = next((d for d in (getattr(a, "_device", None) for a in self.args) if isinstance(d, torch.device)), None)
        if dev is None:
            return self.output_type(dtype, *self._shape_args(), name=name)
        shape = tuple(self._shape)
        from .sparse import _dense_limit

        if int(np.prod(shape, dtype=object)) > _dense_limit():
            from ..tx import config as _txconfig

            with _txconfig.set(platform=dev.type):
                return self.output_type(dtype, *shape, name=name)
        return self.output_type._from_arrays(
            zero_values(shape, dtype, dev), torch.zeros(shape, dtype=torch.bool, device=dev), dtype, name=name
        )

    def _shape_args(self):
        if self._shape is None:
            return ()
        return tuple(self._shape)

    def _get_value(self):
        """Autocompute hook."""
        if self._value is None:
            self._value = self.new()
        return self._value

    # -- autocompute delegation (python-graphblas's generated automethods) ----

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if self.output_type is not None and hasattr(self.output_type, name):
            if not _get_config().get("autocompute"):
                raise TypeError(
                    f"{type(self).__name__} is not computed automatically (autocompute is "
                    f"off). Call .new() first to access .{name}."
                )
            return getattr(self._get_value(), name)
        raise AttributeError(name)

    # numeric dunders bypass __getattr__ (type-level lookup), so scalar
    # expressions mirror them explicitly (TypeError with the autocompute hint
    # when off, as python-graphblas's generated automethods)
    def _scalar_dunder(self, kind, conv):
        if self.output_type is None or self.output_type.__name__ != "Scalar":
            raise TypeError(f"{kind} not defined for objects of type {type(self).__name__}")
        if not _get_config().get("autocompute"):
            raise TypeError(
                f"{type(self).__name__} is not computed automatically (autocompute is "
                f"off). Call .new() first to use {kind}."
            )
        return conv(self._get_value())

    def __float__(self):
        return self._scalar_dunder("__float__", float)

    def __int__(self):
        return self._scalar_dunder("__int__", int)

    def __index__(self):
        return self._scalar_dunder("__index__", lambda v: v.__index__())

    def __complex__(self):
        return self._scalar_dunder("__complex__", complex)

    def __bool__(self):
        if self.output_type is not None and self.output_type.__name__ == "Scalar":
            return self._scalar_dunder("__bool__", bool)
        raise TypeError(
            f"__bool__ not defined for objects of type {type(self).__name__}; "
            "materialize with .new() and compare explicitly"
        )

    # container dunders also bypass __getattr__ (the automethods mirror
    # __iter__/__contains__/__array__ onto expression classes)
    def __iter__(self):
        return iter(self._autocompute_method("__iter__")())

    def __contains__(self, item):
        return self._autocompute_method("__contains__")(item)

    def __array__(self, *args, **kwargs):
        return self._autocompute_method("__array__")(*args, **kwargs)

    def _format_call_string(self):
        """Functional description of the delayed call, e.g.
        ``A.mxm(B, op=plus_times[FP64])``."""

        def nm(a):
            n = getattr(a, "name", None)
            return n or type(a).__name__
        base = nm(self.args[0]) if self.args else ""
        rest = [nm(a) for a in self.args[1:]]
        if self.op is not None:
            rest.append(f"op={self.op.name}")
        return f"{base}.{self.method_name}({', '.join(rest)})"

    def __repr__(self):
        from .formatting import format_expression

        try:
            return format_expression(self)
        except Exception:
            pass
        op_str = f", op={self.op!r}" if self.op is not None else ""
        header = f"{type(self).__name__} (delayed {self.method_name}{op_str}, dtype={self.dtype}, shape={self._shape})"
        if _get_config().get("autocompute") and self._shape is not None and all(
            d <= 64 for d in self._shape
        ):
            try:
                return header + "\n" + repr(self._get_value())
            except Exception:
                return header
        return header

    def _autocompute_method(self, name):
        # every value-bearing expression method goes through _get_value:
        # TypeError when autocompute is off
        if not _get_config().get("autocompute"):
            raise TypeError(
                f"{type(self).__name__} is not computed automatically (autocompute is "
                f"off). Call .new() first to access .{name}."
            )
        return getattr(self._get_value(), name)

    def isequal(self, other, **kwargs):
        return self._autocompute_method("isequal")(other, **kwargs)

    def isclose(self, other, **kwargs):
        return self._autocompute_method("isclose")(other, **kwargs)

    def __lshift__(self, other):
        raise TypeError(f"Cannot use << on an expression; did you mean to call .new()?")

"""Dense-masked engine: every GraphBLAS operation family on (values, struct)
pairs of device tensors.

Counterpart of ``graphblas_tpu/ops/densemasked.py``.  Representation:

- a Matrix is ``(values[nrows, ncols], struct[nrows, ncols] bool)``
- a Vector is ``(values[size], struct[size] bool)``
- absent positions hold the carrier's zero (canonical form, ``canonical``)

Values are carrier tensors of ``core.dtypes`` (UINT16 in int32, UINT32 and
UINT64 in int64), so a function that converts values is told the types it
converts between.  Every function is pure: it returns new tensors (or views)
and never writes into its inputs, so a collection can share its tensors with
a ``dup()``, a mask or a captured expression operand.  Operations run on the
device of their operands.

The matmul family lowers by dtype, never by device, so the CPU tests run
the code the card runs:

- plus_times / plus_first / plus_second over floats: one ``torch.matmul``
  in full float32 (``ops.mxm.full_f32_matmul``, the reference's
  ``Precision.HIGHEST``; float64 is a DGEMM);
- the structure, and plus_pair / boolean reachability: one float32 matmul
  of 0/1 indicators (exact counts while k < 2^24, which ``dense_limit``
  guarantees); torch has no integer GEMM on CUDA;
- integer values: the generic chunked contraction, exact and wrapping as
  XLA does (the reference multiplies them on the MXU in int32/int64);
- min_plus / max_plus / min_max / max_min over float32 with CUDA operands
  and at least 128 x 128 outputs: the Hopper kernel ``gb_tropical``
  through ``ops.mxm.tropical_mxm`` (the reference's Pallas kernel on TPU);
- everything else: the generic contraction, k in chunks of 128, each an
  (m, 128, n) broadcast multiply reduced by the reference's halving tree.

Inside a compiled loop (``core/capture.py``) the structure combinators
``s_*``, ``mxm``'s output structure and the assign scatters keep structure
host-side where their operands are constants, as the reference does under
a trace (structure hoisting, ``core/compiler.py``).

A user-defined type (UDT) keeps its values as a dict of field tensors (a
struct of arrays, each field in its type's carrier): ``tmap`` maps a
function over the fields, and the reduce, elementwise, matmul (the
generic contraction), extract/assign, merge and reshape functions take
either form.
"""

import numpy as np
import torch

from ..core import capture as _cap
from ..core import dtypes as _dt
from .mxm import full_f32_matmul, is_tropical, tropical_mxm

_MXM_CHUNK = 128  # k-chunk for the generic semiring matmul (bounds memory to m*n*chunk)
_INDEX = torch.int64  # positional iotas ride int64 (the reference's 64-bit contract)


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _is_soa(values):
    """UDT collections store values as a dict of field tensors (SoA)."""
    return isinstance(values, dict)


def tmap(fn, values, *rest):
    """Apply fn per field for SoA values, directly otherwise."""
    if _is_soa(values):
        return {key: fn(values[key], *(r[key] for r in rest)) for key in values}
    return fn(values, *rest)


def _shape_of(values):
    return tuple(next(iter(values.values())).shape if _is_soa(values) else values.shape)


# ---------------------------------------------------------------------------
# Structure math that stays on the host inside compiled loops
# ---------------------------------------------------------------------------
#
# Inside a compiled loop's capture scope (core/capture.py) every torch op
# returns a traced tensor, so a structure would turn traced after one
# combine and defeat structure hoisting (core/compiler.py).  These
# combinators detect "in a scope AND all operands concrete" and compute the
# structure's host value in numpy beside the device result (a constant of
# the loop); with one concrete all-true or all-false operand they short-cut.
# Outside a scope they are plain ops.


def _host_concrete(*arrays):
    if _cap.active() is None:
        return False
    return all(_cap.host_of(a) is not None for a in arrays)


def _concrete_const(x):
    """(is_concrete, all_true, all_false) for the structure short-cuts."""
    h = _cap.host_of(x)
    if h is None:
        return False, False, False
    return True, bool(h.all()), bool(not h.any())


def _hosted(t, host):
    return _cap.with_host(t, host)


def s_and(a, b):
    if _host_concrete(a, b):
        return _hosted(a & b, np.logical_and(_cap.host_of(a), _cap.host_of(b)))
    # short-cuts keep structure concrete when one side is a known constant
    # (dense-full loop states: x & True == x, x & False == False); only for
    # equal shapes, which keeps the broadcast shape
    if _cap.active() is not None and a.shape == b.shape:
        for x, y in ((a, b), (b, a)):
            cx, tx, fx = _concrete_const(x)
            if cx and tx:
                return y
            if cx and fx:
                return s_zeros(tuple(x.shape), x.device)
    return a & b


def s_or(a, b):
    if _host_concrete(a, b):
        return _hosted(a | b, np.logical_or(_cap.host_of(a), _cap.host_of(b)))
    if _cap.active() is not None and a.shape == b.shape:
        for x, y in ((a, b), (b, a)):
            cx, tx, fx = _concrete_const(x)
            if cx and tx:
                return s_ones(tuple(x.shape), x.device)
            if cx and fx:
                return y
    return a | b


def s_not(a):
    if _host_concrete(a):
        return _hosted(~a, np.logical_not(_cap.host_of(a)))
    return ~a


def s_where(c, a, b):
    if _host_concrete(c, a, b):
        return _hosted(torch.where(c, a, b), np.where(_cap.host_of(c), _cap.host_of(a), _cap.host_of(b)))
    if _cap.active() is not None:
        cc, ct, cf = _concrete_const(c)
        if cc and ct:
            return a
        if cc and cf:
            return b
        an, bn = _cap.host_of(a), _cap.host_of(b)
        if an is not None and bn is not None:
            # traced condition, both branches concrete and equal: the result
            # is that constant (merging all-present structures under a value
            # mask keeps hoisting alive for dense-full states)
            try:
                ab, bb = np.broadcast_arrays(an, bn)
            except ValueError:
                ab = bb = None
            if ab is not None and np.array_equal(ab, bb):
                shape = np.broadcast_shapes(tuple(c.shape), ab.shape)
                return _hosted(torch.where(c, a, b), np.broadcast_to(ab, shape).copy())
            # edge-layout invariant (core/looplayout.py): in the context every
            # traced mask is a subset of the state slots U (is_last); when both
            # branches hold all of U and the false branch nothing outside it,
            # where(c, a, b) == U for any c within U
            if ab is not None:
                from ..core import looplayout as _ll

                ctx = _ll.active()
                if ctx is not None and tuple(c.shape) == (ctx.e_pad,):
                    U = ctx.is_last
                    try:
                        aU = np.broadcast_to(an, (ctx.e_pad,))
                        bU = np.broadcast_to(bn, (ctx.e_pad,))
                    except ValueError:
                        aU = None
                    if aU is not None and aU[U].all() and bU[U].all() and not bU[~U].any():
                        return ctx.universe(c.device)
    return torch.where(c, a, b)


def s_any(a, axis=None):
    out = a.any() if axis is None else a.any(dim=axis)
    if _host_concrete(a):
        return _hosted(out, np.any(_cap.host_of(a), axis=axis))
    return out


def s_zeros(shape, device):
    """Fresh all-absent structure bitmap (a constant inside compiled loops)."""
    out = torch.zeros(shape, dtype=torch.bool, device=device)
    if _cap.active() is not None:
        return _hosted(out, np.zeros(shape, bool))
    return out


def s_ones(shape, device):
    out = torch.ones(shape, dtype=torch.bool, device=device)
    if _cap.active() is not None:
        return _hosted(out, np.ones(shape, bool))
    return out


def canonical(values, struct):
    """Force absent positions to zero (storage invariant)."""
    return tmap(lambda v: torch.where(struct, v, _zero(v)), values), struct


# ---------------------------------------------------------------------------
# Monoid reduction core
# ---------------------------------------------------------------------------


def _pair_reduce(values, struct, fn, axes):
    """Reduce (values, struct) over ``axes`` with the present-aware monoid

        comp((va, pa), (vb, pb)) = (pa & pb ? fn(va, vb) : pa ? va : vb, pa | pb)

    as the reference's log-depth halving tree, step for step: float results
    come out in the reference's order, and user monoids run with no control
    flow.  SoA values reduce field by field under one structure; ``fn``
    takes and returns dicts of fields."""
    ndim = struct.dim()
    axes = tuple(sorted(ax % ndim for ax in axes))
    keep = tuple(i for i in range(ndim) if i not in axes)
    perm = keep + axes

    def rearrange(x):
        x = x.permute(perm)
        return x.reshape(tuple(x.shape[: len(keep)]) + (-1,))

    s = rearrange(struct)
    v = tmap(rearrange, values)
    keep_shape = tuple(s.shape[:-1])
    if s.shape[-1] == 0:
        return tmap(lambda x: torch.zeros(keep_shape, dtype=x.dtype, device=x.device), v), s_zeros(keep_shape, s.device)

    def tail_pad(x, lo, hi, padn):
        part = x[..., lo:hi]
        if padn:  # the b half padded with absent entries
            part = torch.cat([part, torch.zeros(tuple(part.shape[:-1]) + (padn,), dtype=part.dtype, device=part.device)], -1)
        return part

    while s.shape[-1] > 1:
        r = s.shape[-1]
        h = (r + 1) // 2
        padn = 2 * h - r
        pa = s[..., :h]
        pb = tail_pad(s, h, r, padn)
        both = pa & pb
        va = tmap(lambda x: x[..., :h], v)
        vb = tmap(lambda x: tail_pad(x, h, r, padn), v)
        v = tmap(lambda o, a, b: torch.where(both, o, torch.where(pa, a, b)), fn(va, vb), va, vb)
        s = pa | pb
    return tmap(lambda x: x[..., 0], v), s[..., 0]


def _signed_zero_fix(out, filled, which, axis):
    """jnp.min/max order -0.0 below +0.0; torch.amin/amax leave a tie of
    zeros to the reduction order.  A zero result takes -0.0 for min if any
    -0.0 was reduced (+0.0 for max if any +0.0 was)."""
    zero = filled == 0
    neg = torch.signbit(filled)
    if which == "min":
        hit = (zero & neg).any(dim=axis)
        signed = torch.where(hit, -0.0, 0.0).to(out.dtype)
    else:
        hit = (zero & ~neg).any(dim=axis)
        signed = torch.where(hit, 0.0, -0.0).to(out.dtype)
    return torch.where(out == 0, signed, out)


def _monoid_reduce(values, struct, monoid, axis):
    """Reduce with a typed monoid over one axis; vectorized paths for the
    common monoids, the present-aware halving tree for the rest.  The
    result is a carrier tensor of the monoid's type (torch, like jnp, sums
    narrow integers in int64: the values agree after the conversion)."""
    name = monoid.parent.name if hasattr(monoid, "parent") else None
    dt = monoid.type_
    if _is_soa(values):
        return _pair_reduce(values, struct, monoid.fn if monoid.fn is not None else (lambda a, b: a), (axis,))
    if name in {"plus", "times", "lor", "land", "min", "max"} and not dt._is_complex:
        if name == "plus":
            if dt._is_bool:
                out = (values & struct).any(dim=axis)
            else:
                out = torch.sum(torch.where(struct, values, _zero(values)), dim=axis)
        elif name == "times":
            if dt._is_bool:
                out = torch.where(struct, values, True).all(dim=axis)
            else:
                out = torch.prod(torch.where(struct, values, torch.ones((), dtype=values.dtype, device=values.device)), dim=axis)
        elif name == "lor":
            out = _dt.cast(torch.where(struct, values != 0, False).any(dim=axis), _dt.BOOL, dt)
        elif name == "land":
            out = _dt.cast(torch.where(struct, values != 0, True).all(dim=axis), _dt.BOOL, dt)
        else:  # min, max in the type's order
            filled = torch.where(struct, values, _dt.scalar_tensor(monoid.identity, dt, values.device))
            x = filled.to(torch.uint8) if dt._is_bool else _dt.ordered(filled, dt)
            out = torch.amin(x, dim=axis) if name == "min" else torch.amax(x, dim=axis)
            out = out != 0 if dt._is_bool else _dt.ordered(out, dt)
            if dt._is_float:
                out = _signed_zero_fix(out, filled, name, axis)
        if out.dtype != dt.carrier:
            out = _dt.wrap(out.to(dt.carrier), dt)
        return out, s_any(struct, axis=axis)
    return _pair_reduce(values, struct, monoid.fn if monoid.fn is not None else (lambda a, b: a), (axis,))


def reduce_axis(values, struct, monoid, axis):
    """Rowwise (axis=1) / columnwise (axis=0) monoid reduce -> vector."""
    v, s = _monoid_reduce(values, struct, monoid, axis)
    return canonical(v, s)


def reduce_all(values, struct, monoid):
    """Full monoid reduce -> (0-d value, 0-d present)."""
    return _monoid_reduce(tmap(lambda a: a.reshape(-1), values), struct.reshape(-1), monoid, 0)


# ---------------------------------------------------------------------------
# Elementwise family
# ---------------------------------------------------------------------------


def _safe(values, struct, op):
    """Substitute absent values with 1 before applying fns that can trap or
    give junk on the 0 canonical fill (integer division etc.)."""
    parent = getattr(op, "parent", None)
    if parent is not None and getattr(parent, "_needs_safe_fill", False):
        return torch.where(struct, values, torch.ones((), dtype=values.dtype, device=values.device))
    return values


def apply_unary(values, struct, op):
    """GrB_Matrix_apply; ``values`` in ``op.type_``."""
    return canonical(op.fn(_safe(values, struct, op)), struct)


def apply_bound(values, struct, op, bound, side):
    """Apply a binary op with one argument bound to a 0-d tensor: ``values``
    in the op's type on the free side, ``bound`` on the other
    (GrB_apply_BinaryOp1st/2nd)."""
    values = _safe(values, struct, op)
    out = op.fn(values, bound) if side == "right" else op.fn(bound, values)
    if out.shape != values.shape:
        out = out.expand(values.shape)
    return canonical(out, struct)


def apply_positional_unary(values, struct, op, offset):
    pos = op.positional
    which, delta = pos if not isinstance(pos, str) else (pos, 0)
    shape = tuple(values.shape)
    i, j = _index_grids(shape, values.device)
    idx = i if len(shape) == 1 or which == "i" else j
    out = _dt.cast(idx + delta + offset, _dt.INT64, op.return_type)
    return canonical(out.expand(shape), struct)


def _index_grids(shape, device):
    """Row and column index grids (int64) as broadcast views."""
    if len(shape) == 1:
        i = torch.arange(shape[0], dtype=_INDEX, device=device)
        return i, torch.zeros_like(i)
    i = torch.arange(shape[0], dtype=_INDEX, device=device)[:, None].expand(shape)
    j = torch.arange(shape[1], dtype=_INDEX, device=device)[None, :].expand(shape)
    return i, j


def apply_indexunary(values, struct, op, thunk):
    """GrB_Matrix_apply_IndexOp."""
    i, j = _index_grids(tuple(values.shape), values.device)
    out = op.fn(_safe(values, struct, op), i, j, thunk)
    return canonical(out.expand(values.shape), struct)


def select_op(values, struct, op, thunk):
    """GrB_Matrix_select_*: ``values`` in the collection's own type, given
    to the op as they are (as the reference does)."""
    i, j = _index_grids(tuple(values.shape), values.device)
    keep = op.fn(values, i, j, thunk)
    return canonical(values, struct & keep)


def ewise_mult(av, as_, bv, bs, op):
    """GrB_Matrix_eWiseMult (intersection); ``av`` in ``op.type_``, ``bv`` in
    ``op.type2``."""
    struct = s_and(as_, bs)
    if op.is_positional:
        return _positional_ewise(_shape_of(av), struct, op, struct.device)
    out = op.fn(_safe(av, as_, op), _safe(bv, bs, op))
    return canonical(out, struct)


def ewise_add(av, as_, bv, bs, op):
    """GrB_Matrix_eWiseAdd (union; both-present uses op)."""
    struct = s_or(as_, bs)
    if op.is_positional:
        return _positional_ewise(_shape_of(av), struct, op, struct.device)
    both = s_and(as_, bs)
    out = op.fn(_safe(av, as_, op), _safe(bv, bs, op))
    # non-intersecting entries pass through, cast to the op's output type
    ret = op.return_type
    out = tmap(
        lambda o, a, b: torch.where(both, o, torch.where(as_, a, b)),
        out, _dt.cast(av, op.type_, ret), _dt.cast(bv, op.type2, ret),
    )
    return canonical(out, struct)


def ewise_union(av, as_, bv, bs, op, left_default, right_default):
    """GxB_Matrix_eWiseUnion (union; the absent side takes its default, a
    0-d tensor in the op's input type)."""
    struct = s_or(as_, bs)
    if op.is_positional:
        return _positional_ewise(tuple(av.shape), struct, op, av.device)
    a_filled = torch.where(as_, av, left_default)
    b_filled = torch.where(bs, bv, right_default)
    return canonical(op.fn(a_filled, b_filled), struct)


def _positional_ewise(shape, struct, op, device):
    which, delta = op.positional
    i, j = _index_grids(shape, device)
    idx = {"firsti": i, "firstj": j, "secondi": i, "secondj": j}[which]
    return canonical(_dt.cast(idx + delta, _dt.INT64, op.return_type).expand(shape), struct)


# ---------------------------------------------------------------------------
# Semiring matmul family (mxm / mxv / vxm)
# ---------------------------------------------------------------------------


def _mm(x, y):
    with full_f32_matmul():
        return torch.matmul(x, y)


def _overlap(as_, bs):
    """Structural overlap counts, an f32 matmul of 0/1 indicators: exact
    while k < 2^24 (the reference multiplies int32 indicators)."""
    if as_.shape[1] >= 1 << 24:
        raise ValueError(f"mxm: k = {as_.shape[1]} is past the exact range of the f32 structure count")
    return _mm(as_.to(torch.float32), bs.to(torch.float32))


def _mxm_fast_path(av, as_, bv, bs, semiring, out_dtype):
    """Matmul lowerings for semirings that map onto plus-times algebra.

    plus_times       -> A @ B on float values (absent = 0 annihilates)
    plus_pair/oneb   -> struct @ struct (overlap counts, any numeric type)
    plus_first       -> A @ struct ; plus_second -> struct @ B (floats)
    any/lor/lxor/plus_pair over bool -> overlap > 0 (lxor: odd overlap)
    Returns None when no matmul form applies, also for integer values: torch
    has no integer GEMM on CUDA, so they take the generic contraction, which
    is exact."""
    add = semiring.monoid.parent.name
    mul = semiring.binaryop.parent.name
    if out_dtype._is_complex:
        return None
    overlap = None

    def get_overlap():
        nonlocal overlap
        if overlap is None:
            overlap = _overlap(as_, bs)
        return overlap

    if add == "plus" and not out_dtype._is_bool:
        if mul in {"pair", "oneb"}:
            cv = _dt.cast(get_overlap().to(torch.int64), _dt.INT64, out_dtype)
        elif not out_dtype._is_float:
            return None
        elif mul == "times":
            cv = _mm(_dt.cast(av, semiring.binaryop.type_, out_dtype), _dt.cast(bv, semiring.binaryop.type2, out_dtype))
        elif mul == "first":
            cv = _mm(_dt.cast(av, semiring.binaryop.type_, out_dtype), bs.to(out_dtype.carrier))
        elif mul == "second":
            cv = _mm(as_.to(out_dtype.carrier), _dt.cast(bv, semiring.binaryop.type2, out_dtype))
        else:
            return None
        return cv, get_overlap() > 0
    if add in {"lor", "any", "lxor", "plus"} and mul in {"pair", "oneb"} and out_dtype._is_bool:
        # purely structural: reachability
        cs = get_overlap() > 0
        cv = torch.remainder(get_overlap(), 2) == 1 if add == "lxor" else cs
        return cv, cs
    return None


def _mul_values(avk, bvk, ik, kk, jk, mul):
    """The (m, ck, n) product block for a typed multiply op, with positional
    multiplies (firsti/secondj/...) giving indices."""
    pos = mul.positional
    a = tmap(lambda x: x[:, :, None], avk)
    b = tmap(lambda x: x[None, :, :], bvk)
    if pos is None:
        return mul.fn(a, b)
    if pos == "indexbinary":
        return mul.fn(a, ik, kk, b, kk, jk)
    which, delta = pos
    # a is indexed (i, k); b is indexed (k, j)
    idx = {"firsti": ik, "firstj": kk, "secondi": kk, "secondj": jk}[which]
    return _dt.cast(idx + delta, _dt.INT64, mul.return_type)


def _tropical_allowed(semiring, out_dtype, m, n, strategy, av, bv):
    """Lower tropical-family semirings to the Hopper kernel: CUDA operands,
    strategy auto (float32 output, at least 128 x 128 outputs) or pallas
    (any float output, any size: the explicit opt-in to float32 compute)."""
    if strategy not in {"auto", "pallas"}:
        return False
    if m * n < 128 * 128 and strategy != "pallas":
        return False
    if not (av.is_cuda and bv.is_cuda):
        return False
    add = semiring.monoid.parent.name
    mul = semiring.binaryop.parent.name
    if not is_tropical(add, mul, out_dtype.np_type):
        return False
    if out_dtype.np_type != np.float32 and strategy != "pallas":
        return False
    return True


def mxm(av, as_, bv, bs, semiring, out_dtype, strategy="auto"):
    """GrB_mxm over any semiring.  ``av`` in the multiply's first input type,
    ``bv`` in its second; the result in ``out_dtype``.

    Strategy 1: matmul forms for plus_times-family semirings.
    Strategy 2: the tropical Hopper kernel (min_plus/max_plus/min_max/max_min).
    Strategy 3: generic chunked semiring contraction: k in chunks, each an
    (m, ck, n) broadcast multiply + present-aware halving-tree reduce, chunks
    combined with the monoid in order.

    ``strategy`` (tx.config "mxm_strategy": auto | mxu | pallas | generic)
    keeps the reference's names; "pallas" names the tropical kernel.
    UDT operands (dicts of fields) take strategy 3, field by field."""
    m, k = as_.shape
    _, n = bs.shape
    if as_.device != bs.device:
        raise ValueError(f"mxm: operands on {as_.device} and {bs.device}")
    if _is_soa(av) or _is_soa(bv):
        return _mxm_generic(av, as_, bv, bs, semiring, out_dtype)
    cv, cs = _mxm_paths(av, as_, bv, bs, semiring, out_dtype, strategy, m, n)
    if _host_concrete(as_, bs):
        # constant operand structures (structure hoisting): the output
        # structure, any_k(as_[i,k] & bs[k,j]), is a constant too
        cs_np = (_cap.host_of(as_).astype(np.float32) @ _cap.host_of(bs).astype(np.float32)) > 0
        if cs is as_ or cs is bs:
            cs = cs.clone()
        return cv, _hosted(cs, cs_np)
    return cv, cs


def _mxm_paths(av, as_, bv, bs, semiring, out_dtype, strategy, m, n):
    if semiring.binaryop.positional is None and strategy in {"auto", "mxu"}:
        fast = _mxm_fast_path(av, as_, bv, bs, semiring, out_dtype)
        if fast is not None:
            return canonical(*fast)
    if semiring.binaryop.positional is None and _tropical_allowed(semiring, out_dtype, m, n, strategy, av, bv):
        cv, cs = tropical_mxm(
            av, as_, bv, bs, semiring.monoid.parent.name, semiring.binaryop.parent.name, out_dtype.carrier
        )
        return canonical(cv, cs)
    return _mxm_generic(av, as_, bv, bs, semiring, out_dtype)


def _mxm_generic(av, as_, bv, bs, semiring, out_dtype):
    """The generic contraction; UDT values (dicts of fields) go through it
    field by field, the user operators taking and returning dicts."""
    from ..core.utils import zero_values

    add = semiring.monoid
    mul = semiring.binaryop
    m, k = as_.shape
    _, n = bs.shape
    dev = as_.device
    chunk = min(_MXM_CHUNK, max(k, 1))
    pad = (-k) % chunk if k else chunk
    if pad:
        av = tmap(lambda x: torch.cat([x, torch.zeros((m, pad), dtype=x.dtype, device=dev)], 1), av)
        as_ = torch.cat([as_, s_zeros((m, pad), dev)], 1)
        bv = tmap(lambda x: torch.cat([x, torch.zeros((pad, n), dtype=x.dtype, device=dev)], 0), bv)
        bs = torch.cat([bs, s_zeros((pad, n), dev)], 0)
    nchunks = as_.shape[1] // chunk
    shape = (m, chunk, n)
    i_grid = j_grid = k_local = None
    if mul.positional is not None:
        i_grid = torch.arange(m, dtype=_INDEX, device=dev)[:, None, None].expand(shape)
        j_grid = torch.arange(n, dtype=_INDEX, device=dev)[None, None, :].expand(shape)
        k_local = torch.arange(chunk, dtype=_INDEX, device=dev)[None, :, None].expand(shape)
    fn = add.fn if add.fn is not None else (lambda a, b: a)
    safe = getattr(mul.parent, "_needs_safe_fill", False)

    cv = zero_values((m, n), out_dtype, dev)
    cs = s_zeros((m, n), dev)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        avk, ask = tmap(lambda x: x[:, sl], av), as_[:, sl]
        bvk, bsk = tmap(lambda x: x[sl], bv), bs[sl]
        pres = ask[:, :, None] & bsk[None, :, :]
        if safe:
            avk = torch.where(ask, avk, torch.ones((), dtype=avk.dtype, device=dev))
            bvk = torch.where(bsk, bvk, torch.ones((), dtype=bvk.dtype, device=dev))
        kk = None if k_local is None else k_local + c * chunk
        prod = _mul_values(avk, bvk, i_grid, kk, j_grid, mul)
        prod = _dt.cast(tmap(lambda x: x.expand(shape), prod), mul.return_type, out_dtype)
        bv_red, bs_red = _pair_reduce(prod, pres, fn, (1,))
        both = cs & bs_red
        keep_c = cs
        cv = tmap(lambda mg, a, b: torch.where(both, mg, torch.where(keep_c, a, b)), fn(cv, bv_red), cv, bv_red)
        cs = cs | bs_red
    return canonical(cv, cs)


def mxv(av, as_, xv, xs, semiring, out_dtype, strategy="auto"):
    """GrB_mxv: v as a column, so positional multiplies see j = 0."""
    cv, cs = mxm(av, as_, tmap(lambda x: x[:, None], xv), xs[:, None], semiring, out_dtype, strategy)
    return tmap(lambda x: x[:, 0], cv), cs[:, 0]


def vxm(xv, xs, bv, bs, semiring, out_dtype, strategy="auto"):
    """GrB_vxm: v as a row."""
    cv, cs = mxm(tmap(lambda x: x[None, :], xv), xs[None, :], bv, bs, semiring, out_dtype, strategy)
    return tmap(lambda x: x[0], cv), cs[0]


def kronecker(av, as_, bv, bs, op, out_dtype):
    """GrB_kronecker."""
    m, n = av.shape
    p, q = bv.shape
    prod = op.fn(_safe(av, as_, op)[:, None, :, None], _safe(bv, bs, op)[None, :, None, :])
    pres = as_[:, None, :, None] & bs[None, :, None, :]
    cv = _dt.cast(prod.expand(m, p, n, q).reshape(m * p, n * q), op.return_type, out_dtype)
    cs = pres.expand(m, p, n, q).reshape(m * p, n * q)
    return canonical(cv, cs)


# ---------------------------------------------------------------------------
# Extract / assign
# ---------------------------------------------------------------------------


def _index(idx, device):
    return _cap.upload(np.asarray(idx, np.int64), device)


def extract_matrix(values, struct, rows, cols):
    """GrB_Matrix_extract at host index arrays ``rows`` x ``cols``."""
    r, c = _index(rows, struct.device), _index(cols, struct.device)
    return tmap(lambda a: a.index_select(0, r).index_select(1, c), values), struct.index_select(0, r).index_select(1, c)


def extract_vector(values, struct, idx):
    i = _index(idx, struct.device)
    return tmap(lambda a: a.index_select(0, i), values), struct.index_select(0, i)


def _host_region(cs, as_, write):
    """The host values of (zs, rsel) of a region scatter when C's structure
    and the region's are constants of a compiled loop, else None: the
    structure of an assign into a hoisted state stays a constant."""
    if not _host_concrete(cs, as_):
        return None
    zs = _cap.host_of(cs).copy()
    rsel = np.zeros(zs.shape, bool)
    write(zs, rsel, _cap.host_of(as_))
    return zs, rsel


def _region_out(zs, rsel, host, contig_rsel=None):
    """(zs, rsel) with their host values; a contiguous region's selector is
    a constant even where the structures are traced (as in the reference)."""
    if host is not None:
        return _hosted(zs, host[0]), _hosted(rsel, host[1])
    if contig_rsel is not None and _cap.active() is not None:
        hr = np.zeros(tuple(rsel.shape), bool)
        hr[contig_rsel] = True
        return zs, _hosted(rsel, hr)
    return zs, rsel


def _set_copy(c, key, a):
    """A copy of ``c`` with ``c[key] = a``."""
    z = c.clone()
    z[key] = a
    return z


def scatter_region_matrix(cv, cs, rows, cols, av, as_):
    """Scatter a region-shaped (av, as_), ``av`` in C's carrier, into a copy
    of C at rows x cols; also returns the region-selector bool array (the
    assign/subassign semantics)."""
    r, c = _index(rows, cs.device)[:, None], _index(cols, cs.device)[None, :]
    zv = tmap(lambda x, a: _set_copy(x, (r, c), a), cv, av)
    zs = cs.clone()
    zs[r, c] = as_
    rsel = torch.zeros(cs.shape, dtype=torch.bool, device=cs.device)
    rsel[r, c] = True

    def write(hz, hr, ha):
        ri, ci = np.asarray(rows)[:, None], np.asarray(cols)[None, :]
        hz[ri, ci] = ha
        hr[ri, ci] = True

    return (zv, *_region_out(zs, rsel, _host_region(cs, as_, write)))


def scatter_region_vector(cv, cs, idx, av, as_):
    i = _index(idx, cs.device)
    zv = tmap(lambda x, a: _set_copy(x, i, a), cv, av)
    zs = cs.clone()
    zs[i] = as_
    rsel = torch.zeros(cs.shape, dtype=torch.bool, device=cs.device)
    rsel[i] = True

    def write(hz, hr, ha):
        hz[np.asarray(idx)] = ha
        hr[np.asarray(idx)] = True

    return (zv, *_region_out(zs, rsel, _host_region(cs, as_, write)))


def scatter_region_vector_contig(cv, cs, av, as_, start=0):
    """Contiguous-region variant of ``scatter_region_vector`` (slice assigns,
    ``v(mask)[:] = x``): slice copies instead of an index scatter."""
    size = as_.shape[0]
    zv = tmap(lambda x, a: _set_copy(x, slice(start, start + size), a), cv, av)
    zs = cs.clone()
    zs[start : start + size] = as_
    rsel = torch.zeros(cs.shape, dtype=torch.bool, device=cs.device)
    rsel[start : start + size] = True

    def write(hz, hr, ha):
        hz[start : start + size] = ha
        hr[start : start + size] = True

    return (zv, *_region_out(zs, rsel, _host_region(cs, as_, write), slice(start, start + size)))


def scatter_region_matrix_contig(cv, cs, av, as_, rstart=0, cstart=0):
    """Contiguous 2-D region variant of ``scatter_region_matrix``."""
    nr, nc = as_.shape
    region = (slice(rstart, rstart + nr), slice(cstart, cstart + nc))
    zv = tmap(lambda x, a: _set_copy(x, region, a), cv, av)
    zs = cs.clone()
    zs[region] = as_
    rsel = torch.zeros(cs.shape, dtype=torch.bool, device=cs.device)
    rsel[region] = True

    def write(hz, hr, ha):
        hz[region] = ha
        hr[region] = True

    return (zv, *_region_out(zs, rsel, _host_region(cs, as_, write), region))


def _contig_start(idx, dim):
    """Start offset when host ``idx`` is a contiguous ascending index range
    (slice-shaped), else None."""
    k = idx.shape[0]
    if k == 0:
        return None
    start = int(idx[0])
    if int(idx[-1]) - start != k - 1 or start < 0 or start + k > dim:
        return None
    if k > 1 and not bool((np.diff(idx) == 1).all()):
        return None
    return start


# ---------------------------------------------------------------------------
# Mask / accumulator merge: the single sink every mutating op funnels through
# (analogue of BaseType._update -> GrB call)
# ---------------------------------------------------------------------------


def masked_merge(cv, cs, zv, zs, mask_bits, accum, replace, has_mask, region=None, *, c_type, z_type):
    """Combine computed result Z (values in ``z_type``) into C (``c_type``)
    under mask/accum/replace semantics; the result in ``c_type``.

    - accum: None -> Z replaces C's pattern; else accum(C, Z) on the
      intersection (Z first converted to C's type, as the reference does),
      pass-through on either-only.
    - mask_bits: bool tensor (already complemented if needed), or unused
      when has_mask=False.
    - replace: outside-mask entries are cleared (within ``region`` when
      given, GxB_subassign semantics; everywhere for GrB ops).
    - region: bool tensor limiting where Z applies (assign/subassign); None
      means the whole output.

    UDT values (dicts of fields) go through field by field (a UDT converts
    only to itself).
    """
    if cs.device != zs.device:
        raise ValueError(f"update: the output is on {cs.device} but the result on {zs.device}")
    zv = _dt.cast(zv, z_type, c_type)
    if accum is not None:
        both = s_and(cs, zs)
        acc = accum.fn(_dt.cast(cv, c_type, accum.type_), _dt.cast(zv, c_type, accum.type2))
        zv = tmap(
            lambda a, z, c: torch.where(both, a, torch.where(zs, z, c)), _dt.cast(acc, accum.return_type, c_type), zv, cv
        )
        zs = s_or(cs, zs)
    if not has_mask:
        # no mask: Z already restricted to region by construction
        return canonical(zv, zs)
    m = mask_bits
    if region is not None:
        # mask applies only within the region; outside-region keeps C
        keep_z = s_and(m, region)
        if replace:
            out_s = s_where(keep_z, zs, s_where(region, s_zeros((), cs.device), cs))
        else:
            out_s = s_where(keep_z, zs, cs)
        return canonical(tmap(lambda z, c: torch.where(keep_z, z, c), zv, cv), out_s)
    if replace:
        return canonical(tmap(lambda z: torch.where(m, z, _zero(z)), zv), s_and(m, zs))
    return canonical(tmap(lambda z, c: torch.where(m, z, c), zv, cv), s_where(m, zs, cs))


def mask_to_bits(mv, ms, complement, structural):
    """Resolve one of the 4 mask types to a bool tensor."""
    if structural:
        bits = ms
    else:
        bits = s_and(ms, mv != 0 if mv.dtype != torch.bool else mv)
    if complement:
        bits = s_not(bits)
    return bits


# ---------------------------------------------------------------------------
# Positional / order-based reductions (argmin/argmax/first/last aggregators)
# ---------------------------------------------------------------------------


def argminmax_axis(values, struct, which, axis, dtype):
    """Index of the first smallest (largest) present value along ``axis``
    (NaN first, as numpy's argmin/argmax); int64 indices."""
    if dtype._is_float:
        big, small = float("inf"), float("-inf")
        x = values
    elif dtype._is_bool:
        big, small = 1, 0
        x = values.to(torch.uint8)
    else:
        info = np.iinfo(dtype.np_type)
        big, small = int(info.max), int(info.min)
        if dtype.np_type == np.uint64:
            big, small = (1 << 63) - 1, -(1 << 63)  # in the ordered carrier
        x = _dt.ordered(values, dtype)
    fill = torch.full((), big if which == "min" else small, dtype=x.dtype, device=x.device)
    filled = torch.where(struct, x, fill)
    if dtype._is_float:
        # torch's argmin/argmax leave NaN to the reduction; numpy's take the first
        nan = torch.isnan(filled)
        has_nan = nan.any(dim=axis)
        first_nan = torch.argmax(nan.to(torch.uint8), dim=axis)
    idx = torch.argmin(filled, dim=axis) if which == "min" else torch.argmax(filled, dim=axis)
    if dtype._is_float:
        idx = torch.where(has_nan, first_nan, idx)
    return idx.to(torch.int64), struct.any(dim=axis)


def firstlast_axis(values, struct, which, axis):
    n = struct.shape[axis]
    shape = [1] * struct.dim()
    shape[axis] = n
    pos = torch.arange(n, dtype=_INDEX, device=struct.device).reshape(shape).expand(struct.shape)
    if which == "first":
        idx = torch.where(struct, pos, n).amin(dim=axis)
    else:
        idx = torch.where(struct, pos, -1).amax(dim=axis)
    s = struct.any(dim=axis)
    idx = idx.clamp(0, max(n - 1, 0))
    vals = torch.take_along_dim(values, idx.unsqueeze(axis), dim=axis).squeeze(axis)
    return vals, idx, s


# ---------------------------------------------------------------------------
# Misc structure ops
# ---------------------------------------------------------------------------


def transpose(values, struct):
    return tmap(lambda a: a.T, values), struct.T


def reposition_matrix(values, struct, row_offset, col_offset):
    """GrB_Matrix_reposition recipe: shift via roll + zeroing out-of-range."""
    rolled_v = torch.roll(torch.roll(values, row_offset, 0), col_offset, 1)
    rolled_s = torch.roll(torch.roll(struct, row_offset, 0), col_offset, 1)
    i, j = _index_grids(tuple(values.shape), values.device)
    nr, nc = values.shape
    valid = (i >= row_offset if row_offset >= 0 else i < nr + row_offset) & (
        j >= col_offset if col_offset >= 0 else j < nc + col_offset
    )
    return canonical(torch.where(valid, rolled_v, _zero(values)), torch.where(valid, rolled_s, False))


def diag_extract(values, struct, k):
    """Extract diagonal k as a vector."""
    return torch.diagonal(values, offset=k), torch.diagonal(struct, offset=k)


def diag_build(values, struct, k, nrows, ncols):
    """Build a matrix with a vector on diagonal k."""
    n = values.shape[0]
    out_v = torch.zeros((nrows, ncols), dtype=values.dtype, device=values.device)
    out_s = s_zeros((nrows, ncols), values.device)
    idx = torch.arange(n, device=values.device)
    rows = idx + (-k if k < 0 else 0)
    cols = idx + (k if k > 0 else 0)
    out_v[rows, cols] = values
    out_s[rows, cols] = struct
    return out_v, out_s


def _associative_scan(fn, elems, axis):
    """``jax.lax.associative_scan``'s recursion (odd/even halving), so the
    combine order, and float results, are the reference's."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]

    reduced = fn([sl(e, 0, -1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems])
    odd = _associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd], [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], axis) for e, r in zip(elems, even)]

    def interleave(a, b):
        # a holds the even positions (one more when n is odd), b the odd ones
        out_shape = list(a.shape)
        out_shape[axis] = a.shape[axis] + b.shape[axis]
        out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
        idx = [slice(None)] * a.dim()
        idx[axis] = slice(0, None, 2)
        out[tuple(idx)] = a
        idx[axis] = slice(1, None, 2)
        out[tuple(idx)] = b
        return out

    return [interleave(e, o) for e, o in zip(even, odd)]


def prefix_scan(values, struct, monoid, axis):
    """Prefix scan over present entries along an axis (the reference's
    ``associative_scan`` of the present-aware monoid)."""
    fn = monoid.fn if monoid.fn is not None else (lambda a, b: a)

    def comp(a, b):
        va, pa = a
        vb, pb = b
        both = pa & pb
        return [torch.where(both, fn(va, vb), torch.where(pb, vb, va)), pa | pb]

    v, _ = _associative_scan(comp, [values, struct], axis)
    # the result is present where the original entry was present
    return canonical(v, struct)


def flatten_matrix(values, struct):
    return tmap(lambda a: a.reshape(-1), values), struct.reshape(-1)

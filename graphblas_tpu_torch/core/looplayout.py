"""Edge-layout ("loop layout") lowering of compiled DSL loops.

Counterpart of ``graphblas_tpu/core/looplayout.py``.  The reference's
n-space SpMV is place route -> fill -> perm route -> contrib scan -> collect
route; an iterative loop needs one route fewer when its state lives in the
edge space at dst-segment-last slots (the loop layout of ``models/fast.py``):
loop route -> fill -> perm route -> C.  The port's n-space SpMV is two
launches, C with x's gather fused and the collect (``ops/fastspmv.py``); the
n space is the card's default lowering.  This module lets ``gb.loop`` / ``gb.until`` (``core/compiler.py``) run a
user-written DSL body in that layout:

- every state Vector of size n is carried as an e_pad tensor whose vertex v
  value lives at v's dst-segment-last slot (its "state slot"); a total plan
  (``build_spmv_plan(total=True)``) gives every vertex one;
- elementwise ops, apply and masked merges are slot-wise and unchanged;
- every structure in the context is a subset of the state slots (``is_last``),
  so reduces over a structure are exact; complemented masks are cut back to
  the state slots (``Mask._bits``);
- ``A.mxv(x)`` against the context's matrix runs ``edge_mxv``;
- anything the layout cannot express (positional ops, indexing other than
  the full slice, a second matrix or direction, a partial SpMV input) raises
  ``LayoutUnsupported`` and the compiler keeps the n-space lowering.  Both
  run the same kernels; the results are the same.
"""

import contextvars

import numpy as np
import torch

from . import capture as _cap

_CTX = contextvars.ContextVar("graphblas_tpu_torch_looplayout", default=None)
_PROBE = contextvars.ContextVar("graphblas_tpu_torch_looplayout_probe", default=None)


class LayoutUnsupported(Exception):
    """Internal: the DSL body used an op the edge layout cannot express."""


def active():
    return _CTX.get()


def probing():
    return _PROBE.get()


class _ProbeScope:
    """Records every sparse mxv/vxm dispatch of a compiled loop's n-space
    warm step: the compiler reads the record to decide whether the edge
    layout can apply and which matrix and direction it binds."""

    def __init__(self):
        self.calls = []
        self.token = None

    def __enter__(self):
        self.token = _PROBE.set(self)
        return self

    def __exit__(self, *exc):
        _PROBE.reset(self.token)
        return False

    def record(self, sp, pull, a_first, sr):
        self.calls.append({"sp": sp, "pull": bool(pull), "a_first": bool(a_first), "sr": sr})

    def eligible(self):
        """The single (sparse matrix, direction) every SpMV used, or None."""
        if not self.calls:
            return None
        keys = {(id(c["sp"]), c["pull"]) for c in self.calls}
        if len(keys) != 1:
            return None
        c = self.calls[0]
        return c["sp"], c["pull"]


def host_tables(plan):
    """The plan's state-slot tables on the host, derived once and kept on the
    plan (``graphblas_tpu/ops/fastspmv.py:host_tables``):

    - ``v_of_slot`` int64 (e_pad,): the dst vertex owning each dst-order slot
    - ``is_last`` bool (e_pad,): dst-segment-last slots (the state slots)
    - ``slot_of_v`` int64 (n,): each vertex's state slot (total plans only)
    - ``dst_nonempty`` bool (n,)
    """
    h = plan.__dict__.setdefault("_host", {})
    if not h:
        with _cap.constants():
            ipd = plan.indptr_dst.cpu().numpy().astype(np.int64)
            h["v_of_slot"] = np.repeat(np.arange(plan.n, dtype=np.int64), np.diff(ipd))
            h["is_last"] = plan.is_last_dst.cpu().numpy()
            h["slot_of_v"] = ipd[1:] - 1
            h["dst_nonempty"] = plan.dst_nonempty.cpu().numpy()
    return h


class EdgeLayoutCtx:
    """Active while the compiler runs a DSL body in the edge layout."""

    def __init__(self, sp, plan, pull):
        if not plan.total or plan.loop_idx is None:
            raise LayoutUnsupported("plan is not total/loop-capable")
        if plan.e_pad == plan.n:
            # size-based layout detection would be ambiguous
            raise LayoutUnsupported("e_pad == n")
        self.sp = sp
        self.plan = plan
        self.pull = pull
        self.n = plan.n
        self.e_pad = plan.e_pad
        h = host_tables(plan)
        self.v_of_slot = h["v_of_slot"]
        self.is_last = h["is_last"]
        self.slot_of_v = h["slot_of_v"]
        self.dst_nonempty = h["dst_nonempty"]
        self._cache = {}
        self._token = None

    # -- scope ---------------------------------------------------------------

    def __enter__(self):
        self._token = _CTX.set(self)
        return self

    def __exit__(self, *exc):
        _CTX.reset(self._token)
        return False

    # -- layout predicates -----------------------------------------------------

    def is_state_sized(self, obj):
        return getattr(obj, "ndim", None) == 1 and obj.shape[0] == self.e_pad

    def is_n_sized(self, obj):
        return getattr(obj, "ndim", None) == 1 and obj.shape[0] == self.n

    # -- constants of the layout, on the card with their host values ------------

    def _const(self, key, host, device):
        """A constant tensor of the layout (made once per device, with its host
        value: a constant of the compiled loop)."""
        ck = (key, str(device))
        t = self._cache.get(ck)
        if t is None:
            with _cap.constants():
                t = torch.from_numpy(np.ascontiguousarray(host)).to(device)
            if t.dtype == torch.bool:
                _cap.with_host(t, host)
            self._cache[ck] = t
        return t

    def universe(self, device):
        """The state slots ``is_last`` as a structure."""
        return self._const("is_last", self.is_last, device)

    def slots(self, device):
        """Each vertex's state slot (int64), for the n -> edge lift."""
        return self._const("slot_of_v", self.slot_of_v, device)

    def guard_universe(self, bits):
        """Structures and mask bits in the context never mark non-state slots
        (a complemented mask would otherwise resurrect garbage slots)."""
        from ..ops import densemasked as _dm

        return _dm.s_and(bits, self.universe(bits.device))

    def lift_struct_np(self, s_n):
        """n structure -> edge layout, masked to the state-slot universe."""
        return np.asarray(s_n)[self.v_of_slot] & self.is_last

    def lift_vector(self, vec):
        """A concrete n-sized Vector operand (closed over by the body) -> an
        e_pad edge-layout Vector: values at the state slots of its entries.
        Made once per operand and kept (a constant of the loop)."""
        from .vector import Vector

        v, s = vec._values, vec._struct
        key = ("lift", id(v), id(s))
        hit = self._cache.get(key)
        if hit is not None and hit[0] is v and hit[1] is s:
            return Vector._from_arrays(hit[2], hit[3], vec.dtype, name=vec.name)
        if _cap.is_traced(v) or _cap.is_traced(s):
            raise LayoutUnsupported("abstract n-sized operand in edge-layout body")
        hs = _cap.host_of(s)
        es = self.lift_struct_np(hs)
        dev = v.device
        with _cap.constants():
            slots = self.slots(dev)
            ev = torch.zeros(self.e_pad, dtype=v.dtype, device=dev)
            ev[slots] = v
            ev = torch.where(self.universe(dev) & torch.from_numpy(es).to(dev), ev, torch.zeros((), dtype=v.dtype, device=dev))
            es_t = torch.from_numpy(es).to(dev)
        _cap.with_host(es_t, es)
        self._cache[key] = (v, s, ev, es_t)
        return Vector._from_arrays(ev, es_t, vec.dtype, name=vec.name)

    def ys_nonempty(self, device):
        """Edge-layout structure of an SpMV output for a full input: present
        exactly at state slots of vertices with at least one valid in-edge."""
        host = self._cache.get("ys_nonempty_host")
        if host is None:
            host = self.is_last & self.dst_nonempty[self.v_of_slot]
            self._cache["ys_nonempty_host"] = host
        return self._const("ys_nonempty", host, device)


# ---------------------------------------------------------------------------
# the edge-layout SpMV: loop route (G) -> fill (G) -> perm route (G) -> C
# ---------------------------------------------------------------------------

_EDGE_ADDS = {"plus", "min", "max", "any"}
_EDGE_MULS = {"times", "plus", "first", "second"}


def edge_mxv(ctx, sp, pull, a_first, xv, xs, sr, out_dtype):
    """Loop-layout SpMV on edge-layout state ``xv`` (values at state slots).

    Returns (values e_pad, structure e_pad).  Raises LayoutUnsupported for
    anything the layout cannot express: the compiler then keeps the n-space
    lowering for the whole loop.
    """
    from ..ops import fastspmv as _fs
    from ..ops.permute import apply_perm
    from ..ops.scan import segmented_scan_contrib
    from . import dtypes as _dt
    from .sparse import _plan_mul_name

    if sp is not ctx.sp:
        raise LayoutUnsupported("SpMV against a second matrix in an edge-layout loop")
    if bool(pull) != ctx.pull:
        raise LayoutUnsupported("SpMV in both directions in an edge-layout loop")
    mul = sr.binaryop
    add_name = sr.monoid.parent.name
    if mul.positional is not None:
        raise LayoutUnsupported("positional semiring in edge layout")
    plan_mul = _plan_mul_name(mul, a_first, None)
    if add_name not in _EDGE_ADDS or plan_mul not in _EDGE_MULS:
        raise LayoutUnsupported(f"semiring {sr.name} has no edge-layout channel")
    out_np = np.dtype(out_dtype.np_type)
    channel = _edge_channel(out_np, add_name)
    if channel is None:
        raise LayoutUnsupported(f"no exact edge-layout channel for {out_np}")
    xs_np = _cap.host_of(xs)
    if xs_np is None:
        raise LayoutUnsupported("data-dependent SpMV input structure")
    if not (xs_np | ~ctx.is_last).all():
        # partial input: the scan would need a routed structure channel
        raise LayoutUnsupported("partial (non-full) SpMV input in edge layout")

    dev = xv.device
    plan = sp.plan("pull" if pull else "push", dev, loop=True)
    if plan is not ctx.plan:  # pragma: no cover - plan replaced mid-run
        raise LayoutUnsupported("plan changed between probe and edge run")
    wrap = None
    if channel == np.int32 and out_np.kind in "iu" and out_np.itemsize < 4:
        wrap = (out_np.itemsize * 8, out_np.kind == "i")
    ch = _dt.INT32 if channel == np.int32 else _dt.FP32
    x_type = _dt.lookup_dtype(xv.dtype)
    x_start = apply_perm(_dt.cast(xv, x_type, ch).contiguous(), plan.loop_idx)  # state -> start slots
    xe = _fs._seg_fill(plan, x_start)
    xe_dst = apply_perm(xe, plan.perm_idx)
    w = plan.w_dst_order if plan_mul in ("times", "plus", "second") else None
    if w is not None and w.dtype != xe_dst.dtype:
        w = w.to(xe_dst.dtype)
    op_add = {"plus": "add", "min": "min", "max": "max", "any": "max"}[add_name]
    scanned = segmented_scan_contrib(xe_dst, w, plan.valid_dst_order, plan.seg_start_dst, op_add, plan_mul, wrap)
    ys = ctx.ys_nonempty(dev)
    yv = _dt.cast(scanned, _dt.lookup_dtype(scanned.dtype), out_dtype)
    yv = torch.where(ys, yv, torch.zeros((), dtype=yv.dtype, device=dev))
    return yv, ys


def _edge_channel(out_np, add_name):
    """Exact engine channel for the edge layout (``sparse._plan_channel``
    less the value-range cases, which need concrete inputs: loop state is
    abstract, so 64-bit outputs reject instead of range-checking)."""
    kind = out_np.kind
    if out_np == np.float32:
        return np.float32
    if kind == "b" or (kind in "iu" and out_np.itemsize <= 2) or out_np == np.int32:
        return np.int32
    if out_np == np.uint32:
        # min/max would compare sign-flipped through the int32 channel
        return np.int32 if add_name in ("plus", "any") else None
    return None


# value-only IndexUnaryOp/SelectOp families: exact in any layout (they never
# read the index).  Everything else is index-dependent: slot ids are not
# vertex ids, so the edge layout rejects them.
_VALUE_ONLY_OPS = {"valueeq", "valuene", "valuelt", "valuele", "valuegt", "valuege"}


def reject_index_semantics(obj, op, what):
    """Raise LayoutUnsupported for index-dependent ops on edge-layout state
    (positions in the edge layout are slot ids, not vertex ids)."""
    ctx = _CTX.get()
    if ctx is None or getattr(obj, "ndim", None) != 1:
        return
    if obj.shape[0] != ctx.e_pad:
        return
    name = getattr(getattr(op, "parent", op), "name", None) or getattr(op, "name", "")
    if str(name).split("[")[0] in _VALUE_ONLY_OPS:
        return
    raise LayoutUnsupported(f"{what} ({name}) is index-dependent in the edge layout")


def state_to_n_total(plan, v_state):
    """Exit conversion: edge-layout values -> (n,) through the collect route
    (G; bool as bytes).  A total plan covers every vertex, so nothing needs
    masking.  Values of 8 bytes, which G does not move, take one torch
    gather."""
    from ..kernels.gather import DTYPES
    from ..ops.permute import apply_perm

    v = v_state.contiguous()
    if v.dtype == torch.bool:
        return apply_perm(v.view(torch.uint8), plan.collect_idx)[: plan.n].view(torch.bool)
    if v.dtype not in DTYPES:
        return v.index_select(0, plan.collect_idx[: plan.n].long())
    return apply_perm(v, plan.collect_idx)[: plan.n]

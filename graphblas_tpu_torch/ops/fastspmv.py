"""Analyzed-COO SpMV: a graph is analyzed once into an ``SpmvPlan``, then
every SpMV is one contrib scan over the edges in dst order, x read by index
into its tiles, and one collect of the segment totals.

Counterpart of ``graphblas_tpu/ops/fastspmv.py``.  The slot layout is the
reference's, slot for slot: ``e_pad`` from ``padded_size``, the same stable
sorts, state at dst-segment-last slots and the same donor slots.  The four
routes (place, perm, collect, loop) are the int32 index arrays the reference
computes before it builds its networks, applied by one gather each
(``ops.permute.apply_perm``).

Pipeline of ``spmv`` and ``spmv_masked`` (value channel):

    x (n) --contrib scan, xe[p] = x[src_dst_order[p]] read inside its tiles-->
      totals at dst-seg-last slots --collect route (n slots)--> y (n)

``src_dst_order[p]`` is the source vertex of dst-order slot p, pad slots
included, so the scan's value channel is exactly what the reference's
expand (place route, fill, perm route) builds in the edge space; the
kernel (``segmented_scan_contrib_gather``) reads it from x directly.  x's
structure, when x is not full, is one gather through the same index
(``_expand_dst``).  Without endpoint routes, y is read at the dst-segment
ends.  A JAX-package plan file may lack ``src_dst_order``;
``plan_from_reference`` derives it as ``src_sorted[perm_idx]``.

The routes stay in the plan for the loop layout, one step of which
(``spmv_state``, v2 plans) is

    x at src-seg-start slots --fill--> x[src] per edge (src order)
      --perm route--> dst order --contrib scan--> totals at dst-seg-last slots

and for ``models/fast.py``.  Plans are saved in the port's own format
(``save_spmv_plan`` / ``load_spmv_plan``: the composed index arrays, not
networks); ``plan_from_reference`` reads the JAX package's plan files.
"""

import numpy as np
import torch

from ..exceptions import IndexOutOfBound
from ..native import counting_sort
from .permute import apply_perm, compose_reference_network, padded_size
from .. import kernels
from ..core import capture as _cap
from ..kernels import segscan as _segscan
from .scan import (
    _ident,
    build_fill_tables,
    segmented_fill_static,
    segmented_scan,
    segmented_scan_contrib,
    segmented_scan_contrib_gather,
    segmented_spmm,
)

# tensors of a plan, in the order of graphblas_tpu/ops/fastspmv.py:SpmvPlan
ARRAYS = (
    "src_sorted",  # int32: src of each edge in src-sorted order
    "w_dst_order",  # weights in dst order (f32 or int32), or None
    "indptr_src",  # int32 (n+1,): src segment boundaries
    "indptr_dst",  # int32 (n+1,): dst segment boundaries
    "perm_idx",  # int32 route: src order -> dst order
    "valid_dst_order",  # bool: real edge (dst order)
    "src_dst_order",  # int32: src id of each dst-order slot
    "place_idx",  # int32 route: x[i] -> start slot of src segment i
    "collect_idx",  # int32 route: last slot of dst segment d -> position d
    "seg_start_src",  # bool
    "seg_start_dst",  # bool
    "dst_nonempty",  # bool (n,): >= 1 valid in-edge
    "loop_idx",  # int32 route: dst-seg-last (state) slots -> src-seg-start slots
    "start_has_state",  # bool: the start slot's vertex owns a state slot
    "is_last_dst",  # bool: state slots
    "outdeg_start",  # f32: valid out-degree at start slots, clamped to >= 1
    "last_dangling",  # bool: state slots of vertices with no valid out-edge
    "fill_src",  # int32: latest seg_start_src slot <= p, or -1
)


class SpmvPlan:
    """Static layout and routes for y[d] = REDUCE over edges (s -> d) of
    x[s] (*) w.  A plain holder of tensors; ``to(device)`` moves them.

    ``order_dst`` (host numpy, or None) is the build's dst-order sort of the
    padded edge list: it lets a saved plan take new weights of the same
    pattern (``load_spmv_plan(path, w=...)``)."""

    def __init__(self, n, e_pad, arrays, *, k_iso_dangling=0, loop_donors=False, total=False, order_dst=None):
        unknown = set(arrays) - set(ARRAYS)
        if unknown:
            raise ValueError(f"SpmvPlan: unknown arrays {sorted(unknown)}")
        self.n = int(n)
        self.e_pad = int(e_pad)
        for name in ARRAYS:
            setattr(self, name, arrays.get(name))
        # isolated dangling vertices (no state slot): folded into the mass
        self.k_iso_dangling = int(k_iso_dangling)
        # the loop route feeds no-state start slots from identity donor slots
        self.loop_donors = bool(loop_donors)
        self.total = bool(total)
        self.order_dst = order_dst

    def arrays(self):
        """The plan's tensors by name (None entries left out)."""
        return {k: getattr(self, k) for k in ARRAYS if getattr(self, k) is not None}

    @property
    def device(self):
        return self.valid_dst_order.device

    def to(self, device):
        moved = {k: v.to(device) for k, v in self.arrays().items()}
        return SpmvPlan(
            self.n, self.e_pad, moved,
            k_iso_dangling=self.k_iso_dangling, loop_donors=self.loop_donors, total=self.total,
            order_dst=self.order_dst,
        )

    def __repr__(self):
        return f"SpmvPlan(n={self.n}, e_pad={self.e_pad}, device={self.device})"


def _complete_permutation(partial, e_pad):
    """Fill -1 targets of a partial routing with the unused sources."""
    used = np.zeros(e_pad, bool)
    assigned = partial >= 0
    used[partial[assigned]] = True
    partial[~assigned] = np.flatnonzero(~used)
    return partial


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _padded_weights(w, e_pad):
    """Weights as float32 or int32 (as the reference casts them), zero-padded
    to ``e_pad``."""
    w_arr = np.asarray(w)
    if w_arr.dtype not in (np.dtype(np.float32), np.dtype(np.int32)):
        w_arr = w_arr.astype(np.float32)
    return np.concatenate([w_arr, np.zeros(e_pad - len(w_arr), w_arr.dtype)])


def build_spmv_plan(
    src, dst, w=None, *, n=None, endpoints=True, pad_to=0, loop_net=True, total=False, device="cuda"
):
    """Analyze a COO graph into an SpmvPlan (host-side numpy, once per graph),
    with its tensors on ``device``.

    ``endpoints`` builds the place/collect routes and the loop-layout tables;
    ``loop_net`` the loop route; ``pad_to`` forces a minimum ``e_pad``;
    ``total`` gives every vertex a state slot (one invalid pad edge per
    in-degree-0 vertex).  Same semantics as the JAX package's builder."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    e = len(src)
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    elif e and (min(int(src.min()), int(dst.min())) < 0 or max(int(src.max()), int(dst.max())) >= n):
        raise IndexOutOfBound(
            f"edge endpoints out of range for n={n}: src in [{int(src.min())}, {int(src.max())}], "
            f"dst in [{int(dst.min())}, {int(dst.max())}]"
        )
    e_pad = padded_size(max(e, n, pad_to))
    stateless = None
    if total:
        stateless = np.flatnonzero(np.bincount(dst, minlength=n) == 0)
        if e + len(stateless) > e_pad:
            e_pad = padded_size(max(e + len(stateless), n, pad_to))
    # pad with invalid edges (n-1 -> n-1)
    pad = e_pad - e
    src_p = np.concatenate([src, np.full(pad, n - 1, np.int32)])
    dst_p = np.concatenate([dst, np.full(pad, n - 1, np.int32)])
    if stateless is not None and len(stateless):
        dst_p[e : e + len(stateless)] = stateless.astype(np.int32)
    valid_p = np.zeros(e_pad, bool)
    valid_p[:e] = True
    w_p = _padded_weights(w, e_pad) if w is not None else None

    order_src = counting_sort(src_p, n)
    order_dst = counting_sort(dst_p, n)
    # dst-order slot p draws from src-order slot rank_src[order_dst[p]]
    rank_src = np.empty(e_pad, np.int64)
    rank_src[order_src] = np.arange(e_pad)
    arrays = {
        "src_sorted": src_p[order_src],
        "w_dst_order": w_p[order_dst] if w_p is not None else None,
        "perm_idx": rank_src[order_dst],
        "valid_dst_order": valid_p[order_dst],
        "src_dst_order": src_p[order_dst],
    }
    counts_src = np.bincount(src_p, minlength=n)
    counts_dst = np.bincount(dst_p, minlength=n)
    indptr_src = np.concatenate([[0], np.cumsum(counts_src)]).astype(np.int32)
    indptr_dst = np.concatenate([[0], np.cumsum(counts_dst)]).astype(np.int32)
    arrays["indptr_src"] = indptr_src
    arrays["indptr_dst"] = indptr_dst

    k_iso_dangling = 0
    if endpoints:
        starts_src = indptr_src[:-1].astype(np.int64)
        ne_src = counts_src > 0
        # place: start slot of src i draws x[i]; filler elsewhere
        perm0 = np.full(e_pad, -1, np.int64)
        perm0[starts_src[ne_src]] = np.flatnonzero(ne_src)
        arrays["place_idx"] = _complete_permutation(perm0, e_pad)
        ssrc = np.zeros(e_pad, bool)
        ssrc[starts_src[ne_src]] = True
        arrays["seg_start_src"] = ssrc
        arrays["fill_src"] = build_fill_tables(ssrc)
        # collect: position d draws the last slot of dst segment d
        ne_dst = counts_dst > 0
        perm2 = np.full(e_pad, -1, np.int64)
        perm2[np.flatnonzero(ne_dst)] = indptr_dst[1:].astype(np.int64)[ne_dst] - 1
        arrays["collect_idx"] = _complete_permutation(perm2, e_pad)
        sdst = np.zeros(e_pad, bool)
        sdst[indptr_dst[:-1].astype(np.int64)[ne_dst]] = True
        arrays["seg_start_dst"] = sdst
        arrays["dst_nonempty"] = np.bincount(dst, minlength=n) > 0
        # loop layout: state slots (dst-seg-last) -> src-seg-start slots
        last_dst = indptr_dst[1:].astype(np.int64) - 1
        has_state = counts_dst > 0  # incl. pad edges: slot existence only
        both = ne_src & has_state
        shs = np.zeros(e_pad, bool)
        shs[starts_src[both]] = True
        arrays["start_has_state"] = shs
        il = np.zeros(e_pad, bool)
        il[last_dst[has_state]] = True
        arrays["is_last_dst"] = il
        if loop_net:
            perm3 = np.full(e_pad, -1, np.int64)
            perm3[starts_src[both]] = last_dst[both]
            # donor routing: start slots of vertices with no state slot read a
            # non-last slot, which the state kernels keep at the identity
            nostate = ne_src & ~has_state
            k_ns = int(nostate.sum())
            if k_ns:
                donors = np.flatnonzero(~il)[:k_ns]
                assert len(donors) == k_ns, "donor pool exhausted (impossible by counting)"
                perm3[starts_src[nostate]] = donors
            arrays["loop_idx"] = _complete_permutation(perm3, e_pad)
        true_outdeg = np.bincount(src, minlength=n)  # valid edges only
        od = np.ones(e_pad, np.float32)
        od[starts_src[ne_src]] = np.maximum(true_outdeg[ne_src], 1).astype(np.float32)
        arrays["outdeg_start"] = od
        dangling = true_outdeg == 0
        ld = np.zeros(e_pad, bool)
        ld[last_dst[has_state & dangling]] = True
        arrays["last_dangling"] = ld
        k_iso_dangling = int(np.sum(dangling & ~has_state))

    tensors = {}
    for name, a in arrays.items():
        if a is None:
            continue
        if name.endswith("_idx") or name in ("src_sorted", "src_dst_order"):
            a = np.asarray(a, np.int32)
        tensors[name] = _tensor(a)
    plan = SpmvPlan(
        n, e_pad, tensors,
        k_iso_dangling=k_iso_dangling, loop_donors=bool(endpoints and loop_net), total=bool(total),
        order_dst=order_dst,
    )
    return plan.to(device)


def _reference_stages(data, prefix):
    """Decode one network of a JAX-package plan file (as its _unpack_network)."""
    stages = []
    for i, kind in enumerate(data[f"{prefix}kinds"]):
        kind = str(kind)
        if kind == "S":
            stages.append(("S", np.asarray(data[f"{prefix}stage{i}"])))
        elif kind.startswith("T"):
            stages.append(("T", int(kind[1:])))
        elif kind.startswith("Q"):
            stages.append(("RSEL", np.asarray(data[f"{prefix}stage{i}"]), int(kind[1:])))
        else:  # "R<m>": 3-dim select table, or 2-dim rotated lane-shuffle table
            arr = np.asarray(data[f"{prefix}stage{i}"])
            stages.append(("RSEL" if arr.ndim == 3 else "ROWSEL", arr, int(kind[1:])))
    return stages


def _check_src_dst_order(src_dst_order, n):
    """A plan read from a file must keep ``src_dst_order`` inside x: the
    fused gather reads ``x[src_dst_order]`` on the card unchecked."""
    if src_dst_order.numel() and (int(src_dst_order.min()) < 0 or int(src_dst_order.max()) >= n):
        raise IndexOutOfBound(
            f"plan file: src_dst_order in [{int(src_dst_order.min())}, {int(src_dst_order.max())}], outside [0, {n})"
        )


def plan_from_reference(npz_or_dict, device="cuda"):
    """The port's SpmvPlan from the arrays the JAX package's
    ``save_spmv_plan`` writes (a path, an open npz, or a dict): each network
    is composed into its index array, ``fill_src`` is derived from
    ``seg_start_src``, and ``src_dst_order``, where the file lacks it, from
    ``src_sorted`` and the perm route."""
    data = np.load(npz_or_dict, allow_pickle=False) if isinstance(npz_or_dict, str) else npz_or_dict
    n, e_pad = (int(v) for v in data["meta"])
    arrays = {}
    for name in (
        "src_sorted", "w_dst_order", "indptr_src", "indptr_dst", "valid_dst_order", "src_dst_order",
        "seg_start_src", "seg_start_dst", "dst_nonempty", "start_has_state", "is_last_dst",
        "outdeg_start", "last_dangling",
    ):
        if name in data:
            a = np.asarray(data[name])
            if name in ("src_sorted", "src_dst_order"):
                a = a.astype(np.int32)
            arrays[name] = _tensor(a)
    for name, prefix in (("perm_idx", ""), ("place_idx", "p0_"), ("collect_idx", "p2_"), ("loop_idx", "p3_")):
        if f"{prefix}kinds" in data:
            arrays[name] = _tensor(compose_reference_network(_reference_stages(data, prefix), e_pad))
    if "seg_start_src" in data:
        arrays["fill_src"] = _tensor(build_fill_tables(data["seg_start_src"]))
    if "src_dst_order" not in arrays:
        # dst-order slot p draws from src-order slot perm_idx[p]
        arrays["src_dst_order"] = arrays["src_sorted"][arrays["perm_idx"].long()]
    _check_src_dst_order(arrays["src_dst_order"], n)

    def scalar(key):
        return int(np.asarray(data[key])[0]) if key in data else 0

    plan = SpmvPlan(
        n, e_pad, arrays,
        k_iso_dangling=scalar("k_iso_dangling"), loop_donors=bool(scalar("loop_donors")),
        total=bool(scalar("total")),
    )
    return plan.to(device)


# the tag of the port's plan files (load_spmv_plan refuses other .npz files)
PLAN_FORMAT = "graphblas_tpu_torch.SpmvPlan/1"


def save_spmv_plan(plan, path):
    """Write a plan to an ``.npz`` file in the port's format: its composed
    index arrays and tables, its scalars, and ``order_dst`` when the plan
    has it (then ``load_spmv_plan(path, w=...)`` can swap the weights)."""
    arrays = {k: v.cpu().numpy() for k, v in plan.arrays().items()}
    arrays["format"] = np.asarray(PLAN_FORMAT)
    arrays["meta"] = np.asarray([plan.n, plan.e_pad, plan.k_iso_dangling, plan.loop_donors, plan.total], np.int64)
    if plan.order_dst is not None:
        arrays["order_dst"] = np.asarray(plan.order_dst)
    np.savez(path, **arrays)


def load_spmv_plan(path, w=None, device="cuda"):
    """Read a plan that ``save_spmv_plan`` wrote, onto ``device``.  ``w``
    (length e, the real edges in their original order) replaces the weight
    channel: the routes are pattern analysis only, so one file serves every
    matrix of the same pattern, as the reference's ``load_spmv_plan``."""
    with np.load(path, allow_pickle=False) as data:
        if "format" not in data or str(data["format"]) != PLAN_FORMAT:
            raise ValueError(
                f"{path}: not a {PLAN_FORMAT} file (a JAX-package plan file reads with plan_from_reference)"
            )
        n, e_pad, k_iso, donors, total = (int(v) for v in data["meta"])
        arrays = {k: _tensor(data[k]) for k in ARRAYS if k in data}
        order_dst = np.asarray(data["order_dst"]) if "order_dst" in data else None
    _check_src_dst_order(arrays["src_dst_order"], n)
    if w is not None:
        if order_dst is None:
            raise ValueError(f"{path}: the plan was saved without order_dst, so its weights cannot be replaced")
        e = int(arrays["valid_dst_order"].sum())
        if len(w) != e:
            raise ValueError(f"load_spmv_plan: w has {len(w)} entries, the plan has {e} edges")
        arrays["w_dst_order"] = _tensor(_padded_weights(w, e_pad)[order_dst])
    plan = SpmvPlan(
        n, e_pad, arrays, k_iso_dangling=k_iso, loop_donors=bool(donors), total=bool(total), order_dst=order_dst
    )
    return plan.to(device)


def _seg_fill(plan, placed):
    """Segmented forward fill across src segments through ``fill_src``."""
    return segmented_fill_static(placed, plan.fill_src)


def _collect_v2(scanned, plan, ident):
    """Segment totals -> y (n,): the collect route's first n slots bring each
    dst segment's last slot to position d; destinations with no valid
    in-edge get ``ident``."""
    collected = apply_perm(scanned, plan.collect_idx[: plan.n])
    fill = torch.full((), ident, dtype=collected.dtype, device=collected.device)
    return torch.where(plan.dst_nonempty, collected, fill)


_OPS = {"plus": "add", "min": "min", "max": "max", "any": "max"}


def _dropping_scatter(e_pad, idx, values):
    """``out[idx[i]] = values[i]`` into zeros of length ``e_pad``, where
    ``idx[i] == e_pad`` drops the value (the reference's ``mode="drop"``)."""
    out = torch.zeros(e_pad + 1, dtype=values.dtype, device=values.device)
    out[idx] = values
    return out[:e_pad]


def _dst_segments(indptr_dst, e_pad):
    """(starts, ends, seg_start) of the dst segments: ``seg_start`` flags
    every segment's start slot (an empty segment's is its successor's)."""
    starts = indptr_dst[:-1].long()
    ends = indptr_dst[1:].long()
    seg_start = _dropping_scatter(e_pad, starts, torch.ones_like(starts, dtype=torch.bool))
    return starts, ends, seg_start


def _read_ends(scanned, starts, ends, ident):
    """y[d] = the scan at the last slot of dst segment d (``ends`` are one
    past it); an empty segment reads ``ident``."""
    fill = torch.full((), ident, dtype=scanned.dtype, device=scanned.device)
    padded = torch.cat([fill.reshape(1), scanned])
    return torch.where(starts == ends, fill, padded[ends])


def _expand_dst(x, plan):
    """x (n,) -> x[src] of every edge, in dst order: one gather through
    ``src_dst_order``."""
    return apply_perm(x.contiguous(), plan.src_dst_order)


def _present_dst(xs, plan):
    """x's structure at every dst-order slot (bool), expanded as one byte a
    slot."""
    present = xs if xs.dtype == torch.bool else xs.to(torch.float32) > 0.5
    return _expand_dst(present.contiguous().view(torch.uint8), plan).view(torch.bool)


def _contrib_dst(plan, x, w, valid, seg_start, op, mul, wrap=None):
    """The contrib scan over the dst-order slots with x[src] as the value
    channel, x gathered inside the scan's tiles through ``src_dst_order``."""
    return segmented_scan_contrib_gather(x.contiguous(), plan.src_dst_order, w, valid, seg_start, op, mul, wrap)


def _dst_reduce(plan):
    """(seg_start, read): the dst segment-start flags of the plan, and
    ``read(scanned, ident)``, the per-destination totals of a dst-order scan,
    ``ident`` where a destination has no valid in-edge (v2: the collect
    route) or no in-edge at all (no endpoint routes: the segment ends)."""
    if plan.place_idx is not None:
        return plan.seg_start_dst, lambda scanned, ident: _collect_v2(scanned, plan, ident)
    starts, ends, seg_start = _dst_segments(plan.indptr_dst, plan.e_pad)
    return seg_start, lambda scanned, ident: _read_ends(scanned, starts, ends, ident)


def spmv(plan, x, add="plus", mul="times"):
    """y[d] = ADD over edges (s -> d) of (x[s] MUL w).  add in {plus, min,
    max}; mul in {times, plus, first, second}.  Destinations with no valid
    in-edge get the ADD identity."""
    w = plan.w_dst_order if mul in ("times", "plus", "second") else None
    seg_start, read = _dst_reduce(plan)
    scanned = _contrib_dst(plan, x, w, plan.valid_dst_order, seg_start, _OPS[add], mul)
    return read(scanned, _ident(_OPS[add], scanned.dtype))


def spmv_masked(plan, x, xs, add="plus", mul="times", x_full=False, wrap=None):
    """GraphBLAS-exact SpMV that honours x's structure; returns (values,
    struct).

    y[d] = ADD over edges (s -> d) with x[s] present of (x[s] MUL w); y has an
    entry at d iff at least one such edge exists, and reads 0 elsewhere.  The
    structure ``xs`` is expanded to the edges as a byte channel unless
    ``x_full`` says every x is present.  add in {plus, min, max, any} (any
    is max); mul in {times, plus, first, second, pair, secondi}: ``pair``
    counts the present edges in one scan, ``secondi`` contributes the src
    vertex id (the any_secondi parent-BFS semiring).  ``wrap=(bits,
    signed)`` truncates integer contributions (after the count, for pair).
    Counterpart of ``graphblas_tpu/ops/fastspmv.py:spmv_masked``."""
    # with every x present, a v2 plan knows the structure statically
    static_struct = x_full and plan.place_idx is not None
    op = _OPS[add]
    seg_start, read = _dst_reduce(plan)
    if x_full:
        validc = plan.valid_dst_order
    else:
        validc = plan.valid_dst_order & _present_dst(xs, plan)

    if mul == "pair":
        # every present contribution is 1: one count scan gives values and structure
        ycnt = read(segmented_scan(validc.to(x.dtype), seg_start, "add"), 0)
        ys = plan.dst_nonempty if static_struct else ycnt > 0
        zero = torch.zeros((), dtype=ycnt.dtype, device=ycnt.device)
        yv = ycnt if add == "plus" else torch.where(ycnt > 0, torch.ones_like(zero), zero)
        if wrap is not None and add == "plus":
            bits, signed = wrap
            lo = -(1 << (bits - 1)) if signed else 0
            yv = (yv - lo) % (1 << bits) + lo
        return torch.where(ys, yv, zero), ys

    if mul == "secondi":
        scanned = segmented_scan_contrib(plan.src_dst_order, None, validc, seg_start, op, "first", wrap)
    else:
        w = plan.w_dst_order if mul in ("times", "plus", "second") else None
        if w is not None and w.dtype != x.dtype:
            w = w.to(x.dtype)  # e.g. float weights under an integer x
        scanned = _contrib_dst(plan, x, w, validc, seg_start, op, mul, wrap)
    yv = read(scanned, _ident(op, scanned.dtype))
    if static_struct:
        ys = plan.dst_nonempty
    else:
        ys = read(segmented_scan(validc.to(torch.float32), seg_start, "add"), 0) > 0
    return torch.where(ys, yv, torch.zeros((), dtype=yv.dtype, device=yv.device)), ys


def _spmm_index(plan, seg_start, x):
    """(seg_vertex, tile_base) of the k-column product, derived once a plan:
    the row of each dst segment in slot order (the non-empty dst segments)
    and the flags before each 256-slot block, which every tile of the kernel
    spans a whole number of (None where the plain version runs)."""
    cache = plan.__dict__.setdefault("_spmm", {})
    with _cap.constants():
        if "seg_vertex" not in cache:
            ipd = plan.indptr_dst
            cache["seg_vertex"] = torch.nonzero(ipd[1:] > ipd[:-1]).flatten().to(torch.int32)
        if not x.is_cuda or kernels.plain_requested():
            return cache["seg_vertex"], None
        if "tile_base" not in cache:
            cache["tile_base"] = _segscan.spmm_tile_base(seg_start)
    return cache["seg_vertex"], cache["tile_base"]


def _spmm_rows(plan, seg_vertex):
    """The row-selected product's ``SpmmRows`` of the plan, made once (each
    row's slots from ``indptr_dst``; on the card, its scratch)."""
    cache = plan.__dict__.setdefault("_spmm", {})
    if "rows" not in cache:
        with _cap.constants():
            cache["rows"] = _segscan.SpmmRows(plan.indptr_dst, seg_vertex, plan.valid_dst_order)
    return cache["rows"]


def spmm_masked(plan, x, xs, add="plus", mul="times", x_full=False, keep=None):
    """The k-column ``spmv_masked``: (values, structure) of Y = A (.) X for
    a dense n x k X (float32 or float64, k <= 8), column j what
    ``spmv_masked(plan, x[:, j], xs[:, j], add, mul, x_full)`` gives, in one
    launch that streams the plan once and writes Y's rows at the dst
    segments' ends.  add in {plus, min, max, any}; mul in {times, plus,
    first, second, pair}; the weights ride float32 (widened exactly).

    ``keep`` (bool, n x k): the cells a statement's mask lets it write.  The
    product then computes only the rows where some cell is set (a launch
    lists them first); every other row reads absent."""
    op = _OPS[add]
    seg_start, _ = _dst_reduce(plan)
    w = plan.w_dst_order if mul in ("times", "plus", "second") else None
    seg_vertex, tile_base = _spmm_index(plan, seg_start, x)
    rows = None if keep is None else _spmm_rows(plan, seg_vertex)
    yv, ys = segmented_spmm(
        x.contiguous(), None if x_full else xs.contiguous(), plan.src_dst_order, w, plan.valid_dst_order,
        seg_start, seg_vertex, plan.n, op, mul, tile_base, keep, rows,
    )
    if x_full and plan.place_idx is not None and keep is None:
        # every x present: the structure is the plan's, a constant of a compiled loop
        ys = plan.dst_nonempty[:, None].expand(ys.shape)
    return yv, ys


def spmv_state(plan, x_start, add, mul, w=None):
    """One loop-layout SpMV step: values at src-seg-start slots -> running
    segmented aggregates whose dst-seg-last slots hold y[d]."""
    xe = _seg_fill(plan, x_start)
    xe_dst = apply_perm(xe, plan.perm_idx)
    if w is None:
        w = plan.w_dst_order if mul in ("times", "plus", "second") else None
    return segmented_scan_contrib(xe_dst, w, plan.valid_dst_order, plan.seg_start_dst, _OPS[add], mul)


def state_to_start(plan, v_state, fill_value):
    """Route state-layout values to src-seg-start slots; start slots whose
    vertex has no state slot read ``fill_value``."""
    routed = apply_perm(v_state, plan.loop_idx)
    fill = torch.full((), fill_value, dtype=routed.dtype, device=routed.device)
    return torch.where(plan.start_has_state, routed, fill)


def state_to_start_post(plan, v_state, epilogue, aux=None, scalar=None):
    """``state_to_start`` with the select and further pointwise prep fused
    into the route's gather (``epilogue`` as in ``apply_perm``)."""
    return apply_perm(v_state, plan.loop_idx, epilogue, aux, scalar)


def state_to_n(plan, v_state, ident):
    """Final read-out: state layout -> (n,) through the collect route."""
    return _collect_v2(v_state, plan, ident)

"""Sparse COO container, the semiring SpMV over it, and the masked semiring
SpGEMM, C(M) = A (+).(x) B on M's pattern.

Counterpart of the typed front and the SpGEMM of ``graphblas_tpu/core/sparse.py``.
``SparseMatrixData`` is the canonical row-major COO on the host (numpy) with
device caches per sort order and a cached ``SpmvPlan`` per direction.  The
entry points take typed operators (``core.operator``) with the reference's
signatures; values ride the carriers of ``core.dtypes``.

- ``sparse_mxv``: y = A (+).(x) x over one direction.  Where a plan channel
  is exact (``_plan_channel``) and allowed (``_plan_allowed``: CUDA tensors
  from 2^17 entries, or ``tx.config["mxv_strategy"]``), it runs on the plan
  engine (``ops.fastspmv.spmv_masked``: Kernels G, C and the generic scan);
  else the generic gather + ``_segment_reduce``, exact for every semiring.
  Under "auto" an eager dispatch whose plan is not built yet starts its build
  in a background thread and runs on the generic path until it lands
  (``SparseMatrixData.plan_background``).  Plans are cached per direction and
  device, and on disk by pattern where GRAPHBLAS_TPU_PLAN_CACHE names a
  directory.
- ``sparse_spgemm_analyze`` is the host pattern analysis, copied with its
  constants, so every bucket array compares slot for slot with the
  reference; ``sparse_spgemm_execute`` runs a plan on the plan's device:
  each width bucket through the eqjoin kernel (``ops.eqjoin``) where the
  reference also takes its Pallas kernel, else the reference's XLA
  formulation in plain torch, in the mul's own input types; the task
  partials combine by entry through the reduce net where the reference uses
  it (two routes of Kernel G and two generic scans), else one scatter reduce
  (a user monoid: a segmented log-step scan per bucket, then the monoid
  across buckets); block-dense 128 x 128 bricks, where the plan has them, as
  batched matmuls (``torch.bmm``, full float32).
"""

import hashlib
import os
import threading
import zipfile

import numpy as np
import torch

from .. import exceptions as _exc
from . import capture as _cap
from . import dtypes as _dt
from . import telemetry as _telemetry
from ..kernels.eqjoin import USES_AV, USES_BV
from ..kernels.segscan import SPMM_MAX_COLUMNS
from ..ops import eqjoin as _ej
from ..ops.densemasked import _host_concrete
from ..ops.edgewise import _jax_extreme_fix
from ..ops import fastspmv as _fs
from ..ops.fastspmv import _complete_permutation
from ..ops.mxm import full_f32_matmul
from ..ops.permute import apply_perm, padded_size
from ..ops.scan import _ident as _scan_ident
from ..ops.scan import segmented_scan

_INT32_MAX = np.iinfo(np.int32).max

# numpy ufuncs for host-side dup combination (subset of dup_op names)
_NP_COMBINE = {
    "plus": np.add,
    "times": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
    "lor": np.logical_or,
    "land": np.logical_and,
    "bor": np.bitwise_or,
    "band": np.bitwise_and,
}

# monoids with a direct segment-reduce lowering
_SEGMENT_OPS = {"plus", "min", "max", "times", "lor", "land", "any"}
# the monoids the reduce net scans with (any as max, as the eqjoin kernel)
_NET_SCAN_OPS = {"plus": "add", "min": "min", "max": "max", "any": "max"}
# the plan engine's monoids and multiplies (ops.fastspmv.spmv_masked)
_PLAN_ADDS = {"plus", "min", "max", "any"}
_PLAN_MULS = {"times", "plus", "first", "second", "pair", "oneb"}
_PLAN_MIN_NVALS = 1 << 17  # "auto" takes the plan from this many entries

_SPGEMM_WMAX = 256  # segment width cap; hub lists split into chunk-pair tasks
_SPGEMM_EQ_BUDGET = 1 << 26  # eq-tensor elements per device batch


def _mxv_strategy():
    from ..tx import config as _txconfig

    return _txconfig.get("mxv_strategy", "auto")


def _dense_limit():
    """Storage-format preference: above this many cells, prefer sparse."""
    from ..tx import config as _txconfig

    return int(_txconfig.get("dense_limit", 1 << 24))


def _densify_limit():
    """Hard guard: densifying past this many cells raises OutOfMemory."""
    from ..tx import config as _txconfig

    return int(_txconfig.get("densify_limit", 1 << 26))


def _spgemm_flop_limit():
    from ..tx import config as _txconfig

    return int(_txconfig.get("spgemm_flop_limit", 1 << 28))


class SparseMatrixData:
    """Canonical sorted-dedup'd COO (host numpy) + device and plan caches."""

    __slots__ = (
        "rows", "cols", "vals", "nrows", "ncols", "_dev", "_plans", "_bg_builds", "_sharded_plans", "_col_order", "_stats"
    )

    def __init__(self, rows, cols, vals, nrows, ncols):
        self.rows = rows  # np.int64, row-major sorted
        self.cols = cols  # np.int64
        self.vals = vals  # np array of the matrix dtype
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self._dev = {}
        self._plans = {}
        self._bg_builds = {}  # direction -> (done event, result box) of a background plan build
        self._sharded_plans = {}
        self._col_order = None
        self._stats = {}

    @classmethod
    def from_arrays(cls, rows, cols, vals, nrows, ncols, dup_op=None, *, sorted_dedup=False):
        """Canonicalize (row-major sort + dup combine) host COO arrays.
        ``dup_op`` combines duplicates: an operator, typed or not, or its name."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        cols = np.asarray(cols, np.int64).reshape(-1)
        vals = np.asarray(vals).reshape(-1)
        if not sorted_dedup and rows.size:
            order = _sort_order(rows, cols, ncols)
            rows, cols, vals = rows[order], cols[order], vals[order]
            dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if dup.any():
                rows, cols, vals = _combine_dups(rows, cols, vals, dup, dup_op)
        return cls(rows, cols, vals, nrows, ncols)

    @property
    def nvals(self):
        return int(self.rows.size)

    @property
    def dtype(self):
        return _dt.lookup_dtype(self.vals.dtype)

    def copy(self, vals=None):
        """The same pattern with ``vals`` (default: these).  The host index
        arrays are shared, and so are their device caches: no function writes
        into a host array or a cached tensor."""
        out = SparseMatrixData(self.rows, self.cols, self.vals if vals is None else vals, self.nrows, self.ncols)
        out._col_order = self._col_order
        out._dev = {k: t for k, t in self._dev.items() if vals is None or not k[0].startswith("vals")}
        return out

    def transposed(self):
        """Swap row/col roles (re-canonicalized; indices shared, not copied)."""
        order = self.col_order()
        return SparseMatrixData(self.cols[order], self.rows[order], self.vals[order], self.ncols, self.nrows)

    def col_order(self):
        """Permutation to column-major order (lazily computed and cached)."""
        if self._col_order is None:
            with _telemetry.span("sparse.col_order"):
                self._col_order = _sort_order(self.cols, self.rows, self.nrows)
        return self._col_order

    # ------------------------------------------------------------------
    # device caches
    # ------------------------------------------------------------------

    def _idx_dtype(self):
        return np.int32 if max(self.nrows, self.ncols) <= _INT32_MAX else np.int64

    def device(self, key, device="cuda"):
        """Device tensor cache: rows/cols/vals in row ('_r') or col ('_c')
        order on ``device``; values in their type's carrier."""
        device = torch.device(device)
        ck = (key, str(device))
        if ck not in self._dev:
            name, order = key.rsplit("_", 1)
            sel = self.col_order() if order == "c" else slice(None)
            with _cap.constants(), _telemetry.span("sparse.upload"):
                if name == "vals":
                    t = _dt.to_tensor(self.vals[sel], self.dtype, device)
                elif name in ("rows", "cols") and order in "rc":
                    a = (self.rows if name == "rows" else self.cols)[sel]
                    t = torch.from_numpy(np.ascontiguousarray(a.astype(self._idx_dtype()))).to(device)
                else:
                    raise KeyError(key)
            _count_upload(device, t)
            self._dev[ck] = t
        return self._dev[ck]

    def _vals_absmax(self):
        """max |value| (cached; 64-bit plan-channel range gate)."""
        if "absmax" not in self._stats:
            v = self.vals
            self._stats["absmax"] = float(np.max(np.abs(v.astype(np.float64)))) if v.size else 0.0
        return self._stats["absmax"]

    def _indeg_max(self, direction):
        """max segment length over the dst axis (cached)."""
        key = f"degmax_{direction}"
        if key not in self._stats:
            dst = self.rows if direction == "pull" else self.cols
            if dst.size == 0:
                self._stats[key] = 0
            else:
                _, cnt = np.unique(dst, return_counts=True)
                self._stats[key] = int(cnt.max())
        return self._stats[key]

    # ------------------------------------------------------------------
    # SpMV plans
    # ------------------------------------------------------------------

    def plan(self, direction, device="cuda", loop=False):
        """SpmvPlan for 'pull' (dst=rows, src=cols) or 'push' (dst=cols) on
        ``device``, built once and cached: in memory by direction and device,
        and on disk when GRAPHBLAS_TPU_PLAN_CACHE names a directory
        (``_host_plan``).  A background build of the direction in flight
        (``plan_background``) is waited for, not repeated.

        ``loop=True`` asks for the loop-capable plan (total, with the loop
        route), which ``tools/build_plan.py`` and older plan-cache files
        hold.  It serves every dispatch the same way, so it replaces the
        plain plan in the cache; a CUDA graph captured on the plain plan
        keeps its tensors (``core/capture.py``).
        A build is the span ``sparse.plan_build`` (counted in
        ``sparse.plan_builds``)."""
        key = (direction, str(torch.device(device)))
        if not _serves(self._plans.get(key), loop):
            self._take_background(direction, device, wait=True)
        if not _serves(self._plans.get(key), loop):
            with _cap.constants(), _telemetry.span("sparse.plan_build"):
                self._plans[key] = _plan_to(self._host_plan(direction, loop), device)
            _telemetry.count("sparse.plan_builds")
        return self._plans[key]

    def plan_ready(self, direction, device="cuda"):
        """Whether the plan of ``direction`` is on ``device``.  A background
        build found finished is taken in here (its plan moved to ``device``);
        one that failed raises."""
        self._take_background(direction, device, wait=False)
        return (direction, str(torch.device(device))) in self._plans

    def plan_background(self, direction, device="cuda"):
        """Start building the plan of ``direction`` in a daemon thread, unless
        it is on ``device`` already or a build of it is in flight.

        The eager "auto" dispatch serves the generic path meanwhile
        (``sparse_mxv``), so a first ``A.mxv(x)`` on a big graph answers at
        once instead of stalling for the pattern analysis.  The thread does
        host work only: it builds on the CPU (and writes the cache file), and
        the dispatching thread moves the plan to its device when it first
        finds the build done (``plan_ready``, ``plan``).  So the thread makes
        no CUDA call, which would break a CUDA graph captured meanwhile
        (torch's default ``capture_error_mode="global"``).  A failed build is
        kept and raises on the next ``plan_ready`` or ``plan`` of the
        direction."""
        if (direction, str(torch.device(device))) in self._plans or direction in self._bg_builds:
            return
        done, box = threading.Event(), {}

        def work():
            try:
                with _telemetry.span("sparse.plan_build"):
                    box["plan"] = self._host_plan(direction, loop=False)
                _telemetry.count("sparse.plan_builds")
            except Exception as ex:  # raised in the dispatching thread
                box["error"] = ex
            finally:
                done.set()

        self._bg_builds[direction] = (done, box)
        threading.Thread(target=work, name=f"graphblas-plan-{direction}", daemon=True).start()

    def _take_background(self, direction, device, wait):
        """Take in the background build of ``direction`` once it is done
        (waiting for it when ``wait``): its plan goes to ``device``, and a
        failure raises."""
        bg = self._bg_builds.get(direction)
        if bg is None:
            return
        done, box = bg
        if not (done.wait() if wait else done.is_set()):
            return
        del self._bg_builds[direction]
        if "plan" not in box:
            raise RuntimeError(f"the background build of the {direction} plan failed") from box.get("error")
        key = (direction, str(torch.device(device)))
        if key not in self._plans:
            with _cap.constants():
                self._plans[key] = _plan_to(box["plan"], device)

    def _host_plan(self, direction, loop):
        """The plan of ``direction`` on the CPU: loaded from the on-disk cache
        with this matrix's own weights where GRAPHBLAS_TPU_PLAN_CACHE holds
        this pattern's file (for a plain request, the plain plan's or else the
        loop-capable one's, which serves it as in memory), else built (and
        written there).  A file there that is not a port plan file is rebuilt
        and overwritten; any other error raises."""
        src, dst = (self.cols, self.rows) if direction == "pull" else (self.rows, self.cols)
        w = _channel_weights(self.vals)
        path = _plan_cache_path(self, direction, loop, w is None)
        for variant in sorted({loop, True}):
            found = _plan_cache_path(self, direction, variant, w is None)
            if found is not None and os.path.exists(found):
                try:
                    return _fs.load_spmv_plan(found, w=w, device="cpu")
                except (ValueError, EOFError, zipfile.BadZipFile):
                    pass  # not a port plan file: rebuilt and overwritten below
        plan = _fs.build_spmv_plan(
            src, dst, w, n=max(self.nrows, self.ncols), loop_net=loop, total=loop, device="cpu"
        )
        if path is not None:
            # written under a private name, then renamed: a reader (another
            # thread or process) sees the whole file or none
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path[:-4]}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
            _fs.save_spmv_plan(plan, tmp)
            os.replace(tmp, path)
        return plan

    def sharded_plan(self, direction, mesh):
        """The sharded plan of one direction over an engaged mesh
        (``parallel/fastspmv.py``): edges partition by destination range, one
        SpmvPlan a shard on its shard's device.  Cached by direction and the
        mesh's device list, repeats included, apart from ``_plans``: a shard's
        plan is another graph's."""
        key = (direction, mesh.key())
        if key not in self._sharded_plans:
            from ..parallel.fastspmv import build_sharded_spmv_plan

            n = max(self.nrows, self.ncols)
            src, dst = (self.cols, self.rows) if direction == "pull" else (self.rows, self.cols)
            w = None
            if self.vals is not None and not np.issubdtype(self.vals.dtype, np.bool_):
                w = self.vals.astype(np.float32)
            with _cap.constants():
                self._sharded_plans[key] = build_sharded_spmv_plan(src, dst, w, n=n, mesh=mesh)
        return self._sharded_plans[key]

    # ------------------------------------------------------------------
    # densify (guarded)
    # ------------------------------------------------------------------

    def densify(self, device, *, limit=None):
        """(values, struct) dense tensors on ``device``; raises past the
        densify limit."""
        limit = _densify_limit() if limit is None else limit
        cells = self.nrows * self.ncols
        if cells > limit:
            raise _exc.OutOfMemory(
                f"operation requires densifying a {self.nrows}x{self.ncols} sparse Matrix "
                f"({cells} cells > tx.config['densify_limit']={limit}); use sparse-supported "
                "ops (mxv/vxm/reduce/apply/select/transpose/extract) or raise the limit"
            )
        return _scatter_dense(self.rows * self.ncols + self.cols, self.vals, self.dtype, (self.nrows, self.ncols), device)


def _count_upload(device, *tensors):
    """Count the bytes of ``tensors`` that went from the host to ``device``
    (``sparse.upload_bytes``; nothing where ``device`` is the CPU)."""
    if torch.device(device).type != "cpu":
        _telemetry.count("sparse.upload_bytes", sum(t.numel() * t.element_size() for t in tensors))


def _plan_to(plan, device):
    """A host-built SpmvPlan moved to ``device`` (the span ``sparse.upload``)."""
    with _telemetry.span("sparse.upload"):
        moved = plan.to(device)
    _count_upload(device, *moved.arrays().values())
    return moved


def _scatter_dense(flat, vals, dtype, shape, device):
    """Dense (values, struct) of ``shape`` on ``device`` with ``vals`` at the
    flat host positions ``flat``."""
    cells = int(np.prod(shape, dtype=np.int64))
    dv = torch.zeros(cells, dtype=dtype.carrier, device=device)
    ds = torch.zeros(cells, dtype=torch.bool, device=device)
    if len(flat):
        at = _cap.upload(np.asarray(flat, np.int64), device)
        dv[at] = _dt.to_tensor(vals, dtype, device)
        ds[at] = True
    return dv.reshape(shape), ds.reshape(shape)


def _serves(plan, loop):
    """Whether a cached plan serves a request for the plain (``loop`` false)
    or the loop-capable plan."""
    return plan is not None and (not loop or (plan.total and plan.loop_idx is not None))


def _pattern_digest(sp, weightless):
    """The reference's key of a plan file: blake2b (16 bytes) over int64
    [nrows, ncols, nvals], the rows, the cols, and b"noW" for a matrix
    without weights.  The routes are pattern analysis only, so one file
    serves every matrix of the pattern, each loaded with its own weights."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64([sp.nrows, sp.ncols, sp.nvals]).tobytes())
    h.update(sp.rows.tobytes())
    h.update(sp.cols.tobytes())
    if weightless:
        h.update(b"noW")
    return h.hexdigest()


def _plan_cache_path(sp, direction, loop, weightless):
    """The plan file of ``sp`` in GRAPHBLAS_TPU_PLAN_CACHE, or None when that
    names no directory.  The prefix is one the JAX package never reads (its
    files are ``gbtpu_plan3_*``, another format), so both packages can share
    a directory."""
    cache_dir = os.environ.get("GRAPHBLAS_TPU_PLAN_CACHE")
    if not cache_dir:
        return None
    variant = "loopT_" if loop else ""
    return os.path.join(cache_dir, f"gbtorch_plan1_{variant}{direction}_{_pattern_digest(sp, weightless)}.npz")


def _sort_order(major, minor, n_minor):
    """The stable order by (major, minor) of np.lexsort((minor, major)): one
    stable argsort of the int64 key major * n_minor + minor where every key
    fits (2.4x faster at 8.4 M entries), else the lexsort (2^60-scale
    dimensions)."""
    if (int(major.max(initial=0)) + 1) * max(int(n_minor), 1) <= np.iinfo(np.int64).max:
        return np.argsort(major * n_minor + minor, kind="stable")
    return np.lexsort((minor, major))


def _combine_dups(rows, cols, vals, dup, dup_op):
    """Combine adjacent duplicate (row, col) runs in sorted COO arrays."""
    if dup_op is None:
        raise ValueError("Duplicate indices found; must provide dup_op to combine them")
    starts = np.flatnonzero(np.concatenate([[True], ~dup]))
    name = getattr(dup_op, "name", None) or str(dup_op)
    base = name.split("[")[0]
    if vals.dtype.names is not None and base not in {"first", "second", "any"}:
        raise TypeError("UDT duplicate combination on sparse storage supports only first/second/any dup_op")
    np_fn = _NP_COMBINE.get(base)
    out_rows, out_cols = rows[starts], cols[starts]
    if np_fn is not None:
        out_vals = np_fn.reduceat(vals, starts)
    elif base == "first":
        out_vals = vals[starts]
    elif base in {"second", "any"}:
        lasts = np.concatenate([starts[1:], [len(rows)]]) - 1
        out_vals = vals[lasts]
    else:
        # generic typed op: fold each dup group left to right through the
        # op's function, every group's k-th step in one call, on the host
        # (the COO arrays are host numpy, as the reference combines them)
        from .operator import get_typed_op

        dt = _dt.lookup_dtype(vals.dtype)
        op_t = get_typed_op(dup_op, dt, kind="binary")
        lens = np.diff(np.concatenate([starts, [len(rows)]]))
        acc = _dt.to_tensor(vals[starts], dt, "cpu")
        for k in range(1, int(lens.max())):
            live = np.flatnonzero(lens > k)
            nxt = _dt.to_tensor(vals[starts[live] + k], dt, "cpu")
            acc[live] = _dt.cast(op_t.fn(acc[live], nxt), op_t.return_type, dt)
        out_vals = _dt.to_numpy(acc, dt)
    return out_rows, out_cols, out_vals


# ---------------------------------------------------------------------------
# segmented reduction over segment ids (the sparse monoid core)
# ---------------------------------------------------------------------------


def _extreme(dtype, which):
    """The largest (``"max"``) or smallest value of ``dtype``, in its ordered
    carrier (``core.dtypes.ordered``); bool as 0/1."""
    np_t = dtype.np_type
    if dtype._is_complex:
        raise TypeError(f"{dtype} has no order: no {which} to reduce with")
    if dtype._is_bool:
        return int(which == "max")
    if dtype._is_float:
        return float("inf") if which == "max" else float("-inf")
    info = np.iinfo(np_t)
    v = info.max if which == "max" else info.min
    if np_t == np.uint64:
        return int(v) - (1 << 63)  # the flipped sign bit
    return int(v)


def _compute_carrier(dtype):
    """Bool reduces as int32 0/1 (torch's scatter reductions take no bool)."""
    return torch.int32 if dtype._is_bool else dtype.carrier


def _segment_scan_fold(eff, seg_ids, fn):
    """Segmented inclusive log-step scan of ``eff`` under ``fn`` (combining
    earlier, later) over runs of equal sorted ``seg_ids``."""
    first = torch.ones_like(seg_ids, dtype=torch.bool)
    first[1:] = seg_ids[1:] != seg_ids[:-1]
    v, f = eff, first
    d, n = 1, eff.shape[0]
    while d < n:
        nv = torch.where(f[d:], v[d:], fn(v[:-d], v[d:]))
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def _segment_reduce(contrib, valid, seg_ids, num_segments, monoid_t, dtype=None):
    """Dense (y, ys) from per-edge contributions grouped by segment id.

    Standard monoids are one scatter reduce (any ``seg_ids`` order); any other
    monoid runs a segmented log-step scan with the monoid's function over
    sorted ``seg_ids`` (exact for every associative integer or bool monoid;
    float ones combine in another tree than the reference's
    ``associative_scan``).  ``dtype``: the contributions' type (default the
    monoid's)."""
    dt = monoid_t.type_ if dtype is None else dtype
    name = monoid_t.parent.name
    ident = monoid_t.identity
    dev = contrib.device
    if contrib.numel() == 0:
        iv = _dt.scalar_tensor(np.zeros((), dt.np_type) if ident is None else ident, dt, dev)
        return iv.expand(num_segments).clone(), torch.zeros(num_segments, dtype=torch.bool, device=dev)
    ids = seg_ids.long()
    ys = torch.zeros(num_segments, dtype=torch.int32, device=dev).index_add_(0, ids, valid.to(torch.int32)) > 0
    if _host_concrete(valid, seg_ids):
        # structure hoisting (core/compiler.py): the output structure stays a
        # constant of a compiled loop when its inputs are
        hv, hs = _cap.host_of(valid), _cap.host_of(seg_ids)
        _cap.with_host(ys, np.bincount(hs.astype(np.int64), weights=hv, minlength=num_segments)[:num_segments] > 0)
    zero = torch.zeros((), dtype=dt.carrier, device=dev)
    if name in _SEGMENT_OPS:
        cd = _compute_carrier(dt)
        c = contrib.to(cd)
        if name == "plus":
            y = torch.zeros(num_segments, dtype=cd, device=dev).index_add_(0, ids, torch.where(valid, c, 0))
        elif name == "times":
            y = torch.ones(num_segments, dtype=cd, device=dev).scatter_reduce_(0, ids, torch.where(valid, c, 1), "prod")
        else:  # min, land; max, lor, any: in the type's order
            which, how = ("max", "amin") if name in ("min", "land") else ("min", "amax")
            fill = _extreme(dt, which)
            y = torch.full((num_segments,), fill, dtype=cd, device=dev)
            y = _dt.ordered(y.scatter_reduce_(0, ids, torch.where(valid, _dt.ordered(c, dt), fill), how), dt)
            if dt._is_float:
                y = _jax_extreme_fix(y, c, valid, ids, num_segments, which == "max")
        y = y != 0 if dt._is_bool else _dt.wrap(y, dt).to(dt.carrier)
    else:
        iv = _dt.scalar_tensor(ident, dt, dev)
        eff = torch.where(valid, contrib, iv)
        fn = monoid_t.fn
        scanned = _segment_scan_fold(eff, ids, lambda a, b: _dt.cast(fn(a, b), monoid_t.return_type, dt))
        is_end = torch.ones_like(ids, dtype=torch.bool)
        is_end[:-1] = ids[1:] != ids[:-1]
        y = iv.expand(num_segments).clone()
        y[ids[is_end]] = scanned[is_end]
    return torch.where(ys, y, zero), ys


# ---------------------------------------------------------------------------
# semiring mxv / vxm
# ---------------------------------------------------------------------------


@_telemetry.timed("ops.sparse_mxv")
def sparse_mxv(sp, pull, a_first, xv, xs, sr, out_dtype, *, x_type=None):
    """Semiring y = A (.) x over one direction of a sparse matrix, on the
    device of ``xv``.

    pull: dst=rows/src=cols (GrB_mxv on A); push: dst=cols (vxm / mxv on A.T).
    a_first: the stored matrix is the multiply's FIRST argument (mxv) or the
    second (vxm).  ``xv``: x's values, a carrier tensor of type ``x_type``
    (default: the type its dtype carries natively); ``xs``: x's structure.
    Returns dense (values, struct) over the dst axis.
    """
    out_np = np.dtype(out_dtype.np_type)
    n_out = sp.nrows if pull else sp.ncols
    x_type = _dt.lookup_dtype(xv.dtype) if x_type is None else x_type
    mul = sr.binaryop
    addm = sr.monoid
    add_name = addm.parent.name
    pos = mul.positional
    strategy = _mxv_strategy()

    plan_mul = _plan_mul_name(mul, a_first, pos)
    channel = None
    if _plan_allowed(sp, strategy, xv):
        channel = _plan_channel(sp, strategy, add_name, plan_mul, out_np, pos, xv, x_type)
    if channel is not None and _building_in_background(sp, strategy, "pull" if pull else "push", xv.device):
        channel = None
    if channel is not None:
        yv, ys = _plan_mxv(sp, pull, xv, xs, add_name, plan_mul, pos, out_dtype, channel, x_type)
        if yv.shape[0] != n_out:
            yv, ys = yv[:n_out], ys[:n_out]
        return yv, ys

    # generic gather + segment path: exact for every semiring/dtype
    dev = xv.device
    if pull:
        dst, src, avals = sp.device("rows_r", dev), sp.device("cols_r", dev), sp.device("vals_r", dev)
    else:
        dst, src, avals = sp.device("cols_c", dev), sp.device("rows_c", dev), sp.device("vals_c", dev)
    srcl = src.long()
    valid = xs[srcl]
    if _host_concrete(xs, src):
        # keep the structure gather on the host in compiled loops
        _cap.with_host(valid, _cap.host_of(xs)[_cap.host_of(src).astype(np.int64)])
    if pos is not None:
        which, delta = pos
        role = _positional_role(which, a_first)
        if role == "src":
            contrib = src.long() + delta
        elif role == "dst":
            contrib = dst.long() + delta
        else:
            contrib = torch.full(src.shape, delta, dtype=torch.int64, device=dev)
        contrib = _dt.cast(contrib, _dt.INT64, out_dtype)
    else:
        a_t, x_t = (mul.type_, mul.type2) if a_first else (mul.type2, mul.type_)
        a_c = _dt.cast(avals, sp.dtype, a_t)
        x_c = _dt.cast(xv[srcl], x_type, x_t)
        prod = mul.fn(a_c, x_c) if a_first else mul.fn(x_c, a_c)
        contrib = _dt.cast(prod, mul.return_type, out_dtype)
    monoid_t = addm if addm.type_ == out_dtype else _retype_monoid(addm, out_dtype)
    return _segment_reduce(contrib, valid, dst, n_out, monoid_t)


def _spmm_mul(sp, mul, a_first, pos, out_dtype, x_type):
    """The plan-engine multiply of a k-column product (``spmm_masked``), or
    None where it would not be exact: out and x ride FP32 or FP64, the
    weights (when read) the plan's float32, so the matrix must be FP32."""
    plan_mul = _plan_mul_name(mul, a_first, pos)
    if pos is not None or plan_mul is None or out_dtype not in (_dt.FP32, _dt.FP64):
        return None
    if mul.return_type != out_dtype:
        return None
    a_t, x_t = (mul.type_, mul.type2) if a_first else (mul.type2, mul.type_)
    if plan_mul in ("times", "plus", "first") and x_t != out_dtype:
        return None
    if plan_mul in ("times", "plus", "second") and not (sp.dtype == _dt.FP32 and a_t in (_dt.FP32, _dt.FP64)):
        return None
    return plan_mul


@_telemetry.timed("ops.sparse_mxm_dense")
def sparse_mxm_dense(sp, pull, a_first, bv, bs, sr, out_dtype, *, x_type=None, keep=None):
    """Semiring Y = A (.) X over one direction of a sparse matrix and a dense
    n x k X (``bv`` values, ``bs`` structure), on the device of ``bv``:
    ``sparse_mxv``'s product for k columns.  Returns dense (values,
    structure), n_out x k.

    The plan engine's k-column product (``ops.fastspmv.spmm_masked``, one
    launch a block of up to 8 columns) serves float32 and float64 outputs
    over the semirings ``sparse_mxv``'s plan channel serves, where the
    strategy takes the plan; anything else runs ``sparse_mxv`` column by
    column.  ``keep`` (bool, n_out x k: the cells the statement's mask lets
    it write) selects the rows the plan engine computes, those where some
    cell is set: the others read absent (the column-by-column product
    computes every row).  The counters ``ops.spmm_products``,
    ``ops.spmm_columns`` and ``ops.spmm_launches`` (the hand-kernel launches
    inside the products) count every call, ``ops.spmm_masked_products`` the
    products that took a mask into the plan engine."""
    from .. import kernels

    k = bv.shape[1]
    _telemetry.count("ops.spmm_products")
    _telemetry.count("ops.spmm_columns", k)
    before = sum(kernels.launch_counts().values())
    x_type = _dt.lookup_dtype(bv.dtype) if x_type is None else x_type
    out = _spmm(sp, pull, a_first, bv, bs, sr, out_dtype, x_type, keep)
    _telemetry.count("ops.spmm_launches", sum(kernels.launch_counts().values()) - before)
    return out


def _spmm(sp, pull, a_first, bv, bs, sr, out_dtype, x_type, keep):
    mul, addm = sr.binaryop, sr.monoid
    add_name = addm.parent.name
    plan_mul = _spmm_mul(sp, mul, a_first, mul.positional, out_dtype, x_type)
    strategy = _mxv_strategy()
    from .collection_ops import _mesh_context

    ctx = _mesh_context()
    direction = "pull" if pull else "push"
    use_plan = (
        plan_mul is not None
        and add_name in _PLAN_ADDS
        and bv.shape[1] > 0
        and _plan_allowed(sp, strategy, bv)
        and not (ctx is not None and ctx.mesh.size > 1)
    )
    if use_plan and _building_in_background(sp, strategy, direction, bv.device):
        use_plan = False
    if not use_plan:
        cols = [sparse_mxv(sp, pull, a_first, bv[:, j], bs[:, j], sr, out_dtype, x_type=x_type) for j in range(bv.shape[1])]
        if not cols:
            n_out = sp.nrows if pull else sp.ncols
            return (
                torch.zeros((n_out, 0), dtype=out_dtype.carrier, device=bv.device),
                torch.zeros((n_out, 0), dtype=torch.bool, device=bv.device),
            )
        return torch.stack([c[0] for c in cols], 1), torch.stack([c[1] for c in cols], 1)
    plan = sp.plan(direction, bv.device)
    n_out = sp.nrows if pull else sp.ncols
    x, xs = _dt.cast(bv, x_type, out_dtype), bs
    if x.shape[0] != plan.n:
        pad = plan.n - x.shape[0]
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        xs = torch.cat([xs, xs.new_zeros((pad, xs.shape[1]))])
    if _cap.active() is not None:
        hx = _cap.host_of(bs)
        x_full = hx is not None and bool(hx.all())
    else:
        x_full = bool(bs.all())
    if keep is not None:
        _telemetry.count("ops.spmm_masked_products")
        if keep.shape[0] != plan.n:
            keep = torch.cat([keep, keep.new_zeros((plan.n - keep.shape[0], keep.shape[1]))])
    blocks = [slice(j, j + SPMM_MAX_COLUMNS) for j in range(0, x.shape[1], SPMM_MAX_COLUMNS)]
    parts = [
        _fs.spmm_masked(
            plan, x[:, b], xs[:, b], add=add_name, mul=plan_mul, x_full=x_full,
            keep=None if keep is None else keep[:, b].contiguous(),
        )
        for b in blocks
    ]
    yv = parts[0][0] if len(parts) == 1 else torch.cat([p[0] for p in parts], 1)
    ys = parts[0][1] if len(parts) == 1 else torch.cat([p[1] for p in parts], 1)
    return yv[:n_out], ys[:n_out]


def _retype_monoid(monoid_t, out_dtype):
    from .operator import get_typed_op

    return get_typed_op(monoid_t.parent, out_dtype, kind="monoid")


def _positional_role(which, a_first):
    """Where a positional multiply's index lives for a matrix-vector product:
    in C=A*B terms firsti=i, firstj=k, secondi=k, secondj=j.  For mxv
    (a_first) the vector is B (k,1): j==0; for vxm the vector is A (1,k): i==0.
    """
    base = which
    if base in {"firstj", "secondi"}:
        return "src"
    if base == "firsti":
        return "dst" if a_first else "zero"
    # secondj
    return "zero" if a_first else "dst"


def _plan_mul_name(mul, a_first, pos):
    """Map the GraphBLAS multiply onto a fastspmv channel, or None."""
    if pos is not None:
        which, _ = pos
        return "secondi" if _positional_role(which, a_first) == "src" else None
    name = mul.parent.name
    if name not in _PLAN_MULS:
        return None
    if name in {"times", "plus"}:
        return name
    if name in {"pair", "oneb"}:
        return "pair"
    # first/second: fastspmv's "first" channel is x, "second" is the weights
    if name == "first":
        return "second" if a_first else "first"
    return "first" if a_first else "second"


def _channel_weights(vals):
    """Edge-weight channel array for the plan engine: f32 for floats, int32
    for integer/bool dtypes (astype sign/zero-extends narrow ints and wraps
    64-bit; 64-bit use is range-gated in _plan_channel)."""
    if vals is None:
        return None
    if np.issubdtype(vals.dtype, np.floating):
        return vals.astype(np.float32)
    return vals.astype(np.int32)


def _plan_channel(sp, strategy, add_name, plan_mul, out_np, pos, xv, x_type=None):
    """The plan-engine payload dtype (np.float32 | np.int32) for this
    dispatch, or None to use the generic path.

    Exactness rules (GraphBLAS integer ops wrap at the output width):
    - FP32: f32 channel (native).
    - INT8/16/32, UINT8/16, BOOL: int32 channel, bit-exact: modular
      arithmetic commutes with truncation, and min/max compare contributions
      wrapped to the output width in Kernel C (``wrap``).
    - UINT32: int32 channel for plus/any (modular / representation-agnostic);
      min/max would compare sign-flipped: generic path.
    - INT64/UINT64: int32 channel only when a conservative range bound on
      every intermediate (matrix values x vector values x max in-degree for
      plus) fits int32, else generic.  The bound reads x on the host (one
      device sync).
    - FP64: generic (the engine would round to f32).
    """
    if strategy == "generic" or plan_mul is None or add_name not in _PLAN_ADDS:
        return None
    if pos is not None:
        # src-id channel is int32: exact below 2^31
        if max(sp.nrows, sp.ncols) >= (1 << 31):
            return None
        return np.float32
    kind = out_np.kind
    if out_np == np.float32:
        return np.float32
    if kind == "b" or (kind in "iu" and out_np.itemsize <= 2) or out_np == np.int32:
        return np.int32
    if out_np == np.uint32:
        return np.int32 if add_name in ("plus", "any") else None
    if kind in "iu" and out_np.itemsize == 8:
        x_type = _dt.lookup_dtype(xv.dtype) if x_type is None else x_type
        if _cap.active() is not None:
            hx = _cap.host_of(xv)
            if hx is None:
                return None  # cannot range-check abstract values
            xv = torch.from_numpy(np.ascontiguousarray(hx))
        with _cap.constants():
            xmax = float(_dt.cast(xv, x_type, _dt.FP64).abs().max()) if xv.numel() else 0.0
        mmax = sp._vals_absmax()
        if plan_mul == "times":
            bound = mmax * xmax
        elif plan_mul == "plus":
            bound = mmax + xmax
        elif plan_mul == "first":
            bound = xmax
        elif plan_mul == "second":
            bound = mmax
        else:  # pair
            bound = 1.0
        if add_name == "plus":
            bound *= max(sp._indeg_max("pull"), 1)
        return np.int32 if bound < float(1 << 31) else None
    return None


def _plan_allowed(sp, strategy, xv):
    """Whether the strategy lets this dispatch take the plan engine: "plan"
    always, "generic" never, "auto" for CUDA tensors of at least 2^17
    entries (the plan build is host work worth it for big graphs on the
    card; the reference's auto takes it on a TPU only).  The channel must
    then be exact too (``_plan_channel``)."""
    if strategy == "auto":
        return xv.is_cuda and sp.nvals >= _PLAN_MIN_NVALS
    return strategy == "plan"


def _serve_generic_while_building(strategy, eager, setting, ready):
    """Whether a dispatch the plan engine would take starts the plan's
    background build and runs on the generic path meanwhile: under "auto"
    (strategy "plan" always blocks), for an eager dispatch (a compiled
    loop's scope bakes the path it records into the loop, so it blocks),
    unless GRAPHBLAS_TPU_PLAN_BACKGROUND (``setting``) is "0", and while the
    plan is not ready (``ready()``, asked last: it may take in a finished
    build, which moves the plan to the device)."""
    return strategy == "auto" and eager and setting != "0" and not ready()


def _building_in_background(sp, strategy, direction, device):
    """For a dispatch the plan engine would take: True when it runs on the
    generic path while the plan of ``direction`` builds in the background
    (``_serve_generic_while_building``), the build then started."""
    setting = os.environ.get("GRAPHBLAS_TPU_PLAN_BACKGROUND", "1")
    eager = _cap.active() is None
    if not _serve_generic_while_building(strategy, eager, setting, lambda: sp.plan_ready(direction, device)):
        return False
    sp.plan_background(direction, device)
    return True


def _plan_mxv(sp, pull, xv, xs, add_name, plan_mul, pos, out_dtype, channel, x_type):
    out_np = np.dtype(out_dtype.np_type)
    dev = xv.device
    from .collection_ops import _mesh_context

    # an engaged mesh Context of more than one shard: the float32 channel
    # runs the sharded engine; integer channels stay on one device
    ctx = _mesh_context()
    sharded = ctx is not None and ctx.mesh.size > 1 and channel == np.float32
    plan = None
    if sharded:
        n = max(sp.nrows, sp.ncols)
    else:
        plan = sp.plan("pull" if pull else "push", dev)
        n = plan.n
    ch = _dt.INT32 if channel == np.int32 else _dt.FP32
    # narrow integer outputs: contributions wrap to the output width in
    # Kernel C so min/max compare the wrapped (C-semantics) values
    wrap = None
    if channel == np.int32 and out_np.kind in "iu" and out_np.itemsize < 4:
        wrap = (out_np.itemsize * 8, out_np.kind == "i")
    if plan_mul == "pair":
        # contribution is constantly 1: spmv_masked's pair channel answers
        # from the validity count scan alone (no value-channel expand)
        x_in = torch.zeros(n, dtype=ch.carrier, device=dev)
    else:
        x_in = _dt.cast(xv, x_type, ch)
        if x_in.shape[0] != n:
            x_in = torch.cat([x_in, x_in.new_zeros(n - x_in.shape[0])])
    xs_in = xs
    if xs_in.shape[0] != n:
        xs_in = torch.cat([xs_in, xs_in.new_zeros(n - xs_in.shape[0])])
    if sharded:
        from ..parallel.fastspmv import sharded_spmv_masked

        splan = sp.sharded_plan("pull" if pull else "push", ctx.mesh)
        yv, ys = (t.to(dev) for t in sharded_spmv_masked(splan, x_in, xs_in, add=add_name, mul=plan_mul))
    else:
        # every x present: the plan knows the structure statically.  Inside a
        # compiled loop that is decided from a constant structure (structure
        # hoisting) and never read from the card
        if _cap.active() is not None:
            hx = _cap.host_of(xs)
            x_full = hx is not None and bool(hx.all())
        else:
            x_full = bool(xs.all())
        yv, ys = _fs.spmv_masked(plan, x_in, xs_in, add=add_name, mul=plan_mul, x_full=x_full, wrap=wrap)
    if pos is not None:
        _, delta = pos
        if delta:
            yv = yv + delta
        yv = torch.where(ys, yv, torch.zeros((), dtype=yv.dtype, device=dev))
    return _dt.cast(yv, _dt.lookup_dtype(yv.dtype), out_dtype), ys


# ---------------------------------------------------------------------------
# value work on a device: host arrays in, host arrays out
# ---------------------------------------------------------------------------


def _host_op(fn, args, out_type, out_dtype, device):
    """``fn`` over host arrays ``args`` ((array, type) pairs, each converted
    as numpy converts to its type) on ``device``; the result (``out_type``'s
    carrier) comes back once, converted to ``out_dtype``."""
    ts = [_dt.to_tensor(np.asarray(a).astype(t.np_type, copy=False), t, device) for a, t in args]
    return _dt.to_numpy(_dt.cast(fn(*ts), out_type, out_dtype), out_dtype)


def _reduce_groups(contrib, starts, monoid_t, dtype):
    """Reduce each run of ``contrib`` (a carrier tensor of ``dtype``) that
    begins at a host offset of ``starts`` with the monoid, on contrib's
    device; host values of ``dtype``.  The counterpart of the reference's
    ``_np_reduce_groups``, with the torch segment reduce ("any": each run's
    last value, the reference's pick)."""
    n = contrib.shape[0]
    if monoid_t.parent.name == "any":
        # the reference's pick: each run's last value
        ends = np.concatenate([starts[1:], [n]]) - 1
        return _dt.to_numpy(contrib[_index_t(ends, contrib.device)], dtype)
    seg = np.zeros(n, np.int64)
    seg[starts[1:]] = 1
    ids = _cap.upload(np.cumsum(seg), contrib.device)
    valid = torch.ones(n, dtype=torch.bool, device=contrib.device)
    m = monoid_t if monoid_t.type_ == dtype else _retype_monoid(monoid_t, dtype)
    y, _ = _segment_reduce(contrib, valid, ids, len(starts), m)
    return _dt.to_numpy(y, dtype)


def _index_t(a, device):
    """Host int64 indices as an int64 tensor (the reference's index type on a
    64-bit platform)."""
    return _cap.upload(np.asarray(a, np.int64), device)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def sparse_reduce_axis(sp, monoid_t, axis, device):
    """reduce_rowwise (axis=1) / columnwise (axis=0) over sparse storage:
    dense (values, struct) on ``device``."""
    if axis == 1:
        seg, n_out = sp.device("rows_r", device), sp.nrows
        vals = sp.device("vals_r", device)
    else:
        seg, n_out = sp.device("cols_c", device), sp.ncols
        vals = sp.device("vals_c", device)
    contrib = _dt.cast(vals, sp.dtype, monoid_t.type_)
    valid = torch.ones(contrib.shape, dtype=torch.bool, device=contrib.device)
    return _segment_reduce(contrib, valid, seg, n_out, monoid_t)


def sparse_reduce_scalar(sp, monoid_t, device):
    """Full reduction to a scalar; (value, present) 0-d tensors on ``device``."""
    from ..ops import densemasked as _dm

    if sp.nvals == 0:
        return torch.zeros((), dtype=monoid_t.type_.carrier, device=device), torch.zeros((), dtype=torch.bool, device=device)
    vals = _dt.cast(sp.device("vals_r", device), sp.dtype, monoid_t.type_)
    return _dm.reduce_all(vals, torch.ones(vals.shape, dtype=torch.bool, device=device), monoid_t)


# ---------------------------------------------------------------------------
# ewise / apply / select / positional (host pattern work, device values)
# ---------------------------------------------------------------------------


def _pair_keys(rows, cols):
    """Structured (row, col) sort keys: lexicographic compare without the
    r*ncols+c encoding (which overflows int64 in the 2^60 index space)."""
    k = np.empty(len(rows), dtype=[("r", np.int64), ("c", np.int64)])
    k["r"] = rows
    k["c"] = cols
    return k


def _merge_join(ka, kb):
    """Positions (ia, ib) of the keys in both sorted key arrays."""
    pos = np.searchsorted(kb, ka)
    pos_c = np.minimum(pos, len(kb) - 1) if len(kb) else np.zeros(len(ka), np.int64)
    in_both = (len(kb) > 0) & (pos < len(kb))
    if len(kb):
        in_both &= kb[pos_c] == ka
    ia = np.flatnonzero(in_both)
    ib = pos[ia] if len(ia) else np.zeros(0, np.int64)
    return ia, ib


def _ewise_combine(op_t, out_dtype, device):
    """The op over two host value arrays, on ``device``."""
    out_np = np.dtype(out_dtype.np_type)

    def combine(av, bv):
        if len(av) == 0:
            return np.empty(0, out_np)
        return _host_op(op_t.fn, [(av, op_t.type_), (bv, op_t.type2)], op_t.return_type, out_dtype, device)

    return combine


def _ewise_merge(ka, kb, a_vals, b_vals, op_t, how, out_dtype, device, ld, rd):
    """eWiseMult/Add/Union over two sorted key arrays: (order of the output
    among [both, a only, b only], positions, values)."""
    out_np = np.dtype(out_dtype.np_type)
    combine = _ewise_combine(op_t, out_dtype, device)
    ia, ib = _merge_join(ka, kb)
    if how == "mult":
        return ia, None, None, combine(a_vals[ia], b_vals[ib])
    only_a = np.ones(len(ka), bool)
    only_a[ia] = False
    only_b = np.ones(len(kb), bool)
    only_b[ib] = False
    oa, ob = np.flatnonzero(only_a), np.flatnonzero(only_b)
    both_vals = combine(a_vals[ia], b_vals[ib])
    if how == "add":
        a_part, b_part = a_vals[oa].astype(out_np), b_vals[ob].astype(out_np)
    else:  # union: defaults substitute for the absent side
        t1, t2 = np.dtype(op_t.type_.np_type), np.dtype(op_t.type2.np_type)
        a_part = combine(a_vals[oa], np.full(len(oa), rd, t2))
        b_part = combine(np.full(len(ob), ld, t1), b_vals[ob])
    return ia, oa, ob, np.concatenate([both_vals, a_part, b_part])


def sparse_ewise(a_sp, b_sp, op_t, how, out_dtype, ld=None, rd=None, *, device):
    """Sparse-sparse eWiseMult/Add/Union as a host merge-join on the sorted
    COO patterns + one elementwise combine on ``device``: no densify, so huge
    (2^60-scale) dimensions stay representable."""
    ka = _pair_keys(a_sp.rows, a_sp.cols)
    kb = _pair_keys(b_sp.rows, b_sp.cols)
    ia, oa, ob, vals = _ewise_merge(ka, kb, a_sp.vals, b_sp.vals, op_t, how, out_dtype, device, ld, rd)
    if how == "mult":
        return SparseMatrixData(a_sp.rows[ia], a_sp.cols[ia], vals, a_sp.nrows, a_sp.ncols)
    rows = np.concatenate([a_sp.rows[ia], a_sp.rows[oa], b_sp.rows[ob]])
    cols = np.concatenate([a_sp.cols[ia], a_sp.cols[oa], b_sp.cols[ob]])
    order = np.lexsort((cols, rows))
    return SparseMatrixData(rows[order], cols[order], vals[order], a_sp.nrows, a_sp.ncols)


def sparse_apply_values(sp, fn, out_type, out_dtype, device):
    """Entrywise op on present values (``fn`` over the values' carrier tensor
    on ``device``, giving ``out_type``); pattern unchanged."""
    res = _dt.cast(fn(sp.device("vals_r", device)).expand(sp.vals.shape), out_type, out_dtype)
    return _with_vals(sp, res, out_dtype, device)


def _with_vals(sp, res, dtype, device, key="vals_r"):
    """``sp.copy`` with the values of the tensor ``res`` (of ``dtype``), whose
    device cache (``key``) it seeds."""
    out = sp.copy(vals=_dt.to_numpy(res, dtype))
    out._dev[(key, str(torch.device(device)))] = res
    return out


def _index_args(sp, device):
    return _index_t(sp.rows, device), _index_t(sp.cols, device)


def sparse_apply_indexunary(sp, op_t, thunk_dev, out_dtype, device):
    """IndexUnary apply over present entries: f(val, i, j, thunk)."""
    vals = _dt.cast(sp.device("vals_r", device), sp.dtype, op_t.type_)
    res = op_t.fn(vals, *_index_args(sp, device), thunk_dev)
    return _with_vals(sp, _dt.cast(res.expand(vals.shape), op_t.return_type, out_dtype), out_dtype, device)


def sparse_select(sp, op_t, thunk_dev, device):
    """GrB_select on sparse storage: filter entries, keep sparse."""
    if sp.nvals == 0:
        return sp.copy()
    keep = op_t.fn(sp.device("vals_r", device), *_index_args(sp, device), thunk_dev)
    keep = keep.expand(sp.vals.shape).cpu().numpy().astype(bool)
    return SparseMatrixData(sp.rows[keep], sp.cols[keep], sp.vals[keep], sp.nrows, sp.ncols)


def sparse_apply_positional(sp, which, delta, out_np):
    """Positional unary apply (rowindex/colindex) on sparse storage."""
    idx = sp.rows if which == "i" else sp.cols
    return sp.copy(vals=(idx + delta).astype(out_np))


# ---------------------------------------------------------------------------
# sparse Vector storage
# ---------------------------------------------------------------------------


class SparseVectorData:
    """Canonical sorted-unique (index, value) host arrays for one Vector, with
    device caches."""

    __slots__ = ("idx", "vals", "size", "_dev")

    def __init__(self, idx, vals, size):
        self.idx = idx  # np.int64, sorted unique
        self.vals = vals  # np array of the Vector dtype
        self.size = int(size)
        self._dev = {}

    @classmethod
    def from_arrays(cls, idx, vals, size, dup_op=None, *, sorted_dedup=False):
        idx = np.asarray(idx, np.int64).reshape(-1)
        vals = np.asarray(vals).reshape(-1)
        if not sorted_dedup and idx.size:
            order = np.argsort(idx, kind="stable")
            idx, vals = idx[order], vals[order]
            dup = idx[1:] == idx[:-1]
            if dup.any():
                idx, _, vals = _combine_dups(idx, np.zeros_like(idx), vals, dup, dup_op)
        return cls(idx, vals, size)

    @property
    def nvals(self):
        return int(self.idx.size)

    @property
    def dtype(self):
        return _dt.lookup_dtype(self.vals.dtype)

    def copy(self, vals=None):
        """The same pattern with ``vals`` (indices and their caches shared)."""
        out = SparseVectorData(self.idx, self.vals if vals is None else vals, self.size)
        out._dev = {k: t for k, t in self._dev.items() if vals is None or k[0] == "idx"}
        return out

    def device(self, key, device="cuda"):
        """Device tensor cache: ``"idx"`` (int32 where the size fits) or
        ``"vals"`` (the type's carrier) on ``device``."""
        device = torch.device(device)
        ck = (key, str(device))
        if ck not in self._dev:
            with _cap.constants():
                if key == "idx":
                    idt = np.int32 if self.size <= _INT32_MAX else np.int64
                    self._dev[ck] = torch.from_numpy(np.ascontiguousarray(self.idx.astype(idt))).to(device)
                elif key == "vals":
                    self._dev[ck] = _dt.to_tensor(self.vals, self.dtype, device)
                else:
                    raise KeyError(key)
        return self._dev[ck]

    def densify(self, device, *, limit=None):
        limit = _densify_limit() if limit is None else limit
        if self.size > limit:
            raise _exc.OutOfMemory(
                f"operation requires densifying a size-{self.size} sparse Vector "
                f"(> tx.config['densify_limit']={limit}); use sparse-supported ops "
                "or raise the limit"
            )
        return _scatter_dense(self.idx, self.vals, self.dtype, (self.size,), device)


def sparse_vec_ewise(a, b, op_t, how, out_dtype, ld=None, rd=None, *, device):
    """Sparse-sparse vector eWiseMult/Add/Union: host merge-join on sorted
    index lists + one combine on ``device`` (no densify at any size)."""
    ia, oa, ob, vals = _ewise_merge(a.idx, b.idx, a.vals, b.vals, op_t, how, out_dtype, device, ld, rd)
    if how == "mult":
        return SparseVectorData(a.idx[ia], vals, a.size)
    idx = np.concatenate([a.idx[ia], a.idx[oa], b.idx[ob]])
    order = np.argsort(idx, kind="stable")
    return SparseVectorData(idx[order], vals[order], a.size)


def sparse_vec_apply_values(sv, fn, out_type, out_dtype, device):
    out_np = np.dtype(out_dtype.np_type)
    if sv.nvals == 0:
        return sv.copy(vals=sv.vals.astype(out_np))
    res = _dt.cast(fn(sv.device("vals", device)).expand(sv.vals.shape), out_type, out_dtype)
    return _with_vals(sv, res, out_dtype, device, "vals")


def sparse_vec_apply_indexunary(sv, op_t, thunk_dev, out_dtype, device):
    out_np = np.dtype(out_dtype.np_type)
    if sv.nvals == 0:
        return sv.copy(vals=sv.vals.astype(out_np))
    vals = _dt.cast(sv.device("vals", device), sv.dtype, op_t.type_)
    rows = _index_t(sv.idx, device)
    res = op_t.fn(vals, rows, torch.zeros_like(rows), thunk_dev)
    return sv.copy(vals=_dt.to_numpy(_dt.cast(res.expand(vals.shape), op_t.return_type, out_dtype), out_dtype))


def sparse_vec_select(sv, op_t, thunk_dev, device):
    if sv.nvals == 0:
        return sv.copy()
    rows = _index_t(sv.idx, device)
    keep = op_t.fn(sv.device("vals", device), rows, torch.zeros_like(rows), thunk_dev)
    keep = keep.expand(sv.vals.shape).cpu().numpy().astype(bool)
    return SparseVectorData(sv.idx[keep], sv.vals[keep], sv.size)


def sparse_vec_apply_positional(sv, which, delta, out_np):
    idx = sv.idx if which == "i" else np.zeros_like(sv.idx)
    return sv.copy(vals=(idx + delta).astype(out_np))


def sparse_vec_reduce_scalar(sv, monoid_t, device):
    """Full reduction to a scalar; (value, present) 0-d tensors on ``device``."""
    from ..ops import densemasked as _dm

    if sv.nvals == 0:
        return torch.zeros((), dtype=monoid_t.type_.carrier, device=device), torch.zeros((), dtype=torch.bool, device=device)
    vals = _dt.cast(sv.device("vals", device), sv.dtype, monoid_t.type_)
    return _dm.reduce_all(vals, torch.ones(vals.shape, dtype=torch.bool, device=device), monoid_t)


def sparse_mxv_sv(sp, pull, a_first, sv, sr, out_dtype, *, device):
    """Semiring mxv/vxm with a SPARSE vector operand -> SparseVectorData.

    The edges join the vector's pattern on the host (O(E log nnz(x))); the
    multiply and the monoid run on ``device``: the scalable-correctness route
    for huge dimensions where neither the vector nor the output can be dense.
    """
    out_np = np.dtype(out_dtype.np_type)
    n_out = sp.nrows if pull else sp.ncols
    if pull:
        dst, src, avals = sp.rows, sp.cols, sp.vals
    else:
        order = sp.col_order()
        dst, src, avals = sp.cols[order], sp.rows[order], sp.vals[order]
    # join edges against the vector pattern
    pos = np.searchsorted(sv.idx, src)
    pos_c = np.minimum(pos, max(len(sv.idx) - 1, 0))
    valid = (len(sv.idx) > 0) & (pos < len(sv.idx))
    if len(sv.idx):
        valid &= sv.idx[pos_c] == src
    sel = np.flatnonzero(valid)
    if len(sel) == 0:
        return SparseVectorData(np.empty(0, np.int64), np.empty(0, out_np), n_out)
    dstv = dst[sel]
    mul = sr.binaryop
    addm = sr.monoid
    pos_mul = mul.positional
    if pos_mul is not None:
        which, delta = pos_mul
        role = _positional_role(which, a_first)
        if role == "src":
            idx = src[sel] + delta
        elif role == "dst":
            idx = dstv + delta
        else:
            idx = np.full(len(sel), delta, np.int64)
        contrib = _dt.cast(_index_t(idx, device), _dt.INT64, out_dtype)
    else:
        a_t, x_t = (mul.type_, mul.type2) if a_first else (mul.type2, mul.type_)
        a_c = _dt.to_tensor(avals[sel].astype(a_t.np_type), a_t, device)
        x_c = _dt.to_tensor(sv.vals[pos_c[sel]].astype(x_t.np_type), x_t, device)
        prod = mul.fn(a_c, x_c) if a_first else mul.fn(x_c, a_c)
        contrib = _dt.cast(prod, mul.return_type, out_dtype)
    # group by dst (already sorted in dst-major order for both directions)
    starts = np.flatnonzero(np.concatenate([[True], dstv[1:] != dstv[:-1]]))
    out_vals = _reduce_groups(contrib, starts, addm, out_dtype)
    return SparseVectorData(dstv[starts], out_vals, n_out)


# ---------------------------------------------------------------------------
# sparse extract / assign / delete (host pattern surgery over the canonical
# COO, no densify, so the extract and assign loops work at any dimension)
# ---------------------------------------------------------------------------


def _ix_arr(ix):
    """Materialized np index array for a _DimIndex, or None for kind 'all'."""
    if ix.kind == "all":
        return None
    return np.atleast_1d(np.asarray(ix.index, np.int64))


def _join_positions(entry_keys, ixarr):
    """All (entry, output-position) matches of sorted ``entry_keys`` against
    index array ``ixarr`` (which may repeat values): (entry_sel, out_pos)."""
    order = np.argsort(ixarr, kind="stable")
    sorted_ix = ixarr[order]
    lo = np.searchsorted(sorted_ix, entry_keys, "left")
    hi = np.searchsorted(sorted_ix, entry_keys, "right")
    cnt = hi - lo
    entry_sel = np.repeat(np.arange(len(entry_keys)), cnt)
    total = int(cnt.sum())
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    out_pos = order[np.repeat(lo, cnt) + offs]
    return entry_sel, out_pos


def _in_index(values, ixarr):
    """Membership of ``values`` in ``ixarr`` (kind 'all' -> all True)."""
    if ixarr is None:
        return np.ones(len(values), bool)
    return _in_sorted(values, np.unique(ixarr))


def sparse_extract(sp, rows_ix, cols_ix):
    """C = A[I, J] over sparse storage -> SparseMatrixData (no densify);
    duplicate indices replicate entries."""
    rarr = _ix_arr(rows_ix)
    carr = _ix_arr(cols_ix)
    rows, cols, vals = sp.rows, sp.cols, sp.vals
    if rarr is not None:
        sel, out_r = _join_positions(rows, rarr)
        rows, cols, vals = out_r, cols[sel], vals[sel]
    if carr is not None:
        sel, out_c = _join_positions(cols, carr)
        rows, cols, vals = rows[sel], out_c, vals[sel]
    return SparseMatrixData.from_arrays(rows, cols, vals, rows_ix.size, cols_ix.size, dup_op="second")


def sparse_extract_row(sp, r, cols_ix):
    """w = A[r, J] -> SparseVectorData."""
    lo = np.searchsorted(sp.rows, r, "left")
    hi = np.searchsorted(sp.rows, r, "right")
    cols, vals = sp.cols[lo:hi], sp.vals[lo:hi]
    carr = _ix_arr(cols_ix)
    if carr is None:
        return SparseVectorData(cols.copy(), vals.copy(), cols_ix.size)
    sel, out_c = _join_positions(cols, carr)
    order = np.argsort(out_c, kind="stable")
    return SparseVectorData(out_c[order], vals[sel][order], cols_ix.size)


def sparse_extract_col(sp, c, rows_ix):
    """w = A[I, c] -> SparseVectorData."""
    order_c = sp.col_order()
    cols_sorted = sp.cols[order_c]
    lo = np.searchsorted(cols_sorted, c, "left")
    hi = np.searchsorted(cols_sorted, c, "right")
    rows = sp.rows[order_c][lo:hi]
    vals = sp.vals[order_c][lo:hi]
    rarr = _ix_arr(rows_ix)
    if rarr is None:
        ro = np.argsort(rows, kind="stable")
        return SparseVectorData(rows[ro], vals[ro], rows_ix.size)
    sel, out_r = _join_positions(rows, rarr)
    ro = np.argsort(out_r, kind="stable")
    return SparseVectorData(out_r[ro], vals[sel][ro], rows_ix.size)


def sparse_vec_extract(sv, ix):
    """w = v[I] -> SparseVectorData."""
    iarr = _ix_arr(ix)
    if iarr is None:
        return sv.copy(vals=sv.vals.copy())
    sel, out_i = _join_positions(sv.idx, iarr)
    order = np.argsort(out_i, kind="stable")
    return SparseVectorData(out_i[order], sv.vals[sel][order], ix.size)


_SCALAR_FILL_LIMIT = 1 << 26  # scalar assign materializes the region pattern


def _dedup_last(keys_r, keys_c, vals):
    """Keep the LAST occurrence per (r, c) (duplicate assign indices)."""
    order = np.lexsort((np.arange(len(keys_r)), keys_c, keys_r))
    kr, kc, kv = keys_r[order], keys_c[order], vals[order]
    is_last = np.concatenate([(kr[1:] != kr[:-1]) | (kc[1:] != kc[:-1]), [True]])
    return kr[is_last], kc[is_last], kv[is_last]


def _accum_values(accum, a, b, dtype, device):
    """accum(a, b) over host values of ``dtype`` (the region intersections),
    on ``device``."""
    if len(a) == 0:
        return a
    ta = _dt.cast(_dt.to_tensor(a, dtype, device), dtype, accum.type_)
    tb = _dt.cast(_dt.to_tensor(b.astype(a.dtype), dtype, device), dtype, accum.type2)
    return _dt.to_numpy(_dt.cast(accum.fn(ta, tb), accum.return_type, dtype), dtype)


def _region_array(ix):
    return _ix_arr(ix) if ix.kind != "int" else np.asarray([ix.index], np.int64)


def sparse_assign(sp, ix_list, new_r, new_c, new_v, accum, dtype, device):
    """Region assign on sparse matrix COO (unmasked GrB_assign semantics):
    region entries of C are replaced by the new entries (accum=None) or
    union-merged via accum.  Returns a new SparseMatrixData."""
    np_dtype = np.dtype(dtype.np_type)
    in_region = _in_index(sp.rows, _region_array(ix_list[0])) & _in_index(sp.cols, _region_array(ix_list[1]))
    keep = ~in_region
    new_v = new_v.astype(np_dtype, copy=False)
    new_r, new_c, new_v = _dedup_last(new_r, new_c, new_v)
    if accum is not None and in_region.any():
        # union-merge: C-region entries combine with new entries on intersection
        cr, cc, cv = sp.rows[in_region], sp.cols[in_region], sp.vals[in_region]
        ia, ib = _merge_join(_pair_keys(cr, cc), _pair_keys(new_r, new_c))
        acc_v = _accum_values(accum, cv[ia].astype(np_dtype), new_v[ib], dtype, device)
        only_new = np.ones(len(new_r), bool)
        only_new[ib] = False
        keep_c = np.ones(len(cr), bool)
        keep_c[ia] = False
        new_r = np.concatenate([cr[ia], cr[keep_c], new_r[only_new]])
        new_c = np.concatenate([cc[ia], cc[keep_c], new_c[only_new]])
        new_v = np.concatenate([acc_v, cv[keep_c].astype(np_dtype), new_v[only_new]])
    rows = np.concatenate([sp.rows[keep], new_r])
    cols = np.concatenate([sp.cols[keep], new_c])
    vals = np.concatenate([sp.vals[keep].astype(np_dtype, copy=False), new_v])
    return SparseMatrixData.from_arrays(rows, cols, vals, sp.nrows, sp.ncols, dup_op="second")


def sparse_vec_assign(sv, ix, new_i, new_v, accum, dtype, device):
    """Region assign on sparse vector (unmasked GrB_assign semantics)."""
    np_dtype = np.dtype(dtype.np_type)
    in_region = _in_index(sv.idx, _region_array(ix))
    keep = ~in_region
    new_v = new_v.astype(np_dtype, copy=False)
    new_i, _, new_v = _dedup_last(new_i, np.zeros_like(new_i), new_v)
    if accum is not None and in_region.any():
        ci, cv = sv.idx[in_region], sv.vals[in_region]
        ia, ib = _merge_join(ci, new_i)
        acc_v = _accum_values(accum, cv[ia].astype(np_dtype), new_v[ib], dtype, device)
        only_new = np.ones(len(new_i), bool)
        only_new[ib] = False
        keep_c = np.ones(len(ci), bool)
        keep_c[ia] = False
        new_i = np.concatenate([ci[ia], ci[keep_c], new_i[only_new]])
        new_v = np.concatenate([acc_v, cv[keep_c].astype(np_dtype), new_v[only_new]])
    idx = np.concatenate([sv.idx[keep], new_i])
    vals = np.concatenate([sv.vals[keep].astype(np_dtype, copy=False), new_v])
    order = np.argsort(idx, kind="stable")
    return SparseVectorData(idx[order], vals[order], sv.size)


def sparse_delete_region(sp, ix_list):
    """del C[I, J] on sparse matrix storage."""
    keep = ~(_in_index(sp.rows, _region_array(ix_list[0])) & _in_index(sp.cols, _region_array(ix_list[1])))
    return SparseMatrixData(sp.rows[keep], sp.cols[keep], sp.vals[keep], sp.nrows, sp.ncols)


def sparse_vec_delete_region(sv, ix):
    keep = ~_in_index(sv.idx, _region_array(ix))
    return SparseVectorData(sv.idx[keep], sv.vals[keep], sv.size)


# ---------------------------------------------------------------------------
# host analysis
# ---------------------------------------------------------------------------


class SpgemmPlan:
    """Analyzed masked-SpGEMM tasks: per-width buckets of padded key/value
    tiles on ``device`` (the pattern-analysis step, done once per (A, B, M)
    pattern; re-executed cheaply when values change).

    ``buckets``: [((Wa, Wb), task_entry, multi, akT, avT, bkT, bvT, chunk,
    entry_ids)], the reference's tuple: host numpy ``task_entry`` and
    ``multi``, tensors (W, T) in the tasks-on-lanes layout, int ``chunk``
    (T is a multiple of it) and the tensor ``entry_ids``.
    ``reduce_net``: (order, last, seg_start, has_task) or None; ``order``
    routes the concatenated per-task outputs into entry-grouped order, a
    segmented scan reduces each group, and ``last`` routes each group's last
    (total) slot to its entry position (its first ``n_entries`` slots)."""

    __slots__ = ("m_rows", "m_cols", "n_entries", "buckets", "brick", "reduce_net", "device", "a_type", "b_type")

    def __init__(
        self, m_rows, m_cols, n_entries, buckets, brick=None, reduce_net=None, device="cpu", a_type=None, b_type=None
    ):
        self.m_rows = m_rows
        self.m_cols = m_cols
        self.n_entries = n_entries
        self.buckets = buckets
        self.brick = brick  # SpgemmBrickPlan | None
        self.reduce_net = reduce_net
        self.device = torch.device(device)
        # the types of the value tiles (avT, bvT: their carriers)
        self.a_type = a_type
        self.b_type = b_type

    def nbytes(self):
        """Bytes the plan holds on its device."""
        ts = [t for b in self.buckets for t in (b[3], b[4], b[5], b[6], b[8])]
        ts += list(self.reduce_net or ())
        if self.brick is not None:
            ts += [self.brick.a_bricks, self.brick.b_bricks, self.brick.a_idx, self.brick.b_idx, self.brick.entry_cell]
        return sum(t.numel() * t.element_size() for t in ts)


class SpgemmBrickPlan:
    """Block-dense regions of C(M) = A (.) B: where the mask and both operands
    are dense in 128x128 bricks, the per-entry key intersections become
    batched brick matmuls (plus an indicator matmul for the match counts and
    the structure).  The sparse remainder stays on eqjoin."""

    __slots__ = ("a_bricks", "b_bricks", "a_idx", "b_idx", "entry_cell", "kmax")

    def __init__(self, a_bricks, b_bricks, a_idx, b_idx, entry_cell, kmax):
        self.a_bricks = a_bricks  # (NA+1, 128, 128) f32; last = zeros
        self.b_bricks = b_bricks  # (NB+1, 128, 128) f32
        self.a_idx = a_idx  # (CB, kmax) int32 into a_bricks
        self.b_idx = b_idx  # (CB, kmax) int32 into b_bricks
        # per mask entry: flat cell in the (CB*16384,) brick output, or the
        # sentinel CB*16384 (a zero pad slot) for entries outside dense bricks
        self.entry_cell = entry_cell  # (n_entries,) int32
        self.kmax = kmax


def _to(a, device):
    return _cap.upload(a, device)


def _build_reduce_net(buckets, n_entries, device):
    """The two routes, segment starts and entry flags of the scatter-free
    combine (the reference's two permutation networks, as index arrays:
    out[p] = in[idx[p]])."""
    sizes = [int(b[3].shape[1]) for b in buckets]
    tg = sum(sizes)
    tg_pad = padded_size(max(tg, n_entries, 256))
    gids = np.full(tg_pad, np.iinfo(np.int64).max, np.int64)
    pos = 0
    for b, size in zip(buckets, sizes):
        te = b[1]
        gids[pos : pos + len(te)] = te
        pos += size
    order = np.argsort(gids, kind="stable")
    sorted_gids = gids[order]
    nvalid = int((sorted_gids != np.iinfo(np.int64).max).sum())
    seg_start = np.zeros(tg_pad, bool)
    seg_start[0] = True
    seg_start[1:] = sorted_gids[1:] != sorted_gids[:-1]
    counts = np.bincount(sorted_gids[:nvalid], minlength=n_entries)
    has_task = counts > 0
    last = np.searchsorted(sorted_gids[:nvalid], np.arange(n_entries), side="right") - 1
    perm2 = np.full(tg_pad, -1, np.int64)
    perm2[np.flatnonzero(has_task)] = last[has_task]
    last_idx = _complete_permutation(perm2, tg_pad)
    return (
        _to(order.astype(np.int32), device),
        _to(last_idx.astype(np.int32), device),
        _to(seg_start, device),
        _to(has_task, device),
    )


def _pow2ceil(x):
    return 1 << np.ceil(np.log2(np.maximum(x, 1))).astype(np.int64)


def _pow4ceil(x):
    """Quantize tile widths to powers of 4 (4, 16, 64, 256): fewer buckets
    means fewer kernel launches; padding waste is bounded at 4x."""
    lg = np.ceil(np.log2(np.maximum(x, 1)))
    return (1 << (2 * ((lg.astype(np.int64) + 1) // 2))).astype(np.int64)


def _build_eq_tasks(out, entry_idx, mr, mc, a_indptr, a_keys, a_vals, b_indptr, b_keys, b_vals):
    """Collect rectangular eq-join tasks for a set of mask entries against a
    CSR-like A-row / B-col segment layout, merging into ``out`` keyed by
    (Wa, Wb).  ``entry_idx`` are GLOBAL entry ids (several groups feed the
    same segment-combine space)."""
    if len(entry_idx) == 0:
        return
    da = (a_indptr[mr + 1] - a_indptr[mr]).astype(np.int64)
    db = (b_indptr[mc + 1] - b_indptr[mc]).astype(np.int64)
    wa_e = np.minimum(_SPGEMM_WMAX, np.maximum(4, _pow4ceil(da)))
    wb_e = np.minimum(_SPGEMM_WMAX, np.maximum(4, _pow4ceil(db)))
    nva = max(len(a_keys), 1)
    nvb = max(len(b_keys), 1)
    a_keys = a_keys if len(a_keys) else np.zeros(1, np.int64)
    b_keys = b_keys if len(b_keys) else np.zeros(1, np.int64)
    a_vals = a_vals if len(a_vals) else np.zeros(1, np.float64)
    b_vals = b_vals if len(b_vals) else np.zeros(1, np.float64)
    # keys only feed equality compares: int32 halves the gather traffic
    if max(int(a_keys.max(initial=0)), int(b_keys.max(initial=0))) < (1 << 31) - 2:
        a_keys = a_keys.astype(np.int32)
        b_keys = b_keys.astype(np.int32)
    pairs = wa_e * (1 << 20) + wb_e
    # one argsort groups entries by (Wa, Wb)
    ok = (da > 0) & (db > 0)
    order = np.argsort(np.where(ok, pairs, -1), kind="stable")
    order = order[ok[order]]
    if len(order) == 0:
        return
    sorted_pairs = pairs[order]
    bounds = np.flatnonzero(np.concatenate([[True], sorted_pairs[1:] != sorted_pairs[:-1]]))
    bounds = np.concatenate([bounds, [len(order)]])
    for g in range(len(bounds) - 1):
        in_bucket = order[bounds[g] : bounds[g + 1]]
        key = int(sorted_pairs[bounds[g]])
        Wa, Wb = key >> 20, key & ((1 << 20) - 1)
        dab, dbb = da[in_bucket], db[in_bucket]
        na = -(-dab // Wa)
        nb = -(-dbb // Wb)
        ntasks = na * nb
        rep = np.repeat(np.arange(len(in_bucket)), ntasks)
        task_local = in_bucket[rep]
        task_entry = entry_idx[task_local]
        offs = np.concatenate([[0], np.cumsum(ntasks)])
        local = np.arange(offs[-1]) - offs[rep]
        nb_rep = np.repeat(nb, ntasks)
        ta = local // np.maximum(nb_rep, 1)
        tb = local % np.maximum(nb_rep, 1)
        a_start = (a_indptr[mr[task_local]] + ta * Wa).astype(np.int64)
        b_start = (b_indptr[mc[task_local]] + tb * Wb).astype(np.int64)
        a_len = np.minimum(da[task_local] - ta * Wa, Wa)
        b_len = np.minimum(db[task_local] - tb * Wb, Wb)
        # (T, W) build: per-task W-windows are contiguous in the source
        # arrays, so the big gathers stay cache-friendly
        ai = a_start[:, None] + np.arange(Wa, dtype=np.int64)[None, :]
        np.minimum(ai, nva - 1, out=ai)
        bi = b_start[:, None] + np.arange(Wb, dtype=np.int64)[None, :]
        np.minimum(bi, nvb - 1, out=bi)
        am = np.arange(Wa)[None, :] < a_len[:, None]
        bm = np.arange(Wb)[None, :] < b_len[:, None]
        ak = np.where(am, a_keys[ai], np.asarray(-1, a_keys.dtype))
        bk = np.where(bm, b_keys[bi], np.asarray(-2, b_keys.dtype))
        av = np.where(am, a_vals[ai], np.zeros((), a_vals.dtype))
        bv = np.where(bm, b_vals[bi], np.zeros((), b_vals.dtype))
        out.setdefault((Wa, Wb), []).append((task_entry, ak, av, bk, bv))


def _finalize_eq_buckets(task_groups, n_entries_cap, device, a_type, b_type):
    """Pad merged (Wa, Wb) task groups and move them to ``device`` in the
    tasks-on-lanes (W, T) layout."""
    buckets = []
    for (Wa, Wb), parts in sorted(task_groups.items()):
        task_entry = np.concatenate([p[0] for p in parts])
        ak = np.concatenate([p[1] for p in parts])
        av = np.concatenate([p[2] for p in parts])
        bk = np.concatenate([p[3] for p in parts])
        bv = np.concatenate([p[4] for p in parts])
        if len(parts) > 1 and np.any(task_entry[1:] < task_entry[:-1]):
            # keep tasks grouped by entry id
            order = np.argsort(task_entry, kind="stable")
            task_entry = task_entry[order]
            ak, av, bk, bv = ak[order], av[order], bk[order], bv[order]
        T = len(task_entry)
        # pad the task count to the chunk: a multiple of 512 and of the
        # bucket's task tile, never larger than the padded task count itself
        chunk = max(512, _SPGEMM_EQ_BUDGET // (Wa * Wb) // 512 * 512)
        chunk = min(chunk, -(-T // 512) * 512)
        tile = _ej.task_tile(Wa, Wb)
        chunk = max(tile, chunk // tile * tile)
        chunk = min(chunk, -(-T // tile) * tile)
        pad = (-T) % chunk
        if pad:
            ak = np.pad(ak, ((0, pad), (0, 0)), constant_values=-1)
            bk = np.pad(bk, ((0, pad), (0, 0)), constant_values=-2)
            av = np.pad(av, ((0, pad), (0, 0)))
            bv = np.pad(bv, ((0, pad), (0, 0)))
        idt = np.int32 if n_entries_cap < (1 << 31) else np.int64
        kdt32 = np.int32 if max(int(ak.max(initial=0)), int(bk.max(initial=0)), 2) < (1 << 31) else np.int64
        multi = np.ones(T, bool)  # merged groups: entries may span buckets
        buckets.append(
            (
                (Wa, Wb),
                task_entry,
                multi,
                _to(ak.T.astype(kdt32, copy=False), device),
                _dt.to_tensor(av.T, a_type, device),
                _to(bk.T.astype(kdt32, copy=False), device),
                _dt.to_tensor(bv.T, b_type, device),
                chunk,
                _to(task_entry.astype(idt), device),
            )
        )
    return buckets


def _in_sorted(values, sorted_arr):
    if sorted_arr.size == 0:
        return np.zeros(values.shape, bool)
    pos = np.searchsorted(sorted_arr, values)
    pos_c = np.minimum(pos, len(sorted_arr) - 1)
    return sorted_arr[pos_c] == values


def _analyze_bricks(a_sp, b_sp, b_order, m_rows, m_cols, thresh, device):
    """Find block-dense structure; returns (SpgemmBrickPlan, in_dense_entry)
    or (None, None) when the pattern has no brick-worthy region."""
    nbc = -(-b_sp.ncols // 128)
    nbk = -(-a_sp.ncols // 128)
    cb = (m_rows >> 7) * nbc + (m_cols >> 7)
    ubr, ucnt = np.unique(cb, return_counts=True)
    dense_cb = ubr[ucnt >= thresh]
    ab = (a_sp.rows >> 7) * nbk + (a_sp.cols >> 7)
    uab, uacnt = np.unique(ab, return_counts=True)
    dense_ab = uab[uacnt >= thresh]
    b_rows = b_sp.rows[b_order]
    b_cols = b_sp.cols[b_order]
    bb = (b_rows >> 7) * nbc + (b_cols >> 7)
    udb, udcnt = np.unique(bb, return_counts=True)
    dense_bb = udb[udcnt >= thresh]
    if dense_cb.size == 0 or dense_ab.size == 0 or dense_bb.size == 0:
        return None, None
    in_dense = _in_sorted(cb, dense_cb)
    a_in = _in_sorted(ab, dense_ab)
    b_in = _in_sorted(bb, dense_bb)

    NA, NB, CB = len(dense_ab), len(dense_bb), len(dense_cb)
    a_bricks = np.zeros((NA + 1, 128, 128), np.float32)
    apos = np.searchsorted(dense_ab, ab[a_in])
    a_bricks[apos, a_sp.rows[a_in] & 127, a_sp.cols[a_in] & 127] = a_sp.vals[a_in].astype(np.float32)
    b_bricks = np.zeros((NB + 1, 128, 128), np.float32)
    bpos = np.searchsorted(dense_bb, bb[b_in])
    b_bricks[bpos, b_rows[b_in] & 127, b_cols[b_in] & 127] = b_sp.vals[b_order][b_in].astype(np.float32)

    # task lists: for C brick (bi, bj), every k with A(bi, k) and B(k, bj) dense
    a_by_row = {}
    for idx, key in enumerate(dense_ab):
        a_by_row.setdefault(int(key) // nbk, []).append((int(key) % nbk, idx))
    b_by_col = {}
    for idx, key in enumerate(dense_bb):
        b_by_col.setdefault(int(key) % nbc, {})[int(key) // nbc] = idx
    tasks = []
    for key in dense_cb:
        bi, bj = int(key) // nbc, int(key) % nbc
        row_ks = a_by_row.get(bi, [])
        col_ks = b_by_col.get(bj, {})
        tasks.append([(ai_, col_ks[k]) for k, ai_ in row_ks if k in col_ks])
    kmax = max((len(t) for t in tasks), default=0)
    if kmax == 0:
        return None, None
    a_idx = np.full((CB, kmax), NA, np.int32)
    b_idx = np.full((CB, kmax), NB, np.int32)
    for c_i, t in enumerate(tasks):
        for j, (ai_, bi_) in enumerate(t):
            a_idx[c_i, j] = ai_
            b_idx[c_i, j] = bi_

    # per-entry flat cell into the (CB*16384,) brick output (+1 zero pad slot)
    pos = np.searchsorted(dense_cb, cb)
    cell = np.full(len(m_rows), CB * 16384, np.int64)
    cell[in_dense] = pos[in_dense] * 16384 + (m_rows[in_dense] & 127) * 128 + (m_cols[in_dense] & 127)
    cdt = np.int32 if CB * 16384 + 1 < (1 << 31) else np.int64
    plan = SpgemmBrickPlan(
        _to(a_bricks, device), _to(b_bricks, device), _to(a_idx, device), _to(b_idx, device),
        _to(cell.astype(cdt), device), kmax,
    )
    return plan, in_dense


def sparse_spgemm_analyze(
    a_sp, b_sp, m_rows, m_cols, *, bricks=False, brick_thresh=1024, reduce_net=False, device="cuda"
):
    """Build the task plan for C(M) = A (.) B (host-side pattern analysis),
    with its tensors on ``device``.

    ``bricks=True`` additionally detects 128x128 block-dense regions (of the
    mask AND both operands) and plans them as batched matmuls; only valid
    when the semiring executes as plus_pair / plus_times over f32 (the
    execute step checks this).  The remainder (sparse-region entries, plus
    each dense entry's (A_rest x B) and (A_dense x B_rest) contributions)
    stays on eqjoin.  ``reduce_net=True`` plans the scatter-free combine."""
    m_rows = np.asarray(m_rows, np.int64)
    m_cols = np.asarray(m_cols, np.int64)
    n_entries = len(m_rows)
    a_indptr = np.searchsorted(a_sp.rows, np.arange(a_sp.nrows + 1))
    b_order = b_sp.col_order()
    b_order_cols = b_sp.cols[b_order]
    b_indptr = np.searchsorted(b_order_cols, np.arange(b_sp.ncols + 1))
    a_keys_all = a_sp.cols
    a_vals_all = a_sp.vals
    b_keys_all = b_sp.rows[b_order]
    b_vals_all = b_sp.vals[b_order]
    if max(a_sp.ncols, b_sp.nrows, 2) < (1 << 31):
        # narrow keys before tile construction: tiles are the big host arrays
        a_keys_all = a_keys_all.astype(np.int32)
        b_keys_all = b_keys_all.astype(np.int32)

    brick = in_dense = None
    if bricks:
        brick, in_dense = _analyze_bricks(a_sp, b_sp, b_order, m_rows, m_cols, brick_thresh, device)

    all_idx = np.arange(n_entries)
    groups = {}
    if brick is None:
        _build_eq_tasks(
            groups, all_idx, m_rows, m_cols, a_indptr, a_keys_all, a_vals_all, b_indptr, b_keys_all, b_vals_all
        )
    else:
        # split operand entries into dense-brick / rest parts (order-preserving
        # boolean selection keeps A row-sorted and B col-sorted)
        nbk = -(-a_sp.ncols // 128)
        nbc = -(-b_sp.ncols // 128)
        ab = (a_sp.rows >> 7) * nbk + (a_sp.cols >> 7)
        uab, uacnt = np.unique(ab, return_counts=True)
        a_in = _in_sorted(ab, uab[uacnt >= brick_thresh])
        bb = (b_sp.rows[b_order] >> 7) * nbc + (b_order_cols >> 7)
        udb, udcnt = np.unique(bb, return_counts=True)
        b_in = _in_sorted(bb, udb[udcnt >= brick_thresh])

        def sub_rows(sel):
            return np.searchsorted(a_sp.rows[sel], np.arange(a_sp.nrows + 1)), a_keys_all[sel], a_vals_all[sel]

        def sub_cols(sel):
            return np.searchsorted(b_order_cols[sel], np.arange(b_sp.ncols + 1)), b_keys_all[sel], b_vals_all[sel]

        ad_indptr, ad_keys, ad_vals = sub_rows(a_in)
        ar_indptr, ar_keys, ar_vals = sub_rows(~a_in)
        br_indptr, br_keys, br_vals = sub_cols(~b_in)
        sparse, dense = ~in_dense, in_dense
        _build_eq_tasks(
            groups, all_idx[sparse], m_rows[sparse], m_cols[sparse],
            a_indptr, a_keys_all, a_vals_all, b_indptr, b_keys_all, b_vals_all,
        )
        # dense-entry remainder: A_rest x B_full  +  A_dense x B_rest
        _build_eq_tasks(
            groups, all_idx[dense], m_rows[dense], m_cols[dense],
            ar_indptr, ar_keys, ar_vals, b_indptr, b_keys_all, b_vals_all,
        )
        _build_eq_tasks(
            groups, all_idx[dense], m_rows[dense], m_cols[dense],
            ad_indptr, ad_keys, ad_vals, br_indptr, br_keys, br_vals,
        )
    buckets = _finalize_eq_buckets(groups, n_entries, device, a_sp.dtype, b_sp.dtype)
    rnet = _build_reduce_net(buckets, n_entries, device) if reduce_net and buckets else None
    return SpgemmPlan(m_rows, m_cols, n_entries, buckets, brick, rnet, device, a_sp.dtype, b_sp.dtype)


# ---------------------------------------------------------------------------
# execute
# ---------------------------------------------------------------------------


def _bucket_kernel_ok(add, mul, akT, bkT, out_dtype):
    """The reference's condition for its Pallas eqjoin (core/sparse.py:1440-1448,
    less the interpret-mode size limit, a CPU speed workaround): ``add`` and
    ``mul`` are the monoid's and the multiply's names."""
    return (
        _ej.supported(add, mul)
        and akT.dtype == torch.int32
        and bkT.dtype == torch.int32
        and (out_dtype == _dt.FP32 or mul == "pair")
    )


def _bucket_body(akT, avT, bkT, bvT, chunk, addm, mul, out_dtype, a_type, b_type):
    """One width bucket: (vals (T,) in ``out_dtype``'s carrier, nmatch (T,)
    int32), untrimmed (pad tasks give 0 matches)."""
    name, mul_name = addm.parent.name, mul.parent.name
    if _bucket_kernel_ok(name, mul_name, akT, bkT, out_dtype):
        avv = _dt.cast(avT, a_type, _dt.FP32) if mul_name in USES_AV else None
        bvv = _dt.cast(bvT, b_type, _dt.FP32) if mul_name in USES_BV else None
        vals, nmatch = _ej.eqjoin(akT, avv, bkT, bvv, name, mul_name)
        return _dt.cast(vals, _dt.FP32, out_dtype), nmatch
    return _bucket_plain(akT, avT, bkT, bvT, chunk, addm, mul, out_dtype, a_type, b_type)


def _fold(eff, fn):
    """Fold each row of ``eff`` (in order, pairwise) under the associative
    ``fn``; an odd tail is carried up a level unchanged."""
    while eff.shape[1] > 1:
        w = eff.shape[1] // 2 * 2
        folded = fn(eff[:, 0:w:2], eff[:, 1:w:2])
        eff = torch.cat([folded, eff[:, w:]], dim=1)
    return eff[:, 0]


def _bucket_plain(akT, avT, bkT, bvT, chunk, addm, mul, out_dtype, a_type, b_type):
    """The reference's XLA formulation (core/sparse.py:1453-1483) in plain
    torch: (chunk, Wa, Wb) key equalities per chunk of tasks, the product in
    the multiply's own input types, reduced by the monoid in ``out_dtype``
    (a user monoid: a pairwise fold of its function)."""
    name = addm.parent.name
    cd = _compute_carrier(out_dtype)
    ak, av, bk, bv = akT.T, _dt.cast(avT, a_type, mul.type_).T, bkT.T, _dt.cast(bvT, b_type, mul.type2).T
    vals, nms = [], []
    for s in range(0, ak.shape[0], chunk):
        akk, bkk = ak[s : s + chunk], bk[s : s + chunk]
        eq = akk[:, :, None] == bkk[:, None, :]
        prod = mul.fn(av[s : s + chunk, :, None], bv[s : s + chunk, None, :])
        prod = _dt.cast(prod, mul.return_type, out_dtype).to(cd)
        nms.append(eq.sum((1, 2), dtype=torch.int32))
        if name == "plus":
            val = torch.where(eq, prod, 0).sum((1, 2), dtype=None if cd.is_floating_point or cd.is_complex else torch.int64)
        elif name in ("min", "land"):
            big = _extreme(out_dtype, "max")
            val = _dt.ordered(torch.where(eq, _dt.ordered(prod, out_dtype), big).amin((1, 2)), out_dtype)
        elif name in ("max", "lor", "any"):
            small = _extreme(out_dtype, "min")
            val = _dt.ordered(torch.where(eq, _dt.ordered(prod, out_dtype), small).amax((1, 2)), out_dtype)
        elif name == "times":
            val = torch.where(eq, prod, 1).flatten(1).prod(1, dtype=None if cd.is_floating_point or cd.is_complex else torch.int64)
        else:
            iv = _dt.scalar_tensor(addm.identity, out_dtype, prod.device)
            eff = torch.where(eq, prod, iv).reshape(prod.shape[0], -1)
            fn = addm.fn
            val = _fold(eff, lambda a, b: _dt.cast(fn(a, b), addm.return_type, out_dtype))
        val = val != 0 if out_dtype._is_bool else _dt.wrap(val.to(out_dtype.carrier), out_dtype)
        vals.append(val)
    return torch.cat(vals), torch.cat(nms)


def _combine_net(vs, nms, reduce_net, scan_op, n_entries):
    """The scatter-free combine (core/sparse.py:1356-1375): route the
    concatenated task outputs into entry order (Kernel G), scan each entry's
    tasks (the generic scan: ``scan_op`` on the values, int32 add on the
    counts), and route each entry's total to its position (Kernel G)."""
    order, last, seg_start, has_task = reduce_net
    stream_v = torch.cat(vs).to(torch.float32)
    stream_nm = torch.cat(nms).to(torch.int32)
    pad = seg_start.shape[0] - stream_v.shape[0]
    if pad:
        stream_v = torch.cat([stream_v, stream_v.new_zeros(pad)])
        stream_nm = torch.cat([stream_nm, stream_nm.new_zeros(pad)])
    sv = apply_perm(stream_v, order)
    snm = apply_perm(stream_nm, order)
    sv = torch.where(snm > 0, sv, _scan_ident(scan_op, torch.float32))
    scanned_v = segmented_scan(sv, seg_start, scan_op)
    scanned_nm = segmented_scan(snm, seg_start, "add")
    out_v = apply_perm(scanned_v, last[:n_entries])
    out_nm = apply_perm(scanned_nm, last[:n_entries])
    hit = has_task & (out_nm > 0)
    return torch.where(hit, out_v, 0.0), hit


def _brick_body(brick, mul, acc, hit):
    """Add the dense bricks' products into (acc, hit); returns (acc, hit,
    matches).  The value product runs in full float32 (the reference's
    ``Precision.HIGHEST``); the 0/1 indicator product is exact at any
    precision."""
    cb = brick.a_idx.shape[0]
    accv = torch.zeros((cb, 128, 128), dtype=torch.float32, device=acc.device)
    accc = torch.zeros_like(accv)
    with full_f32_matmul():
        for k in range(brick.kmax):
            a = brick.a_bricks[brick.a_idx[:, k].long()]
            b = brick.b_bricks[brick.b_idx[:, k].long()]
            cnt = torch.bmm((a != 0).to(torch.float32), (b != 0).to(torch.float32))
            accc += cnt
            accv += cnt if mul == "pair" else torch.bmm(a, b)
    pad = accv.new_zeros(1)
    cell = brick.entry_cell.long()
    dv = torch.cat([accv.reshape(-1), pad])[cell].to(acc.dtype)
    dc = torch.cat([accc.reshape(-1), pad])[cell]
    dhit = dc > 0
    acc = torch.where(dhit & hit, acc + dv, torch.where(dhit, dv, acc))
    return acc, hit | dhit, dc.to(torch.int64).sum()


def sparse_spgemm_execute(plan, sr, out_dtype, *, keep_on_device=False):
    """Run the analyzed masked SpGEMM under the typed semiring ``sr`` into
    ``out_dtype`` on the plan's device: one eqjoin launch per width bucket,
    the task partials combined by entry on the device.

    Returns host (rows, cols, values, flops) of the entries that have a
    match, as the reference does; ``keep_on_device=True`` returns (values
    (n_entries,) in ``out_dtype``'s carrier, hit, flops) as tensors instead.
    ``flops`` is 2 x the matches (int64)."""
    mul = sr.binaryop
    addm = sr.monoid
    name = addm.parent.name
    brick = plan.brick
    if brick is not None and not (name == "plus" and mul.parent.name in ("pair", "times") and out_dtype == _dt.FP32):
        raise ValueError(
            "brick-analyzed SpGEMM plan requires a plus_pair/plus_times f32 semiring; re-analyze with bricks=False"
        )
    n = plan.n_entries
    dev = plan.device
    acc = torch.zeros(n, dtype=out_dtype.carrier, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    matches = torch.zeros((), dtype=torch.int64, device=dev)
    if plan.buckets:
        args = (addm, mul, out_dtype, plan.a_type, plan.b_type)
        outs = []
        for _w, _te, _multi, akT, avT, bkT, bvT, chunk, ids in plan.buckets:
            v, nm = _bucket_body(akT, avT, bkT, bvT, chunk, *args)
            outs.append((v, nm, ids))
            matches = matches + nm[: ids.shape[0]].sum(dtype=torch.int64)
        scan_op = _NET_SCAN_OPS.get(name)
        if name not in _SEGMENT_OPS:
            # a user monoid: reduce each bucket's sorted tasks, then combine
            # the buckets with the monoid (an entry may span several)
            for v, nm, ids in outs:
                y, ys = _segment_reduce(v[: ids.shape[0]], nm[: ids.shape[0]] > 0, ids, n, addm, out_dtype)
                both = ys & hit
                acc = torch.where(both, _dt.cast(addm.fn(acc, y), addm.return_type, out_dtype), torch.where(ys, y, acc))
                hit = hit | ys
        elif plan.reduce_net is not None and scan_op is not None and out_dtype == _dt.FP32:
            acc, hit = _combine_net([o[0] for o in outs], [o[1] for o in outs], plan.reduce_net, scan_op, n)
        else:
            all_v = torch.cat([v[: i.shape[0]] for v, _, i in outs])
            all_nm = torch.cat([nm[: i.shape[0]] for _, nm, i in outs])
            acc, hit = _segment_reduce(all_v, all_nm > 0, torch.cat([i for _, _, i in outs]), n, addm, out_dtype)
    if brick is not None:
        acc, hit, brick_matches = _brick_body(brick, mul.parent.name, acc, hit)
        matches = matches + brick_matches
    flops = 2 * matches
    if keep_on_device:
        return acc, hit, flops
    keep = hit.cpu().numpy()
    return plan.m_rows[keep], plan.m_cols[keep], _dt.to_numpy(acc, out_dtype)[keep], int(flops)


def sparse_mxm_masked(a_sp, b_sp, m_rows, m_cols, sr, out_dtype, *, device="cuda"):
    """C(M) = A (+).(x) B over sparse operands, the output restricted to M's
    pattern (the masked dot method): for each mask entry (i, j), intersect
    A's row i with B's column j.  Analyzes (bricks for plus_pair/plus_times
    into FP32, the reduce net for plus/min/max/any into FP32) and executes
    on ``device``.  Returns host (rows, cols, values, flops)."""
    out_np = np.dtype(out_dtype.np_type)
    m_rows = np.asarray(m_rows, np.int64)
    m_cols = np.asarray(m_cols, np.int64)
    if len(m_rows) == 0 or a_sp.nvals == 0 or b_sp.nvals == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, out_np), 0
    name = sr.monoid.parent.name
    f32 = out_dtype == _dt.FP32
    use_bricks = name == "plus" and sr.binaryop.parent.name in ("pair", "times") and f32
    use_net = name in _NET_SCAN_OPS and f32
    plan = sparse_spgemm_analyze(a_sp, b_sp, m_rows, m_cols, bricks=use_bricks, reduce_net=use_net, device=device)
    return sparse_spgemm_execute(plan, sr, out_dtype)


# ---------------------------------------------------------------------------
# unmasked sparse x sparse SpGEMM -> sparse output (GrB_mxm's output is
# always sparse)
# ---------------------------------------------------------------------------


def sparse_spgemm_full(a_sp, b_sp, sr, out_dtype, *, device):
    """C = A (+).(x) B over sparse operands -> SparseMatrixData.

    Host expand-join Gustavson: the intermediate products' pattern is
    materialized on the host (bounded by tx.config['spgemm_flop_limit']) and
    grouped by (i, j); the multiply and the monoid run on ``device``.  The
    masked dot engine (``sparse_mxm_masked``) remains the performance path;
    this is the semantically complete unmasked route that never densifies.
    """
    out_np = np.dtype(out_dtype.np_type)
    if a_sp.nvals == 0 or b_sp.nvals == 0:
        return SparseMatrixData(
            np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, out_np), a_sp.nrows, b_sp.ncols
        )
    # per-A-entry B-row ranges via binary search (no nrows-sized indptr:
    # dimensions may be 2^40+)
    lo = np.searchsorted(b_sp.rows, a_sp.cols, "left")
    hi = np.searchsorted(b_sp.rows, a_sp.cols, "right")
    cnt = hi - lo
    total = int(cnt.sum())
    limit = _spgemm_flop_limit()
    if total > limit:
        raise _exc.OutOfMemory(
            f"unmasked sparse mxm would materialize {total} intermediate products "
            f"(> tx.config['spgemm_flop_limit']={limit}); provide a mask "
            "(C(M) << A.mxm(B)) to run the masked dot engine, or raise the limit"
        )
    rep = np.repeat(np.arange(a_sp.nvals), cnt)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    bpos = lo[rep] + offs
    ci = a_sp.rows[rep]
    cj = b_sp.cols[bpos]
    order = np.lexsort((cj, ci))
    ci, cj, rep, bpos = ci[order], cj[order], rep[order], bpos[order]
    mul = sr.binaryop
    pos_mul = mul.positional
    if pos_mul is not None:
        which, delta = pos_mul
        src_idx = {"firsti": ci, "firstj": a_sp.cols[rep], "secondi": b_sp.rows[bpos], "secondj": cj}[which]
        prod = _dt.cast(_index_t(src_idx + delta, device), _dt.INT64, out_dtype)
    elif mul.parent.name in ("pair", "oneb"):
        prod = _dt.cast(torch.ones(total, dtype=torch.int64, device=device), _dt.INT64, out_dtype)
    else:
        # the products in the multiply's input types, gathered on the device
        av = _dt.cast(a_sp.device("vals_r", device), a_sp.dtype, mul.type_)[_index_t(rep, device)]
        bv = _dt.cast(b_sp.device("vals_r", device), b_sp.dtype, mul.type2)[_index_t(bpos, device)]
        prod = _dt.cast(mul.fn(av, bv), mul.return_type, out_dtype)
    starts = np.flatnonzero(np.concatenate([[True], (ci[1:] != ci[:-1]) | (cj[1:] != cj[:-1])]))
    out_v = _reduce_groups(prod, starts, sr.monoid, out_dtype)
    return SparseMatrixData(ci[starts], cj[starts], out_v, a_sp.nrows, b_sp.ncols)

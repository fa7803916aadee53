"""The acceptance-workload algorithms written in the user DSL, compiled.

Counterpart of ``graphblas_tpu/models/dsl.py``, recipe for recipe: PageRank,
level BFS (the notebook's sparse frontier and the dense 0/1 frontier), SSSP,
connected components and FastSV, written as ordinary DSL statements (mxv /
ewise / apply / assign / reduce over Matrix/Vector/Scalar) and compiled with
``gb.loop`` / ``gb.until``: on the card each loop runs as CUDA graph
replays of its body (``core/compiler.py``); ``fastsv`` is host-driven and
runs eagerly.  ``GRAPHBLAS_TPU_DSL_UNROLL`` and ``GRAPHBLAS_TPU_SEED_ROUND``
are read with the reference's defaults.

The matrix argument ``AT`` is the pull-oriented adjacency: ``AT[i, j]`` is an
edge j -> i, so ``AT.mxv(x)`` computes y[i] = REDUCE over in-neighbors j of
x[j] (*) w(j, i).  Build it with ``Matrix.from_coo(dst, src, w)``.
"""

import os

import numpy as np

_BIG = float(np.float32(3.4e38) / 4)


def _unroll():
    """Body steps per while iteration for the fixpoint recipes (BFS/SSSP/CC
    accumulate under min/max, so steps past convergence are no-ops).
    Amortizes the per-iteration cond/while overhead at the cost of up to
    unroll-1 extra no-op steps."""
    return max(1, int(os.environ.get("GRAPHBLAS_TPU_DSL_UNROLL", "1")))


def _gb():
    import graphblas_tpu_torch as gb

    return gb


def _seed_round():
    """Bake round 1 into the initial state at build time (the runner already
    binds the source/graph at build).  Round 1 of BFS/SSSP only propagates
    from the source — O(deg) useful work — but a compiled-loop round costs a
    full O(E) pass; connected components' round 1 is one host segment-min.
    Deletes exactly one full round (same fixpoint — tests A/B this).
    GRAPHBLAS_TPU_SEED_ROUND=0 disables."""
    return os.environ.get("GRAPHBLAS_TPU_SEED_ROUND", "1") == "1"


def _host_coo(AT):
    """(rows, cols, vals) of a sparse-backed DSL Matrix, else None (the
    build-time seed is skipped for dense-backed matrices)."""
    sp = getattr(AT, "_sparse", None)
    if sp is None:
        return None
    return np.asarray(sp.rows), np.asarray(sp.cols), np.asarray(sp.vals)


def pagerank(AT, *, damping=0.85, max_iters=50, dtype=None):
    """PageRank via DSL statements in one compiled loop.

    Matches models/fast.pagerank semantics (dangling mass redistributed,
    fixed iteration count).  Reference recipe: notebooks/Pagerank Demo.
    """
    return pagerank_runner(AT, damping=damping, max_iters=max_iters, dtype=dtype)()


def pagerank_runner(AT, *, damping=0.85, max_iters=50, dtype=None):
    """Build the compiled PageRank program once; call the result repeatedly
    (each call re-runs the same captured program from r0 = 1/n)."""
    gb = _gb()
    from .. import binary, semiring
    from ..core import dtypes as dtm
    from ..core.vector import Vector

    dtype = dtm.FP32 if dtype is None else dtype
    n = AT.nrows
    d = float(damping)

    # -- setup (host-side, once): out-degree, dangling indicator ------------
    outdeg = AT.reduce_columnwise("plus").new(dtype)  # out-degree of each src
    deg = np.asarray(outdeg.to_dense(fill_value=0.0)).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    inv_deg = Vector.from_dense(inv.astype(np.float32), dtype=dtype)
    dang = Vector.from_dense((deg == 0).astype(np.float32), dtype=dtype)

    r0 = Vector.from_scalar(1.0 / n, n, dtype)

    def body(r):
        q = r.ewise_mult(inv_deg, binary.times).new(dtype)  # r / outdeg
        dm = r.ewise_mult(dang, binary.times).reduce("plus").new(dtype)
        pulled = AT.mxv(q, semiring.plus_times).new(dtype)
        # teleport term: (1-d)/n + d * dangling_mass / n  (scalar DSL algebra)
        t = (dm * (d / n) + (1.0 - d) / n).new(dtype)
        tv = Vector.from_scalar(t, n, dtype)
        scaled = pulled.apply(binary.times, right=d).new(dtype)
        r_new = tv.ewise_add(scaled, binary.plus).new(dtype)
        return r_new

    return gb.loop_runner(int(max_iters), body, r0)


def bfs_level(AT, source, *, max_iters=None):
    """Level BFS via DSL statements in one compiled while-loop.

    Reference recipe: notebooks/Example B.1 — ``v(q.S)[:] = level`` then
    ``q(~v.S, replace) << q.vxm(A, any_pair)``; here the pull form
    ``AT.mxv(q)`` is used (same result on the transposed matrix).
    Returns an INT32 Vector of levels (entries only at reached vertices).
    """
    return bfs_level_runner(AT, source, max_iters=max_iters)()


def bfs_level_runner(AT, source, *, max_iters=None):
    gb = _gb()
    from .. import monoid, semiring
    from ..core import dtypes as dtm
    from ..core.scalar import Scalar
    from ..core.vector import Vector

    n = AT.nrows
    v0 = Vector(dtm.INT32, n, name="levels")
    q0 = Vector(dtm.BOOL, n, name="frontier")
    q0[int(source)] = True
    lvl0 = Scalar.from_value(0, dtm.INT32)

    def cond(v, q, lvl):
        return q.reduce(monoid.lor)

    def body(v, q, lvl):
        v(q.S)[:] = lvl
        q_new = Vector(dtm.BOOL, n)
        q_new(~v.S, replace=True) << AT.mxv(q, semiring.any_pair["BOOL"])
        lvl_new = (lvl + 1).new(dtm.INT32)
        return v, q_new, lvl_new

    runner = gb.until_runner(cond, body, v0, q0, lvl0, max_iters=max_iters or n, unroll=_unroll())

    def run():
        v, _, _ = runner()
        return v

    run.mode = runner.mode
    run.runner = runner
    return run


def bfs_level_dense(AT, source, *, max_iters=None):
    """Level BFS with a dense 0/1 frontier: see :func:`bfs_level_dense_runner`."""
    return bfs_level_dense_runner(AT, source, max_iters=max_iters)()


def bfs_level_dense_runner(AT, source, *, max_iters=None):
    """Level BFS with a DENSE 0/1 frontier.

    The notebook recipe (:func:`bfs_level_runner`) carries a sparse frontier
    whose structure is data-dependent, so the compiled loop falls back to
    carried mode and every SpMV pays a structure-channel expand on top of the
    value channel.  Riding the frontier as a dense FP32 0/1 vector keeps every
    loop state structurally FULL: the loop hoists all structure to trace-time
    constants (mode == "hoisted") and each level is ONE value-channel
    ``max_second`` SpMV — the same recipe as the hand-written model
    (models/fast._bfs_loop).  Same result as ``bfs_level``: an INT32 vector of
    levels, dense with -1 at unreached vertices.
    """
    gb = _gb()
    from .. import binary, monoid, semiring
    from ..core import dtypes as dtm
    from ..core.scalar import Scalar
    from ..core.vector import Vector

    n = AT.nrows
    source = int(source)
    v0_np = np.full(n, -1, np.int32)
    q0_np = np.zeros(n, np.float32)
    lvl = 0
    coo = _host_coo(AT) if _seed_round() else None
    if coo is not None:
        # build-time seed: level 1 = source's out-neighbors (round 1 on host)
        r, c, _ = coo
        nb = np.unique(r[c == source])
        nb = nb[nb != source]
        v0_np[nb] = 1
        q0_np[nb] = 1.0
        lvl = 1
    else:
        q0_np[source] = 1.0
    v0_np[source] = 0
    v0 = Vector.from_dense(v0_np, dtype=dtm.INT32, name="levels")
    q0 = Vector.from_dense(q0_np, dtype=dtm.FP32, name="frontier")
    lvl0 = Scalar.from_value(lvl, dtm.INT32)
    # closed-over dense zero: unioning with it keeps the frontier
    # structurally FULL every iteration (the mxv output pattern alone is
    # only the vertices with in-edges, which would break hoisting)
    zeros = Vector.from_scalar(0.0, n, dtm.FP32, name="zeros")

    def cond(v, q, lvl):
        return q.reduce(monoid.max).apply(binary.gt, right=0.0)

    def body(v, q, lvl):
        lvl1 = (lvl + 1).new(dtm.INT32)
        pulled = AT.mxv(q, semiring.max_second).new(dtm.FP32)
        newly = pulled.apply(binary.gt, right=0.0).new(dtm.BOOL)
        unvis = v.apply(binary.lt, right=0).new(dtm.BOOL)
        nxt = newly.ewise_mult(unvis, binary.land).new(dtm.BOOL)
        v_new = v.dup()
        v_new(nxt.V)[:] = lvl1
        q_new = nxt.ewise_add(zeros, binary.plus).new(dtm.FP32)  # dense 0/1
        return v_new, q_new, lvl1

    runner = gb.until_runner(cond, body, v0, q0, lvl0, max_iters=max_iters or n, unroll=_unroll())

    def run():
        v, _, _ = runner()
        return v

    run.mode = runner.mode
    run.runner = runner
    return run


def sssp(AT, source, *, max_iters=None):
    """Bellman-Ford SSSP via DSL statements in one compiled while-loop.

    Reference recipe: notebooks/Intro to GraphBLAS + SSSP example —
    ``w(accum=min) << A.mxv(w, min_plus)`` until no distance improves.
    Distances ride a dense FP32 vector (unreached = _BIG) so the loop state
    is structurally stable and the compiled loop hoists every structure
    channel to trace-time constants.
    """
    return sssp_runner(AT, source, max_iters=max_iters)()


def sssp_runner(AT, source, *, max_iters=None):
    gb = _gb()
    from .. import binary, monoid, semiring
    from ..core import dtypes as dtm
    from ..core.scalar import Scalar
    from ..core.vector import Vector

    n = AT.nrows
    source = int(source)
    d0_np = np.full(n, _BIG, np.float32)
    coo = _host_coo(AT) if _seed_round() else None
    if coo is not None:
        # build-time seed: relax the source's out-edges (round 1) on host —
        # AT[i, j] is edge j -> i, so source's out-edges are cols == source
        r, c, w = coo
        m = c == source
        np.minimum.at(d0_np, r[m], w[m].astype(np.float32))
    d0_np[source] = 0.0
    d0 = Vector.from_dense(d0_np, dtype=dtm.FP32, name="dist")
    ch0 = Scalar.from_value(True, dtm.BOOL)

    def cond(dist, changed):
        return changed

    def body(dist, changed):
        relaxed = AT.mxv(dist, semiring.min_plus).new(dtm.FP32)
        new = dist.dup()
        new(accum=binary.min) << relaxed
        ch = new.ewise_mult(dist, binary.lt).reduce(monoid.lor).new(dtm.BOOL)
        return new, ch

    runner = gb.until_runner(cond, body, d0, ch0, max_iters=max_iters or n, unroll=_unroll())

    def run():
        dist, _ = runner()
        return dist

    run.mode = runner.mode
    run.runner = runner
    return run


def connected_components(AT, *, max_iters=None, dtype=None):
    """(Weakly-)connected components via DSL statements in one compiled loop.

    Min-label propagation with ALTERNATING direction passes, the reference's
    recipe: each super-iteration pulls the minimum label along in-edges
    (``min_second`` mxv) and then pushes it along out-edges (``min_first``
    vxm), both on the O(E) plan engine.  Same fixed point (the component
    minimum) as FastSV on the symmetrized graph, over the directed adjacency
    (about half the edge slots of its symmetrization).  ``AT`` may be ANY
    adjacency (weak connectivity == connectivity of the symmetrization).
    models/fastsv.py keeps the pointer-jumping variant.

    Labels ride FP32 (exact for n < 2**24); pass ``dtype=INT64`` past that.
    Returns a Vector where each vertex holds its component's minimum id.
    """
    return connected_components_runner(AT, max_iters=max_iters, dtype=dtype)()


def connected_components_runner(AT, *, max_iters=None, dtype=None):
    gb = _gb()
    from .. import binary, monoid, semiring
    from ..core import dtypes as dtm
    from ..core.scalar import Scalar
    from ..core.vector import Vector

    dtype = dtm.FP32 if dtype is None else dtype
    n = AT.nrows
    p0_np = np.arange(n, dtype=np.int64)
    coo = _host_coo(AT) if _seed_round() else None
    if coo is not None:
        # build-time seed: one alternating super-round on host (two
        # segment-min passes) — deletes one full compiled super-iteration
        r, c, _ = coo
        m = np.full(n, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(m, r, p0_np[c])
        p0_np = np.minimum(p0_np, m)
        m = np.full(n, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(m, c, p0_np[r])
        p0_np = np.minimum(p0_np, m)
    p0 = Vector.from_dense(p0_np, dtype=dtype, name="labels")
    ch0 = Scalar.from_value(True, dtm.BOOL)

    def cond(p, changed):
        return changed

    def body(p, changed):
        m1 = AT.mxv(p, semiring.min_second).new(dtype)  # pull along in-edges
        p1 = p.dup()
        p1(accum=binary.min) << m1
        m2 = p1.vxm(AT, semiring.min_first).new(dtype)  # push along out-edges
        new = p1.dup()
        new(accum=binary.min) << m2
        ch = new.ewise_mult(p, binary.lt).reduce(monoid.lor).new(dtm.BOOL)
        return new, ch

    runner = gb.until_runner(cond, body, p0, ch0, max_iters=max_iters or n, unroll=_unroll())

    def run():
        p, _ = runner()
        return p

    run.mode = runner.mode
    run.runner = runner
    return run


def fastsv(AT, *, max_iters=None, dtype=None):
    """FastSV connected components — the reference notebook recipe verbatim.

    Host-driven loop of DSL statements (reference: notebooks/Connected
    Components -- FastSV.ipynb, LAGraph FastSV): min_second mxv hooking,
    scatter-assign ``f(min)[I] << mngp``, min-merges, and the grandparent
    extract ``gp << f[f_values]``.  Runs on sparse matrices at any scale with
    no densify; per-iteration host reads (``to_coo``) make it slower than
    :func:`connected_components` (the compiled min-label loop) — use that for
    production CC; this one exists for recipe parity.

    ``AT`` must be structurally symmetric.  Labels ride FP32 below 2**24
    vertices (exact; enables the plan engine), INT64 above.
    """
    gb = _gb()
    from .. import binary, monoid, semiring
    from ..core import dtypes as dtm
    from ..core.vector import Vector

    n = AT.nrows
    if dtype is None:
        dtype = dtm.FP32 if n < (1 << 24) else dtm.INT64
    I0 = np.arange(n)
    f = Vector.from_coo(I0, I0, dtype, size=n, name="parents")
    gp = f.dup()
    gp_dup = gp.dup()
    mngp = f.dup(name="min_grandparent")
    change = True
    it = 0
    limit = max_iters or n
    while change and it < limit:
        mngp(binary.min) << AT.mxv(gp, semiring.min_second)
        f(binary.min)[I0] << mngp
        f << f.ewise_mult(mngp, binary.min)
        f << f.ewise_mult(gp, binary.min)
        _, fv = f.to_coo()
        gp << f[fv.astype(np.int64)]
        mod = gp.ewise_mult(gp_dup, binary.ne).new(dtm.BOOL)
        change = bool(mod.reduce(monoid.lor).new().value)
        gp_dup << gp
        it += 1
    return f

"""The SpMV engine's k-column product: ``A.mxm(F, sr)`` with a sparse A and
a dense n x k F (``core.sparse.sparse_mxm_dense`` → ``ops.fastspmv.spmm_masked``
→ ``kernels.segscan.segscan_spmm``).

On the CPU the product runs the kernel's plain version ("plan") or the
column-by-column ``sparse_mxv`` ("auto": CPU tensors take the generic path);
each is held to a dense float64 product computed here, to k separate
``mxv`` calls, to the JAX package's product on the same COO and frontier,
and, through masks, complements, replace and accumulators, to the same
statements over a dense-backed copy of A (the dense engine) and in the JAX
package.
The plain version is held to Kernel C's plain version read at the segment
ends.  The ``cuda`` cases hold the kernel to its plain version on the card.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gb
from graphblas_tpu_torch import Matrix, binary, semiring
from graphblas_tpu_torch.core import telemetry
from graphblas_tpu_torch.kernels import segscan as ks
from graphblas_tpu_torch.models.graph import rmat
from graphblas_tpu_torch.ops import fastspmv as fs

N = 256
SEMIRINGS = ["plus_second", "plus_times", "min_plus", "any_pair"]
DTYPES = {"FP64": (gb.dtypes.FP64, np.float64), "FP32": (gb.dtypes.FP32, np.float32)}


def _pattern(kind, seed=3):
    """(rows, cols, weights) of an n = 256 pattern: Kronecker-skewed or uniform."""
    rng = np.random.default_rng(seed)
    if kind == "rmat":
        g = rmat(8, 8, seed=seed, weighted=True, device="cpu")
        r, c = g.dst.cpu().numpy().astype(np.int64), g.src.cpu().numpy().astype(np.int64)
        keep = r < N
        r, c = r[keep], c[keep]
    else:
        r, c = rng.integers(0, N, 8 * N), rng.integers(0, N, 8 * N)
    key = np.unique(r * N + c)
    r, c = key // N, key % N
    w = (rng.integers(1, 8, r.size) / 4.0).astype(np.float32)  # exact in float32
    return r, c, w


def _frontier(k, np_t, seed=5, density=0.3):
    rng = np.random.default_rng(seed)
    vals = (rng.integers(1, 64, (N, k)) / 8.0).astype(np_t)
    present = rng.random((N, k)) < density
    return vals, present


def _matrices(kind, k, dt, np_t):
    r, c, w = _pattern(kind)
    with gb.tx.config.set(dense_limit=4096):
        A = Matrix.from_coo(r, c, w, gb.dtypes.FP32, nrows=N, ncols=N)
    assert A._sparse is not None
    vals, present = _frontier(k, np_t)
    fr, fc = np.nonzero(present)
    F = Matrix.from_coo(fr, fc, vals[fr, fc], dt, nrows=N, ncols=k)
    assert F._sparse is None
    return A, F, (r, c, w), (vals, present)


def _dense_product(coo, frontier, sr):
    """(values, structure) of A (.) F in float64 from the COO and F's arrays."""
    r, c, w = coo
    vals, present = frontier
    k = vals.shape[1]
    out = np.zeros((N, k))
    struct = np.zeros((N, k), bool)
    for j in range(k):
        ok = present[c, j]
        rr, aa, xx = r[ok], w[ok].astype(np.float64), vals[c[ok], j].astype(np.float64)
        if sr == "plus_second":
            contrib, reduce, fill = xx, np.add, 0.0
        elif sr == "plus_times":
            contrib, reduce, fill = aa * xx, np.add, 0.0
        elif sr == "min_plus":
            contrib, reduce, fill = aa + xx, np.minimum, np.inf
        else:  # any_pair
            contrib, reduce, fill = np.ones_like(xx), np.maximum, 0.0
        col = np.full(N, fill)
        reduce.at(col, rr, contrib)
        hit = np.bincount(rr, minlength=N) > 0
        struct[:, j] = hit
        out[:, j] = np.where(hit, col, 0.0)
    return out, struct


def _arrays(M):
    return M._values.double().numpy(), M._struct.numpy()


@pytest.fixture(params=["plan", "auto"])
def strategy(request, monkeypatch):
    monkeypatch.setenv("GRAPHBLAS_TPU_PLAN_BACKGROUND", "0")
    with gb.tx.config.set(platform="cpu", mxv_strategy=request.param):
        yield request.param


@pytest.mark.parametrize("kind", ["rmat", "uniform"])
@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 2, 4, 8, 11])  # 11: two launches, of 8 and 3 columns
def test_product_matches_dense_and_columns(strategy, kind, sr, dt, k):
    dtype, np_t = DTYPES[dt]
    A, F, coo, frontier = _matrices(kind, k, dtype, np_t)
    before = telemetry.counter("kernels.plain.segscan_spmm")
    Y = A.mxm(F, getattr(semiring, sr)).new()
    calls = telemetry.counter("kernels.plain.segscan_spmm") - before
    # "plan": one pass of the plain version for each 8 columns; "auto" on the CPU: k generic mxv
    assert calls == (-(-k // 8) if strategy == "plan" else 0)
    assert Y.dtype == dtype and Y.shape == (N, k) and Y._sparse is None
    yv, ys = _arrays(Y)
    want_v, want_s = _dense_product(coo, frontier, sr)
    assert np.array_equal(ys, want_s)
    # the operands are exact binary fractions: sums of at most 64 of them
    # round in neither float32 nor float64, whatever the order
    assert np.array_equal(yv, want_v)
    for j in range(k):
        y = A.mxv(F[:, j].new(), getattr(semiring, sr)).new()
        cv, cs = y._values.double().numpy(), y._struct.numpy()
        assert np.array_equal(cs, ys[:, j]) and np.array_equal(cv, yv[:, j]), j


STATEMENTS = ["mask", "complement_replace", "accum", "mask_accum_replace", "value_mask", "transposed"]


def _statement(pkg, A, F, M, stmt):
    """One of the BC recipe's statement forms, in package ``pkg`` (the port
    or the JAX package), on a copy of M."""
    sr, binop = pkg.semiring, pkg.binary
    C = M.dup()
    if stmt == "mask":
        C(M.S) << A.mxm(F, sr.plus_second)
    elif stmt == "complement_replace":
        C(~M.S, replace=True) << A.mxm(F, sr.plus_second)
    elif stmt == "accum":
        C(accum=binop.plus) << A.mxm(F, sr.plus_times)
    elif stmt == "mask_accum_replace":
        C(M.S, accum=binop.min, replace=True) << A.mxm(F, sr.min_plus)
    elif stmt == "value_mask":
        C((M == 2.0).new().V) << A.mxm(F, sr.plus_second)
    else:
        C(accum=binop.plus) << A.T.mxm(F, sr.plus_times)
    return C


def _mask(dt, np_t):
    vals, present = _frontier(4, np_t, seed=11, density=0.5)
    mr, mc = np.nonzero(present)
    return mr, mc, vals[mr, mc]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("stmt", STATEMENTS)
def test_masks_and_accumulators_match_the_dense_engine(strategy, dt, stmt):
    """The BC recipe's statement forms, against the same statements over a
    dense-backed A (the dense engine computes that product)."""
    dtype, np_t = DTYPES[dt]
    A, F, coo, _ = _matrices("rmat", 4, dtype, np_t)
    with gb.tx.config.set(dense_limit=1 << 20):
        Ad = Matrix.from_coo(*coo, gb.dtypes.FP32, nrows=N, ncols=N)
    assert Ad._sparse is None
    M = Matrix.from_coo(*_mask(dt, np_t), dtype, nrows=N, ncols=4)
    outs = [_arrays(_statement(gb, mat, F, M, stmt)) for mat in (A, Ad)]
    assert np.array_equal(outs[0][1], outs[1][1])
    assert np.array_equal(outs[0][0], outs[1][0])


# ---- the JAX package on the same inputs ---------------------------------------


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


def _reference_operands(R, coo, frontier, dt):
    """A (densified by the JAX package at n = 256) and F in the JAX package,
    from the arrays the port's operands were built from."""
    r, c, w = coo
    A = R.Matrix.from_coo(r, c, w, R.dtypes.FP32, nrows=N, ncols=N)
    vals, present = frontier
    fr, fc = np.nonzero(present)
    F = R.Matrix.from_coo(fr, fc, vals[fr, fc], getattr(R.dtypes, dt), nrows=N, ncols=vals.shape[1])
    return A, F


def _same(port, reference):
    """Equal structure and equal values (exact: the operands are binary
    fractions, whose sums round in neither float32 nor float64)."""
    assert port.dtype.name == reference.dtype.name and port.shape == reference.shape
    pr, pc, pv = port.to_coo()
    rr, rc, rv = reference.to_coo()
    assert np.array_equal(np.asarray(pr, np.int64), np.asarray(rr, np.int64))
    assert np.array_equal(np.asarray(pc, np.int64), np.asarray(rc, np.int64))
    assert pv.dtype == rv.dtype and np.array_equal(pv, rv)


@pytest.mark.parametrize("kind", ["rmat", "uniform"])
@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 2, 4, 8, 11])
def test_product_matches_the_jax_package(ref, strategy, kind, sr, dt, k):
    dtype, np_t = DTYPES[dt]
    A, F, coo, frontier = _matrices(kind, k, dtype, np_t)
    RA, RF = _reference_operands(ref, coo, frontier, dt)
    _same(A.mxm(F, getattr(semiring, sr)).new(), RA.mxm(RF, getattr(ref.semiring, sr)).new())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("stmt", STATEMENTS)
def test_masks_and_accumulators_match_the_jax_package(ref, strategy, dt, stmt):
    dtype, np_t = DTYPES[dt]
    A, F, coo, frontier = _matrices("rmat", 4, dtype, np_t)
    RA, RF = _reference_operands(ref, coo, frontier, dt)
    mask = _mask(dt, np_t)
    M = Matrix.from_coo(*mask, dtype, nrows=N, ncols=4)
    RM = ref.Matrix.from_coo(*mask, getattr(ref.dtypes, dt), nrows=N, ncols=4)
    _same(_statement(gb, A, F, M, stmt), _statement(ref, RA, RF, RM, stmt))


def test_product_never_densifies_a():
    """Past ``densify_limit`` the dense engine would refuse A; the k-column
    product runs on its plan."""
    rng = np.random.default_rng(1)
    n = 1 << 14
    r, c = rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)
    with gb.tx.config.set(platform="cpu", mxv_strategy="plan", densify_limit=1 << 20):
        A = Matrix.from_coo(r, c, 1.0, gb.dtypes.FP32, nrows=n, ncols=n, dup_op=binary.first)
        F = Matrix.from_coo(np.arange(4), np.arange(4), 1.0, gb.dtypes.FP64, nrows=n, ncols=4)
        Y = A.mxm(F, semiring.plus_second).new()
        want = np.stack([np.bincount(r[c == j], minlength=n) > 0 for j in range(4)], 1)
        assert np.array_equal(Y._struct.numpy(), want)


@pytest.mark.parametrize("op,mul", [("add", "times"), ("min", "plus"), ("max", "second"), ("add", "first")])
@pytest.mark.parametrize("xs_given", [True, False])
def test_plain_equals_contrib_scan_at_segment_ends(op, mul, xs_given):
    """The plain k-column product equals Kernel C's plain version with x's
    gather, one column at a time, read at each dst segment's end (float
    sums bit for bit: both scan in the same order)."""
    r, c, w = _pattern("rmat", seed=9)
    plan = fs.build_spmv_plan(c.astype(np.int32), r.astype(np.int32), w, n=N, device="cpu")
    vals, present = _frontier(3, np.float32, seed=4)
    x, xs = torch.from_numpy(vals), torch.from_numpy(present)
    seg_start, read = fs._dst_reduce(plan)
    seg_vertex, _ = fs._spmm_index(plan, seg_start, x)
    wt = plan.w_dst_order if mul in ("times", "plus", "second") else None
    yv, ys = ks.segscan_spmm_plain(
        x, xs if xs_given else None, plan.src_dst_order, wt, plan.valid_dst_order, seg_start, seg_vertex, plan.n, op, mul
    )
    for j in range(3):
        valid = plan.valid_dst_order & (xs[:, j][plan.src_dst_order.long()] if xs_given else True)
        scanned = ks.segscan_contrib_gather_plain(x[:, j].contiguous(), plan.src_dst_order, wt, valid, seg_start, op, mul)
        col = read(scanned, ks._ident(op, torch.float32))
        struct = read(ks._scan_plain("add", valid.int(), seg_start), 0) > 0
        assert torch.equal(ys[:, j], struct), j
        assert torch.equal(yv[:, j], torch.where(struct, col, torch.zeros(()))), j


def test_checks():
    x = torch.zeros((4, 9), dtype=torch.float64)
    idx = torch.zeros(8, dtype=torch.int32)
    b = torch.zeros(8, dtype=torch.bool)
    sv = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 8 columns"):
        ks.segscan_spmm_plain(x, None, idx, None, b, b, sv, 4, "add", "first")
    with pytest.raises(TypeError, match="float32 or float64"):
        ks.segscan_spmm_plain(x[:, :2].int(), None, idx, None, b, b, sv, 4, "add", "first")
    with pytest.raises(ValueError, match="needs w"):
        ks.segscan_spmm_plain(x[:, :2], None, idx, None, b, b, sv, 4, "add", "times")
    with pytest.raises(ValueError, match="takes no w"):
        ks.segscan_spmm_plain(x[:, :2], None, idx, torch.zeros(8), b, b, sv, 4, "add", "pair")


def test_counters_and_span(strategy):
    A, F, _, _ = _matrices("rmat", 4, gb.dtypes.FP64, np.float64)
    telemetry.reset("ops.spmm", "ops.sparse_mxm_dense")
    A.mxm(F, semiring.plus_second).new()
    snap = telemetry.snapshot()
    assert snap["counters"]["ops.spmm_products"] == 1 and snap["counters"]["ops.spmm_columns"] == 4
    assert snap["counters"]["ops.spmm_launches"] == 0  # no card: no hand-kernel launch
    assert snap["spans"]["ops.sparse_mxm_dense"]["count"] == 1


def test_compiled_loop_carries_the_product(strategy):
    """A frontier loop of the BC forward sweep's form under ``gb.until_runner``
    (on the CPU every step runs eagerly) gives what the statements give
    eagerly."""
    A, F0, _, _ = _matrices("rmat", 4, gb.dtypes.FP64, np.float64)
    from graphblas_tpu_torch import monoid

    def body(F, P):
        Fn = Matrix(gb.dtypes.FP64, N, 4)
        Fn(~P.S, replace=True) << A.mxm(F, semiring.plus_second)
        Pn = P.dup()
        Pn(accum=binary.plus) << Fn
        return Fn, Pn

    def cond(F, P):
        return F.reduce_scalar(monoid.plus).apply(binary.gt, right=0.0)

    runner = gb.until_runner(cond, body, F0.dup(), F0.dup(), max_iters=N)
    Fc, Pc = runner(F0.dup(), F0.dup())
    F, P = F0.dup(), F0.dup()
    steps = 0
    while F.nvals:
        F, P = body(F, P)
        steps += 1
    assert runner.last_iters == steps
    assert np.array_equal(_arrays(Pc)[1], _arrays(P)[1]) and np.array_equal(_arrays(Pc)[0], _arrays(P)[0])


# ---- the k-column kernel's tiles, from sizes and pointers (no card needed) ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", range(1, 9))
def test_spmm_tile_fits_shared_memory(k, dtype):
    """The tile follows from the value row's bytes: a multiple of 8 slots a
    scan thread and of the tile_base block, the largest such that fits two
    blocks' shared memory on an SM."""
    kp = ks.spmm_columns(k)
    tile = ks.spmm_tile(k, dtype)
    step = max(2048 // kp, ks.SPMM_GRANULE)
    assert tile % step == 0 and tile % ks.SPMM_GRANULE == 0 and step <= tile <= 2048
    row = kp * torch.empty((), dtype=dtype).element_size()
    smem = tile * (20 + row + (16 if kp >= 4 else 4 * ((kp + 6) // 4)) + 5) + 32
    assert smem <= 112 * 1024
    assert tile == 2048 or smem + step * (smem - 32) // tile > 112 * 1024  # the largest that fits
    if dtype == torch.float64 and k == 4:
        assert tile == 1536  # the bc cell's product


def test_spmm_tiles_counts_staged_tiles():
    """Full tiles of 16-byte aligned streams are staged; the ragged last
    tile is not, and no tile of an unaligned stream is."""
    tile = ks.spmm_tile(4, torch.float64)
    n = 3 * tile + 5
    idx = torch.zeros(n + 4, dtype=torch.int32)
    valid = torch.zeros(n + 16, dtype=torch.bool)
    flags = torch.zeros(n + 16, dtype=torch.bool)
    w = torch.zeros(n + 4)
    assert ks.spmm_tiles(n, 4, torch.float64, idx[:n], w[:n], valid[:n], flags[:n]) == (4, 3)
    assert ks.spmm_tiles(3 * tile, 4, torch.float64, idx, None, valid, flags) == (3, 3)
    assert ks.spmm_tiles(n, 4, torch.float64, idx[1:], None, valid[:n], flags[:n]) == (4, 0)
    assert ks.spmm_tiles(n, 4, torch.float64, idx[:n], w[1:], valid[:n], flags[:n]) == (4, 0)
    assert ks.spmm_tiles(n, 4, torch.float64, idx[:n], None, valid[1:], flags[:n]) == (4, 0)
    assert ks.spmm_tiles(5, 1, torch.float32, idx[:5], None, valid[:5], flags[:5]) == (1, 0)


def test_spmm_tile_base_counts_flags_before_each_block():
    g = torch.Generator().manual_seed(2)
    for n in (1, 255, 256, 257, 5 * ks.SPMM_GRANULE + 17):
        flags = torch.rand(n, generator=g) < 0.1
        base = ks.spmm_tile_base(flags)
        nb = -(-n // ks.SPMM_GRANULE)
        assert base.dtype == torch.int32 and base.shape == (nb + 1,)
        want = [int(flags[: b * ks.SPMM_GRANULE].sum()) for b in range(nb + 1)]
        assert base.tolist() == want


# ---- the row-selected product: C(M) << A.mxm(F) computes the rows M reaches --

MASK_KINDS = ["S", "V", "~S", "~V"]
MODES = ["plain", "replace", "accum", "accum_replace"]


def _row_mask(k, seed, rows=0.4):
    """(rows, cols, values) of a mask of k columns whose entries lie in a
    share ``rows`` of the rows, half the cells there, valued 0 or 2: its
    value form reaches fewer rows than its structure."""
    rng = np.random.default_rng(seed)
    on = (rng.random(N) < rows)[:, None] & (rng.random((N, k)) < 0.5)
    mr, mc = np.nonzero(on)
    return mr, mc, rng.integers(0, 2, mr.size).astype(np.float64) * 2


def _masked_statement(pkg, A, F, M, C, kind, mode, sr="plus_times"):
    """``C(mask, accum, replace) << A.mxm(F)`` in package ``pkg`` on a copy of C."""
    mask = {"S": M.S, "V": M.V, "~S": ~M.S, "~V": ~M.V}[kind]
    C = C.dup()
    accum = pkg.binary.plus if mode.startswith("accum") else None
    C(mask, accum=accum, replace=mode.endswith("replace")) << A.mxm(F, getattr(pkg.semiring, sr))
    return C


def _both(ref, coo_mask, k):
    """The mask collection (from COO) in the port and in the JAX package."""
    r, c, v = coo_mask
    return (
        Matrix.from_coo(r, c, v, gb.dtypes.FP64, nrows=N, ncols=k),
        ref.Matrix.from_coo(r, c, v, ref.dtypes.FP64, nrows=N, ncols=k),
    )


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_masked_product_matches_the_jax_package(ref, strategy, kind, mode, k):
    """Structure and value masks, plain and complemented, with and without
    replace and an accumulator: the statement over the row-selected product
    gives the JAX package's result on the same operands."""
    A, F, coo, frontier = _matrices("rmat", k, gb.dtypes.FP64, np.float64)
    RA, RF = _reference_operands(ref, coo, frontier, "FP64")
    M, RM = _both(ref, _row_mask(k, 7), k)
    C, RC = _both(ref, _row_mask(k, 8, rows=0.7), k)
    _same(_masked_statement(gb, A, F, M, C, kind, mode), _masked_statement(ref, RA, RF, RM, RC, kind, mode))


def _hub_row(coo):
    """The row of A with the most entries: the longest dst segment."""
    return int(np.argmax(np.bincount(coo[0], minlength=N)))


def _shape_mask(shape, k, coo):
    if shape == "nothing":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)
    rows = np.arange(N) if shape == "everything" else np.array([_hub_row(coo)])
    mr, mc = np.repeat(rows, k), np.tile(np.arange(k), rows.size)
    return mr, mc, np.ones(mr.size)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("shape", ["nothing", "everything", "hub"])
def test_masked_product_keeps_nothing_everything_or_a_hub_row(ref, strategy, shape, k):
    """A mask that reaches no row, every row, or the one row of the longest
    segment, under replace and without."""
    A, F, coo, frontier = _matrices("rmat", k, gb.dtypes.FP64, np.float64)
    RA, RF = _reference_operands(ref, coo, frontier, "FP64")
    M, RM = _both(ref, _shape_mask(shape, k, coo), k)
    C, RC = _both(ref, _row_mask(k, 9, rows=0.7), k)
    for mode in ("plain", "replace"):
        got = _masked_statement(gb, A, F, M, C, "S", mode, "plus_second")
        _same(got, _masked_statement(ref, RA, RF, RM, RC, "S", mode, "plus_second"))


def test_masked_product_counts_the_kept_slots(strategy):
    """The plan engine takes the mask (``ops.spmm_masked_products``) and
    streams the hub row's segment alone: its entries are the kept slots,
    the plan's slots the masked ones; the column-by-column product takes
    none."""
    A, F, coo, _ = _matrices("rmat", 4, gb.dtypes.FP64, np.float64)
    M = Matrix.from_coo(*_shape_mask("hub", 4, coo), gb.dtypes.FP64, nrows=N, ncols=4)
    telemetry.reset("ops.spmm")
    C = Matrix(gb.dtypes.FP64, N, 4)
    C(M.S) << A.mxm(F, semiring.plus_second)
    counters = telemetry.snapshot()["counters"]
    assert counters["ops.spmm_products"] == 1
    if strategy == "plan":
        plan = A._sparse.plan("pull", torch.device("cpu"))
        assert counters["ops.spmm_masked_products"] == 1
        assert counters["ops.spmm_kept_slots"] == int(np.bincount(coo[0], minlength=N)[_hub_row(coo)])
        assert counters["ops.spmm_masked_slots"] == plan.e_pad
    else:
        assert not any(counters.get(name, 0) for name in ("ops.spmm_masked_products", "ops.spmm_kept_slots"))


def _plan_and_frontier(k=4, seed=4):
    r, c, w = _pattern("rmat", seed=9)
    # two entries in row n - 1, whose segment also holds the plan's padding
    r, c, w = np.append(r, [N - 1, N - 1]), np.append(c, [0, 5]), np.append(w, np.float32([1, 2]))
    plan = fs.build_spmv_plan(c.astype(np.int32), r.astype(np.int32), w, n=N, device="cpu")
    vals, present = _frontier(k, np.float64, seed=seed)
    return plan, torch.from_numpy(vals), torch.from_numpy(present), r


@pytest.mark.parametrize("x_full", [False, True])
@pytest.mark.parametrize("add,mul", [("plus", "times"), ("min", "plus"), ("any", "pair")])
def test_row_selected_rows_outside_read_absent(x_full, add, mul):
    """The product with mask bits: the rows that no bit reaches read 0 and
    absent (a full x included, whose structure would otherwise be the
    plan's), every other row what the unmasked product gives."""
    plan, x, xs, _ = _plan_and_frontier()
    g = torch.Generator().manual_seed(3)
    keep = (torch.rand(N, generator=g) < 0.3)[:, None] & (torch.rand((N, 4), generator=g) < 0.5)
    if x_full:
        xs = torch.ones_like(xs)
    yv, ys = fs.spmm_masked(plan, x, xs, add, mul, x_full=x_full, keep=keep)
    fv, fss = fs.spmm_masked(plan, x, xs, add, mul, x_full=x_full)
    sel = keep.any(1)
    assert 0 < int(sel.sum()) < N
    assert not bool(ys[~sel].any()) and bool((yv[~sel] == 0).all())
    assert torch.equal(ys[sel], fss[sel]) and torch.equal(yv[sel], fv[sel])


def test_keep_plain_lists_the_kept_segments():
    """``spmm_keep_plain``: the kept segments in slot order, each trimmed of
    the plan's padding (row n - 1's invalid tail), their running counts, and
    the tile entries, against a walk over the segments here."""
    plan, x, _, r = _plan_and_frontier()
    seg_start, _ = fs._dst_reduce(plan)
    seg_vertex, _ = fs._spmm_index(plan, seg_start, x)
    rows = fs._spmm_rows(plan, seg_vertex)
    indeg = np.bincount(r, minlength=N)
    assert plan.e_pad > indeg.sum() and rows.pad_from == indeg.sum()  # the padding ends the slots
    g = torch.Generator().manual_seed(5)
    keep = (torch.rand(N, generator=g) < 0.4)[:, None] & (torch.rand((N, 4), generator=g) < 0.5)
    keep[N - 1] = True  # the row whose segment holds the padding
    tile = 32
    out = ks.spmm_keep_plain(keep, rows, tile)
    ipd = plan.indptr_dst.numpy()
    want_rows, want_start, want_cum, masked = [], [], [0], []
    for v in seg_vertex.tolist():
        n_slots = min(ipd[v + 1], rows.pad_from) - ipd[v]
        kept = bool(keep[v].any()) and n_slots > 0
        masked.append(v if kept else -1)
        if kept:
            want_rows.append(v)
            want_start.append(ipd[v])
            want_cum.append(want_cum[-1] + n_slots)
    assert out["kept_row"].tolist() == want_rows and out["kept_start"].tolist() == want_start
    assert out["kept_cum"].tolist() == want_cum and out["masked_rows"].tolist() == masked
    assert out["n_kept"] == len(want_rows) and out["kept_slots"] == want_cum[-1]
    assert want_rows[-1] == N - 1 and want_cum[-1] - want_cum[-2] == indeg[N - 1] == 2  # without its padding
    info = out["tile_info"].tolist()
    assert len(info) == -(-want_cum[-1] // tile) + 1 and info[-1] == 2 * len(want_rows) + 1
    for t, e in enumerate(info[:-1]):
        o = max(j for j in range(len(want_rows)) if want_cum[j] <= t * tile)
        assert e == (2 * o + 1 if want_cum[o] == t * tile else 2 * (o + 1)), t


def test_compiled_loop_carries_the_masked_backward_step(strategy):
    """The BC recipe's backward statement ``Y(at.V) << A.mxm(W)`` under a
    value mask, in a ``gb.loop_runner`` (eager on the CPU), gives what the
    statements give eagerly."""
    A, W0, _, _ = _matrices("rmat", 4, gb.dtypes.FP64, np.float64)
    levels = Matrix.from_coo(*_row_mask(4, 12, rows=0.6), gb.dtypes.FP64, nrows=N, ncols=4)

    def body(B, D):
        at = D.apply(binary.eq, right=2.0).new(gb.dtypes.BOOL)
        Y = Matrix(gb.dtypes.FP64, N, 4)
        Y(at.V) << A.mxm(B, semiring.plus_second)
        Bn = B.dup()
        Bn(accum=binary.plus) << Y
        return Bn, D

    runner = gb.loop_runner(3, body, W0.dup(), levels)
    Bc, _ = runner(W0.dup(), levels)
    B, D = W0.dup(), levels
    for _ in range(3):
        B, D = body(B, D)
    assert np.array_equal(_arrays(Bc)[1], _arrays(B)[1]) and np.array_equal(_arrays(Bc)[0], _arrays(B)[0])


# ---- CUDA half: the kernel against its plain version on the card -------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _kernel_inputs(seed, n_slots, k, dtype, xs_given, mul, n_src=1 << 14, n_out=1 << 14):
    """Slots in dst order over segments of mixed length (some a few tiles
    long), a fifth of them invalid, and x of k columns."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, 40, (n_out,), generator=g)
    lens[torch.randint(0, n_out, (8,), generator=g)] = torch.randint(5000, 30000, (8,), generator=g)
    lens[torch.rand(n_out, generator=g) < 0.3] = 0  # rows of no segment
    ends = torch.cumsum(lens, 0)
    keep = ends <= n_slots
    lens = torch.where(keep, lens, torch.zeros_like(lens))
    used = int(lens.sum())
    lens[-1] += n_slots - used  # the last row takes the rest (n_slots in all)
    seg_vertex = torch.nonzero(lens > 0).flatten().int()
    starts = torch.cumsum(lens, 0) - lens
    flags = torch.zeros(n_slots, dtype=torch.bool)
    flags[starts[lens > 0]] = True
    idx = torch.randint(0, n_src, (n_slots,), generator=g, dtype=torch.int32)
    valid = torch.rand(n_slots, generator=g) < 0.8
    w = (torch.randint(1, 9, (n_slots,), generator=g) / 4.0).float() if mul in ("times", "plus", "second") else None
    x = (torch.randn((n_src, k), generator=g, dtype=torch.float64) * 100).to(dtype)
    xs = torch.rand((n_src, k), generator=g) < 0.6 if xs_given else None
    return x, xs, idx, w, valid, flags, seg_vertex, n_out


def _tolerance(dtype, op):
    """min and max are exact; sums round in the kernel's tile order against
    the plain version's log-step order: 1e-12 relative in float64, 1e-6 in
    float32 (Kernel C's tolerance)."""
    if op != "add":
        return 0.0
    return 1e-12 if dtype == torch.float64 else 1e-6


def _against_plain(cuda, x, xs, idx, w, valid, flags, seg_vertex, n_out, op, mul):
    """The kernel against its plain version on the card; returns the share
    of the launch's tiles that took the staged (bulk-copied) stream."""
    dev = [None if t is None else t.to(cuda) for t in (x, xs, idx, w, valid, flags, seg_vertex)]
    want_v, want_s = ks.segscan_spmm_plain(*dev, n_out, op, mul)
    before = telemetry.counter("kernels.spmm.tiles"), telemetry.counter("kernels.spmm.async_tiles")
    got_v, got_s = ks.segscan_spmm(*dev, n_out, op, mul)
    torch.cuda.synchronize()
    assert torch.equal(got_s, want_s)
    tol = _tolerance(x.dtype, op)
    if tol:
        torch.testing.assert_close(got_v, want_v, rtol=tol, atol=tol * float(want_v.abs().max()))
    else:
        assert torch.equal(got_v, want_v)
    tiles = telemetry.counter("kernels.spmm.tiles") - before[0]
    return (telemetry.counter("kernels.spmm.async_tiles") - before[1]) / tiles


def _kernel_against_plain(cuda, seed, n_slots, k, dtype, op, mul, xs_given):
    x, xs, idx, w, valid, flags, seg_vertex, n_out = _kernel_inputs(seed, n_slots, k, dtype, xs_given, mul)
    return _against_plain(cuda, x, xs, idx, w, valid, flags, seg_vertex, n_out, op, mul)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op,mul", [("add", "first"), ("add", "times"), ("min", "plus"), ("max", "second"), ("add", "pair")])
@pytest.mark.parametrize("xs_given", [True, False])
@pytest.mark.parametrize("n_slots", [5, 4096 + 13])
def test_cuda_spmm_matches_plain(cuda, k, dtype, op, mul, xs_given, n_slots):
    _kernel_against_plain(cuda, k * 7 + n_slots % 97, n_slots, k, dtype, op, mul, xs_given)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op,mul", [("add", "first"), ("min", "plus")])
def test_cuda_spmm_matches_plain_long(cuda, k, dtype, op, mul):
    """2^20 slots: segments of up to 30000 slots cross many tiles' look-back."""
    _kernel_against_plain(cuda, k, (1 << 20) + 77, k, dtype, op, mul, True)


@pytest.mark.cuda
def test_cuda_spmm_unaligned_views(cuda):
    """Streams one slot into their storage on the card: no tile's stream
    arrives by bulk copy, the threads load every one."""
    x, xs, idx, w, valid, flags, _, _ = _kernel_inputs(3, (1 << 18) + 1, 4, torch.float64, True, "times")
    flags[1] = True
    cut = [t[1:] for t in (idx, w, valid, flags)]
    # each segment of the cut slots its own row
    nseg = int(cut[3].sum())
    rows = torch.arange(nseg, dtype=torch.int32)
    want_v, want_s = ks.segscan_spmm_plain(x, xs, cut[0], cut[1], cut[2], cut[3], rows, nseg, "add", "times")
    dev = [x.to(cuda), xs.to(cuda), *[t.to(cuda)[1:] for t in (idx, w, valid, flags)], rows.to(cuda)]
    assert all(t.data_ptr() % 16 for t in dev[2:6])
    before = telemetry.counter("kernels.spmm.tiles"), telemetry.counter("kernels.spmm.async_tiles")
    got_v, got_s = ks.segscan_spmm(*dev, nseg, "add", "times")
    torch.cuda.synchronize()
    assert telemetry.counter("kernels.spmm.tiles") > before[0]
    assert telemetry.counter("kernels.spmm.async_tiles") == before[1]  # no tile of an unaligned stream is staged
    assert torch.equal(got_s.cpu(), want_s)
    torch.testing.assert_close(got_v.cpu(), want_v, rtol=1e-12, atol=1e-12 * float(want_v.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_cuda_product_one_launch(cuda, sr):
    """On the card the DSL's product is one hand-kernel launch for k = 4,
    and matches the plain versions' run of the same statement."""
    from graphblas_tpu_torch import kernels

    with gb.tx.config.set(platform="cuda", mxv_strategy="plan"):
        r, c, w = _pattern("rmat")
        with gb.tx.config.set(dense_limit=4096):
            A = Matrix.from_coo(r, c, w, gb.dtypes.FP32, nrows=N, ncols=N)
        vals, present = _frontier(4, np.float64)
        fr, fc = np.nonzero(present)
        F = Matrix.from_coo(fr, fc, vals[fr, fc], gb.dtypes.FP64, nrows=N, ncols=4)
        A.mxm(F, getattr(semiring, sr)).new()  # the plan and its derived arrays
        before = telemetry.counter("ops.spmm_launches")
        Y = A.mxm(F, getattr(semiring, sr)).new()
        assert telemetry.counter("ops.spmm_launches") - before == 1
        with kernels.plain_versions():
            Yp = A.mxm(F, getattr(semiring, sr)).new()
        torch.cuda.synchronize()
        assert torch.equal(Y._struct, Yp._struct)
        assert torch.equal(Y._values, Yp._values)  # exact binary fractions: no rounding in any order


@pytest.mark.cuda
def test_cuda_product_in_a_graph_replay(cuda):
    """``gb.compile`` captures the product in a CUDA graph; two replays give
    the eager answer."""
    with gb.tx.config.set(platform="cuda", mxv_strategy="plan"):
        r, c, w = _pattern("uniform")
        with gb.tx.config.set(dense_limit=4096):
            A = Matrix.from_coo(r, c, w, gb.dtypes.FP32, nrows=N, ncols=N)

        @gb.compile
        def step(F):
            return A.mxm(F, semiring.plus_times).new()

        for seed in (5, 6):
            vals, present = _frontier(4, np.float64, seed=seed)
            fr, fc = np.nonzero(present)
            F = Matrix.from_coo(fr, fc, vals[fr, fc], gb.dtypes.FP64, nrows=N, ncols=4)
            got = step(F)
            want = A.mxm(F, semiring.plus_times).new()
            torch.cuda.synchronize()
            assert torch.equal(got._values, want._values) and torch.equal(got._struct, want._struct)


# ---- CUDA: the staged gather's edges ----------------------------------------


def _segments(lens, n_src, k, dtype, mul, seed, xs_kind="random"):
    """Inputs over segments of the given lengths (one a row, 0: no segment),
    a fifth of the slots invalid; x's structure random (60%), all absent,
    all present, or None."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.as_tensor(lens, dtype=torch.int64)
    n_slots = int(lens.sum())
    seg_vertex = torch.nonzero(lens > 0).flatten().int()
    flags = torch.zeros(n_slots, dtype=torch.bool)
    flags[(torch.cumsum(lens, 0) - lens)[lens > 0]] = True
    idx = torch.randint(0, n_src, (n_slots,), generator=g, dtype=torch.int32)
    valid = torch.rand(n_slots, generator=g) < 0.8
    w = (torch.randint(1, 9, (n_slots,), generator=g) / 4.0).float() if mul in ("times", "plus", "second") else None
    x = (torch.randn((n_src, k), generator=g, dtype=torch.float64) * 100).to(dtype)
    xs = {
        "random": lambda: torch.rand((n_src, k), generator=g) < 0.6,
        "absent": lambda: torch.zeros((n_src, k), dtype=torch.bool),
        "present": lambda: torch.ones((n_src, k), dtype=torch.bool),
        "none": lambda: None,
    }[xs_kind]()
    return x, xs, idx, w, valid, flags, seg_vertex, lens.numel()


def _lens_for(n_slots, seed, n_out=4096):
    """Row lengths summing to n_slots: segments of 1-40 slots, three rows in
    ten without one."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, 40, (n_out,), generator=g)
    lens[torch.rand(n_out, generator=g) < 0.3] = 0
    lens = torch.where(torch.cumsum(lens, 0) <= n_slots, lens, torch.zeros_like(lens))
    lens[-1] += n_slots - int(lens.sum())
    return lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.float64, 4), (torch.float32, 1), (torch.float64, 8)])
@pytest.mark.parametrize("unit", ["block", "tile", "tiles"])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_cuda_spmm_slot_counts_at_the_edges(cuda, dtype, k, unit, delta):
    """Slot counts at one 256-slot block (one gather round of the block's
    threads), one tile and three tiles, and one either side: the ragged last
    tile is loaded by the threads, every full tile by bulk copy."""
    tile = ks.spmm_tile(k, dtype)
    n = {"block": ks.SPMM_GRANULE, "tile": tile, "tiles": 3 * tile}[unit] + delta
    x, xs, idx, w, valid, flags, sv, n_out = _segments(_lens_for(n, n), 1 << 12, k, dtype, "times", 7)
    share = _against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, "add", "times")
    assert share == (n // tile) / -(-n // tile)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op,mul", [("add", "first"), ("min", "plus"), ("max", "times")])
def test_cuda_spmm_one_segment_over_every_tile(cuda, dtype, op, mul):
    """One segment of 9 tiles and a bit: the look-back carries it through
    every tile to its one end."""
    n = 9 * ks.spmm_tile(4, dtype) + 3
    x, xs, idx, w, valid, flags, sv, n_out = _segments([0, 0, n, 0], 1 << 12, 4, dtype, mul, 3)
    assert _against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, op, mul) == 9 / 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_spmm_runs_of_empty_segments(cuda, dtype):
    """Rows of no segment in runs of hundreds between short segments, and a
    tile that holds only ends: the segment-row runs each tile reads cross
    long stretches of empty rows."""
    g = torch.Generator().manual_seed(5)
    lens = torch.randint(1, 4, (1 << 16,), generator=g)
    for start in range(0, 1 << 16, 1000):
        lens[start : start + 700] = 0
    x, xs, idx, w, valid, flags, sv, n_out = _segments(lens, 1 << 12, 4, dtype, "times", 5)
    assert int(flags.sum()) < n_out
    _against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, "add", "times")


@pytest.mark.cuda
@pytest.mark.parametrize("xs_kind", ["absent", "present", "none"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_cuda_spmm_x_all_absent_all_present_or_full(cuda, xs_kind, dtype, op):
    """Tiles in which x is all absent (no value is gathered), all present,
    or full (no structure round)."""
    n = 4 * ks.spmm_tile(4, dtype) + 77
    x, xs, idx, w, valid, flags, sv, n_out = _segments(_lens_for(n, 11), 1 << 12, 4, dtype, "plus", 13, xs_kind)
    _against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, op, "plus")


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_cuda_spmm_every_k(cuda, k, dtype, op):
    """Every k in both precisions and every op, over several tiles of each
    instance's own size, aligned: every full tile staged."""
    tile = ks.spmm_tile(k, dtype)
    n = 5 * tile + 19
    x, xs, idx, w, valid, flags, sv, n_out = _segments(_lens_for(n, k), 1 << 12, k, dtype, "times", 17 + k)
    assert _against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, op, "times") == 5 / 6


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_spmm_unaligned_x_and_structure(cuda, k, dtype):
    """x and its structure as views one row into their buffers: rows of
    x's structure start at any byte, and float rows at any 4 bytes (the
    narrowest value copies)."""
    n = 3 * ks.spmm_tile(k, dtype) + 1
    x, xs, idx, w, valid, flags, sv, n_out = _segments(_lens_for(n, 3), 1 << 12, k, dtype, "times", 23)
    x_buf = torch.cat([x[:1], x])
    xs_buf = torch.cat([xs[:1], xs])
    dev = torch.device("cuda")
    xv, xsv = x_buf.to(dev)[1:], xs_buf.to(dev)[1:]
    assert xsv.data_ptr() % 4 != 0 or k % 4 == 0
    _against_plain(cuda, xv, xsv, idx, w, valid, flags, sv, n_out, "add", "times")


@pytest.mark.cuda
def test_cuda_spmm_geometry(cuda):
    """The card's instances: the tile that the wrapper sizes its scratch for,
    shared memory within an SM's, at least one block resident, no spills."""
    for dtype in (torch.float32, torch.float64):
        for k in range(1, 9):
            geo = ks.spmm_geometry(k, dtype)
            assert geo["tile"] == ks.spmm_tile(k, dtype), (k, dtype)
            assert 0 < geo["smem"] <= 227 * 1024 and geo["blocks_per_sm"] >= 1, (k, dtype, geo)
    assert ks.spmm_geometry(4, torch.float64)["blocks_per_sm"] >= 2  # the bc cell's instance


@pytest.mark.cuda
def test_cuda_spmm_graph_replay(cuda):
    """The launch captured in a CUDA graph: replays over new x and new
    structure give the plain version's answer."""
    x, xs, idx, w, valid, flags, sv, n_out = _segments(_lens_for(1 << 16, 9), 1 << 12, 4, torch.float64, "times", 9)
    dev = [None if t is None else t.to(cuda) for t in (x, xs, idx, w, valid, flags, sv)]
    base = ks.spmm_tile_base(dev[5])
    ks.segscan_spmm(*dev, n_out, "add", "times", base)  # the library and the instance's attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_v, out_s = ks.segscan_spmm(*dev, n_out, "add", "times", base)
    g = torch.Generator(device=cuda).manual_seed(4)
    for _ in range(2):
        dev[0].copy_(torch.randn(dev[0].shape, generator=g, device=cuda, dtype=torch.float64))
        dev[1].copy_(torch.rand(dev[1].shape, generator=g, device=cuda) < 0.5)
        graph.replay()
        want_v, want_s = ks.segscan_spmm_plain(*dev, n_out, "add", "times")
        torch.cuda.synchronize()
        assert torch.equal(out_s, want_s)
        torch.testing.assert_close(out_v, want_v, rtol=1e-12, atol=1e-12 * float(want_v.abs().max()))


# ---- CUDA: the row-selected product -------------------------------------------


def _keep_bits(n_out, k, rows_kept, lens, seed):
    """Mask bits of n_out x k over rows with segments of ``lens``: none, all,
    the longest segment's row, a share of the rows (one cell of each at
    least), or one row in a hundred."""
    g = torch.Generator().manual_seed(seed)
    keep = torch.zeros((n_out, k), dtype=torch.bool)
    if rows_kept == "all":
        keep[:] = True
    elif rows_kept == "hub":
        keep[int(torch.argmax(lens)), k - 1] = True
    elif rows_kept != "none":
        share = {"most": 0.9, "some": 0.3, "few": 0.01}[rows_kept]
        pick = torch.rand(n_out, generator=g) < share
        keep[pick, torch.randint(0, k, (int(pick.sum()),), generator=g)] = True
    return keep


def _row_selected_against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, op, mul, keep):
    """The kernel with the mask bits against the plain version, and its list
    (``segscan_spmm_keep``'s outputs) against the plain list."""
    dev = [None if t is None else t.to(cuda) for t in (x, xs, idx, w, valid, flags, sv)]
    kd = keep.to(cuda)
    rows = ks.SpmmRows.of(dev[5], dev[6], dev[4], n_out)
    want_v, want_s = ks.segscan_spmm_plain(*dev, n_out, op, mul, keep=kd)
    before = telemetry.counter("kernels.launches.segscan_spmm_keep")
    got_v, got_s = ks.segscan_spmm(*dev, n_out, op, mul, keep=kd, rows=rows)
    torch.cuda.synchronize()
    assert telemetry.counter("kernels.launches.segscan_spmm_keep") == before + 1
    assert torch.equal(got_s, want_s)
    tol = _tolerance(x.dtype, op)
    if tol:
        torch.testing.assert_close(got_v, want_v, rtol=tol, atol=tol * float(want_v.abs().max().clamp(min=1)))
    else:
        assert torch.equal(got_v, want_v)
    lists = ks.spmm_keep_plain(kd, rows, ks.spmm_tile(x.shape[1], x.dtype))
    sc, nk, total = rows.scratch, lists["n_kept"], lists["kept_slots"]
    assert sc["ctl"].view(torch.int32)[:2].tolist() == [nk, total]
    for name, size in (("kept_row", nk), ("kept_start", nk), ("kept_cum", nk + 1), ("masked_rows", sv.numel()),
                       ("tile_info", lists["tile_info"].numel())):
        assert torch.equal(sc[name][:size], lists[name].to(sc[name])), name
    return total / valid.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("rows_kept", ["none", "all", "most", "some", "few", "hub"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_cuda_row_selected_matches_plain(cuda, k, dtype, rows_kept):
    """Masks that reach no row, every row, 90% (the whole plan streamed, the
    other rows left unwritten), 30% and 1% of the rows (the kept slots
    alone), or the row of the longest segment (one segment over many kept
    tiles), over segments of mixed length and a fifth of the slots invalid."""
    x, xs, idx, w, valid, flags, sv, n_out = _kernel_inputs(k + 40, (1 << 18) + 77, k, dtype, True, "times")
    lens = torch.zeros(n_out, dtype=torch.int64)
    starts = torch.nonzero(flags).flatten()
    lens[sv.long()] = torch.diff(torch.cat([starts, torch.tensor([flags.numel()])]))
    keep = _keep_bits(n_out, k, rows_kept, lens, seed=k)
    share = _row_selected_against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, "add", "times", keep)
    assert (share == 0) == (rows_kept == "none")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op,mul", [("add", "first"), ("min", "plus"), ("max", "second"), ("add", "pair")])
@pytest.mark.parametrize("xs_kind", ["random", "none"])
def test_cuda_row_selected_ops_and_full_x(cuda, dtype, op, mul, xs_kind):
    """Every op and multiply, x's structure given or x full, at 30% of the
    rows; and a segment over every tile kept alone."""
    n = 6 * ks.spmm_tile(4, dtype) + 11
    lens = _lens_for(n, 21)
    x, xs, idx, w, valid, flags, sv, n_out = _segments(lens, 1 << 12, 4, dtype, mul, 21, xs_kind)
    keep = _keep_bits(n_out, 4, "some", lens, seed=2)
    _row_selected_against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, op, mul, keep)
    one = [0, 0, 9 * ks.spmm_tile(4, dtype) + 3, 0]
    x, xs, idx, w, valid, flags, sv, n_out = _segments(one, 1 << 12, 4, dtype, mul, 3, xs_kind)
    keep = _keep_bits(n_out, 4, "hub", torch.tensor(one), seed=1)
    _row_selected_against_plain(cuda, x, xs, idx, w, valid, flags, sv, n_out, op, mul, keep)


@pytest.mark.cuda
def test_cuda_row_selected_graph_replay(cuda):
    """The mask's launch and the product captured in a CUDA graph: replays
    over new mask bits and new x give the plain version's answer."""
    lens = _lens_for(1 << 16, 9)
    x, xs, idx, w, valid, flags, sv, n_out = _segments(lens, 1 << 12, 4, torch.float64, "times", 9)
    dev = [None if t is None else t.to(cuda) for t in (x, xs, idx, w, valid, flags, sv)]
    keep = _keep_bits(n_out, 4, "some", lens, seed=3).to(cuda)
    rows = ks.SpmmRows.of(dev[5], dev[6], dev[4], n_out)
    base = ks.spmm_tile_base(dev[5])
    ks.segscan_spmm(*dev, n_out, "add", "times", base, keep=keep, rows=rows)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_v, out_s = ks.segscan_spmm(*dev, n_out, "add", "times", base, keep=keep, rows=rows)
    g = torch.Generator(device=cuda).manual_seed(4)
    for share in (0.05, 0.5, 0.95):
        dev[0].copy_(torch.randn(dev[0].shape, generator=g, device=cuda, dtype=torch.float64))
        keep.copy_(torch.rand(keep.shape, generator=g, device=cuda) < share / 4)
        graph.replay()
        want_v, want_s = ks.segscan_spmm_plain(*dev, n_out, "add", "times", keep=keep)
        torch.cuda.synchronize()
        assert torch.equal(out_s, want_s), share
        torch.testing.assert_close(out_v, want_v, rtol=1e-12, atol=1e-12 * float(want_v.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_cuda_masked_statement_matches_plain_versions(cuda, kind):
    """On the card ``C(M) << A.mxm(F)`` is two hand-kernel launches (the
    mask's list, then the product) and gives the plain versions' result;
    the kept slots are counted on the card."""
    from graphblas_tpu_torch import kernels

    with gb.tx.config.set(platform="cuda", mxv_strategy="plan"):
        r, c, w = _pattern("rmat")
        with gb.tx.config.set(dense_limit=4096):
            A = Matrix.from_coo(r, c, w, gb.dtypes.FP32, nrows=N, ncols=N)
        vals, present = _frontier(4, np.float64)
        fr, fc = np.nonzero(present)
        F = Matrix.from_coo(fr, fc, vals[fr, fc], gb.dtypes.FP64, nrows=N, ncols=4)
        M = Matrix.from_coo(*_row_mask(4, 7), gb.dtypes.FP64, nrows=N, ncols=4)
        C = Matrix.from_coo(*_row_mask(4, 8, rows=0.7), gb.dtypes.FP64, nrows=N, ncols=4)
        _masked_statement(gb, A, F, M, C, kind, "replace")  # the plan and its derived arrays
        telemetry.reset("ops.spmm")
        got = _masked_statement(gb, A, F, M, C, kind, "replace")
        counters = telemetry.snapshot()["counters"]
        assert counters["ops.spmm_launches"] == 2 and counters["ops.spmm_masked_products"] == 1
        assert 0 < counters["ops.spmm_kept_slots"] < counters["ops.spmm_masked_slots"]
        with kernels.plain_versions():
            want = _masked_statement(gb, A, F, M, C, kind, "replace")
        torch.cuda.synchronize()
        assert torch.equal(got._struct, want._struct) and torch.equal(got._values, want._values)

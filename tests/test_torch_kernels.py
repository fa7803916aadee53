"""Parity of the port's kernel layer with the JAX package's Pallas kernels.

CPU half: each plain PyTorch version (taken by the wrappers for CPU tensors)
against the JAX function on the same numpy inputs, the Pallas kernels run in
interpret mode as the JAX package's own tests run them.  CUDA half (marked
``cuda``): each hand-written kernel against its plain version on the card.
The JAX package is imported by the ``ref`` fixture, not at import time, so
the CUDA half also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: min, max, fill, gathers and all integer scans are bit-exact;
C with x's gather fused equals C on ``x[idx]`` bit for bit on the card,
float add included.  A
float add scan rounds in another order in each implementation (the TPU
kernel's lane/row tree, the plain log-step scan, the CUDA thread/warp tree),
so float add compares within rtol 1e-6 on positive inputs.  eqjoin is exact
but for float plus and times accumulations of values (each implementation
sums or multiplies the matches in its own order: rtol 1e-5); the tropical
matmul and the compare probe are bit-exact.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from graphblas_tpu_torch import kernels
from graphblas_tpu_torch.kernels import eqjoin as ke
from graphblas_tpu_torch.kernels import gather as kg
from graphblas_tpu_torch.kernels import segscan as ks
from graphblas_tpu_torch.kernels import tropical as kt
from graphblas_tpu_torch.ops import eqjoin as te
from graphblas_tpu_torch.ops import mxm as tm
from graphblas_tpu_torch.ops import permute as tp
from graphblas_tpu_torch.ops import scan as ts

N = 128 * 16  # one JAX tile; the plain scan has no tiles to carry between
DTYPES = {"f32": np.float32, "i32": np.int32, "i16": np.int16, "i8": np.int8, "u8": np.uint8}


def _inputs(seed, dt, n=N, positive=False):
    rng = np.random.default_rng(seed)
    if dt == "f32":
        x = (rng.random(n) if positive else rng.standard_normal(n)).astype(np.float32)
        w = (rng.random(n) * 9 + 1).astype(np.float32)
    elif dt == "i32":
        x = rng.integers(-300, 300, n).astype(np.int32)
        w = rng.integers(-300, 300, n).astype(np.int32)
    else:
        x = rng.integers(-20, 20, n).astype(np.int8)
        w = rng.integers(-5, 6, n).astype(np.int8)
    valid = rng.random(n) < 0.8
    flags = rng.random(n) < 0.125
    flags[:7] = False  # a prefix before the first segment start
    return x, w, valid, flags


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernels (the reference of the CPU half)."""
    jnp = pytest.importorskip("jax.numpy")
    from graphblas_tpu.ops import pallas_eqjoin, pallas_mxm, pallas_scan, permute

    return SimpleNamespace(jnp=jnp, scan=pallas_scan, perm=permute, eqjoin=pallas_eqjoin, mxm=pallas_mxm)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_equal(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want))


# ---- fill (Kernel G, epilogue "fill") -------------------------------------


@pytest.mark.parametrize("dt", ["f32", "i32"])
def test_fill_static_matches_reference(ref, dt):
    jnp = ref.jnp
    x, _, _, flags = _inputs(1, dt)
    j, hp = ref.scan.build_fill_tables(flags)
    want = ref.scan.segmented_fill_static(jnp.asarray(x), jnp.asarray(j), jnp.asarray(hp), interpret=True)
    fill_src = ts.build_fill_tables(flags)
    got = ts.segmented_fill_static(_t(x), _t(fill_src))
    _assert_equal(got, want)
    assert (fill_src[:7] == -1).all()  # "0 before the first flag"
    assert (got[:7] == 0).all()


# ---- generic scan ---------------------------------------------------------


def _scan_inputs(seed, dt, n):
    rng = np.random.default_rng(seed)
    if dt == "f32":
        v = rng.random(n).astype(np.float32)  # positive: float add compares by rtol
    elif dt == "i32":
        v = rng.integers(-(2**30), 2**30, n).astype(np.int32)  # sums wrap at 32 bits
    else:
        info = np.iinfo(DTYPES[dt])
        v = rng.integers(info.min, int(info.max) + 1, n).astype(DTYPES[dt])
    flags = rng.random(n) < 0.125
    flags[:7] = False  # a prefix before the first segment start
    return v, flags


def _check_scan(got, want, dt, op):
    assert got.dtype == torch.from_numpy(np.zeros(1, DTYPES[dt])).dtype
    if dt == "f32" and op == "add":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    else:
        _assert_equal(got, want)


@pytest.mark.parametrize("op", ["fill", "add", "min", "max"])
@pytest.mark.parametrize("dt", ["f32", "i32", "i16", "i8", "u8"])
def test_segmented_scan_matches_reference(ref, dt, op):
    v, flags = _scan_inputs(11, dt, N)
    want = ref.scan.segmented_scan(ref.jnp.asarray(v), ref.jnp.asarray(flags), op, interpret=True)
    got = ts.segmented_scan(_t(v), _t(flags), op)
    _check_scan(got, want, dt, op)
    if op == "fill":
        assert (got[:7] == 0).all()  # "0 before the first flag"


@pytest.mark.parametrize("dt,op", [("f32", "fill"), ("f32", "add"), ("i8", "add"), ("f32", "min")])
def test_segmented_scan_across_reference_tiles(ref, dt, op):
    """Two full 1024-row reference tiles and a ragged third, so the reference
    carries across tiles and pads its last one."""
    v, flags = _scan_inputs(12, dt, 128 * (2 * 1024 + 5))
    want = ref.scan.segmented_scan(ref.jnp.asarray(v), ref.jnp.asarray(flags), op, interpret=True)
    _check_scan(ts.segmented_scan(_t(v), _t(flags), op), want, dt, op)


@pytest.mark.parametrize("op", ["fill", "add", "max"])
@pytest.mark.parametrize("n", [128, 2048, 128 * 3])
def test_segmented_scan_without_a_flag(ref, n, op):
    """No flag at all: a fill reads 0 everywhere, the last slot of a
    power-of-two length included (the plain log-step scan once read slot 0's
    value there); add and max run over the whole array."""
    v, _ = _scan_inputs(14, "f32", n)
    flags = np.zeros(n, bool)
    want = ref.scan.segmented_scan(ref.jnp.asarray(v), ref.jnp.asarray(flags), op, interpret=True)
    got = ts.segmented_scan(_t(v), _t(flags), op)
    _check_scan(got, want, "f32", op)
    if op == "fill":
        assert not got.any()


def test_segmented_scan_rejects_what_it_does_not_take():
    v, flags = _scan_inputs(13, "f32", N)
    with pytest.raises(ValueError, match="multiple of 128"):
        ts.segmented_scan(_t(v[:100]), _t(flags[:100]), "add")
    with pytest.raises(TypeError):
        ts.segmented_scan(_t(v.astype(np.float64)), _t(flags), "add")
    with pytest.raises(ValueError):
        ts.segmented_scan(_t(v), _t(flags), "mul")
    with pytest.raises(ValueError):
        ts.segmented_scan(_t(v), _t(flags.astype(np.int8)), "add")


# ---- contrib scan (Kernel C) ----------------------------------------------

CONTRIB_CASES = (
    [(dt, op, mul, True, None) for dt in ("f32", "i32") for op in ks.OPS for mul in ks.MULS]
    + [("f32", op, "first", False, None) for op in ks.OPS]
    + [("i32", "add", "times", False, None)]
    + [("i32", op, "times", True, (8, True)) for op in ("add", "max")]
    + [("i32", op, "plus", True, (16, False)) for op in ("add", "min")]
    + [("i8", op, "times", True, None) for op in ("add", "min")]
)


@pytest.mark.parametrize("dt,op,mul,has_w,wrap", CONTRIB_CASES)
def test_scan_contrib_matches_reference(ref, dt, op, mul, has_w, wrap):
    jnp = ref.jnp
    x, w, valid, flags = _inputs(2, dt, positive=True)
    # the jitted entry point traces ``wrap``; its callers reach it inside an
    # outer trace with ``wrap`` static, so call the function under the jit
    fn = ref.scan.segmented_scan_contrib
    want = (fn.__wrapped__ if wrap else fn)(
        jnp.asarray(x), jnp.asarray(w) if has_w else None, jnp.asarray(valid), jnp.asarray(flags),
        op, mul, interpret=True, wrap=wrap,
    )
    got = ts.segmented_scan_contrib(_t(x), _t(w) if has_w else None, _t(valid), _t(flags), op, mul, wrap)
    assert got.dtype == torch.from_numpy(np.zeros(1, DTYPES[dt])).dtype
    if dt == "f32" and op == "add":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    else:
        _assert_equal(got, want)


def _look_back_model(op, v, f, tile, seed, window=4):
    """Kernel C's single pass, modelled in Python: tiles of ``tile`` slots
    run in a seeded random order of steps; a tile first publishes its
    aggregate, then looks back over up to ``window`` predecessors at a time,
    blocked while one of them up to the nearest stop has published nothing.
    It stops at an inclusive prefix or at an aggregate whose flag is set;
    then it scans its own slots from that prefix and publishes its own."""
    combine = {
        "add": lambda a, b: a + b, "min": min, "max": max, "fill": lambda a, b: a,
    }[op]
    ident = ks._ident(op, v.dtype)

    def join(a, b):  # b later; a set flag in b starts a segment
        return (b[0] if b[1] else combine(a[0], b[0]), a[1] or b[1])

    vals, flags = v.tolist(), f.tolist()
    nt = -(-len(vals) // tile)
    aggs = []
    for t in range(nt):
        acc = (ident, False)
        for i in range(t * tile, min((t + 1) * tile, len(vals))):
            acc = join(acc, (vals[i], flags[i]))
        aggs.append(acc)
    desc = [None] * nt  # None, ("A", (v, f)) or ("P", (v, f))
    out = [None] * len(vals)
    rng = np.random.default_rng(seed)
    pending = list(range(nt))
    waits = 0
    while pending:
        t = pending[rng.integers(len(pending))]
        if desc[t] is None:
            desc[t] = ("P" if t == 0 else "A", aggs[t])
            if t > 0:
                continue
        if t > 0:
            run, end, blocked = (ident, False), t, False
            while True:
                win = [desc[j] if j >= 0 else ("P", (ident, False)) for j in range(end - 1, end - 1 - window, -1)]
                stop = next((k for k, d in enumerate(win) if d and (d[0] == "P" or d[1][1])), None)
                upto = win if stop is None else win[: stop + 1]
                if any(d is None for d in upto):
                    blocked = True
                    break
                for d in upto:  # nearest first, so each is earlier than ``run``
                    run = join(d[1], run)
                if stop is not None:
                    break
                end -= window
            if blocked:
                waits += 1
                continue
        else:
            run = (ident, False)
        acc = run
        for i in range(t * tile, min((t + 1) * tile, len(vals))):
            acc = join(acc, (vals[i], flags[i]))
            out[i] = acc[0]
        desc[t] = ("P", join(run, aggs[t]))
        pending.remove(t)
    return torch.tensor(out, dtype=v.dtype), waits


LOOK_BACK_CASES = [
    pytest.param(op, kind, None, id=f"{kind}-{op}")
    for kind in ("random", "none", "tile_starts", "sparse")
    for op in ("add", "min", "max", "fill")
] + [
    pytest.param(op, kind, dt, id=f"{kind}-{op}-{dt}")
    for dt in ("i8", "i16")
    for kind in ("random", "none")
    for op in ("add", "min", "max", "fill")
]


@pytest.mark.parametrize("op,flags_kind,dt", LOOK_BACK_CASES)
def test_look_back_model_matches_plain_scan(op, flags_kind, dt):
    """The rule Kernel C and the generic scan rely on: a look-back that stops
    at an inclusive prefix or a flagged aggregate, with tiles finishing in
    any order, gives the inclusive segmented scan.  The int8 / int16 cases
    are the generic scan's: values over the whole narrow range, scanned
    exactly and truncated to the narrow type on store, against the plain
    version, which computes in int32 and truncates (add wraps)."""
    rng = np.random.default_rng(40)
    n, tile = 517, 8
    if dt is None:
        v = torch.from_numpy(rng.integers(-50, 50, n))
    else:
        info = np.iinfo(DTYPES[dt])
        v = torch.from_numpy(rng.integers(info.min, int(info.max) + 1, n))
    f = {
        "random": rng.random(n) < 0.2,
        "none": np.zeros(n, bool),
        "tile_starts": np.arange(n) % tile == 0,
        "sparse": rng.random(n) < 0.01,
    }[flags_kind]
    got, waits = _look_back_model(op, v, torch.from_numpy(f), tile, seed=41)
    assert waits > 0  # some look-backs found a predecessor with nothing published
    if dt is None:
        assert torch.equal(got, ks._scan_plain(op, v, torch.from_numpy(f)))
    else:  # segscan_plain's arithmetic (n here is no multiple of 128, which it requires)
        narrow = v.to(_t(np.zeros(1, DTYPES[dt])).dtype)
        want = ks._scan_plain(op, narrow.to(torch.int32), torch.from_numpy(f)).to(narrow.dtype)
        assert torch.equal(got.to(narrow.dtype), want)
        if op == "add" and flags_kind == "none":
            assert got.abs().max() > np.iinfo(DTYPES[dt]).max  # the exact sums leave the range: wraps on store


def _state_model(mode, x, w, valid, flags, is_last, state, depth, fr_reduce, tile, seed):
    """Kernel S on the single pass, modelled: the prologue (x + w rounded once
    in float32, the identity at invalid slots), the look-back model's scan,
    then the store on each tile's slots; with ``fr_reduce`` each tile ORs its
    changes and the flag is raised if any tile's OR is set."""
    op = "max" if mode == "bfs" else "min"
    c = x if w is None else (x + w).astype(np.float32)
    c = np.where(valid, c, np.float32(ks._ident(op, torch.float32))).astype(np.float32)
    scanned, waits = _look_back_model(op, torch.from_numpy(c), torch.from_numpy(flags), tile, seed)
    v = scanned.numpy()
    new = np.empty_like(state)
    fr = np.zeros(len(v), np.float32)
    raised = False
    for t in range(-(-len(v) // tile)):
        sl = slice(t * tile, (t + 1) * tile)
        if mode == "bfs":
            nxt = is_last[sl] & (v[sl] > 0) & (state[sl] < 0)
            new[sl] = np.where(nxt, depth + 1, state[sl])
            fr[sl] = nxt
        else:
            new[sl] = np.where(is_last[sl], np.minimum(state[sl], v[sl]), ts.STATE_BIG)
            fr[sl] = new[sl] < state[sl]
            raised |= bool(fr[sl].any())
    return new, (np.array([int(raised)], np.int32) if fr_reduce else fr), waits


@pytest.mark.parametrize("flags_kind", ["random", "none"])
@pytest.mark.parametrize("mode,fr_reduce", [("bfs", False), ("sssp", False), ("sssp", True)])
def test_state_model_matches_plain(mode, fr_reduce, flags_kind):
    """S's single pass with its epilogue, tiles finishing in any order,
    against segscan_state_plain, with flags at random and with none (one
    segment: every look-back walks to tile 0)."""
    x, w, valid, flags, is_last, state = _state_inputs(mode, seed=44, n=517)
    if flags_kind == "none":
        flags[:] = False
        is_last[:] = False
        is_last[-1] = True
    new, fr, waits = _state_model(mode, x, w, valid, flags, is_last, state, 2, fr_reduce, tile=8, seed=45)
    assert waits > 0
    want_st, want_fr = ks.segscan_state_plain(
        mode, _t(x), None if w is None else _t(w), _t(valid), _t(flags), _t(is_last), _t(state), 2, fr_reduce
    )
    _assert_equal(want_st, new)
    _assert_equal(want_fr, fr)
    assert want_fr.any()  # the round changes something


# ---- NaN and signed zeros through the min / max scans ----------------------

NAN_CASES = [
    ("contrib", "min"), ("contrib", "max"), ("state", "bfs"), ("state", "sssp"), ("state", "sssp_fr"),
    ("segscan", "min"), ("segscan", "max"),
]


def _nan_inputs(kind, how, n, seed):
    """Inputs of one scan with NaN at a flagged slot, mid-segment, at a
    thread's first slot (a multiple of 8) and at a tile's first slot (a
    multiple of 2048), every one valid, and +-0.0 among the values, the
    weights and SSSP's distances.  Returns the call's arguments."""
    rng = np.random.default_rng(seed)
    x = (rng.random(n) * 10).astype(np.float32)
    x[rng.random(n) < 0.05] = 0.0
    x[rng.random(n) < 0.05] = -0.0
    flags = rng.random(n) < 1 / 16
    valid = rng.random(n) < 0.9
    flagged = np.flatnonzero(flags[100:]) + 100
    mid = next(i for i in range(300, n) if not flags[i - 1] and not flags[i] and not flags[i + 1])
    nan_at = [flagged[0], mid, 8 * 37 + 1024, 2048]
    flags[[8 * 37 + 1024, 2048]] = False  # NaN arrives mid-segment at a thread's and a tile's first slot
    x[nan_at] = np.nan
    valid[nan_at] = True
    if kind == "segscan":
        return (_t(x), _t(flags), how)
    w = (rng.random(n) * 3).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0
    w[rng.random(n) < 0.1] = -0.0
    if kind == "contrib":
        return (_t(x), _t(w), _t(valid), _t(flags), how, "plus" if how == "min" else "times")
    mode = "bfs" if how == "bfs" else "sssp"
    is_last = np.zeros(n, bool)
    is_last[np.flatnonzero(flags) - 1] = True
    is_last[-1] = True
    if mode == "bfs":
        x = np.where(np.isnan(x), x, (x > 5).astype(np.float32)).astype(np.float32)
        state = np.where(rng.random(n) < 0.7, -1, rng.integers(0, 4, n)).astype(np.int32)
        w = None
    else:
        state = np.where(rng.random(n) < 0.3, ts.STATE_BIG, rng.random(n) * 25).astype(np.float32)
        state[rng.random(n) < 0.05] = 0.0
        state[rng.random(n) < 0.05] = -0.0
        state[np.flatnonzero(is_last)[5]] = np.nan  # a NaN distance at a last slot
    return (mode, _t(x), None if w is None else _t(w), _t(valid), _t(flags), _t(is_last), _t(state), 2, how == "sssp_fr")


def _nan_call(kind, args, plain=False):
    """The port's scan ``kind`` on ``args``: the wrapper, or its plain version."""
    fn = {
        "contrib": (ks.segscan_contrib, ks.segscan_contrib_plain),
        "state": (ks.segscan_state, ks.segscan_state_plain),
        "segscan": (ks.segscan, ks.segscan_plain),
    }[kind][plain]
    out = fn(*args)
    return out if isinstance(out, tuple) else (out,)


def _assert_nan_and_zero_bits(got, want):
    """Equal, NaN where the other has NaN, and the signed zeros bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == np.float32:
        _assert_same_bits(got, want)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,how", NAN_CASES)
def test_scans_propagate_nan_as_the_reference(ref, kind, how):
    """The same NaN and signed-zero inputs through the reference (Pallas in
    interpret mode) and the port's plain versions: min / max propagate NaN
    and put -0.0 below +0.0, as jnp.minimum / jnp.maximum do."""
    jnp = ref.jnp
    args = _nan_inputs(kind, how, 4096, seed=46)

    def j(a):
        return None if a is None else jnp.asarray(a.numpy())

    if kind == "segscan":
        want = (ref.scan.segmented_scan(j(args[0]), j(args[1]), how, interpret=True),)
    elif kind == "contrib":
        want = (ref.scan.segmented_scan_contrib.__wrapped__(*map(j, args[:4]), *args[4:], interpret=True),)
    else:
        mode, *arrays, depth, fr = args
        want = ref.scan.segmented_scan_state(mode, *map(j, arrays), depth, interpret=True, fr_reduce=fr)
    got = _nan_call(kind, args)
    if kind == "state" and args[-1]:  # fr_reduce: one flag against the reference's per-block maxima
        _assert_nan_and_zero_bits(got[0], want[0])
        assert int(got[1][0]) == int(np.asarray(want[1]).max() > 0)
    else:
        for g, w_ in zip(got, want):
            _assert_nan_and_zero_bits(g, w_)
    out = np.asarray(got[0])
    if out.dtype == np.float32:
        assert np.isnan(out).any() and (np.signbit(out) & (out == 0)).any()


def test_scan_contrib_rejects_what_it_does_not_take():
    x, w, valid, flags = _inputs(3, "f32")
    with pytest.raises(ValueError):
        ts.segmented_scan_contrib(_t(x), _t(w), _t(valid), _t(flags), "add", "times", (8, True))
    with pytest.raises(ValueError):
        ts.segmented_scan_contrib(_t(x), _t(w), _t(valid), _t(flags), "mul", "times")
    with pytest.raises(TypeError):
        ts.segmented_scan_contrib(_t(x), _t(w.astype(np.int32)), _t(valid), _t(flags), "add", "times")


# ---- contrib scan with x's gather fused ------------------------------------


def _gather_inputs(seed, dt, n=N, nx=97):
    """C's inputs with the values drawn as ``x[idx]``: x of ``nx`` slots, an
    int32 index of ``n``."""
    _, w, valid, flags = _inputs(seed, dt, n=n, positive=True)
    x = _inputs(seed + 1, dt, n=nx, positive=True)[0]
    idx = np.random.default_rng(seed).integers(0, nx, n).astype(np.int32)
    return x, idx, w, valid, flags


@pytest.mark.parametrize("dt,op,mul,has_w,wrap", CONTRIB_CASES)
def test_scan_contrib_gather_is_the_contrib_scan_of_the_gather(ref, dt, op, mul, has_w, wrap):
    """The plain version equals C's plain version on ``x[idx]`` exactly, and
    the reference's contrib scan on ``x[idx]`` (float add within rtol 1e-6)."""
    jnp = ref.jnp
    x, idx, w, valid, flags = _gather_inputs(5, dt)
    wt = _t(w) if has_w else None
    kernels.reset_counts()
    got = ts.segmented_scan_contrib_gather(_t(x), _t(idx), wt, _t(valid), _t(flags), op, mul, wrap)
    assert kernels.plain_counts()["segscan_contrib_gather"] == 1 and kernels.plain_counts()["segscan_contrib"] == 0
    assert torch.equal(got, ts.segmented_scan_contrib(_t(x[idx]), wt, _t(valid), _t(flags), op, mul, wrap))
    fn = ref.scan.segmented_scan_contrib
    want = (fn.__wrapped__ if wrap else fn)(
        jnp.asarray(x[idx]), jnp.asarray(w) if has_w else None, jnp.asarray(valid), jnp.asarray(flags),
        op, mul, interpret=True, wrap=wrap,
    )
    if dt == "f32" and op == "add":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    else:
        _assert_equal(got, want)


def test_scan_contrib_gather_rejects_what_it_does_not_take():
    x, idx, w, valid, flags = _gather_inputs(3, "f32")
    with pytest.raises(TypeError):
        ts.segmented_scan_contrib_gather(_t(x), _t(idx.astype(np.int64)), _t(w), _t(valid), _t(flags), "add", "times")
    with pytest.raises(ValueError):
        ts.segmented_scan_contrib_gather(_t(x), _t(idx), _t(w), _t(valid[1:]), _t(flags), "add", "times")
    with pytest.raises(ValueError):
        ts.segmented_scan_contrib_gather(_t(x).reshape(-1, 1), _t(idx), _t(w), _t(valid), _t(flags), "add", "times")
    with pytest.raises(TypeError):
        ts.segmented_scan_contrib_gather(_t(x), _t(idx), _t(w.astype(np.int32)), _t(valid), _t(flags), "add", "times")
    with pytest.raises(ValueError):
        ts.segmented_scan_contrib_gather(_t(x), _t(idx), _t(w), _t(valid), _t(flags), "add", "times", (8, True))


@pytest.mark.parametrize("bad", [-98, 97], ids=["below", "past_x"])
def test_scan_contrib_gather_plain_raises_outside_x(bad):
    """An index outside x raises in the plain version (the card's kernel
    reads x[idx] unchecked: its callers keep idx inside x)."""
    x, idx, w, valid, flags = _gather_inputs(3, "f32")
    idx[7] = bad
    with pytest.raises(IndexError):
        ts.segmented_scan_contrib_gather(_t(x), _t(idx), _t(w), _t(valid), _t(flags), "add", "times")


# ---- state scan (Kernel S) ------------------------------------------------


def _state_inputs(mode, seed=4, n=N):
    rng = np.random.default_rng(seed)
    _, w, valid, flags = _inputs(seed, "f32", n=n)
    is_last = np.zeros(n, bool)
    is_last[np.flatnonzero(flags) - 1] = True
    is_last[-1] = True
    if mode == "bfs":
        x = (rng.random(n) < 0.1).astype(np.float32)
        state = np.where(rng.random(n) < 0.7, -1, rng.integers(0, 4, n)).astype(np.int32)
        w = None
    else:
        x = np.where(rng.random(n) < 0.3, ts.STATE_BIG, rng.random(n) * 20).astype(np.float32)
        state = np.where(rng.random(n) < 0.5, ts.STATE_BIG, rng.random(n) * 25).astype(np.float32)
    return x, w, valid, flags, is_last, state


@pytest.mark.parametrize("mode,fr_reduce", [("bfs", False), ("sssp", False), ("sssp", True)])
def test_scan_state_matches_reference(ref, mode, fr_reduce):
    jnp = ref.jnp
    x, w, valid, flags, is_last, state = _state_inputs(mode)
    depth = 2
    want_st, want_fr = ref.scan.segmented_scan_state(
        mode, jnp.asarray(x), None if w is None else jnp.asarray(w), jnp.asarray(valid),
        jnp.asarray(flags), jnp.asarray(is_last), jnp.asarray(state), depth,
        interpret=True, fr_reduce=fr_reduce,
    )
    got_st, got_fr = ts.segmented_scan_state(
        mode, _t(x), None if w is None else _t(w), _t(valid), _t(flags), _t(is_last), _t(state),
        depth, fr_reduce=fr_reduce,
    )
    _assert_equal(got_st, want_st)
    if fr_reduce:
        assert got_fr.shape == (1,) and got_fr.dtype == torch.int32
        assert bool(got_fr[0]) == bool(np.asarray(want_fr).max() > 0)
        assert bool(got_fr[0])  # the inputs do change some distance
    else:
        _assert_equal(got_fr, want_fr)
    if mode == "sssp":
        # the donor invariant: every non-last slot holds STATE_BIG
        assert (got_st.numpy()[~is_last] == ts.STATE_BIG).all()


# ---- routes (Kernel G) against apply_plan ---------------------------------


@pytest.fixture(scope="module")
def network(ref):
    """A JAX permutation network with T and RSEL stages (e_pad = 4 * 128^2)."""
    e_pad = 4 * 128 * 128
    perm = np.random.default_rng(5).permutation(e_pad)
    plan = ref.perm.build_permutation_plan(perm)
    return perm, plan


def synthetic_network(e_pad, seed):
    """S -> T(level) -> RSEL(m = 4) -> S with random tables, for
    e_pad = 4 * 128^(level + 2): the stages of the fused shuffle-transpose and
    the row-select kernels, as chip_smoke.py builds it at e_pad = 2^23."""
    rng = np.random.default_rng(seed)
    rows, m = e_pad // 128, 4
    level = round(np.log(e_pad // (4 * 128 * 128)) / np.log(128))
    assert 4 * 128 ** (level + 2) == e_pad

    def lanes():
        return np.argsort(rng.random((rows, 128)), axis=1).astype(np.int32)

    src_top = np.argsort(rng.random((m, e_pad // (128 * m), 128)), axis=0).astype(np.int32)
    return [("S", lanes()), ("T", level), ("RSEL", src_top, m), ("S", lanes())]


@pytest.mark.parametrize("which", ["router", "synthetic"])
def test_apply_network_plain_matches_apply_plan(ref, network, which):
    """Stage by stage against the reference's non-Pallas apply_plan, on a
    routed network (S, T and row-select stages) and on the synthetic one."""
    jnp = ref.jnp
    if which == "router":
        _, plan = network
    else:
        plan = ref.perm.PermutePlan(4 * 128 * 128, synthetic_network(4 * 128 * 128, 22))
    x = np.random.default_rng(23).random(plan.n).astype(np.float32)
    want = ref.perm.apply_plan(jnp.asarray(x), plan, pallas=False)
    got = tp.apply_network_plain(_t(x), plan.stages)
    _assert_equal(got, want)
    idx = _t(tp.compose_reference_network(plan.stages, plan.n))
    _assert_equal(kg.gather(_t(x), idx), want)


def test_compose_reference_network_is_the_permutation(ref, network):
    perm, plan = network
    kinds = {s[0] for s in plan.stages}
    assert {"S", "T"} <= kinds and kinds & {"RSEL", "ROWSEL"}
    idx = tp.compose_reference_network(plan.stages, plan.n)
    assert idx.dtype == np.int32
    _assert_equal(idx, perm)
    routed = np.asarray(ref.perm.apply_plan(ref.jnp.arange(plan.n, dtype=ref.jnp.int32), plan))
    _assert_equal(idx, routed)


@pytest.mark.parametrize("epilogue", [None, "pagerank"])
def test_apply_perm_matches_apply_plan(ref, network, epilogue):
    jnp = ref.jnp
    perm, plan = network
    rng = np.random.default_rng(6)
    x = rng.random(plan.n).astype(np.float32)
    idx = _t(tp.compose_reference_network(plan.stages, plan.n))
    if epilogue is None:
        want = ref.perm.apply_plan(jnp.asarray(x), plan)
        got = tp.apply_perm(_t(x), idx)
    else:
        a = (rng.integers(1, 30, plan.n) * np.where(rng.random(plan.n) < 0.8, 1, -1)).astype(np.float32)
        c = np.float32(0.37)

        def post(y, aux, s):
            return jnp.where(aux[0] > 0, y / aux[0], s[0] / (-aux[0]))

        want = ref.perm.apply_plan(
            jnp.asarray(x), plan, postlude=post, post_aux=(jnp.asarray(a),), post_scalars=(jnp.asarray(c),)
        )
        got = tp.apply_perm(_t(x), idx, "pagerank", aux=_t(a), scalar=torch.tensor(c))
    _assert_equal(got, want)


def test_wrappers_take_plain_versions_on_cpu_and_count():
    x, w, valid, flags = _inputs(7, "f32")
    kernels.reset_counts()
    ts.segmented_fill_static(_t(x), _t(ts.build_fill_tables(flags)))
    ts.segmented_scan_contrib(_t(x), _t(w), _t(valid), _t(flags), "max", "times")
    ts.segmented_scan(_t(x), _t(flags), "min")
    kg.gather(_t(x), _t(np.arange(N, dtype=np.int32)))
    ak, av, bk, bv = _eqjoin_inputs(4, 16, 512, seed=7)
    te.eqjoin(_t(ak), _t(av), _t(bk), _t(bv), "plus", "times")
    a = torch.rand(8, 4, generator=torch.Generator().manual_seed(7))
    tm.tropical_mxm_filled(a, a.T, "min", "plus")
    ke.compare_probe(a, a)
    tm.int_matmul(a, a.T, torch.int32)
    assert kernels.plain_counts() == {
        "gather": 1, "gather_fill": 1, "segscan_contrib": 1, "segscan_state": 0, "segscan": 1,
        "segscan_contrib_gather": 0, "segscan_spmm": 0, "segscan_spmm_keep": 0, "eqjoin": 1, "compare_probe": 1,
        "tropical_mxm": 1, "imatmul": 1,
    }
    assert sum(kernels.launch_counts().values()) == 0
    kernels.reset_counts()
    assert sum(kernels.plain_counts().values()) == 0


def test_wrappers_raise_on_devices_without_a_kernel():
    x = torch.zeros(8, device="meta")
    idx = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        kg.gather(x, idx)
    with pytest.raises(RuntimeError, match="no kernel"):
        ks.segscan(torch.zeros(128, device="meta"), torch.zeros(128, dtype=torch.bool, device="meta"), "add")
    keys = torch.zeros((4, 512), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ke.eqjoin(keys, None, keys, None, "plus", "pair")
    with pytest.raises(RuntimeError, match="no kernel"):
        kt.tropical_mxm(torch.zeros(4, 4, device="meta"), torch.zeros(4, 4, device="meta"), "min", "plus")
    with pytest.raises(RuntimeError, match="no kernel"):
        ke.compare_probe(torch.zeros(8, device="meta"), torch.zeros(8, device="meta"))


# ---- eqjoin ----------------------------------------------------------------


def _eqjoin_inputs(Wa, Wb, T, seed, nan=False):
    """Key tiles over a small key range (so tasks match), each task's tail
    padded with -1 (A) / -2 (B); values in [-1.5, 1.5).  ``nan`` puts one NaN
    value of A on a match."""
    rng = np.random.default_rng(seed)
    ak = rng.integers(0, 3 * max(Wa, Wb), (Wa, T)).astype(np.int32)
    bk = rng.integers(0, 3 * max(Wa, Wb), (Wb, T)).astype(np.int32)
    ak[np.arange(Wa)[:, None] >= rng.integers(1, Wa + 1, T)[None, :]] = -1
    bk[np.arange(Wb)[:, None] >= rng.integers(0, Wb + 1, T)[None, :]] = -2
    av = (rng.random((Wa, T)) * 3 - 1.5).astype(np.float32)
    bv = (rng.random((Wb, T)) * 3 - 1.5).astype(np.float32)
    if nan:
        bk[0, 5] = ak[0, 5]
        av[0, 5] = np.nan
    return ak, av, bk, bv


def _eqjoin_edge_inputs(Wa, Wb, T, seed):
    """Unsorted keys with duplicates over a small range (so tasks match, some
    keys more than once), each task's tail padded with -1 (A) / -2 (B);
    values in [-1.5, 1.5) with a few NaN and 5% -0.0 among them."""
    rng = np.random.default_rng(seed)
    span = max(4, (Wa + Wb) // 3)
    ak = rng.integers(0, span, (Wa, T)).astype(np.int32)
    bk = rng.integers(0, span, (Wb, T)).astype(np.int32)
    ak[np.arange(Wa)[:, None] >= rng.integers(1, Wa + 1, T)[None, :]] = -1
    bk[np.arange(Wb)[:, None] >= rng.integers(0, Wb + 1, T)[None, :]] = -2
    av = (rng.random((Wa, T)) * 3 - 1.5).astype(np.float32)
    bv = (rng.random((Wb, T)) * 3 - 1.5).astype(np.float32)
    for v in (av, bv):
        v[rng.random(v.shape) < 0.05] = -0.0
        v.flat[rng.choice(v.size, min(3, v.size), replace=False)] = np.nan
    return ak, av, bk, bv


def _eqjoin_rtol(add, mul):
    """Float plus / times accumulations of values round in each
    implementation's own order; everything else is exact."""
    return 1e-5 if add in ("plus", "times") and mul != "pair" else None


def _assert_eqjoin_equal(got, want, add, mul):
    (gv, gn), (wv, wn) = got, want
    _assert_equal(gn, wn)
    rtol = _eqjoin_rtol(add, mul)
    if rtol is None:
        _assert_equal(gv, wv)
    else:
        np.testing.assert_allclose(np.asarray(gv), np.asarray(wv), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("mul", sorted(ke.MULS))
@pytest.mark.parametrize("add", sorted(ke.ADDS))
@pytest.mark.parametrize("Wa,Wb", [(4, 16), (16, 64)])
def test_eqjoin_matches_reference(ref, Wa, Wb, add, mul):
    """Every add and multiply of the reference's _ADD_OPS x _MUL_OPS, with pad
    keys and one NaN value on a match."""
    jnp = ref.jnp
    assert te.supported(add, mul) and ref.eqjoin.supported(add, mul)
    ak, av, bk, bv = _eqjoin_inputs(Wa, Wb, 512, seed=Wa + Wb, nan=True)
    want = ref.eqjoin.eqjoin(
        jnp.asarray(ak), jnp.asarray(av) if mul != "pair" else None, jnp.asarray(bk),
        jnp.asarray(bv) if mul in ("times", "plus", "second") else None, add=add, mul=mul, interpret=True,
    )
    got = te.eqjoin(_t(ak), _t(av), _t(bk), _t(bv), add, mul)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _assert_eqjoin_equal(got, want, add, mul)
    assert int(got[1].sum()) > 0 and (got[1].numpy() == 0).any()  # matches and empty tasks both occur
    if mul in ("times", "plus", "first") and add not in ("lor", "land"):
        assert np.isnan(got[0][5].item())  # the NaN propagates (lor / land read it as nonzero)


_EQ_IDENT = {"plus": 0.0, "lor": 0.0, "min": np.inf, "max": -np.inf, "any": -np.inf, "times": 1.0, "land": 1.0}


def _signed_zero(a, b, r, neg):
    """``r`` with the sign of a tie of zeros settled: -0.0 where ``neg``."""
    both = (a == 0) & (b == 0)
    return np.where(both, np.where(neg, np.float32(-0.0), np.float32(0.0)), r)


def _maximum(a, b):
    """jnp.maximum: NaN propagates, +0.0 above -0.0 (numpy's keeps b on a tie)."""
    return _signed_zero(a, b, np.maximum(a, b), np.signbit(a) & np.signbit(b))


def _minimum(a, b):
    """jnp.minimum: NaN propagates, -0.0 below +0.0."""
    return _signed_zero(a, b, np.minimum(a, b), np.signbit(a) | np.signbit(b))


def eqjoin_order_model(ak, av, bk, bv, add, mul):
    """The TPU kernel's order of arithmetic (graphblas_tpu/ops/pallas_eqjoin.py:
    91-120) in numpy float32, each product and sum rounded once: per k an
    accumulator over l in order, then a combine over k in order."""
    f32 = np.float32
    Wa, T = ak.shape
    acc = np.full((Wa, T), _EQ_IDENT[add], f32)
    nm = np.zeros(T, np.int64)
    with np.errstate(invalid="ignore", over="ignore"):
        for l in range(bk.shape[0]):
            eq = ak == bk[l]
            nm += eq.sum(0)
            prod = {
                "pair": lambda: np.ones_like(acc), "times": lambda: av * bv[l], "plus": lambda: av + bv[l],
                "first": lambda: av, "second": lambda: np.broadcast_to(bv[l], acc.shape),
            }[mul]()
            if add == "plus":
                acc = acc + np.where(eq, prod, f32(0))
            elif add == "min":
                acc = np.where(eq, _minimum(acc, prod), acc)
            elif add in ("max", "any"):
                acc = np.where(eq, _maximum(acc, prod), acc)
            elif add == "times":
                acc = np.where(eq, acc * prod, acc)
            elif add == "lor":
                acc = np.where(eq & (prod != 0), f32(1), acc)
            else:  # land
                acc = np.where(eq, acc * (prod != 0).astype(f32), acc)
        total = np.full(T, _EQ_IDENT[add], f32)
        for k in range(Wa):
            if add == "plus":
                total = total + acc[k]
            elif add == "min":
                total = _minimum(total, acc[k])
            elif add in ("max", "any"):
                total = _maximum(total, acc[k])
            elif add == "lor":
                total = np.fmax(total, acc[k])
            else:  # times, land
                total = total * acc[k]
    return np.where(nm > 0, total, f32(0)).astype(f32), nm.astype(np.int32)


def _assert_same_bits(got, want):
    """Bit for bit, NaN anywhere the other has NaN (its payload aside)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("mul", sorted(ke.MULS))
@pytest.mark.parametrize("add", sorted(ke.ADDS))
def test_eqjoin_order_model_matches_reference(ref, add, mul):
    """The numpy model of the kernels' order against the Pallas kernel in
    interpret mode, bit for bit (NaN and -0.0 values, pads, duplicate keys)."""
    jnp = ref.jnp
    ak, av, bk, bv = _eqjoin_edge_inputs(4, 16, 512, seed=50)
    want = ref.eqjoin.eqjoin(
        jnp.asarray(ak), jnp.asarray(av) if mul != "pair" else None, jnp.asarray(bk),
        jnp.asarray(bv) if mul in ("times", "plus", "second") else None, add=add, mul=mul, interpret=True,
    )
    vals, nm = eqjoin_order_model(ak, av, bk, bv, add, mul)
    _assert_equal(nm, want[1])
    _assert_same_bits(vals, want[0])
    assert nm.sum() > 0 and (nm == 0).any()


def test_eqjoin_task_tile_is_the_reference_padding_rule(ref):
    for Wa in (4, 16, 64, 256):
        for Wb in (4, 16, 64, 256):
            assert te.task_tile(Wa, Wb) == ref.eqjoin.task_tile(Wa, Wb)
    assert ke.ADDS and set(ke.ADDS) == ref.eqjoin._ADD_OPS and set(ke.MULS) == ref.eqjoin._MUL_OPS


def test_eqjoin_rejects_what_it_does_not_take():
    ak, av, bk, bv = (_t(a) for a in _eqjoin_inputs(4, 16, 512, seed=3))
    with pytest.raises(ValueError):
        te.eqjoin(ak, av, bk, bv, "minus", "times")
    with pytest.raises(ValueError):
        te.eqjoin(ak, None, bk, bv, "plus", "times")
    with pytest.raises(TypeError):
        te.eqjoin(ak.long(), av, bk, bv, "plus", "times")
    with pytest.raises(ValueError):
        te.eqjoin(ak, av, bk[:, :256], bv[:, :256], "plus", "times")


# ---- tropical matmul ------------------------------------------------------


def _tropical_inputs(m, k, n, seed, nan=False):
    rng = np.random.default_rng(seed)
    av = (rng.random((m, k)) * 10).astype(np.float32)
    bv = (rng.random((k, n)) * 10).astype(np.float32)
    as_, bs = rng.random((m, k)) < 0.4, rng.random((k, n)) < 0.4
    if nan:
        av[1, 2], as_[1, 2] = np.nan, True
    return av, as_, bv, bs


@pytest.mark.parametrize("add,mul", list(kt.SEMIRINGS))
@pytest.mark.parametrize("shape", [(48, 72, 33), (130, 520, 2050)])  # the second crosses every TPU tile edge
def test_tropical_mxm_matches_reference(ref, add, mul, shape):
    jnp = ref.jnp
    av, as_, bv, bs = _tropical_inputs(*shape, seed=sum(shape), nan=shape[0] < 100)
    wv, ws = ref.mxm.tropical_mxm(
        jnp.asarray(av), jnp.asarray(as_), jnp.asarray(bv), jnp.asarray(bs), add, mul, np.float32, interpret=True
    )
    gv, gs = tm.tropical_mxm(_t(av), _t(as_), _t(bv), _t(bs), add, mul, torch.float32)
    assert gv.dtype == torch.float32 and gs.dtype == torch.bool
    _assert_equal(gs, ws)
    _assert_equal(gv, wv)  # bit-exact, NaN where the reference has NaN
    assert tm.is_tropical(add, mul, np.float32) and not tm.is_tropical(add, mul, np.int32)


def test_tropical_mxm_filled_on_filled_arrays(ref):
    rng = np.random.default_rng(31)
    a = np.where(rng.random((40, 70)) < 0.3, np.inf, rng.random((40, 70)) * 5).astype(np.float32)
    b = np.where(rng.random((70, 20)) < 0.3, np.inf, rng.random((70, 20)) * 5).astype(np.float32)
    want = ref.mxm.tropical_mxm_filled(ref.jnp.asarray(a), ref.jnp.asarray(b), "min", "plus", interpret=True)
    _assert_equal(tm.tropical_mxm_filled(_t(a), _t(b), "min", "plus"), want)


def test_tropical_mxm_rejects_what_it_does_not_take():
    a = torch.zeros(4, 5)
    with pytest.raises(ValueError):
        kt.tropical_mxm(a, a, "min", "plus")  # (4, 5) x (4, 5)
    with pytest.raises(ValueError):
        kt.tropical_mxm(a, a.T, "plus", "times")
    with pytest.raises(TypeError):
        kt.tropical_mxm(a.double(), a.T.double(), "min", "plus")
    with pytest.raises(RuntimeError, match="no kernel"):
        kt.tropical_mxm_in_tile(a, a.T.contiguous(), "min", "plus", 128)  # the kernel alone: CUDA tensors only


@pytest.mark.parametrize("m,n,tile", [
    (2048, 2048, 128), (2047, 2048, 128), (4096, 4096, 128),  # whole waves of 128-tiles
    (2047, 2049, 64), (1024, 1024, 64), (512, 512, 64), (256, 256, 64),  # just past a wave; few tiles
])
def test_tropical_tile_for_132_sms(m, n, tile):
    """The block tile the wrapper picks on an H100's 132 SMs, where the card
    measured the faster form (both forms timed by tools/probe_kernels.py)."""
    assert kt.tile_for(m, n, 132) == tile


# ---- compare probe --------------------------------------------------------


def test_compare_probe_matches_numpy():
    rng = np.random.default_rng(32)
    a = rng.integers(0, 100, (256, 128)).astype(np.float32)
    b = rng.integers(0, 40, (256, 128)).astype(np.float32)
    want = sum((a == b + np.float32(i)).astype(np.float32) for i in range(ke.PROBE_K))
    got = ke.compare_probe(_t(a), _t(b))
    _assert_equal(got, want)
    assert 0 < got.sum() < got.numel()


# ---- CUDA half: kernel against plain version on the card ------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [None if a is None else _t(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "epilogue,dt",
    [("none", "f32"), ("fill", "f32"), ("pagerank", "f32"), ("none", "i16"), ("none", "i8"), ("fill", "i8")],
)
def test_cuda_gather_matches_plain(cuda, epilogue, dt):
    rng = np.random.default_rng(8)
    n = 1 << 20
    x = rng.random(n).astype(np.float32) if dt == "f32" else _scan_inputs(8, dt, n)[0]
    if epilogue == "fill":
        idx = ts.build_fill_tables(rng.random(n) < 0.06)
    else:
        idx = rng.permutation(n).astype(np.int32)
    a = (rng.integers(1, 30, n) * np.where(rng.random(n) < 0.8, 1, -1)).astype(np.float32)
    xd, idxd, ad = _on(cuda, x, idx, a)
    c = torch.tensor(0.37, device=cuda)
    aux, scalar = (ad, c) if epilogue == "pagerank" else (None, None)
    got = kg.gather(xd, idxd, epilogue, aux, scalar)
    want = kg.gather_plain(xd, idxd, epilogue, aux, scalar)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dt,op,mul,wrap", [
    ("f32", "add", "times", None), ("f32", "min", "plus", None), ("f32", "max", "first", None),
    ("i32", "add", "times", (8, True)), ("i32", "min", "plus", (16, False)), ("i8", "max", "times", None),
])
@pytest.mark.parametrize("n", [5, 2048, (1 << 20) + 77])
def test_cuda_scan_contrib_matches_plain(cuda, dt, op, mul, wrap, n):
    x, w, valid, flags = _inputs(9, dt, n=n, positive=True)
    xd, wd, vd, fd = _on(cuda, x, w, valid, flags)
    got = ks.segscan_contrib(xd, wd, vd, fd, op, mul, wrap)
    want = ks.segscan_contrib_plain(xd, wd, vd, fd, op, mul, wrap)
    torch.cuda.synchronize()
    if dt == "f32" and op == "add":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,fr_reduce", [("bfs", False), ("sssp", False), ("sssp", True)])
def test_cuda_scan_state_matches_plain(cuda, mode, fr_reduce):
    x, w, valid, flags, is_last, state = _state_inputs(mode, seed=10, n=(1 << 20) + 77)
    args = _on(cuda, x, w, valid, flags, is_last, state)
    got = ks.segscan_state(mode, *args, 3, fr_reduce)
    want = ks.segscan_state_plain(mode, *args, 3, fr_reduce)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["fill", "add", "min", "max"])
@pytest.mark.parametrize("dt", ["f32", "i32", "i16", "i8", "u8"])
@pytest.mark.parametrize("n", [128, 2048, (1 << 20) + 128 * 3])  # one slot row, one block, a ragged last block
def test_cuda_segscan_matches_plain(cuda, dt, op, n):
    v, flags = _scan_inputs(24, dt, n)
    vd, fd = _on(cuda, v, flags)
    got = ks.segscan(vd, fd, op)
    want = ks.segscan_plain(vd, fd, op)
    torch.cuda.synchronize()
    if dt == "f32" and op == "add":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["random", "none"])
@pytest.mark.parametrize("offset", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dt", ["f32", "i32", "i16", "i8", "u8"])
def test_cuda_segscan_on_views(cuda, dt, offset, pattern):
    """The single pass on values ``offset`` slots into their buffer (off
    16-byte alignment: plain loads), with flags at random and with none (the
    look-back walks the whole chain), every op."""
    n = (1 << 20) + 128 * 3
    v, flags = _scan_inputs(offset, dt, n)
    if pattern == "none":
        flags[:] = False
    vd, fd = _view(cuda, v, offset), _view(cuda, flags, 0)
    for op in ("fill", "add", "min", "max"):
        got = ks.segscan(vd, fd, op)
        want = ks.segscan_plain(vd, fd, op)
        torch.cuda.synchronize()
        _check_contrib(got, want, dt, op)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "i32", "i16", "i8", "u8"])
def test_cuda_segscan_long_and_short(cuda, dt):
    """2^25 slots (16,384 tiles) without a flag, and one ragged tile of 128
    slots (the SpGEMM reduce net's short arrays), every op."""
    for n, pattern in ((1 << 25, "none"), (128, "random")):
        v, flags = _scan_inputs(60, dt, n)
        if pattern == "none":
            flags[:] = False
        vd, fd = _on(cuda, v, flags)
        for op in ("fill", "add", "min", "max"):
            got = ks.segscan(vd, fd, op)
            want = ks.segscan_plain(vd, fd, op)
            torch.cuda.synchronize()
            _check_contrib(got, want, dt, op)


@pytest.mark.cuda
def test_cuda_gather_network_matches_plain(cuda):
    e_pad = 4 * 128**3
    stages = synthetic_network(e_pad, 25)
    x = torch.rand(e_pad, device=cuda)
    idx = torch.from_numpy(tp.compose_reference_network(stages, e_pad)).to(cuda)
    got = kg.gather(x, idx)
    want = tp.apply_network_plain(x, stages)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("add,mul", [
    ("plus", "pair"), ("plus", "times"), ("min", "plus"), ("max", "first"), ("any", "second"),
    ("lor", "pair"), ("land", "times"), ("times", "plus"),
])
@pytest.mark.parametrize("Wa,Wb,T", [(4, 4, 1000), (16, 64, 4096), (64, 256, 512), (256, 256, 700)])
def test_cuda_eqjoin_matches_plain(cuda, Wa, Wb, T, add, mul):
    args = _on(cuda, *_eqjoin_inputs(Wa, Wb, T, seed=Wa * Wb + T, nan=True))
    got = ke.eqjoin(*args, add, mul)
    want = ke.eqjoin_plain(*args, add, mul)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    rtol = _eqjoin_rtol(add, mul)
    torch.testing.assert_close(got[0], want[0], rtol=rtol or 0, atol=1e-6 if rtol else 0, equal_nan=True)


def _eqjoin_in_every_layout(dev, ak, av, bk, bv, semirings):
    """The kernel in each layout ``ke.layouts(Wa)`` gives, on each semiring,
    bit for bit against the numpy order model."""
    args = _on(dev, ak, av, bk, bv)
    for add, mul in semirings:
        want_v, want_n = eqjoin_order_model(ak, av, bk, bv, add, mul)
        for lanes in ke.layouts(ak.shape[0]):
            got_v, got_n = ke.eqjoin_in_layout(*args, add, mul, lanes)
            torch.cuda.synchronize()
            _assert_equal(got_n.cpu(), want_n)
            _assert_same_bits(got_v.cpu().numpy(), want_v)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 31, 513, 4097])
@pytest.mark.parametrize("Wb", [4, 16, 64, 256])
@pytest.mark.parametrize("Wa", [4, 16, 64, 256])
def test_cuda_eqjoin_every_layout_matches_the_order_model(cuda, Wa, Wb, T):
    """Every layout the host may pick, at the bucket widths the analysis
    makes, around the warp and block sizes of both layouts: keys unsorted
    with duplicates and pads, NaN and -0.0 values."""
    semirings = [("plus", "pair"), ("plus", "times"), ("min", "plus"), ("max", "first"), ("times", "second")]
    _eqjoin_in_every_layout(cuda, *_eqjoin_edge_inputs(Wa, Wb, T, seed=Wa * 7 + Wb * 3 + T), semirings)


@pytest.mark.cuda
@pytest.mark.parametrize("Wa,Wb,T", [(16, 64, 513), (256, 256, 31), (4, 256, 97)])
def test_cuda_eqjoin_every_add_mul_in_every_layout(cuda, Wa, Wb, T):
    """Every add x mul of the reference, in every layout, bit for bit."""
    semirings = [(a, m) for a in ke.ADDS for m in ke.MULS]
    _eqjoin_in_every_layout(cuda, *_eqjoin_edge_inputs(Wa, Wb, T, seed=T), semirings)


@pytest.mark.cuda
def test_cuda_eqjoin_picks_its_layout_and_counts(cuda):
    """``eqjoin`` launches once, in the layout ``lanes_per_task`` picks, and
    agrees with the model; a layout the kernel does not take raises."""
    ak, av, bk, bv = _eqjoin_edge_inputs(256, 256, 512, seed=3)
    assert ke.lanes_per_task(256, 256, 512) == 32
    args = _on(cuda, ak, av, bk, bv)
    kernels.reset_counts()
    got_v, got_n = ke.eqjoin(*args, "min", "plus")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["eqjoin"] == 1 and kernels.plain_counts()["eqjoin"] == 0
    want_v, want_n = eqjoin_order_model(ak, av, bk, bv, "min", "plus")
    _assert_equal(got_n.cpu(), want_n)
    _assert_same_bits(got_v.cpu().numpy(), want_v)
    with pytest.raises(ValueError, match="not a layout"):
        ke.eqjoin_in_layout(*args, "min", "plus", 16)  # 256 / 16 keys a lane: more than the kernel holds


@pytest.mark.cuda
@pytest.mark.parametrize("add,mul", list(kt.SEMIRINGS))
@pytest.mark.parametrize("shape", [(1, 1, 1), (65, 17, 129), (300, 1000, 77), (128, 2048, 256)])
def test_cuda_tropical_mxm_matches_plain(cuda, add, mul, shape):
    av, as_, bv, bs = _tropical_inputs(*shape, seed=sum(shape), nan=shape[0] > 1)
    fill = kt.fill_value(add)
    a, b = _on(cuda, np.where(as_, av, fill).astype(np.float32), np.where(bs, bv, fill).astype(np.float32))
    got = kt.tropical_mxm(a, b, add, mul)
    want = kt.tropical_mxm_plain(a, b, add, mul)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1 << 14, 128), (1000, 3)])
def test_cuda_compare_probe_matches_plain(cuda, shape):
    rng = np.random.default_rng(33)
    a, b = _on(cuda, rng.integers(0, 100, shape).astype(np.float32), rng.integers(0, 40, shape).astype(np.float32))
    got = ke.compare_probe(a, b)
    want = ke.compare_probe_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---- CUDA half: G and C at the edges of their designs ----------------------


def _view(dev, arr, offset):
    """``arr`` on the card as a view ``offset`` elements into a larger
    allocation: offsets 1-3 leave it off 16-byte alignment."""
    t = _t(arr)
    buf = torch.zeros(len(arr) + offset, dtype=t.dtype, device=dev)
    buf[offset:] = t.to(dev)
    return buf[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, 0), (1, 3), (3, 1), (2, 2)])  # x's, idx's
@pytest.mark.parametrize("n", [1, 3, 4097, (1 << 20) + 5])
@pytest.mark.parametrize("dt", ["f32", "i32", "i16", "i8", "u8"])
def test_cuda_gather_lengths_widths_views(cuda, dt, n, offsets):
    """The route at lengths around a warp's step of 8 x 32 slots, every word
    width, on views at every alignment."""
    rng = np.random.default_rng(n + 7 * offsets[0] + offsets[1])
    nx = max(n // 3, 1)
    x = rng.random(nx).astype(np.float32) if dt == "f32" else _scan_inputs(n, dt, nx)[0]
    idx = rng.integers(0, nx, n).astype(np.int32)
    xd, idd = _view(cuda, x, offsets[0]), _view(cuda, idx, offsets[1])
    got = kg.gather(xd, idd)
    want = kg.gather_plain(xd, idd)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 2, 3), (3, 0, 1), (2, 1, 0)])  # x's, idx's, aux's
@pytest.mark.parametrize("n", [1, 3, 4097, (1 << 20) + 5])
def test_cuda_gather_fill_and_pagerank_on_views(cuda, n, offsets):
    """fill with negative indices (a prefix before the first flag) and the
    PageRank epilogue, at every alignment of x, idx and aux."""
    rng = np.random.default_rng(n + 11 * offsets[1])
    x = rng.random(n).astype(np.float32)
    flags = rng.random(n) < 0.06
    flags[: min(n, 5)] = False
    fill_src = ts.build_fill_tables(flags)
    perm = rng.permutation(n).astype(np.int32)
    a = (rng.integers(1, 30, n) * np.where(rng.random(n) < 0.8, 1, -1)).astype(np.float32)
    xd = _view(cuda, x, offsets[0])
    fd, pd, ad = _view(cuda, fill_src, offsets[1]), _view(cuda, perm, offsets[1]), _view(cuda, a, offsets[2])
    c = torch.tensor(0.37, device=cuda)
    for args in ((xd, fd, "fill"), (xd, pd, "pagerank", ad, c)):
        got = kg.gather(*args)
        want = kg.gather_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert (kg.gather(xd, fd, "fill")[: min(n, 5)] == 0).all()


@pytest.mark.cuda
def test_cuda_gather_x_larger_than_l2(cuda):
    """x of 2^24 float32 slots (64 MB, more than the 50 MB L2)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(42)
    x = torch.rand(1 << 24, generator=gen, device=cuda)
    idx = torch.randint(0, 1 << 24, ((1 << 23) + 3,), generator=gen, device=cuda, dtype=torch.int32)
    got = kg.gather(x, idx)
    want = kg.gather_plain(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _contrib_inputs_on(dev, n, pattern, seed):
    """Kernel C's inputs made on the card; ``pattern`` places the flags."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.rand(n, generator=gen, device=dev)
    w = torch.rand(n, generator=gen, device=dev) * 9 + 1
    valid = torch.rand(n, generator=gen, device=dev) < 0.9
    slot = torch.arange(n, device=dev)
    flags = {
        "none": torch.zeros(n, dtype=torch.bool, device=dev),
        "every": torch.ones(n, dtype=torch.bool, device=dev),
        "first": slot == 0,
        "tile_starts": slot % kernels._build.library().gb_segscan_tile() == 0,
        "random": torch.rand(n, generator=gen, device=dev) < 1 / 16,
    }[pattern]
    return x, w, valid, flags


def _check_contrib(got, want, dt, op):
    if dt == "f32" and op == "add":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["none", "every", "first", "tile_starts", "random"])
@pytest.mark.parametrize("n", [1, 5, 2047, 2049, (1 << 20) + 77, 1 << 25])
def test_cuda_scan_contrib_lengths_and_flags(cuda, n, pattern):
    """The single pass at lengths around its 2048-slot tile and up to 2^25,
    with no flag at all (the look-back walks the whole chain), a flag at
    every slot, only at slot 0, only at tile starts, and at random."""
    x, w, valid, flags = _contrib_inputs_on(cuda, n, pattern, seed=n)
    for op, mul in (("add", "times"), ("min", "plus"), ("max", "first")):
        wv = None if mul == "first" else w
        got = ks.segscan_contrib(x, wv, valid, flags, op, mul)
        want = ks.segscan_contrib_plain(x, wv, valid, flags, op, mul)
        torch.cuda.synchronize()
        _check_contrib(got, want, "f32", op)


@pytest.mark.cuda
def test_cuda_scan_contrib_twenty_calls_in_a_row(cuda):
    """Each call zeroes its descriptors and ticket afresh: 20 calls without a
    synchronisation between them, alternating inputs, all agree."""
    ins = [_contrib_inputs_on(cuda, (1 << 20) + 77, p, seed=5) for p in ("none", "random")]
    outs = [ks.segscan_contrib(*ins[k % 2], "add", "times") for k in range(20)]
    wants = [ks.segscan_contrib_plain(*ins[k], "add", "times") for k in range(2)]
    torch.cuda.synchronize()
    for k, got in enumerate(outs):
        _check_contrib(got, wants[k % 2], "f32", "add")


@pytest.mark.cuda
@pytest.mark.parametrize("dt,op,mul,has_w,wrap", CONTRIB_CASES)
def test_cuda_scan_contrib_every_op_mul_wrap(cuda, dt, op, mul, has_w, wrap):
    """Every op x mul x wrap of the reference's cases, over several tiles."""
    x, w, valid, flags = _inputs(43, dt, n=3 * 2048 + 100, positive=True)
    xd, wd, vd, fd = _on(cuda, x, w if has_w else None, valid, flags)
    got = ks.segscan_contrib(xd, wd, vd, fd, op, mul, wrap)
    want = ks.segscan_contrib_plain(xd, wd, vd, fd, op, mul, wrap)
    torch.cuda.synchronize()
    _check_contrib(got, want, dt, op)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 0, 0, 0), (0, 2, 0, 0), (0, 0, 3, 1), (3, 1, 2, 5)])  # x, w, valid, flags
@pytest.mark.parametrize("pattern", ["none", "random"])
def test_cuda_scan_contrib_on_views(cuda, offsets, pattern):
    """Unaligned views take the plain loads inside the same single pass."""
    n = (1 << 20) + 77
    ins = [t.cpu().numpy() for t in _contrib_inputs_on(cuda, n, pattern, seed=9)]
    xd, wd, vd, fd = (_view(cuda, a, o) for a, o in zip(ins, offsets))
    for op, mul in (("add", "times"), ("min", "plus")):
        got = ks.segscan_contrib(xd, wd, vd, fd, op, mul)
        want = ks.segscan_contrib_plain(xd, wd, vd, fd, op, mul)
        torch.cuda.synchronize()
        _check_contrib(got, want, "f32", op)


def _check_gathered(got, dev, x, idx, w, valid, flags, op, mul, wrap=None, dt="f32"):
    """The fused gather's output ``got`` against C on ``x[idx]`` bit for bit
    (the same tiles in the same order, float sums included) and against its
    plain version within C's tolerances."""
    torch.cuda.synchronize()
    want = ks.segscan_contrib(kg.gather(x, idx), w, valid, flags, op, mul, wrap)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = ks.segscan_contrib_gather_plain(x, idx, w, valid, flags, op, mul, wrap)
    torch.cuda.synchronize()
    _check_contrib(got, plain, dt, op)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nx", [(5, 3), (3 * 2048 + 100, 1000), ((1 << 20) + 77, 1 << 16)])
@pytest.mark.parametrize("dt,op,mul,has_w,wrap", CONTRIB_CASES)
def test_cuda_scan_contrib_gather_is_c_on_the_gather(cuda, dt, op, mul, has_w, wrap, n, nx):
    """Every op x mul x wrap of C's cases, f32, int32 and int8 (widened over
    x's own slots): a ragged tail, x shorter than a tile."""
    x, idx, w, valid, flags = _on(cuda, *_gather_inputs(n + nx, dt, n=n, nx=nx))
    wd = w if has_w else None
    got = ks.segscan_contrib_gather(x, idx, wd, valid, flags, op, mul, wrap)
    assert got.dtype == x.dtype and got.shape == (n,)
    _check_gathered(got, cuda, x, idx, wd, valid, flags, op, mul, wrap, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["none", "every", "tile_starts", "random"])
@pytest.mark.parametrize("n", [1, 2047, 2049, (1 << 20) + 77, 1 << 25])
def test_cuda_scan_contrib_gather_lengths_flags_and_invalid_tiles(cuda, n, pattern):
    """Lengths around the 2048-slot tile and up to 2^25, with no flag at all
    (the longest look-back), a flag at every slot, at tile starts and at
    random; every third tile wholly invalid (nothing of x read there)."""
    _, w, valid, flags = _contrib_inputs_on(cuda, n, pattern, seed=n + 1)
    nx = max(n >> 4, 1)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    x = torch.rand(nx, generator=gen, device=cuda)
    idx = torch.randint(0, nx, (n,), generator=gen, device=cuda, dtype=torch.int32)
    tile = kernels._build.library().gb_segscan_tile()
    valid = valid & (torch.arange(n, device=cuda) // tile % 3 != 1)
    for op, mul in (("add", "times"), ("min", "plus"), ("max", "first")):
        wv = None if mul == "first" else w
        got = ks.segscan_contrib_gather(x, idx, wv, valid, flags, op, mul)
        _check_gathered(got, cuda, x, idx, wv, valid, flags, op, mul)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 0, 0, 0, 0), (0, 1, 0, 0, 0), (0, 0, 2, 0, 0), (0, 0, 0, 3, 1), (3, 1, 2, 5, 7)])
@pytest.mark.parametrize("pattern", ["none", "random"])
def test_cuda_scan_contrib_gather_on_views(cuda, offsets, pattern):
    """x, idx, w, valid and flags as views off 16-byte alignment (idx, w,
    valid or flags unaligned: the plain loads) in the same single pass."""
    n = (1 << 20) + 77
    _, w, valid, flags = (t.cpu().numpy() for t in _contrib_inputs_on(cuda, n, pattern, seed=13))
    rng = np.random.default_rng(13)
    x = rng.random(1 << 16).astype(np.float32)
    idx = rng.integers(0, 1 << 16, n).astype(np.int32)
    xd, idd, wd, vd, fd = (_view(cuda, a, o) for a, o in zip((x, idx, w, valid, flags), offsets))
    for op, mul in (("add", "times"), ("min", "plus")):
        got = ks.segscan_contrib_gather(xd, idd, wd, vd, fd, op, mul)
        _check_gathered(got, cuda, xd, idd, wd, vd, fd, op, mul)


@pytest.mark.cuda
def test_cuda_scan_contrib_gather_counts_its_launch(cuda):
    x, idx, w, valid, flags = _on(cuda, *_gather_inputs(17, "f32", n=4096, nx=300))
    kernels.reset_counts()
    ks.segscan_contrib_gather(x, idx, w, valid, flags, "add", "times")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["segscan_contrib_gather"] == 1 and kernels.launch_counts()["segscan_contrib"] == 0
    assert not any(kernels.plain_counts().values())


# ---- CUDA half: NaN through the scans, S and the tropical matmul at their edges


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6784, (1 << 20) + 128 * 3])  # three tiles and a ragged fourth; many tiles
@pytest.mark.parametrize("kind,how", NAN_CASES)
def test_cuda_scans_propagate_nan(cuda, kind, how, n):
    """C (min, max), S (BFS, SSSP, SSSP with fr_reduce) and the generic scan
    (f32 min, max) with NaN at a flagged slot, mid-segment, at a thread's
    first slot and at a tile's first slot, and +-0.0 among the values: equal
    to the plain version, NaN for NaN, the signed zeros bit for bit."""
    args = tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in _nan_inputs(kind, how, n, seed=n))
    got = _nan_call(kind, args)
    want = _nan_call(kind, args, plain=True)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        _assert_nan_and_zero_bits(g.cpu(), w_.cpu())
    assert torch.isnan(want[0]).any() if want[0].dtype == torch.float32 else True


def _state_on(dev, mode, n, pattern, seed):
    """S's inputs on the card: flags at random (1/16) or none at all."""
    x, w, valid, flags, is_last, state = _state_inputs(mode, seed=seed, n=n)
    if pattern == "none":
        flags[:] = False
        is_last[:] = False
        is_last[-1] = True
    return _on(dev, x, w, valid, flags, is_last, state)


def _check_state(args, mode, fr_reduce, depth=3):
    got = ks.segscan_state(mode, *args, depth, fr_reduce)
    want = ks.segscan_state_plain(mode, *args, depth, fr_reduce)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["random", "none"])
@pytest.mark.parametrize("n", [1, 5, 1023, 1025, 2049, (1 << 20) + 77, 1 << 23])
@pytest.mark.parametrize("mode,fr_reduce", [("bfs", False), ("sssp", False), ("sssp", True)])
def test_cuda_scan_state_lengths_and_flags(cuda, mode, fr_reduce, n, pattern):
    """S's single pass at lengths around its tile, up to e_pad = 2^23, with
    flags at random and with none (one segment: the longest look-back)."""
    _check_state(_state_on(cuda, mode, n, pattern, seed=n % 1000), mode, fr_reduce)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 0, 0, 0, 0, 0), (0, 1, 0, 0, 0, 0), (0, 0, 3, 1, 2, 0), (0, 0, 0, 0, 0, 1)])
@pytest.mark.parametrize("mode,fr_reduce", [("bfs", False), ("sssp", False), ("sssp", True)])
def test_cuda_scan_state_on_views(cuda, mode, fr_reduce, offsets):
    """Views off 16-byte alignment (x, w, valid, flags, is_last, state) take
    the plain loads inside the same single pass."""
    n = (1 << 20) + 77
    arrays = _state_inputs(mode, seed=12, n=n)
    args = [None if a is None else _view(cuda, a, o) for a, o in zip(arrays, offsets)]
    _check_state(args, mode, fr_reduce)


@pytest.mark.cuda
def test_cuda_scan_state_twenty_calls_in_a_row(cuda):
    """Each call zeroes its descriptors and ticket afresh: 20 calls without a
    synchronisation between them, alternating inputs and modes, all agree."""
    ins = [
        ("sssp", True, _state_on(cuda, "sssp", (1 << 20) + 77, "none", seed=5)),
        ("bfs", False, _state_on(cuda, "bfs", (1 << 20) + 77, "random", seed=6)),
    ]
    outs = [ks.segscan_state(ins[k % 2][0], *ins[k % 2][2], 3, ins[k % 2][1]) for k in range(20)]
    wants = [ks.segscan_state_plain(mode, *args, 3, fr) for mode, fr, args in ins]
    torch.cuda.synchronize()
    for k, got in enumerate(outs):
        assert all(torch.equal(g, w_) for g, w_ in zip(got, wants[k % 2]))


def _tropical_edge_inputs(m, k, n, add, seed):
    """Filled operands with NaN, +inf and -inf among the values."""
    av, as_, bv, bs = _tropical_inputs(m, k, n, seed)
    fill = kt.fill_value(add)
    a, b = np.where(as_, av, fill).astype(np.float32), np.where(bs, bv, fill).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    for arr in (a, b):
        arr[rng.random(arr.shape) < 0.01] = np.inf
        arr[rng.random(arr.shape) < 0.01] = -np.inf
    if m * k:
        a.flat[rng.integers(m * k)] = np.nan
    if k * n:
        b.flat[rng.integers(k * n)] = np.nan
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("add,mul", list(kt.SEMIRINGS))
@pytest.mark.parametrize("shape", [
    (128, 128, 128), (256, 384, 512),  # exact 128 multiples
    (127, 129, 1), (129, 127, 130), (1, 129, 127), (129, 1, 129),  # M, N, K of 127 / 129 / 1
    (200, 300, 130), (131, 257, 6),  # K no multiple of 4 (the scalar loads), N no multiple of 4
    (40, 70, 0),  # K = 0: the fill
])
def test_cuda_tropical_mxm_at_the_tile_edges(cuda, add, mul, shape):
    """Both block tiles (128 x 128 with its 8-deep k step, 64 x 64) at each
    edge, every semiring, NaN and +-inf, bit for bit against the plain
    version; and the tile the wrapper picks."""
    a, b = _on(cuda, *_tropical_edge_inputs(*shape, add, seed=sum(shape)))
    want = kt.tropical_mxm_plain(a, b, add, mul).cpu().numpy()
    for got in [kt.tropical_mxm_in_tile(a, b, add, mul, t) for t in kt.TILES] + [kt.tropical_mxm(a, b, add, mul)]:
        torch.cuda.synchronize()
        _assert_same_bits(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("add,mul", list(kt.SEMIRINGS))
def test_cuda_tropical_mxm_on_views(cuda, add, mul):
    """Operands one float into their buffers (off 16-byte alignment: the
    scalar loads), against the same operands aligned."""
    a, b = _tropical_edge_inputs(256, 256, 256, add, seed=7)
    av, bv = (_view(cuda, x.ravel(), 1).view(x.shape) for x in (a, b))
    want = kt.tropical_mxm_plain(*_on(cuda, a, b), add, mul).cpu().numpy()
    for t in kt.TILES:
        for x, y in ((av, bv), _on(cuda, a, b)):
            got = kt.tropical_mxm_in_tile(x, y, add, mul, t)
            torch.cuda.synchronize()
            _assert_same_bits(got.cpu().numpy(), want)

"""Parity of the port's integer products with the JAX package's.

The reference computes every integer product as an integer matmul through
XLA: the dense engine's plus_times, plus_first and plus_second over integer
types in ``promote_types(out, int32)``, plus_pair and the tropical mxm's
structure as int8 -> int32 overlap counts, the triangle count in int8 blocks
against ``L^T`` and the k-truss support in int32.  The port computes the
counts with ``ops.mxm.indicator_counts`` (``torch._int_mm``) and the values
with ``ops.mxm.int_matmul`` (``gb_imatmul`` on the card, its plain version
here).  The same numpy-seeded inputs go through both packages on the CPU,
with values chosen so that the sums wrap; every result is compared bit for
bit.  The JAX function's Pallas kernel runs in interpret mode, as the JAX
package's own tests run it.  The CUDA test (``-m cuda``; it skips here)
holds ``gb_imatmul`` to its plain version bit for bit.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P
from graphblas_tpu_torch import models as PM
from graphblas_tpu_torch.kernels import imatmul as ki
from graphblas_tpu_torch.ops import mxm as pmxm

INT_TYPES = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "BOOL"]
SEMIRINGS = ["plus_times", "plus_first", "plus_second", "plus_pair"]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def pinned(request):
    """The port on the CPU; mxm_strategy "auto" in both."""
    if "ref" not in request.fixturenames:
        with P.tx.config.set(platform="cpu", mxm_strategy="auto"):
            yield
        return
    R = request.getfixturevalue("ref")
    with P.tx.config.set(platform="cpu", mxm_strategy="auto"), R.tx.config.set(mxm_strategy="auto"):
        yield


def wrapping_values(np_type, n, rng):
    """Values over the whole range of ``np_type``, so products and sums wrap."""
    if np_type == np.bool_:
        return rng.random(n) < 0.5
    info = np.iinfo(np_type)
    return rng.integers(info.min, info.max, n, endpoint=True, dtype=np.int64 if info.min < 0 else np.uint64).astype(
        np_type
    )


def coo(shape, density, np_type, seed):
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(rng.random(shape[0] * shape[1]) < density)
    return cells // shape[1], cells % shape[1], wrapping_values(np_type, len(cells), rng)


def run_products(gb, name, sr_name, kind):
    t = getattr(gb.dtypes, name)
    sr = getattr(gb.semiring, sr_name)[t]
    m, k, n = 23, 41, 19
    A = gb.Matrix.from_coo(*coo((m, k), 0.7, t.np_type, 1), t, nrows=m, ncols=k)
    if kind == "mxm":
        B = gb.Matrix.from_coo(*coo((k, n), 0.7, t.np_type, 2), t, nrows=k, ncols=n)
        return A.mxm(B, sr).new().to_coo()
    i, _, v = coo((k, 1), 0.8, t.np_type, 3)
    x = gb.Vector.from_coo(i, v, t, size=k)
    return A.mxv(x, sr).new().to_coo()


@pytest.mark.parametrize("kind", ["mxm", "mxv"])
@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("name", INT_TYPES)
def test_integer_products_match_the_reference(ref, name, sr_name, kind):
    got, want = run_products(P, name, sr_name, kind), run_products(ref, name, sr_name, kind)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_int_products_take_the_matmul_and_generic_the_contraction():
    """The dense engine's integer plus_times runs one ``int_matmul`` (the
    plain version on the CPU); ``mxm_strategy="generic"`` still forces the
    generic contraction, with the same bits."""
    from graphblas_tpu_torch import kernels

    t = P.dtypes.INT32
    A = P.Matrix.from_coo(*coo((30, 50), 0.6, np.int32, 4), t, nrows=30, ncols=50)
    kernels.reset_counts()
    fast = A.mxm(A.T.new(), P.semiring.plus_times[t]).new()
    assert kernels.plain_counts()["imatmul"] == 1
    kernels.reset_counts()
    with P.tx.config.set(mxm_strategy="generic"):
        gen = A.mxm(A.T.new(), P.semiring.plus_times[t]).new()
    assert kernels.plain_counts()["imatmul"] == 0
    assert fast.isequal(gen, check_dtype=True)


def compiled_products(gb):
    """INT32 plus_times and INT16 plus_pair inside a compiled function, two calls."""

    @gb.compile
    def step(A, B):
        C = A.mxm(B, gb.semiring.plus_times[gb.dtypes.INT32]).new()
        return C, A.mxm(C, gb.semiring.plus_pair[gb.dtypes.INT16]).new()

    t = gb.dtypes.INT32
    A = gb.Matrix.from_coo(*coo((24, 24), 0.5, np.int32, 6), t, nrows=24, ncols=24)
    B = gb.Matrix.from_coo(*coo((24, 24), 0.5, np.int32, 7), t, nrows=24, ncols=24)
    return [x.to_coo() for pair in (step(A, B), step(B, A)) for x in pair]


def test_compiled_integer_products_match_the_reference(ref):
    for g, w in zip(compiled_products(P), compiled_products(ref)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("add, mul", [("min", "plus"), ("max", "plus"), ("min", "max"), ("max", "min")])
def test_tropical_structure_matches_the_reference(ref, add, mul):
    import jax.numpy as jnp
    from graphblas_tpu.ops import pallas_mxm

    rng = np.random.default_rng(5)
    av, bv = rng.random((37, 45), np.float32), rng.random((45, 29), np.float32)
    as_, bs = rng.random((37, 45)) < 0.05, rng.random((45, 29)) < 0.05
    cv, cs = pmxm.tropical_mxm(
        torch.from_numpy(av), torch.from_numpy(as_), torch.from_numpy(bv), torch.from_numpy(bs), add, mul, torch.float32
    )
    rv, rs = pallas_mxm.tropical_mxm(
        jnp.asarray(av), jnp.asarray(as_), jnp.asarray(bv), jnp.asarray(bs), add, mul, np.float32, interpret=True
    )
    np.testing.assert_array_equal(cs.numpy(), np.asarray(rs))
    assert 0 < int(cs.sum()) < cs.numel()
    np.testing.assert_array_equal(cv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("scale", [8, 9, 10])
def test_triangle_count_on_rmat(ref, scale):
    from graphblas_tpu.models.graph import rmat as ref_rmat
    from graphblas_tpu.models import triangle_count as ref_tc

    got = PM.triangle_count(PM.rmat(scale, 8, seed=scale, device="cpu"))
    assert got == ref_tc(ref_rmat(scale, 8, seed=scale)) > 0


@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("scale", [8, 9])
def test_k_truss_on_rmat(ref, scale, k):
    from graphblas_tpu.models import k_truss as ref_kt
    from graphblas_tpu.models.graph import rmat as ref_rmat

    got = PM.k_truss(PM.rmat(scale, 8, seed=scale), k)
    want = ref_kt(ref_rmat(scale, 8, seed=scale), k)
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    pairs = np.stack([got.src.numpy()[gv], got.dst.numpy()[gv]])
    np.testing.assert_array_equal(pairs, np.stack([np.asarray(want.src)[wv], np.asarray(want.dst)[wv]]))
    assert pairs.shape[1] > 0


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 9, 3), (17, 33, 8), (31, 7, 65), (64, 130, 40)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_imatmul_plain_wraps_as_numpy(dtype, shape):
    """imatmul_plain = numpy's integer matmul, which wraps mod 2^32 (int32)
    and mod 2^64 (int64), on values over the whole range."""
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    a, b = (wrapping_values(dtype, r * c, rng).reshape(r, c) for r, c in ((m, k), (k, n)))
    with np.errstate(over="ignore"):
        want = a @ b
    got = ki.imatmul_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [1, 7, 17, 1023])
def test_indicator_counts_pad_to_int_mm(rows):
    """Shapes off ``torch._int_mm``'s rule (16 rows or fewer, K or N not a
    multiple of 8) are padded and sliced back; the counts are exact."""
    rng = np.random.default_rng(rows)
    k, n = 13, 21
    a, b = rng.random((rows, k)) < 0.5, rng.random((k, n)) < 0.5
    got = pmxm.indicator_counts(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))
    # int8 operands as they are, a transposed view among them (the triangle count's L^T)
    l8 = torch.from_numpy(rng.random((64, 64)) < 0.3).to(torch.int8)
    np.testing.assert_array_equal(
        pmxm.indicator_counts(l8[:32], l8.T).numpy(), l8[:32].numpy().astype(np.int32) @ l8.T.numpy().astype(np.int32)
    )


def test_imatmul_wrapper_routes_and_checks():
    """CPU tensors take the plain version; the wrapper refuses mixed or
    unsupported types."""
    from graphblas_tpu_torch import kernels

    kernels.reset_counts()
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert torch.equal(ki.imatmul(a, a.T.contiguous()), (a.long() @ a.T.long()).int())
    assert kernels.plain_counts()["imatmul"] == 1 and kernels.launch_counts()["imatmul"] == 0
    with pytest.raises(TypeError):
        ki.imatmul(a, a.T.contiguous().long())
    with pytest.raises(TypeError):
        ki.imatmul(a.float(), a.T.contiguous().float())
    with pytest.raises(ValueError):
        ki.imatmul(a, a)


# ---------------------------------------------------------------------------
# the card (skipped here)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype, shape", [(torch.int32, (256, 512, 384)), (torch.int32, (1000, 1030, 999)), (torch.int64, (300, 257, 129))]
)
def test_cuda_imatmul_matches_plain(card, dtype, shape):
    """gb_imatmul in every form against its plain version, bit for bit, on
    values that wrap, aligned and ragged, and on an unaligned view."""
    m, k, n = shape
    info = torch.iinfo(dtype)
    gen = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randint(info.min, info.max, (m, k), dtype=dtype, device="cuda", generator=gen)
    b = torch.randint(info.min, info.max, (k, n), dtype=dtype, device="cuda", generator=gen)
    want = ki.imatmul_plain(a, b)
    for tile in ki.TILES[dtype]:
        assert torch.equal(ki.imatmul_in_tile(a, b, tile), want)
    assert torch.equal(ki.imatmul(a, b), want)
    buf = torch.empty(m * k + 1, dtype=dtype, device="cuda")
    buf[1:] = a.reshape(-1)
    assert torch.equal(ki.imatmul(buf[1:].view(m, k), b), want)
    counts = pmxm.indicator_counts(a > 0, b > 0)
    assert torch.equal(counts, ((a > 0).int().cpu() @ (b > 0).int().cpu()).cuda())


@pytest.mark.cuda
def test_cuda_integer_products_in_a_cuda_graph(card):
    """A compiled function's integer products (gb_imatmul, torch._int_mm)
    are captured in its CUDA graph: its replays launch gb_imatmul and give
    the CPU's results."""
    from graphblas_tpu_torch import kernels

    with P.tx.config.set(platform="cpu"):
        want = compiled_products(P)
    with P.tx.config.set(platform="cuda"):
        kernels.reset_counts()

        @P.compile
        def step(A, B):
            C = A.mxm(B, P.semiring.plus_times[P.dtypes.INT32]).new()
            return C, A.mxm(C, P.semiring.plus_pair[P.dtypes.INT16]).new()

        t = P.dtypes.INT32
        A = P.Matrix.from_coo(*coo((24, 24), 0.5, np.int32, 6), t, nrows=24, ncols=24)
        B = P.Matrix.from_coo(*coo((24, 24), 0.5, np.int32, 7), t, nrows=24, ncols=24)
        got = [x.to_coo() for pair in (step(A, B), step(B, A)) for x in pair]
        assert next(iter(step._cache.values())).capture == "graph"
        # the warm step's launch, then one a replay (the capture launches nothing)
        assert kernels.launch_counts()["imatmul"] == 3 and kernels.plain_counts()["imatmul"] == 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)

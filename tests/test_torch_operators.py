"""Parity of the port's operator system (``graphblas_tpu_torch``'s ``unary``,
``binary``, ``monoid``, ``semiring``, ``indexunary``, ``indexbinary``,
``select``, ``op``, ``agg`` and ``dtypes`` namespaces, and the four
``*.numpy`` ones) with the JAX package's.

The names test enumerates the reference's registry; every other test is
parametrised by op name over the port's (which the names test holds equal).
For each name: the same typed ops per input type, the same return types,
coercions, and monoid identities (bit for bit); and the same values on
numpy-made inputs that hold 0, -1, INT_MIN/INT_MAX, the unsigned top bit,
+-0.0, +-inf and NaN (complex inputs: finite values, the two libraries'
complex functions differ at infinities and on branch cuts by design).

Tolerance (``BASELINE.md``'s parity rule): integers and bool bit for bit;
floats within 1e-6 relative, NaN for NaN, and results below the type's
smallest normal read as 0 (XLA's CPU flushes float32 denormals).  Looser,
where the reference's and torch's transcendental functions differ, with
what was found (``LOOSE``).  The JAX package is imported by the ``ref``
fixture, not at import time.
"""

import importlib
import subprocess
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P
from graphblas_tpu_torch.core import dtypes as pdt

NAMESPACES = ["unary", "binary", "monoid", "semiring", "indexunary", "indexbinary", "select", "op", "agg", "dtypes"]
NUMPY = ["unary", "binary", "monoid", "semiring"]
TYPES = ["BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64", "FP32", "FP64", "FC32", "FC64"]

# name -> (rtol, atol) beyond 1e-6 relative; what was found on these inputs
LOOSE = {
    # FP32 at x = 64: XLA's result is 10 ulp from the true value, torch's 4
    # ulp (14 ulp apart, 1.4e-6 relative)
    "sinh": (2e-6, 0.0),
    "cosh": (2e-6, 0.0),
    # XLA's float32 lgamma: 4.8e-7 at x = 1 (torch: 0, exact) and 3.3e-6
    # relative at x = 2.5
    "lgamma": (5e-6, 1e-6),
    # float64 lgamma of XLA and torch differ by ulps; exp of it amplifies
    # them to 7.6e-6 relative at results near 2^31
    "binom": (1e-5, 0.0),
    # complex pow, logaddexp, logaddexp2 (FC32): up to 4e-6 relative
    "pow": (1e-5, 0.0),
    "rpow": (1e-5, 0.0),
    "power": (1e-5, 0.0),
    "float_power": (1e-5, 0.0),
    "logaddexp": (1e-5, 0.0),
    # complex arctan2 (FC32, computed in complex64 by both): 1.5e-6 relative
    "arctan2": (2e-6, 0.0),
    # XLA's float32 exp2 at 2^127: 3.1e-6 relative
    "exp2": (4e-6, 0.0),
    # near-zero results of log1p(exp2(.)) differ absolutely: 1.1e-8 (FP32),
    # 4.8e-17 (FP64)
    "logaddexp2": (1e-5, 1.2e-7),
}


@pytest.fixture(scope="module")
def ref():
    """The JAX package and jax.numpy.  The port's ``mapnumpy`` follows the
    reference's, which the test harness draws at random."""
    jnp = pytest.importorskip("jax.numpy")
    import graphblas_tpu as R

    P.config["mapnumpy"] = R.config.get("mapnumpy")
    return SimpleNamespace(R=R, jnp=jnp)


def _contains(op, t):
    """``t in op``, where the reference may raise (it reports a UDF that
    fails to trace for a type as an error, not as False)."""
    try:
        return t in op
    except Exception:
        return False


def _port_ns(name):
    return importlib.import_module(f"graphblas_tpu_torch.{name}")


def _ref_ns(name):
    return importlib.import_module(f"graphblas_tpu.{name}")


def _numpy_names(ns):
    mod = _port_ns(f"{ns}.numpy")
    return list(getattr(mod, "_UFUNC_NAMES", None) or mod.__all__)


def specials(dt):
    """Values of ``dt`` (numpy) with the edge cases of its kind."""
    npt = np.dtype(dt.np_type)
    rng = np.random.default_rng(7)
    if npt == np.bool_:
        return np.array([True, False])
    if npt.kind == "i":
        ii = np.iinfo(npt)
        edge = [0, 1, -1, 2, 3, -3, 7, 5, ii.min, ii.max, ii.min + 1, ii.max - 1]
        return np.array(edge + list(rng.integers(ii.min // 2, ii.max // 2, 4)), npt)
    if npt.kind == "u":
        ii = np.iinfo(npt)
        top = 1 << (npt.itemsize * 8 - 1)
        edge = [0, 1, 2, 3, 5, 7, ii.max, ii.max - 1, top, top + 3]
        return np.array(edge + list(rng.integers(0, ii.max // 2, 4)), npt)
    if npt.kind == "f":
        return np.array([0.0, -0.0, 1.0, -1.0, 0.5, 2.5, -2.5, 3.7, -7.25, np.inf, -np.inf, np.nan, 1e-30, 1e30, 64.0], npt)
    re = np.array([1.0, -1.5, 2.5, 0.5])
    im = np.array([1.0, -2.0, 0.25])
    return np.concatenate([(re[:, None] + 1j * im[None, :]).ravel(), [1j, 1.5, -2j]]).astype(npt)


def assert_same(want, got, ret, name):
    want = np.asarray(want)
    assert want.dtype == ret.np_type, (name, want.dtype, ret)
    assert got.dtype == ret.np_type, (name, got.dtype, ret)
    loose = LOOSE.get(name.split("[")[0].removeprefix("numpy."))
    if ret.np_type.kind in "biu":
        if loose is None:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:  # binom: an integer rounded from a float64 lgamma
            np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=loose[0], err_msg=name)
        return
    rtol, atol = loose or (1e-6, 0.0)
    if ret.np_type.kind == "c":  # relative to the complex magnitude
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        if name.startswith("numpy.arctan2"):
            # an angle: -pi and +pi on the branch cut are one value, and the
            # two libraries' complex64 rounding lands on either side
            turn = np.round((got.real - want.real) / (2 * np.pi)) * 2 * np.pi
            got = (got.real - turn + 1j * got.imag).astype(got.dtype)
        ok = np.isnan(want) | (got == want) | (np.abs(got - want) <= rtol * np.abs(want) + atol)
        assert ok.all(), (name, got[~ok], want[~ok])
        return
    tiny = np.finfo(ret.np_type).tiny
    w = np.where(np.abs(want) < tiny, 0, want)
    g = np.where(np.abs(got) < tiny, 0, got)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True, err_msg=name)


def _fixed(x, n):
    """``x`` padded to ``n`` slots by repeating its head: one array shape for
    every op and type, so the reference's eager jnp compiles each primitive
    once per type."""
    return np.concatenate([x, np.resize(x, n - len(x))])


def _inputs(dt, nargs, name):
    v = specials(dt)
    if name.endswith(("gcd", "lcm")) and dt._is_signed_int:
        # the reference's gcd loops forever where |INT_MIN| wraps negative
        v = v[v != np.iinfo(dt.np_type).min]
    if nargs == 1:
        return [_fixed(v, 16)]
    a, b = np.meshgrid(v, v)
    return [_fixed(a.ravel(), 256), _fixed(b.ravel(), 256)]


def _check_values(ref, rop, pop, nargs, label):
    for dtn in [t.name for t in rop.types]:
        rt, pt = rop[dtn], pop[dtn]
        if rt.fn is None:
            assert pt.fn is None, label  # positional: the engine supplies indices
            continue
        dt = pdt.lookup_dtype(dtn)
        args = _inputs(dt, nargs, label)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = rt.fn(*[ref.jnp.asarray(x) for x in args])
        got = pdt.to_numpy(pt.fn(*[pdt.to_tensor(x, dt) for x in args]), pt.return_type)
        assert_same(want, got, pt.return_type, f"{label}[{dtn}]")


def _types(op):
    return {k.name: v.name for k, v in op.types.items()}


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_names(ref):
    """The public names of each reference namespace and its builtin ops, from
    a fresh interpreter: other test files register operators into the
    reference's namespaces and import its numpy modules in this process."""
    import json

    code = (
        "import importlib, json, sys; out = {}\n"
        "for ns in sys.argv[1:]:\n"
        "    m = importlib.import_module('graphblas_tpu.' + ns)\n"
        "    names = getattr(m, '_UFUNC_NAMES', None) or getattr(m, '__all__', None) if ns.endswith('.numpy') else None\n"
        "    out[ns] = [list(names or [n for n in dir(m) if not n.startswith('_')]), sorted(getattr(m, '_ops', {}))]\n"
        "print(json.dumps(out))"
    )
    spaces = NAMESPACES + [f"{n}.numpy" for n in NUMPY]
    proc = subprocess.run([sys.executable, "-c", code, *spaces], capture_output=True, text=True, env=_env())
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("ns", NAMESPACES + [f"{n}.numpy" for n in NUMPY])
def test_namespace_names_match_reference(ref_names, ns):
    """Every public name of the reference's namespace is in the port's; the
    numpy namespaces list the same ufunc names; the builtin registries hold
    the same names."""
    rnames, rops = ref_names[ns]
    pmod = _port_ns(ns)
    if ns.endswith(".numpy"):
        assert _numpy_names(ns.split(".")[0]) == rnames
    missing = [n for n in rnames if not hasattr(pmod, n)]
    assert not missing
    if rops and ns != "semiring":  # semiring names resolve lazily: _ops grows on use
        assert sorted(pmod._ops) == rops


def test_numpy_namespaces_load_as_the_reference_loads_them():
    """``binary.numpy`` and ``unary.numpy`` load on attribute access;
    ``monoid.numpy`` and ``semiring.numpy`` need their own import, in both
    packages (each checked in a fresh interpreter)."""
    code = (
        "import importlib, sys; pkg = importlib.import_module(sys.argv[1]);"
        "out = [hasattr(getattr(pkg, ns), 'numpy') for ns in ('unary', 'binary', 'monoid', 'semiring')];"
        "importlib.import_module(sys.argv[1] + '.semiring.numpy'); importlib.import_module(sys.argv[1] + '.monoid.numpy');"
        "out += [hasattr(getattr(pkg, ns), 'numpy') for ns in ('monoid', 'semiring')]; print(out)"
    )
    got = {}
    for pkg in ("graphblas_tpu", "graphblas_tpu_torch"):
        proc = subprocess.run([sys.executable, "-c", code, pkg], capture_output=True, text=True, env=_env())
        assert proc.returncode == 0, proc.stderr
        got[pkg] = proc.stdout.strip()
    assert got["graphblas_tpu_torch"] == got["graphblas_tpu"] == "[True, True, False, False, True, True]"


def _env():
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(P.__file__)))
    env["JAX_PLATFORMS"] = "cpu"
    return env


# ---------------------------------------------------------------------------
# builtin typed ops: types, identities, values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(P.unary._ops))
def test_unary_matches_reference(ref, name):
    rop, pop = getattr(ref.R.unary, name), getattr(P.unary, name)
    assert _types(rop) == _types(pop)
    assert _types(SimpleNamespace(types=rop.coercions)) == _types(SimpleNamespace(types=pop.coercions))
    assert rop.positional == pop.positional
    _check_values(ref, rop, pop, 1, name)


@pytest.mark.parametrize("name", sorted(n for n, op in P.binary._ops.items() if hasattr(op, "types")))
def test_binary_matches_reference(ref, name):
    rop, pop = getattr(ref.R.binary, name), getattr(P.binary, name)
    assert _types(rop) == _types(pop)
    assert _types(SimpleNamespace(types=rop.coercions)) == _types(SimpleNamespace(types=pop.coercions))
    assert rop._commutes_to_name == pop._commutes_to_name and rop._needs_safe_fill == pop._needs_safe_fill
    assert rop.positional == pop.positional
    _check_values(ref, rop, pop, 2, name)


def _same_scalar(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _check_monoid(ref, rop, pop, label):
    assert _types(rop) == _types(pop), label
    assert _types(SimpleNamespace(types=rop.coercions)) == _types(SimpleNamespace(types=pop.coercions)), label
    assert rop.is_idempotent == pop.is_idempotent
    for dt in rop.types:
        assert _same_scalar(rop[dt.name].identity, pop[dt.name].identity), (label, dt)
    _check_values(ref, rop, pop, 2, label)


@pytest.mark.parametrize("name", sorted(P.monoid._ops))
def test_monoid_matches_reference(ref, name):
    _check_monoid(ref, getattr(ref.R.monoid, name), getattr(P.monoid, name), name)


@pytest.mark.parametrize("name", sorted(P.semiring._ops))
def test_semiring_matches_reference(ref, name):
    rop, pop = getattr(ref.R.semiring, name), getattr(P.semiring, name)
    for t in TYPES:
        assert (t in rop) == (t in pop), (name, t)
        if t in rop:
            a, b = rop[t], pop[t]
            fields = ("return_type", "type_", "type2")
            assert [getattr(a, f).name for f in fields] == [getattr(b, f).name for f in fields], (name, t)
            assert (a.monoid.parent.name, a.monoid.type_.name) == (b.monoid.parent.name, b.monoid.type_.name)
            assert (a.binaryop.parent.name, a.binaryop.type_.name) == (b.binaryop.parent.name, b.binaryop.type_.name)
            assert a.is_positional == b.is_positional


def _index_inputs(ref, dt, thunk_int):
    v = specials(dt)
    i = np.arange(len(v), dtype=np.int64) % 5
    j = (np.arange(len(v), dtype=np.int64) * 3) % 7
    t = np.full(len(v), 2, np.int64) if thunk_int else np.full(len(v), v[len(v) // 2], v.dtype)
    return (v, i, j, t), (pdt.to_tensor(v, dt), torch.from_numpy(i), torch.from_numpy(j), pdt.to_tensor(t, pdt.INT64 if thunk_int else dt))


@pytest.mark.parametrize("kind", ["indexunary", "select"])
def test_index_ops_match_reference(ref, kind):
    rmod, pmod = getattr(ref.R, kind), getattr(P, kind)
    assert sorted(rmod._ops) == sorted(pmod._ops)
    for name in sorted(pmod._ops):
        rop, pop = getattr(rmod, name), getattr(pmod, name)
        assert _types(rop) == _types(pop), name
        assert rop.positional == pop.positional
        assert getattr(rop._thunk_dtype, "name", None) == getattr(pop._thunk_dtype, "name", None)
        for dtn in [t.name for t in rop.types]:
            dt = pdt.lookup_dtype(dtn)
            rargs, pargs = _index_inputs(ref, dt, pop._thunk_dtype is not None)
            want = np.asarray(rop[dtn].fn(*[ref.jnp.asarray(a) for a in rargs]))
            got = pdt.to_numpy(pop[dtn].fn(*pargs), pop[dtn].return_type)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind}.{name}[{dtn}]")


@pytest.mark.parametrize("name", sorted(P.agg._ops))
def test_aggregator_matches_reference(ref, name):
    """Types and the pre-apply op of each monoid-family recipe; applying an
    aggregator needs a collection (queue 3) and raises until then."""
    rop, pop = getattr(ref.R.agg, name), getattr(P.agg, name)
    assert _types(rop) == _types(pop)
    assert rop._monoid_name == pop._monoid_name and rop._composite == pop._composite
    assert (rop._finalize is None) == (pop._finalize is None)
    if pop._pre is not None:
        for dt in rop.types:
            a, b = rop._pre(dt), pop._pre(pdt.lookup_dtype(dt.name))
            assert (a.type_.name, a.return_type.name) == (b.type_.name, b.return_type.name), (name, dt)
    if pop._finalize is not None:
        x = np.array([0.25, 4.0, 2.0])
        np.testing.assert_allclose(pop._finalize(torch.from_numpy(x)).numpy(), np.asarray(rop._finalize(ref.jnp.asarray(x))), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="queue 3"):
        pop(object())


@pytest.mark.parametrize("ns", NUMPY[:2])
def test_numpy_ops_match_reference(ref, ns):
    """The numpy-named unary and binary ops (``mapnumpy`` on: the aliased
    builtins and the rest), per name."""
    rmod, pmod = _ref_ns(f"{ns}.numpy"), _port_ns(f"{ns}.numpy")
    nargs = 1 if ns == "unary" else 2
    for name in _numpy_names(ns):
        rop, pop = getattr(rmod, name), getattr(pmod, name)
        assert _types(rop) == _types(pop), name
        assert rop.name == pop.name and rop._modname == pop._modname
        if pop is getattr(P, ns)._ops.get(pop.name):
            continue  # an alias of a builtin, whose values its own test holds
        _check_values(ref, rop, pop, nargs, pop.name)


def test_numpy_monoids_and_semirings_match_reference(ref):
    rmod, pmod = _ref_ns("monoid.numpy"), _port_ns("monoid.numpy")
    for name in _numpy_names("monoid"):
        _check_monoid(ref, getattr(rmod, name), getattr(pmod, name), f"numpy.{name}")
    rsr, psr = _ref_ns("semiring.numpy"), _port_ns("semiring.numpy")
    for name in _numpy_names("semiring")[::7]:
        a, b = getattr(rsr, name), getattr(psr, name)
        assert a.name == b.name
        for t in TYPES:
            assert _contains(a, t) == _contains(b, t), (name, t)
            if _contains(a, t):
                assert (a[t].return_type.name, a[t].type_.name) == (b[t].return_type.name, b[t].type_.name), (name, t)


# ---------------------------------------------------------------------------
# integer division at its edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["div", "cdiv", "rdiv", "floordiv", "rfloordiv", "truediv", "rtruediv", "numpy.mod", "numpy.remainder", "numpy.floor_divide", "numpy.fmod"])
def test_integer_division_edges(ref, name):
    """Divisors 0 and -1 and INT_MIN dividends, on every type of each family:
    the reference's values (cdiv: 0 for y == 0, INT_MIN / -1 wraps to
    INT_MIN), with neither torch's CPU nor its CUDA integer division behind
    them."""
    if name.startswith("numpy."):
        rop, pop = getattr(_ref_ns("binary.numpy"), name[6:]), getattr(_port_ns("binary.numpy"), name[6:])
    else:
        rop, pop = getattr(ref.R.binary, name), getattr(P.binary, name)
    assert _types(rop) == _types(pop)
    for dt in rop.types:
        pt_dt = pdt.lookup_dtype(dt.name)
        npt = np.dtype(dt.np_type)
        if npt.kind in "iu":
            lo = np.iinfo(npt).min
            x = np.array([lo, lo, lo, 7, -7, 0, 1, lo + 1, 5] if npt.kind == "i" else [0, 7, 1, np.iinfo(npt).max, 5, 0], npt)
            y = np.array([-1, 0, 1, 0, -1, 0, -1, -1, 2] if npt.kind == "i" else [0, 0, 1, 0, 2, 3], npt)
        elif npt.kind == "b":
            x, y = np.array([True, False, True]), np.array([False, False, True])
        elif npt.kind == "f":
            x = np.array([1.0, -1.0, 0.0, 7.0, -7.0, np.inf], npt)
            y = np.array([0.0, -0.0, 0.0, -1.0, 2.0, 3.0], npt)
        else:  # complex division by 0 differs (ROADMAP.md section 3): nonzero divisors
            x = np.array([1.0, -1.0 + 2j, 0.0, 7.0, -7.0j, 3.5], npt)
            y = np.array([1j, -0.5, 2.0 - 1j, -1.0, 2.0, 3.0], npt)
        for a, b in ((x, y), (y, x)):
            want = rop[dt].fn(ref.jnp.asarray(a), ref.jnp.asarray(b))
            got = pop[pt_dt].fn(pdt.to_tensor(a, pt_dt), pdt.to_tensor(b, pt_dt))
            assert_same(want, pdt.to_numpy(got, pop[pt_dt].return_type), pop[pt_dt].return_type, f"{name}[{dt}]")


# ---------------------------------------------------------------------------
# user-defined operators
# ---------------------------------------------------------------------------

# one Python lambda each, run on jnp arrays by the reference and on torch
# tensors by the port
UDFS = {
    "axpy_ish": lambda x, y: x * 2 + y,
    "scaled": lambda x, y: x * 1.5 + y,
    "greater": lambda x, y: x > y,
    "absdiff": lambda x, y: abs(x - y),
}


@pytest.mark.parametrize("udf", sorted(UDFS))
def test_udf_binary_monoid_semiring_match_reference(ref, udf):
    """register_anonymous and register_new of a binary op, a monoid and a
    semiring over the same lambda: the same typed ops, return types and
    values (the reference types by tracing, the port by evaluating on typed
    one-element tensors)."""
    func = UDFS[udf]
    rb = ref.R.binary.register_anonymous(func, f"udf_{udf}")
    pb = P.binary.register_anonymous(func, f"udf_{udf}")
    assert _types(rb) == _types(pb)
    _check_values(ref, rb, pb, 2, f"udf_{udf}")
    name = f"udf_{udf}_{abs(hash(udf)) % 10**6}"
    rn = ref.R.binary.register_new(name, func)
    pn = P.binary.register_new(name, func)
    assert getattr(P.binary, name) is pn and _types(rn) == _types(pn)
    if udf == "axpy_ish":  # not associative with an identity: no monoid
        return
    ident = {"scaled": 0, "greater": False, "absdiff": 0}[udf]
    rm = ref.R.monoid.register_anonymous(rb, ident)
    pm = P.monoid.register_anonymous(pb, ident)
    assert _types(rm) == _types(pm)
    for dt in rm.types:
        assert _same_scalar(rm[dt.name].identity, pm[dt.name].identity)
    rs = ref.R.semiring.register_anonymous(rm, ref.R.binary.times)
    ps = P.semiring.register_anonymous(pm, P.binary.times)
    for t in TYPES:
        assert (t in rs) == (t in ps)
        if t in rs:
            assert rs[t].return_type.name == ps[t].return_type.name


def test_udf_monoid_register_new_and_udt(ref):
    """A user integer monoid by register_new, and a UDF over a UDT (a dict of
    field tensors, as the reference's struct of arrays)."""
    name = "port_test_bxor_plus1"
    func = lambda x, y: (x ^ y) + 0  # noqa: E731
    rm = ref.R.monoid.register_new(name, ref.R.binary.register_anonymous(func, name), 0)
    pm = P.monoid.register_new(name, P.binary.register_anonymous(func, name), 0)
    assert getattr(P.monoid, name) is pm and _types(rm) == _types(pm)
    _check_values(ref, rm, pm, 2, name)
    fields = [("a", np.int32), ("b", np.float64)]
    rudt = ref.R.dtypes.register_anonymous(np.dtype(fields))
    pudt = P.dtypes.register_anonymous(np.dtype(fields))
    assert rudt.name == pudt.name and rudt.np_type == pudt.np_type
    func = lambda x, y: {"a": x["a"] + y["a"], "b": x["b"] * y["b"]}  # noqa: E731
    rop, pop = ref.R.binary.register_anonymous(func, "udt_add"), P.binary.register_anonymous(func, "udt_add")
    rt, pt = rop[rudt], pop[pudt]
    assert rt.return_type.np_type == pt.return_type.np_type
    x = np.array([(1, 2.5), (-3, 0.5), (7, -1.0)], np.dtype(fields))
    y = np.array([(4, 2.0), (3, 8.0), (2147483647, 3.0)], np.dtype(fields))
    want = rt.fn({f: ref.jnp.asarray(x[f]) for f in x.dtype.names}, {f: ref.jnp.asarray(y[f]) for f in y.dtype.names})
    got = pt.fn(pdt.to_tensor(x, pudt), pdt.to_tensor(y, pudt))
    for f in x.dtype.names:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))


def test_udf_return_types_follow_jax_promotion(ref):
    """Return types where torch's own promotion differs from JAX's under x64:
    a Python float on an integer (FP64, torch alone says float32), unsigned
    types on their wider carriers, an explicit conversion, a positional UDF
    mixing the value with INT64 indices."""
    import torch as t

    cases = [
        (lambda x: x * 1.5, lambda x: x * 1.5),
        (lambda x: x + 1, lambda x: x + 1),
        (lambda x: (x != 0).astype(np.int64), lambda x: (x != 0).to(t.int64)),
        (lambda x: x * x, lambda x: x * x),
    ]
    for rf, pf in cases:
        ro, po = ref.R.unary.register_anonymous(rf), P.unary.register_anonymous(pf)
        assert _types(ro) == _types(po)
    ri = ref.R.indexunary.register_anonymous(lambda v, i, j, th: v + i)
    pi = P.indexunary.register_anonymous(lambda v, i, j, th: v + i)
    assert _types(ri) == _types(pi)

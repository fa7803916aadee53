"""Parity of the port's dense-masked engine with the JAX package's, part
two: the semiring matmul family (``mxm``, ``mxv``, ``vxm``, ``kronecker``),
the tropical dispatch, and the mask/accumulator merge (``masked_merge``,
``mask_to_bits``), called directly.

The inputs, the comparison and its tolerances are those of
``test_torch_densemasked.py`` (its helpers): integers and bool exactly,
floats within 1e-6 relative or bit for bit where both sides compute the same
float operations in the same order (the generic contraction, the tropical
matmul); float plus over a matmul within 1e-5, because ``torch.matmul`` and
XLA's dot sum the k products in their own orders.  ``mxm_strategy`` is
passed explicitly on both sides.  The JAX package is imported by the ``ref``
fixture, not at import time.
"""

import numpy as np
import pytest
import torch
from test_torch_densemasked import assert_same, both, operand, reference

import graphblas_tpu_torch as P
from graphblas_tpu_torch import kernels
from graphblas_tpu_torch.core import dtypes as pdt
from graphblas_tpu_torch.core.operator import get_typed_op as pget
from graphblas_tpu_torch.ops import densemasked as pdm
from graphblas_tpu_torch.ops import mxm as pmxm


@pytest.fixture(scope="module")
def ref():
    return reference()


# ---------------------------------------------------------------------------
# semiring matmul family
# ---------------------------------------------------------------------------

SEMIRINGS = [
    "plus_times", "plus_pair", "plus_first", "plus_second", "min_plus", "max_plus", "min_max", "max_min",
    "any_pair", "lor_land", "lxor_pair", "min_first", "max_second", "times_times", "plus_min", "bor_band",
    "any_secondi", "min_firstj", "plus_firsti", "max_secondj1",
]
FLOAT_PLUS = {"plus_times", "plus_first", "plus_second", "plus_min"}


STRATEGY_CASES = [(name, "auto") for name in SEMIRINGS] + [
    (name, strategy) for name in ("plus_times", "plus_pair", "min_plus", "any_pair", "lxor_pair") for strategy in ("mxu", "generic", "pallas")
]
MXM_TYPES = ["BOOL", "INT8", "INT32", "UINT16", "UINT64", "FP32", "FP64", "FC64"]


@pytest.mark.parametrize("name, strategy", STRATEGY_CASES)
def test_mxm_mxv_vxm_match_reference(ref, name, strategy):
    """Every strategy on CPU operands: the matmul forms (floats, overlap
    counts), the generic contraction (integers, the rest; k = 150 crosses a
    chunk), and the tropical semirings, which take the generic path on CPU
    tensors in both packages.  Each semiring runs over four of the types
    (rotating), mxv and vxm over two."""
    rng = np.random.default_rng(17)
    psr, rsr = getattr(P.semiring, name), getattr(ref.R.semiring, name)
    start = SEMIRINGS.index(name) + ("auto", "mxu", "generic", "pallas").index(strategy)
    types = [t for t in MXM_TYPES if t in psr]
    types = [types[(start + i) % len(types)] for i in range(min(4, len(types)))]
    for which, dtn in enumerate(types):
        if dtn not in psr:
            continue
        pt, rt = pget(psr, dtn, dtn, kind="semiring"), ref.get(rsr, dtn, dtn, kind="semiring")
        m, k, n = (5, 150, 4) if dtn in ("INT32", "FP32") else (4, 7, 3)
        a = operand(pt.binaryop.type_.name, (m, k), rng, special=False)
        b = operand(pt.binaryop.type2.name, (k, n), rng, special=False)
        (ra, ras), (pa, pas) = both(ref, *a, pt.binaryop.type_.name)
        (rb, rbs), (pb, pbs) = both(ref, *b, pt.binaryop.type2.name)
        out = pt.return_type
        rtol = 1e-5 if name in FLOAT_PLUS else 1e-6
        label = f"{name}[{dtn}] {strategy}"
        assert_same(pdm.mxm(pa, pas, pb, pbs, pt, out, strategy), ref.dm.mxm(ra, ras, rb, rbs, rt, rt.return_type, strategy), out.name, label, rtol=rtol)
        if which >= 2:
            continue
        x = operand(pt.binaryop.type2.name, (k,), rng, special=False)
        (rx, rxs), (px, pxs) = both(ref, *x, pt.binaryop.type2.name)
        assert_same(pdm.mxv(pa, pas, px, pxs, pt, out, strategy), ref.dm.mxv(ra, ras, rx, rxs, rt, rt.return_type, strategy), out.name, f"mxv {label}", rtol=rtol)
        y = operand(pt.binaryop.type_.name, (k,), rng, special=False)
        (ry, rys), (py, pys) = both(ref, *y, pt.binaryop.type_.name)
        assert_same(pdm.vxm(py, pys, pb, pbs, pt, out, strategy), ref.dm.vxm(ry, rys, rb, rbs, rt, rt.return_type, strategy), out.name, f"vxm {label}", rtol=rtol)


def test_tropical_dispatch_forced_on_cpu_is_the_reference_generic_path(ref):
    """``ops.mxm.tropical_mxm`` on CPU tensors (the plain version of
    gb_tropical) against the reference's generic contraction: bit for bit,
    for the four tropical semirings over float32 with NaN-free inputs."""
    rng = np.random.default_rng(19)
    kernels.reset_counts()
    for add, mul in (("min", "plus"), ("max", "plus"), ("min", "max"), ("max", "min")):
        name = f"{add}_{mul}"
        rt = ref.get(getattr(ref.R.semiring, name), "FP32", "FP32", kind="semiring")
        a = operand("FP32", (33, 150), rng, 0.3, special=False)
        b = operand("FP32", (150, 21), rng, 0.3, special=False)
        (ra, ras), (pa, pas) = both(ref, *a, "FP32")
        (rb, rbs), (pb, pbs) = both(ref, *b, "FP32")
        pv, ps = pmxm.tropical_mxm(pa, pas, pb, pbs, add, mul, torch.float32)
        assert_same(pdm.canonical(pv, ps), ref.dm.mxm(ra, ras, rb, rbs, rt, rt.return_type, "generic"), "FP32", name, bits=True)
    assert kernels.plain_counts()["tropical_mxm"] == 4 and kernels.launch_counts()["tropical_mxm"] == 0


def test_tropical_dispatch_conditions():
    """The engine takes the kernel only for CUDA operands; on CPU tensors
    every strategy keeps the reference's CPU path."""
    sr = pget(P.semiring.min_plus, "FP32", "FP32", kind="semiring")
    a = torch.zeros(128, 128)
    assert not pdm._tropical_allowed(sr, pdt.FP32, 128, 128, "auto", a, a)
    assert not pdm._tropical_allowed(sr, pdt.FP32, 128, 128, "pallas", a, a)
    meta = torch.zeros(128, 128, device="meta")
    assert not pdm._tropical_allowed(sr, pdt.FP32, 128, 128, "auto", meta, meta)


@pytest.mark.parametrize("name", ["times", "plus", "first", "div", "lt", "secondj"])
def test_kronecker_matches_reference(ref, name):
    rng = np.random.default_rng(23)
    for dtn in ["INT16", "FP32"] if name in ("times", "plus") else ["UINT32"]:
        pop, rop = getattr(P.binary, name), getattr(ref.R.binary, name)
        if dtn not in pop:
            continue
        pt, rt = pget(pop, dtn, kind="binary"), ref.get(rop, dtn, kind="binary")
        a, b = operand(pt.type_.name, (2, 3), rng), operand(pt.type2.name, (3, 2), rng)
        (ra, ras), (pa, pas) = both(ref, *a, pt.type_.name)
        (rb, rbs), (pb, pbs) = both(ref, *b, pt.type2.name)
        if pt.is_positional:
            continue
        assert_same(pdm.kronecker(pa, pas, pb, pbs, pt, pt.return_type), ref.dm.kronecker(ra, ras, rb, rbs, rt, rt.return_type), pt.return_type.name, f"{name}[{dtn}]")


# ---------------------------------------------------------------------------
# extract / assign / merge / masks
# ---------------------------------------------------------------------------




# ---------------------------------------------------------------------------
# the mask / accumulator merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [None, "plus", "minus", "second", "min"])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("region", [False, True])
def test_masked_merge_matches_reference(ref, accum, replace, region):
    """Every mask kind (none, and the four resolved by mask_to_bits) x accum
    x replace, with and without an assign region; Z of another type than
    C (converted to C's type first, as the reference does)."""
    rng = np.random.default_rng(31 + replace + 2 * region)
    pairs = (("INT32", "FP64"), ("FP32", "FP32"), ("UINT8", "INT16"))
    for ctn, ztn in pairs[(replace + 2 * region + (accum is None)) % 3 :][:1]:
        c, z, mk = operand(ctn, (5, 6), rng, special=False), operand(ztn, (5, 6), rng, special=False), operand("INT8", (5, 6), rng)
        (rc, rcs), (pc, pcs) = both(ref, *c, ctn)
        (rz, rzs), (pz, pzs) = both(ref, *z, ztn)
        (rm, rms), (pm, pms) = both(ref, *mk, "INT8")
        reg = rng.random((5, 6)) < 0.5
        rreg, preg = (ref.jnp.asarray(reg), torch.from_numpy(reg)) if region else (None, None)
        pacc = None if accum is None else pget(getattr(P.binary, accum), ctn, kind="binary")
        racc = None if accum is None else ref.get(getattr(ref.R.binary, accum), ctn, kind="binary")
        rzc = rz.astype(rc.dtype)
        for has_mask in (False, True):
            for comp in (False, True):
                for structural in (False, True):
                    pbits = pdm.mask_to_bits(pm, pms, comp, structural)
                    rbits = ref.dm.mask_to_bits(rm, rms, comp, structural)
                    np.testing.assert_array_equal(pbits.numpy(), np.asarray(rbits))
                    label = f"{ctn}<-{ztn} accum={accum} replace={replace} region={region} mask={has_mask, comp, structural}"
                    if replace and not has_mask:
                        continue
                    got = pdm.masked_merge(pc, pcs, pz, pzs, pbits, pacc, replace, has_mask, preg, c_type=pdt.lookup_dtype(ctn), z_type=pdt.lookup_dtype(ztn))
                    want = ref.dm.masked_merge(rc, rcs, rzc, rzs, rbits, racc, replace, has_mask, rreg)
                    assert_same(got, want, ctn, label)



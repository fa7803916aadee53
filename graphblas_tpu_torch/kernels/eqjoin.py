"""The eqjoin kernel and the compare-rate probe (``csrc/eqjoin.cu``).

- ``eqjoin`` replaces ``graphblas_tpu/ops/pallas_eqjoin.py:eqjoin``: per task
  t, ADD over (k, l) with ``akT[k, t] == bkT[l, t]`` of
  ``MUL(avT[k, t], bvT[l, t])``, and the match count; the value is 0 where
  nothing matched.  Pad keys -1 (A) and -2 (B) never match.  The kernel runs
  a bucket one thread a task or g lanes a task, as ``lanes_per_task`` picks
  from (Wa, Wb, T); ``eqjoin_in_layout`` runs any layout ``layouts(Wa)``
  gives (both give the same bits).
- ``compare_probe`` replaces ``graphblas_tpu/tools/profile_spgemm_roofline.py``'s
  ``vpu_kernel``: ``PROBE_K`` = 64 compare-adds per element,
  ``acc += (a == b + i)``, a measured ceiling for eqjoin's roofline.

The plain versions compute the same functions with torch broadcasts: eqjoin
as (Wa, Wb, chunk) tensors over chunks of tasks, so that no tensor passes
2^26 elements.  Float plus and times sum and multiply in another order than
the kernel's; every other add, and pair, is exact.
"""

import functools
import math

import torch

from ..core import telemetry as _telemetry
from . import _build

ADDS = ("plus", "min", "max", "any", "lor", "land", "times")  # gb_eqjoin's codes
MULS = ("pair", "times", "plus", "first", "second")
USES_AV = ("times", "plus", "first")
USES_BV = ("times", "plus", "second")
PROBE_K = 64
PLAIN_ELEMENTS = 1 << 26  # the largest broadcast of the plain eqjoin
RESIDENT_THREADS = 132 * 2048  # an H100's resident threads: 132 SMs x 2048
LANE_KEYS = (1, 2, 4, 8)  # A keys a lane holds in the lanes layout (the kernel's instances)
KERNELS = ("eqjoin", "compare_probe")  # launch counts by kernel name


def _check(akT, avT, bkT, bvT, add, mul):
    if add not in ADDS:
        raise ValueError(f"eqjoin: add {add!r} not in {ADDS}")
    if mul not in MULS:
        raise ValueError(f"eqjoin: mul {mul!r} not in {MULS}")
    if akT.dim() != 2 or bkT.dim() != 2 or akT.shape[1] != bkT.shape[1]:
        raise ValueError(f"eqjoin: akT {tuple(akT.shape)} and bkT {tuple(bkT.shape)} must be (Wa, T) and (Wb, T)")
    if akT.dtype != torch.int32 or bkT.dtype != torch.int32:
        raise TypeError("eqjoin: keys must be int32")
    for name, v, k, used in (("avT", avT, akT, mul in USES_AV), ("bvT", bvT, bkT, mul in USES_BV)):
        if not used:
            continue
        if v is None:
            raise ValueError(f"eqjoin: mul {mul!r} needs {name}")
        if v.shape != k.shape or v.dtype != torch.float32:
            raise ValueError(f"eqjoin: {name} must be float32 shaped like its keys")
    devices = {t.device for t in (akT, avT, bkT, bvT) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"eqjoin: tensors on {sorted(map(str, devices))}")


def _step(add, eq, prod):
    """The per-k accumulator over l (pallas_eqjoin.py:91-102), for a whole
    (Wa, Wb, c) block at once: reduce over l."""
    if add == "plus":
        return torch.where(eq, prod, torch.zeros((), dtype=prod.dtype, device=prod.device)).sum(1)
    if add == "min":
        return torch.where(eq, prod, math.inf).amin(1)
    if add in ("max", "any"):
        return torch.where(eq, prod, -math.inf).amax(1)
    if add == "times":
        return torch.where(eq, prod, 1.0).prod(1)
    if add == "lor":
        return (eq & (prod != 0)).any(1).to(torch.float32)
    return (~eq | (prod != 0)).all(1).to(torch.float32)  # land


def _combine(add, acc):
    """The combine over k (pallas_eqjoin.py:110-120); a k without a match
    holds the identity, which every combine leaves unchanged."""
    if add == "plus":
        return acc.sum(0)
    if add == "min":
        return acc.amin(0)
    if add in ("max", "any", "lor"):
        return acc.amax(0)
    return acc.prod(0)  # times, land


def eqjoin_plain(akT, avT, bkT, bvT, add, mul):
    """Plain PyTorch version of the eqjoin kernel (any device)."""
    _check(akT, avT, bkT, bvT, add, mul)
    _telemetry.count("kernels.plain.eqjoin")
    (Wa, T), Wb = akT.shape, bkT.shape[0]
    dev = akT.device
    vals = torch.empty(T, dtype=torch.float32, device=dev)
    nm = torch.empty(T, dtype=torch.int32, device=dev)
    chunk = max(1, PLAIN_ELEMENTS // (Wa * Wb))
    for s in range(0, T, chunk):
        e = min(T, s + chunk)
        eq = akT[:, None, s:e] == bkT[None, :, s:e]  # (Wa, Wb, c)
        if mul == "pair":
            prod = torch.ones((), dtype=torch.float32, device=dev).expand(eq.shape)
        else:
            a = avT[:, None, s:e] if mul in USES_AV else None
            b = bvT[None, :, s:e] if mul in USES_BV else None
            if mul == "times":
                prod = a * b
            elif mul == "plus":
                prod = a + b
            else:
                prod = (a if mul == "first" else b).expand(eq.shape)
        n = eq.sum((0, 1), dtype=torch.int32)
        val = _combine(add, _step(add, eq, prod))
        vals[s:e] = torch.where(n > 0, val, torch.zeros((), dtype=torch.float32, device=dev))
        nm[s:e] = n
    return vals, nm


def _layout_cost(Wa, Wb, T, g):
    """A task's instructions in layout g over the share of the card its
    threads keep busy, in arbitrary units.  One thread a task: Wa * Wb
    compares, busy from 132 x 128 threads (16 A keys in registers give each
    thread ILP enough).  g lanes a task: 0.85 as much per compare (B's keys
    read by broadcast from shared memory) and the combine handed from lane to
    lane (g hops of Wa / g + 3 steps on each of g lanes, at 0.2 of a compare
    each), busy from 132 x 512 threads.  The constants fit the per-bucket
    sweep of tools/profile_spgemm_roofline.py --sweep on an H100 (PERF.md):
    over the bench and RMAT-14 plans the picks sum within 3% of the best
    layout of each bucket."""
    if g == 1:
        return Wa * Wb / min(1.0, T / (132 * 128))
    return (0.85 * Wa * Wb + 0.2 * g * (Wa + 3 * g)) / min(1.0, T * g / (132 * 512))


@functools.lru_cache(maxsize=None)  # a pure function of ints, asked once a bucket per execute
def lanes_per_task(Wa, Wb, T):
    """The kernel's layout for a (Wa, Wb) bucket of T tasks: 1 is one thread
    a task; g > 1 is g lanes of a warp a task, each holding Wa / g of its A
    keys.  One thread a task where the tasks fill half the card's resident
    threads (its narrow buckets are bound by bytes), or give every SM a
    128-thread block while a task's work is small (Wa * Wb < 1024: the lanes'
    own loads and combine outweigh what they spread; the bench plan's (16, 4)
    and (16, 16) buckets ran 13-33% slower on lanes); otherwise the layout of
    least ``_layout_cost``."""
    if T >= RESIDENT_THREADS // 2 or (T >= 132 * 128 and Wa * Wb < 1024):
        return 1
    return min(layouts(Wa), key=lambda g: _layout_cost(Wa, Wb, T, g))


@functools.lru_cache(maxsize=None)
def layouts(Wa):
    """Every layout the kernel takes for Wa: 1, and each power of two g up
    to 32 that leaves Wa / g in ``LANE_KEYS`` (none where Wa is no power of
    two)."""
    return (1,) + tuple(g for g in (2, 4, 8, 16, 32) if Wa % g == 0 and Wa // g in LANE_KEYS)


def eqjoin(akT, avT, bkT, bvT, add, mul):
    """Batched sorted-segment intersection under a semiring.  ``akT`` (Wa, T)
    and ``bkT`` (Wb, T) int32; ``avT``/``bvT`` float32 of the same shapes, or
    None where ``mul`` ignores them.  Returns (vals (T,) float32, nmatch (T,)
    int32).  CPU tensors take the plain version; CUDA tensors launch the
    kernel, which takes Wa a multiple of 4, in the layout that
    ``lanes_per_task`` picks."""
    if akT.device.type == "cpu":
        return eqjoin_plain(akT, avT, bkT, bvT, add, mul)
    (Wa, T), Wb = akT.shape, bkT.shape[0]
    return eqjoin_in_layout(akT, avT, bkT, bvT, add, mul, lanes_per_task(Wa, Wb, T))


def eqjoin_in_layout(akT, avT, bkT, bvT, add, mul, lanes):
    """The kernel in the layout ``lanes`` (one of ``layouts(Wa)``), on CUDA
    tensors: ``eqjoin``'s launch, and a way to time or test every layout."""
    with _telemetry.span("kernels.eqjoin"):
        _check(akT, avT, bkT, bvT, add, mul)
        if akT.device.type != "cuda":
            raise RuntimeError(f"eqjoin: no kernel for device {akT.device}")
        (Wa, T), Wb = akT.shape, bkT.shape[0]
        if Wa % 4 or Wb < 1:
            raise ValueError(f"eqjoin: the kernel takes Wa a multiple of 4 and Wb >= 1, got ({Wa}, {Wb})")
        if lanes not in layouts(Wa):
            raise ValueError(f"eqjoin: {lanes} lanes a task is not a layout of Wa = {Wa}: {layouts(Wa)}")
        av = avT if mul in USES_AV else None
        bv = bvT if mul in USES_BV else None
        if not all(t.is_contiguous() for t in (akT, bkT, av, bv) if t is not None):
            raise ValueError("eqjoin: inputs must be contiguous")
        lib = _build.library()
        vals = torch.empty(T, dtype=torch.float32, device=akT.device)
        nm = torch.empty(T, dtype=torch.int32, device=akT.device)
        with torch.cuda.device(akT.device):
            rc = lib.gb_eqjoin(
                akT.data_ptr(), None if av is None else av.data_ptr(), bkT.data_ptr(),
                None if bv is None else bv.data_ptr(), vals.data_ptr(), nm.data_ptr(), Wa, Wb, T,
                ADDS.index(add), MULS.index(mul), lanes, _build.stream_of(akT),
            )
        _build.check(rc, "eqjoin")
        _telemetry.count("kernels.launches.eqjoin")
        return vals, nm


def _check_probe(a, b):
    if a.dtype != torch.float32 or b.dtype != torch.float32 or a.shape != b.shape or a.device != b.device:
        raise ValueError("compare_probe: a and b must be float32 of one shape on one device")


def compare_probe_plain(a, b):
    """Plain PyTorch version of the probe (any device): ``PROBE_K`` passes."""
    _check_probe(a, b)
    _telemetry.count("kernels.plain.compare_probe")
    acc = torch.zeros_like(a)
    for i in range(PROBE_K):
        acc = acc + (a == b + float(i)).to(torch.float32)
    return acc


def compare_probe(a, b):
    """``sum over i < PROBE_K of (a == b + i)``, elementwise, float32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return compare_probe_plain(a, b)
    with _telemetry.span("kernels.compare_probe"):
        _check_probe(a, b)
        if a.device.type != "cuda":
            raise RuntimeError(f"compare_probe: no kernel for device {a.device}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("compare_probe: inputs must be contiguous")
        lib = _build.library()
        if lib.gb_compare_probe_k() != PROBE_K:
            raise RuntimeError("compare_probe: the kernel's K differs from PROBE_K")
        out = torch.empty_like(a)
        with torch.cuda.device(a.device):
            rc = lib.gb_compare_probe(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), _build.stream_of(a))
        _build.check(rc, "compare_probe")
        _telemetry.count("kernels.launches.compare_probe")
        return out

"""The tropical matmul kernel (``csrc/tropical.cu``).

Replaces ``graphblas_tpu/ops/pallas_mxm.py:tropical_mxm_filled``:
``C[i, j] = ADD over k of MUL(a[i, k], b[k, j])`` on annihilator-filled
float32 operands, for min_plus, max_plus, min_max and max_min.  Each product
rounds once and min/max are exact, so the kernel, its plain version and the
reference agree bit for bit; min and max propagate NaN.
"""

import functools
import math

import torch

from ..core import telemetry as _telemetry
from . import _build

ADDS = ("min", "max")  # gb_tropical's codes
MULS = ("plus", "max", "min")
SEMIRINGS = (("min", "plus"), ("max", "plus"), ("min", "max"), ("max", "min"))
PLAIN_ELEMENTS = 1 << 26  # the largest (M, k-chunk, N) broadcast of the plain version
# gb_tropical's two block tiles (csrc/tropical.cu): 128 x 128 outputs of 8 x 8 a
# thread, 2 blocks an SM; 64 x 64 of 4 x 4 a thread, 4 blocks an SM.  A full wave
# of 128-tiles takes 1.24x the time of one of 64-tiles at the same K and does
# 4 times the work (min_plus 2048^3 on an NVIDIA H100 80GB HBM3, 700 W: 0.739
# ms for one wave of 256 128-tiles, 1.182-1.191 ms for two of 1024 64-tiles).
TILES = (128, 64)
BLOCKS_PER_SM = {128: 2, 64: 4}
WAVE_COST = {128: 1.24, 64: 1.0}
KERNELS = ("tropical_mxm",)  # launch counts by kernel name


def fill_value(add):
    """The add's identity, which annihilates the multiply."""
    return math.inf if add == "min" else -math.inf


def _check(a, b, add, mul):
    if (add, mul) not in SEMIRINGS:
        raise ValueError(f"tropical_mxm: ({add!r}, {mul!r}) not in {SEMIRINGS}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tropical_mxm: shapes {tuple(a.shape)} and {tuple(b.shape)} do not chain")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("tropical_mxm: operands must be float32")
    if a.device != b.device:
        raise ValueError(f"tropical_mxm: a on {a.device} but b on {b.device}")


def tropical_mxm_plain(a, b, add, mul):
    """Plain PyTorch version (any device): k-chunked broadcasts."""
    _check(a, b, add, mul)
    _telemetry.count("kernels.plain.tropical_mxm")
    (m, k), n = a.shape, b.shape[1]
    red = torch.amin if add == "min" else torch.amax
    acc_fn = torch.minimum if add == "min" else torch.maximum
    mul_fn = {"plus": torch.add, "max": torch.maximum, "min": torch.minimum}[mul]
    acc = torch.full((m, n), fill_value(add), dtype=torch.float32, device=a.device)
    kc = max(1, PLAIN_ELEMENTS // max(1, m * n))
    for s in range(0, k, kc):
        e = min(k, s + kc)
        part = mul_fn(a[:, s:e, None], b[None, s:e, :])  # (m, kc, n)
        acc = acc_fn(acc, red(part, dim=1))
    return acc


def tile_for(m, n, sms, tiles=TILES, blocks_per_sm=BLOCKS_PER_SM, wave_cost=WAVE_COST):
    """The block tile whose grid takes the fewer waves' worth of time on
    ``sms`` SMs: 128 where its tiles fill whole waves, 64 for a grid of few
    output tiles or one just past a wave (``kernels.imatmul`` passes its own
    forms)."""

    def cost(t):
        n_tiles = -(-m // t) * -(-n // t)
        return -(-n_tiles // (blocks_per_sm[t] * sms)) * wave_cost[t]

    return min(tiles, key=cost)


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def tropical_mxm(a, b, add, mul):
    """Tropical matmul of filled float32 operands a (M, K) and b (K, N).  CPU
    tensors take the plain version; CUDA tensors launch the kernel, in the
    block tile ``tile_for`` picks."""
    if a.device.type == "cpu":
        return tropical_mxm_plain(a, b, add, mul)
    _check(a, b, add, mul)
    if a.device.type != "cuda":
        raise RuntimeError(f"tropical_mxm: no kernel for device {a.device}")
    m, n = a.shape[0], b.shape[1]
    tile = tile_for(m, n, _sms(a.device.index if a.device.index is not None else torch.cuda.current_device()))
    return tropical_mxm_in_tile(a, b, add, mul, tile)


def tropical_mxm_in_tile(a, b, add, mul, tile):
    """The kernel in block tile ``tile`` (128 or 64), whatever ``tile_for``
    would pick (the tests and tools run both)."""
    with _telemetry.span("kernels.tropical_mxm"):
        _check(a, b, add, mul)
        if a.device.type != "cuda":
            raise RuntimeError(f"tropical_mxm: no kernel for device {a.device}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("tropical_mxm: operands must be contiguous")
        if tile not in TILES:
            raise ValueError(f"tropical_mxm: tile {tile} not in {TILES}")
        (m, k), n = a.shape, b.shape[1]
        if max(m, n, k) >= 2**31 or -(-m // tile) > 65535:
            raise ValueError(f"tropical_mxm: shape ({m}, {k}) x ({k}, {n}) is past the kernel's grid")
        lib = _build.library()
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        with torch.cuda.device(a.device):
            rc = lib.gb_tropical(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, ADDS.index(add), MULS.index(mul), tile,
                _build.stream_of(a),
            )
        _build.check(rc, "tropical_mxm")
        _telemetry.count("kernels.launches.tropical_mxm")
        return out

"""The integer matmul kernel (``csrc/imatmul.cu``).

``C = A @ B`` on int32 or int64 operands, in that type, products and sums
wrapping as XLA's do: the product the JAX package leaves to XLA's integer
matmul (``graphblas_tpu/ops/densemasked.py:565``).  It replaces no Pallas
kernel; ``torch.matmul`` raises on CUDA integer tensors.  Wrapping sums are
associative, so the kernel, its plain version and the reference agree bit
for bit.
"""

import functools

import torch

from ..core import telemetry as _telemetry
from . import _build
from .tropical import tile_for

PLAIN_ELEMENTS = 1 << 26  # the largest (M, k-chunk, N) broadcast of the plain version
# gb_imatmul's forms (csrc/imatmul.cu): int32 in 128 x 128 tiles of 8 x 8 a
# thread (2 blocks an SM) or 64 x 64 of 4 x 4 (4 blocks an SM), picked by the
# waves each grid needs; int64 in 64 x 64 tiles only.  A full wave of
# 128-tiles takes 1.95x the time of one of 64-tiles (int32 2048^3 on an NVIDIA
# H100 80GB HBM3, 700 W, tools/probe_kernels.py: 0.620 ms for one wave of 256
# 128-tiles, 0.635 ms for two of 1024 64-tiles)
TILES = {torch.int32: (128, 64), torch.int64: (64,)}
BLOCKS_PER_SM = {128: 2, 64: 4}
WAVE_COST = {128: 1.95, 64: 1.0}
KERNELS = ("imatmul",)  # launch counts by kernel name


def _check(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"imatmul: shapes {tuple(a.shape)} and {tuple(b.shape)} do not chain")
    if a.dtype not in TILES or b.dtype != a.dtype:
        raise TypeError(f"imatmul: operands must both be int32 or both int64, not {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"imatmul: a on {a.device} but b on {b.device}")


def imatmul_plain(a, b):
    """Plain PyTorch version (any device): k-chunked broadcast products
    summed in int64, wrapped to int32 for int32 operands (each product taken
    mod 2^32 first, so no int64 sum overflows); int64 products and sums
    wrap in int64."""
    _check(a, b)
    _telemetry.count("kernels.plain.imatmul")
    (m, k), n = a.shape, b.shape[1]
    narrow = a.dtype == torch.int32
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    acc = torch.zeros((m, n), dtype=torch.int64, device=a.device)
    kc = max(1, PLAIN_ELEMENTS // max(1, m * n))
    for s in range(0, k, kc):
        e = min(k, s + kc)
        part = a64[:, s:e, None] * b64[None, s:e, :]  # (m, kc, n)
        if narrow:
            part &= 0xFFFFFFFF
        acc += part.sum(dim=1)
        if narrow:
            acc &= 0xFFFFFFFF
    if narrow:
        acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)
    return acc


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def imatmul(a, b):
    """Integer matmul of a (M, K) and b (K, N), both int32 or both int64.
    CPU tensors take the plain version; CUDA tensors launch the kernel, in
    the form ``tile_for`` picks."""
    if a.device.type == "cpu":
        return imatmul_plain(a, b)
    _check(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"imatmul: no kernel for device {a.device}")
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    tile = tile_for(a.shape[0], b.shape[1], _sms(index), TILES[a.dtype], BLOCKS_PER_SM, WAVE_COST)
    return imatmul_in_tile(a, b, tile)


def imatmul_in_tile(a, b, tile):
    """The kernel in block tile ``tile``, whatever ``tile_for`` would pick
    (the tests and tools run every form)."""
    with _telemetry.span("kernels.imatmul"):
        _check(a, b)
        if a.device.type != "cuda":
            raise RuntimeError(f"imatmul: no kernel for device {a.device}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("imatmul: operands must be contiguous")
        if tile not in TILES[a.dtype]:
            raise ValueError(f"imatmul: tile {tile} not in {TILES[a.dtype]} for {a.dtype}")
        (m, k), n = a.shape, b.shape[1]
        if max(m, n, k) >= 2**31 or -(-m // tile) > 65535:
            raise ValueError(f"imatmul: shape ({m}, {k}) x ({k}, {n}) is past the kernel's grid")
        lib = _build.library()
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        with torch.cuda.device(a.device):
            rc = lib.gb_imatmul(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.element_size(), tile, _build.stream_of(a)
            )
        _build.check(rc, "imatmul")
        _telemetry.count("kernels.launches.imatmul")
        return out

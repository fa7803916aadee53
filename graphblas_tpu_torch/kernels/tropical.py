"""The tropical matmul kernel (``csrc/tropical.cu``).

Replaces ``graphblas_tpu/ops/pallas_mxm.py:tropical_mxm_filled``:
``C[i, j] = ADD over k of MUL(a[i, k], b[k, j])`` on annihilator-filled
float32 operands, for min_plus, max_plus, min_max and max_min.  Each product
rounds once and min/max are exact, so the kernel, its plain version and the
reference agree bit for bit; min and max propagate NaN.
"""

import math

import torch

from . import _build

ADDS = ("min", "max")  # gb_tropical's codes
MULS = ("plus", "max", "min")
SEMIRINGS = (("min", "plus"), ("max", "plus"), ("min", "max"), ("max", "min"))
PLAIN_ELEMENTS = 1 << 26  # the largest (M, k-chunk, N) broadcast of the plain version
LAUNCHES = {"tropical_mxm": 0}
PLAIN_CALLS = {"tropical_mxm": 0}


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
    PLAIN_CALLS["tropical_mxm"] += 1
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


def tropical_mxm(a, b, add, mul):
    """Tropical matmul of filled float32 operands a (M, K) and b (K, N).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return tropical_mxm_plain(a, b, add, mul)
    _check(a, b, add, mul)
    if a.device.type != "cuda":
        raise RuntimeError(f"tropical_mxm: no kernel for device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tropical_mxm: operands must be contiguous")
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, k) >= 2**31 or -(-m // 64) > 65535:
        raise ValueError(f"tropical_mxm: shape ({m}, {k}) x ({k}, {n}) is past the kernel's grid")
    lib = _build.library()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.gb_tropical(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, ADDS.index(add), MULS.index(mul),
            _build.stream_of(a),
        )
    _build.check(rc, "tropical_mxm")
    LAUNCHES["tropical_mxm"] += 1
    return out

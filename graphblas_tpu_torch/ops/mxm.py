"""Dense tropical-family semiring matmul (min_plus, max_plus, min_max,
max_min).

Counterpart of ``graphblas_tpu/ops/pallas_mxm.py``.  The values go through the
Hopper kernel (``kernels.tropical``, or its plain version inside
``kernels.plain_versions()``) on annihilator-filled arrays; the structure is
one matmul of 0/1 indicators outside the kernel.
"""

import contextlib

import numpy as np
import torch

from .. import kernels
from ..kernels import tropical as _tropical


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full float32 within the block (TF32 off, as the
    reference's ``Precision.HIGHEST``); the caller's setting is restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def is_tropical(add_name, mul_name, np_dtype):
    return (add_name, mul_name) in _tropical.SEMIRINGS and np.issubdtype(np.dtype(np_dtype), np.floating)


def tropical_mxm_filled(a_filled, b_filled, add_name, mul_name):
    """Tropical matmul on filled (annihilator-encoded) arrays: a (M, K),
    b (K, N), any shape; computed in float32."""
    fn = _tropical.tropical_mxm_plain if kernels.plain_requested() else _tropical.tropical_mxm
    return fn(
        a_filled.to(torch.float32).contiguous(), b_filled.to(torch.float32).contiguous(), add_name, mul_name
    )


def tropical_mxm(av, as_, bv, bs, add_name, mul_name, out_dtype):
    """Full tropical semiring mxm on (values, structure) pairs; returns
    (values in ``out_dtype``, structure bool).

    The structure is ``as_ @ bs > 0``, an f32 matmul of 0/1 indicators with
    TF32 off (the reference's int8 -> int32 matmul): its sums are integer
    counts up to K, exact in f32 while K < 2^24."""
    if as_.shape[1] >= 1 << 24:
        raise ValueError(f"tropical_mxm: K = {as_.shape[1]} is past the exact range of the f32 structure count")
    fill = _tropical.fill_value(add_name)
    a_filled = torch.where(as_, av.to(torch.float32), fill)
    b_filled = torch.where(bs, bv.to(torch.float32), fill)
    cv = tropical_mxm_filled(a_filled, b_filled, add_name, mul_name)
    with full_f32_matmul():
        cs = torch.matmul(as_.to(torch.float32), bs.to(torch.float32)) > 0
    cv = torch.where(cs, cv, torch.zeros((), dtype=cv.dtype, device=cv.device)).to(out_dtype)
    return cv, cs

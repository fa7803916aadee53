"""Dense tropical-family semiring matmul (min_plus, max_plus, min_max,
max_min), and the integer products the dense engine and models share.

Counterpart of ``graphblas_tpu/ops/pallas_mxm.py``.  The values go through the
Hopper kernel (``kernels.tropical``, or its plain version inside
``kernels.plain_versions()``) on annihilator-filled arrays; the structure is
one int8 matmul of 0/1 indicators outside the kernel, as the reference's.

``indicator_counts`` is the reference's int8 -> int32 product of 0/1
indicators (overlap counts): ``torch._int_mm`` on the card and on the CPU.
``int_matmul`` is its int32/int64 value product: the Hopper kernel
``kernels.imatmul`` on the card, its plain version on the CPU.
"""

import contextlib

import numpy as np
import torch

from .. import kernels
from ..kernels import imatmul as _imatmul
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


def _int8_padded(x, rows, cols, col_major):
    """``x`` as int8, zero-padded to (rows, cols), row-major or column-major;
    ``x`` itself where it already is all that (a view too)."""
    if x.shape == (rows, cols) and x.dtype == torch.int8 and x.stride() == ((1, rows) if col_major else (cols, 1)):
        return x
    out = torch.zeros((cols, rows) if col_major else (rows, cols), dtype=torch.int8, device=x.device)
    out = out.T if col_major else out
    out[: x.shape[0], : x.shape[1]] = x
    return out


def indicator_counts(as_, bs):
    """Overlap counts of 0/1 (bool or int8) operands, ``as_ (M, K) @ bs (K,
    N)`` in int32: the reference's int8 -> int32 matmul of indicators.  One
    ``torch._int_mm``, its operands zero-padded to its shape rule (more than
    16 rows; K and N multiples of 8), which leaves every count unchanged, and
    the result sliced back.  ``bs`` goes column-major (a transposed view is
    taken as it is): ``_int_mm(A, A)`` on a row-major int8 A took 65.0 ms at
    16384^3 on an NVIDIA H100, ``_int_mm(A, A.T)`` 8.4 ms."""
    (m, k), n = as_.shape, bs.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=as_.device)
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    out = torch._int_mm(_int8_padded(as_, mp, kp, False), _int8_padded(bs, kp, np_, True))
    return out if (mp, np_) == (m, n) else out[:m, :n]


def int_matmul(x, y, acc):
    """``x @ y`` in the integer type ``acc`` (torch.int32 or torch.int64),
    products and sums wrapping: ``gb_imatmul`` on the card, its plain version
    on the CPU (and inside ``kernels.plain_versions()``)."""
    fn = _imatmul.imatmul_plain if kernels.plain_requested() else _imatmul.imatmul
    return fn(x.to(acc).contiguous(), y.to(acc).contiguous())


def tropical_mxm(av, as_, bv, bs, add_name, mul_name, out_dtype):
    """Full tropical semiring mxm on (values, structure) pairs; returns
    (values in ``out_dtype``, structure bool).

    The structure is ``as_ @ bs > 0`` by ``indicator_counts``, the
    reference's int8 -> int32 matmul."""
    fill = _tropical.fill_value(add_name)
    a_filled = torch.where(as_, av.to(torch.float32), fill)
    b_filled = torch.where(bs, bv.to(torch.float32), fill)
    cv = tropical_mxm_filled(a_filled, b_filled, add_name, mul_name)
    cs = indicator_counts(as_, bs) > 0
    cv = torch.where(cs, cv, torch.zeros((), dtype=cv.dtype, device=cv.device)).to(out_dtype)
    return cv, cs

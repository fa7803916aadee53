"""Kernel G: ``out[p] = x[idx[p]]`` with a fused epilogue (``csrc/gather.cu``).

Replaces four TPU kernels of the JAX package:

- ``graphblas_tpu/ops/permute.py:_pallas_shuffle`` behind ``apply_plan``: the
  permutation network is composed into one int32 index array, applied here in
  one pass (epilogue ``none``, or ``pagerank`` for the fused postlude of
  ``graphblas_tpu/models/fast.py:514-517``);
- ``graphblas_tpu/ops/permute.py:_pallas_rsel`` and ``_pallas_shuffle_then_t``,
  the row-select and shuffle-then-transpose stages of the same networks: they
  are part of the composed index too;
- ``graphblas_tpu/ops/pallas_scan.py:segmented_fill_static``: with
  ``fill_src`` as the index, epilogue ``fill`` (``idx[p] < 0`` gives 0).

Channels of 1, 2 and 4 bytes move at their own width (float32, int32,
int16, int8, uint8).  Launch counts are kept per role: ``gather`` (routes,
any epilogue but fill) and ``gather_fill`` (the segmented fill).

On the card a thread keeps 8 random loads of x in flight; idx, aux and out
stream through L2 evict-first while x is read evict-last, so that x stays
resident where it fits (``csrc/gather.cu`` says what bounds the kernel).
Views at any alignment run in the same launch.
"""

import torch

from ..core import telemetry as _telemetry
from . import _build

EPILOGUES = ("none", "fill", "pagerank")
DTYPES = (torch.float32, torch.int32, torch.int16, torch.int8, torch.uint8)
KERNELS = ("gather", "gather_fill")  # launch counts by kernel name


def _role(epilogue):
    return "gather_fill" if epilogue == "fill" else "gather"


def _check(x, idx, epilogue, aux, scalar):
    if epilogue not in EPILOGUES:
        raise ValueError(f"gather: unknown epilogue {epilogue!r}; expected one of {EPILOGUES}")
    if x.dim() != 1 or idx.dim() != 1:
        raise ValueError("gather: x and idx must be 1-D")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather: idx must be int32, got {idx.dtype}")
    if x.dtype not in DTYPES:
        raise TypeError(f"gather: x must be one of {DTYPES}, got {x.dtype}")
    if x.device != idx.device:
        raise ValueError(f"gather: x on {x.device} but idx on {idx.device}")
    if epilogue == "pagerank":
        if x.dtype != torch.float32:
            raise TypeError("gather: the pagerank epilogue takes float32 x")
        if aux is None or scalar is None:
            raise ValueError("gather: the pagerank epilogue needs aux and scalar")
        if aux.shape != idx.shape or aux.dtype != torch.float32 or aux.device != x.device:
            raise ValueError("gather: aux must be float32, shaped like idx, on x's device")
        if scalar.numel() != 1 or scalar.dtype != torch.float32 or scalar.device != x.device:
            raise ValueError("gather: scalar must be a one-element float32 tensor on x's device")


def gather_plain(x, idx, epilogue="none", aux=None, scalar=None):
    """Plain PyTorch version of Kernel G (any device)."""
    _check(x, idx, epilogue, aux, scalar)
    _telemetry.count("kernels.plain." + _role(epilogue))
    i = idx.long()
    if epilogue == "fill":
        return torch.where(idx >= 0, x[i.clamp(min=0)], torch.zeros((), dtype=x.dtype, device=x.device))
    y = x[i]
    if epilogue == "pagerank":
        c = scalar.reshape(())
        return torch.where(aux > 0, y / aux, c / (-aux))
    return y


def gather(x, idx, epilogue="none", aux=None, scalar=None):
    """``out[p] = x[idx[p]]`` then the epilogue.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.  ``idx`` must lie in
    ``[0, len(x))`` except, for ``fill``, where negative means "no source"."""
    if x.device.type == "cpu":
        return gather_plain(x, idx, epilogue, aux, scalar)
    with _telemetry.span("kernels.gather"):
        _check(x, idx, epilogue, aux, scalar)
        if x.device.type != "cuda":
            raise RuntimeError(f"gather: no kernel for device {x.device}")
        if not (x.is_contiguous() and idx.is_contiguous()):
            raise ValueError("gather: x and idx must be contiguous")
        lib = _build.library()
        out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
        n = idx.numel()
        if epilogue == "pagerank" and not aux.is_contiguous():
            raise ValueError("gather: aux must be contiguous")
        with torch.cuda.device(x.device):
            stream = _build.stream_of(x)
            if epilogue == "pagerank":
                rc = lib.gb_gather_pagerank(
                    x.data_ptr(), idx.data_ptr(), aux.data_ptr(), scalar.data_ptr(), out.data_ptr(), n, stream
                )
            else:
                rc = lib.gb_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(), n, x.element_size(), stream)
        _build.check(rc, "gather")
        _telemetry.count("kernels.launches." + _role(epilogue))
        return out

"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

Counterpart of the Pallas kernels of ``graphblas_tpu/ops/pallas_scan.py`` and
``graphblas_tpu/ops/permute.py`` that the SpMV engine reaches.

- ``gather``: Kernel G (``csrc/gather.cu``), ``out[p] = x[idx[p]]`` with the
  ``none``, ``fill`` and ``pagerank`` epilogues; a route's index may be the
  composition of a network with transpose and row-select stages.
- ``segscan``: Kernels C and S (``csrc/segscan.cu``), the fused segmented
  scans ``segscan_contrib`` and ``segscan_state``, and the generic scan
  ``segscan``.

A wrapper takes its plain version for CPU tensors, launches its kernel for
CUDA tensors, and raises for anything else; it never falls back.  Each
wrapper counts its launches and each plain version its calls, so a run can
show which path it took.  Nothing here imports a compiler or builds a kernel
at import time: the library is built on the first launch (``_build``).

``plain_versions()`` is the one way to run the plain versions on CUDA
tensors: the ops layer consults it, so a whole algorithm can be replayed on
the card through the plain code as the reference for its kernels.
"""

import contextlib
import contextvars

from . import gather, segscan

_PLAIN = contextvars.ContextVar("graphblas_tpu_torch_plain", default=False)


@contextlib.contextmanager
def plain_versions():
    """Within this block the ops layer calls the plain versions directly,
    whatever device the tensors are on (a reference run, never a fallback)."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_requested():
    return _PLAIN.get()


def launch_counts():
    """Kernel launches since the last reset, by kernel name."""
    return {**gather.LAUNCHES, **segscan.LAUNCHES}


def plain_counts():
    """Plain-version calls since the last reset, by kernel name."""
    return {**gather.PLAIN_CALLS, **segscan.PLAIN_CALLS}


def reset_counts():
    for d in (gather.LAUNCHES, gather.PLAIN_CALLS, segscan.LAUNCHES, segscan.PLAIN_CALLS):
        for k in d:
            d[k] = 0

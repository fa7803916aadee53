"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

Counterpart of the Pallas kernels of ``graphblas_tpu/ops/pallas_scan.py``,
``graphblas_tpu/ops/permute.py``, ``graphblas_tpu/ops/pallas_eqjoin.py``,
``graphblas_tpu/ops/pallas_mxm.py`` and the compare probe of
``graphblas_tpu/tools/profile_spgemm_roofline.py``.

- ``gather``: Kernel G (``csrc/gather.cu``), ``out[p] = x[idx[p]]`` with the
  ``none``, ``fill`` and ``pagerank`` epilogues; a route's index may be the
  composition of a network with transpose and row-select stages.
- ``segscan``: Kernels C and S (``csrc/segscan.cu``), the fused segmented
  scans ``segscan_contrib`` and ``segscan_state``, and the generic scan
  ``segscan``.
- ``eqjoin``: the masked-SpGEMM inner loop ``eqjoin`` and the compare-rate
  probe ``compare_probe`` (``csrc/eqjoin.cu``).
- ``tropical``: the tropical matmul ``tropical_mxm`` (``csrc/tropical.cu``).

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

from . import eqjoin, gather, segscan, tropical

_MODULES = (gather, segscan, eqjoin, tropical)

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
    return {k: v for m in _MODULES for k, v in m.LAUNCHES.items()}


def plain_counts():
    """Plain-version calls since the last reset, by kernel name."""
    return {k: v for m in _MODULES for k, v in m.PLAIN_CALLS.items()}


def add_launches(delta, times=1):
    """Add ``times`` x ``delta`` (launches by kernel name) to the counts: a
    CUDA graph replay launches what its capture recorded, and the capture
    itself launched nothing (``core/compiler.py``)."""
    for m in _MODULES:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] += times * delta.get(k, 0)


def reset_counts():
    for d in [m.LAUNCHES for m in _MODULES] + [m.PLAIN_CALLS for m in _MODULES]:
        for k in d:
            d[k] = 0

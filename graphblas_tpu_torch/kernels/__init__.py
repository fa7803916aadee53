"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

Counterpart of the Pallas kernels of ``graphblas_tpu/ops/pallas_scan.py``,
``graphblas_tpu/ops/permute.py``, ``graphblas_tpu/ops/pallas_eqjoin.py``,
``graphblas_tpu/ops/pallas_mxm.py`` and the compare probe of
``graphblas_tpu/tools/profile_spgemm_roofline.py``; and kernels for two
products the JAX package leaves to XLA, the integer matmul and the sparse x
dense (n x k) product.

- ``gather``: Kernel G (``csrc/gather.cu``), ``out[p] = x[idx[p]]`` with the
  ``none``, ``fill`` and ``pagerank`` epilogues; a route's index may be the
  composition of a network with transpose and row-select stages.
- ``segscan``: Kernels C and S (``csrc/segscan.cu``), the fused segmented
  scans ``segscan_contrib`` and ``segscan_state``, and the generic scan
  ``segscan``; the k-column product ``segscan_spmm`` (``csrc/spmm.cu``).
- ``eqjoin``: the masked-SpGEMM inner loop ``eqjoin`` and the compare-rate
  probe ``compare_probe`` (``csrc/eqjoin.cu``).
- ``tropical``: the tropical matmul ``tropical_mxm`` (``csrc/tropical.cu``).
- ``imatmul``: the int32/int64 matmul ``imatmul`` (``csrc/imatmul.cu``), for
  the dense engine's integer plus_times, plus_first and plus_second.

A wrapper takes its plain version for CPU tensors, launches its kernel for
CUDA tensors, and raises for anything else; it never falls back.  Each
wrapper counts its launches and each plain version its calls (counters of
``core.telemetry``), so a run can show which path it took; a wrapper's
launch is the span ``kernels.<wrapper>``.  Nothing here imports a compiler
or builds a kernel at import time: the library is built on the first launch
(``_build``).

``plain_versions()`` is the one way to run the plain versions on CUDA
tensors: the ops layer consults it, so a whole algorithm can be replayed on
the card through the plain code as the reference for its kernels.
"""

import contextlib
import contextvars

from ..core import telemetry as _telemetry
from . import eqjoin, gather, imatmul, segscan, tropical

_NAMES = tuple(k for m in (gather, segscan, eqjoin, tropical, imatmul) for k in m.KERNELS)

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
    """Kernel launches since the last reset, by kernel name (the counters
    ``kernels.launches.<name>`` of ``core.telemetry``)."""
    return {k: _telemetry.counter("kernels.launches." + k) for k in _NAMES}


def plain_counts():
    """Plain-version calls since the last reset, by kernel name (the
    counters ``kernels.plain.<name>``)."""
    return {k: _telemetry.counter("kernels.plain." + k) for k in _NAMES}


def add_launches(delta, times=1):
    """Add ``times`` x ``delta`` (launches by kernel name) to the counts: a
    CUDA graph replay launches what its capture recorded, and the capture
    itself launched nothing (``core/compiler.py``)."""
    for k in _NAMES:
        if delta.get(k):
            _telemetry.count("kernels.launches." + k, times * delta[k])


def reset_counts():
    _telemetry.reset("kernels.launches.", "kernels.plain.")

"""The masked-SpGEMM dot-method inner loop: a batched intersection of sorted
key segments under a semiring.

Counterpart of ``graphblas_tpu/ops/pallas_eqjoin.py``.  ``eqjoin`` keeps its
signature, less the interpret flag, and dispatches to the Hopper kernel
(``kernels.eqjoin``), or to its plain version inside
``kernels.plain_versions()``.
"""

from .. import kernels
from ..kernels import eqjoin as _eqjoin

_ADD_OPS = frozenset(_eqjoin.ADDS)
_MUL_OPS = frozenset(_eqjoin.MULS)

_BLK = 512
# The TPU kernel's swept task tiles (graphblas_tpu/ops/pallas_eqjoin.py:28-37).
# The CUDA kernel's block does not depend on them: they are kept as the
# padding rule of the SpGEMM analysis (core/sparse.py:_finalize_eq_buckets),
# so its bucket arrays compare slot for slot with the reference's.
_BLK_TABLE = {
    (4, 16): 4096,
    (4, 64): 1024,
    (4, 256): 2048,
    (64, 16): 1024,
    (64, 64): 2048,
    (64, 256): 2048,
    (256, 16): 1024,
    (256, 64): 1024,
}


def task_tile(Wa, Wb):
    """The task count a (Wa, Wb) bucket is padded to a multiple of."""
    return _BLK_TABLE.get((int(Wa), int(Wb)), _BLK)


def supported(add_name, mul_name):
    return add_name in _ADD_OPS and mul_name in _MUL_OPS


def eqjoin(akT, avT, bkT, bvT, add, mul):
    """Per task t: ADD over (k, l) with ``akT[k, t] == bkT[l, t]`` of
    ``MUL(avT[k, t], bvT[l, t])``, and the match count.  akT/bkT: (Wa, T) /
    (Wb, T) int32 key tiles (pad: -1 / -2); avT/bvT: float32 values, or None
    where ``mul`` ignores them.  Returns (vals (T,) float32, nmatch (T,)
    int32)."""
    fn = _eqjoin.eqjoin_plain if kernels.plain_requested() else _eqjoin.eqjoin
    return fn(akT, avT, bkT, bvT, add, mul)

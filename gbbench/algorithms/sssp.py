"""Bellman-Ford single-source shortest paths written in ``graphblas_tpu_torch``'s DSL.

Distances ride a dense float32 vector (unreached: +inf).  Each round relaxes
every edge at once, ``dist(accum=min) << A.mxv(dist, min_plus)``, and the loop
stops after the first round that changes no distance, under
``gb.until_runner`` (CUDA graph replays, one stop flag read a round).  Each
trial builds its own initial state for its root (Graph500 kernel 3's search
keys, taken in turn).
"""


def bytes_needed(n, nnz, iters):
    """Bytes a work-efficient SSSP could get by with, each input read once and
    each output written once: the column index and weight of every entry
    (8 B), the offsets ((n + 1) x 4 B) and the distances written (4 B a
    vertex); Bellman-Ford's repeated rounds are not counted."""
    return 8 * nnz + 4 * (n + 1) + 4 * n


class SSSP:
    def __init__(self, A, params, roots, hooks):
        import graphblas_tpu_torch as gb
        from graphblas_tpu_torch import Scalar, Vector, binary, monoid, semiring

        FP32, BOOL = gb.dtypes.FP32, gb.dtypes.BOOL
        n = A.nrows
        self.roots = list(roots)

        def body(dist, changed):
            relaxed = A.mxv(dist, semiring.min_plus).new(FP32)
            new = dist.dup()
            new(accum=binary.min) << relaxed
            changed = new.ewise_mult(dist, binary.lt).reduce(monoid.lor).new(BOOL)
            return new, changed

        def cond(dist, changed):
            return changed

        def start(root):
            dist = Vector.from_scalar(float("inf"), n, FP32)
            dist[root] = 0.0
            return dist, Scalar.from_value(True, BOOL)

        self._start = start
        self._runner = gb.until_runner(cond, body, *start(self.roots[0]), max_iters=n)

    def trial(self, i):
        """Distances from root ``i`` (taken in turn) on the host: (distances,
        rounds, root)."""
        root = self.roots[i % len(self.roots)]
        dist, _ = self._runner(*self._start(root))
        return dist.to_dense(), self._runner.last_iters, root


def build(A, params, roots, hooks):
    return SSSP(A, params, roots, hooks)

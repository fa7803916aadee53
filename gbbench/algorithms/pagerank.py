"""GAP PageRank (``pr.cc``) written in ``graphblas_tpu_torch``'s DSL.

Pull form over the symmetric adjacency A: each iteration every vertex takes
``(1 - d) / n + d * sum of r[u] / outdeg(u)`` over its in-neighbours u, and the
L1 change ``sum |r_new - r|`` stops the loop below ``tol`` or after
``max_iters`` iterations.  Dangling mass is not redistributed (as ``pr.cc``).
``mode`` "compiled" runs the iterations under ``gb.until_runner`` (CUDA graph
replays, one stop flag read a replay); "eager" runs the same statements line
by line, reading the L1 change on the host each iteration, as ordinary
python-graphblas user code runs.
"""

import contextlib


def bytes_needed(n, nnz, iters):
    """Bytes the algorithm needs, each input read once and each output written
    once: per iteration the column index of every entry (4 B), the offsets
    ((n + 1) x 4 B), x read and y written (4 B a vertex each)."""
    return iters * (4 * nnz + 4 * (n + 1) + 8 * n)


class PageRank:
    def __init__(self, A, params, hooks):
        import graphblas_tpu_torch as gb
        from graphblas_tpu_torch import Scalar, Vector, agg, binary, monoid, semiring, unary

        FP32 = gb.dtypes.FP32
        n = A.nrows
        d = float(params["damping"])
        self.tol = float(params["tol"])
        self.max_iters = int(params["max_iters"])
        self.mode = params["mode"]
        stmt = hooks.stmt if self.mode == "eager" else contextlib.nullcontext

        outdeg = A.reduce_columnwise(agg.count).new(FP32)
        inv_deg = Vector.from_scalar(0.0, n, FP32).ewise_add(outdeg.apply(unary.minv), binary.plus).new(FP32)
        base = Vector.from_scalar((1.0 - d) / n, n, FP32)

        def body(r, err):
            with stmt():
                contrib = r.ewise_mult(inv_deg, binary.times).new(FP32)
            with stmt():
                incoming = A.mxv(contrib, semiring.plus_second).new(FP32)
            with stmt():
                scaled = incoming.apply(binary.times, right=d).new(FP32)
            with stmt():
                r_new = base.ewise_add(scaled, binary.plus).new(FP32)
            with stmt():
                change = r_new.ewise_add(r, binary.minus).apply(unary.abs).new(FP32)
            with stmt():
                err = change.reduce(monoid.plus).new(FP32)
            return r_new, err

        def cond(r, err):
            return err.apply(binary.ge, right=self.tol)

        self._body = body
        self._r0 = lambda: Vector.from_scalar(1.0 / n, n, FP32)
        self._err0 = lambda: Scalar.from_value(1.0, FP32)
        self._runner = None
        if self.mode == "compiled":
            self._runner = gb.until_runner(cond, body, self._r0(), self._err0(), max_iters=self.max_iters)
        elif self.mode != "eager":
            raise ValueError(f"pagerank: unknown mode {self.mode!r}")

    def trial(self, i):
        """One PageRank from r = 1/n to the ranks on the host: (ranks,
        iterations, None)."""
        if self._runner is not None:
            r, _ = self._runner()
            iters = self._runner.last_iters
        else:
            r, err = self._r0(), self._err0()
            iters = 0
            while iters < self.max_iters:
                r, err = self._body(r, err)
                iters += 1
                if err.value < self.tol:
                    break
        return r.to_dense(), iters, None


def build(A, params, roots, hooks):
    return PageRank(A, params, hooks)

"""GAP betweenness centrality (``bc.cc``) written in ``graphblas_tpu_torch``'s DSL.

LAGraph's batch Brandes (``LAGr_Betweenness``, Kolodziej and Davis) in the
pull form over the symmetric pattern A (its weights are not read), from a
batch of ``BATCH`` sources at once, every state an n x BATCH FP64 matrix
(column b: source b):

- forward, under ``gb.until_runner`` (one stop flag read a level): the
  frontier of path counts ``F(~P.S, replace) << A.mxm(F, plus_second)``,
  the counts ``P(accum=plus) << F`` (sigma) and the levels ``D(F.S) << d``,
  until F is empty;
- backward, for d from the deepest level L down to 2, as one run of a
  ``gb.loop_runner`` built for one step and run for L - 1 (its one-step
  graph replayed L - 1 times; L is known when the forward sweep ends, so
  no flag is read):
  ``W(D == d) << B / P``, ``Y(D == d - 1) << A.mxm(W, plus_second)``,
  ``B(accum=plus) << Y * P``, B starting at 1 on P's structure (B is
  1 + delta).  Level 0 holds the sources, whose own dependency Brandes
  leaves out, so no product updates it;
- the scores ``c = sum over the batch of (B - 1)``, read on the host as an
  n-long FP64 vector.

The scores are unnormalised and count ordered pairs over the symmetric
graph, as LAGraph's; GAP's ``bc.cc`` divides them by the largest at the
end, which is left out.  A trial is one batch; the 64 search keys, in the
order the run's seed draws, make 16 batches of 4 consecutive keys, taken in
turn.  Its iterations are its products, forward and backward.
"""

BATCH = 4  # sources a trial (GAP's bc runs 4 a trial); the traffic's "batch"


def batches(roots):
    """The batches of ``roots``: ``BATCH`` consecutive keys each, in their order."""
    return [tuple(roots[i : i + BATCH]) for i in range(0, len(roots) - BATCH + 1, BATCH)]


def bytes_needed(n, nnz, iters):
    """Bytes each product needs, each input read once and each output written
    once: the column index of every entry (4 B), the offsets ((n + 1) x 4 B),
    and the n x BATCH FP64 operand read and product written (8 BATCH B a
    vertex each)."""
    return iters * (4 * nnz + 4 * (n + 1) + 2 * 8 * BATCH * n)


class BC:
    def __init__(self, A, params, roots, hooks):
        import graphblas_tpu_torch as gb
        from graphblas_tpu_torch import Matrix, Scalar, binary, monoid, semiring, unary

        if int(params["batch"]) != BATCH or params["dtype"] != "FP64":
            raise ValueError(f"bc: the recipe runs batches of {BATCH} sources in FP64, not {params}")
        FP64, INT32, BOOL = gb.dtypes.FP64, gb.dtypes.INT32, gb.dtypes.BOOL
        n = A.nrows
        self.batches = batches(roots)

        def forward(F, P, D, d):
            d1 = (d + 1).new(INT32)
            Fn = Matrix(FP64, n, BATCH)
            Fn(~P.S, replace=True) << A.mxm(F, semiring.plus_second)
            Pn = P.dup()
            Pn(accum=binary.plus) << Fn
            Dn = D.dup()
            Dn(Fn.S)[:, :] = d1
            return Fn, Pn, Dn, d1

        def frontier_left(F, P, D, d):
            # the counts are 1 or more: the sum is positive iff F holds an entry
            return F.reduce_scalar(monoid.plus).apply(binary.gt, right=0.0)

        def backward(B, P, D, d):
            at_d = D.apply(binary.eq, right=d).new(BOOL)
            d1 = (d - 1).new(INT32)
            at_d1 = D.apply(binary.eq, right=d1).new(BOOL)
            W = Matrix(FP64, n, BATCH)
            W(at_d.V) << B.ewise_mult(P, binary.truediv)
            Y = Matrix(FP64, n, BATCH)
            Y(at_d1.V) << A.mxm(W, semiring.plus_second)
            Bn = B.dup()
            Bn(accum=binary.plus) << Y.ewise_mult(P, binary.times)
            return Bn, P, D, d1

        def start(i):
            # the batch's sources as a 4-entry sparse matrix, merged in (accum:
            # loop state is dense) and dropped with the trial.  A dense
            # from_coo would build and upload the whole n x BATCH arrays, and
            # a source matrix kept across trials keeps the dense form that its
            # first merge gives it (112 MB a batch)
            batch = self.batches[i]
            with gb.tx.config.set(dense_limit=0):
                ones = Matrix.from_coo(batch, range(BATCH), 1.0, FP64, nrows=n, ncols=BATCH)
                level0 = Matrix.from_coo(batch, range(BATCH), 0, INT32, nrows=n, ncols=BATCH)
            F, D = Matrix(FP64, n, BATCH), Matrix(INT32, n, BATCH)
            F(accum=binary.plus) << ones
            D(accum=binary.plus) << level0
            return F, F.dup(), D, Scalar.from_value(0, INT32)

        def dependencies(P, D, deepest):
            B = P.apply(unary.one).new(FP64)
            return B, P, D, Scalar.from_value(deepest, INT32)

        self._start = start
        self._dependencies = dependencies
        self._scores = lambda B: B.apply(binary.minus, right=1.0).reduce_rowwise(monoid.plus).new(FP64)
        self._forward = gb.until_runner(frontier_left, forward, *start(0), max_iters=n)
        # one backward step, recorded here from the first batch and run for as
        # many levels as a trial's batch reaches
        _, P, D, _ = self._forward(*start(0))
        deepest = self._forward.last_iters - 1
        self._backward = gb.loop_runner(1, backward, *dependencies(P, D, max(deepest, 2)))
        self._backward(*dependencies(P, D, max(deepest, 2)))

    def trial(self, i):
        """Brandes from batch ``i`` (taken in turn) to the scores on the host:
        ((scores, the deepest level), products, the batch's sources)."""
        i %= len(self.batches)
        _, P, D, _ = self._forward(*self._start(i))
        deepest = self._forward.last_iters - 1
        state = self._dependencies(P, D, deepest)
        B = self._backward(*state, n_iters=deepest - 1)[0] if deepest >= 2 else state[0]
        scores = self._scores(B).to_dense(fill_value=0.0)
        return (scores, deepest), self._forward.last_iters + max(deepest - 1, 0), self.batches[i]


def build(A, params, roots, hooks):
    return BC(A, params, roots, hooks)

"""Hand-written kernel launches a sparse x dense product (``A.mxm(F)`` with
F a dense n x k matrix): the port's counter ``ops.spmm_launches`` (the
launches counted inside ``ops.sparse_mxm_dense``) over ``ops.spmm_products``,
over the run's eager, warm and recorded products (a replay runs what its
recording ran).  One k-column launch reads 1; a product that fell back to k
SpMVs would read k times an SpMV's launches."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    counters = telemetry.snapshot()["counters"]
    products = counters.get("ops.spmm_products", 0)
    return counters.get("ops.spmm_launches", 0) / products if products else None

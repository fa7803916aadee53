"""Seconds of the library's column-order sorts over the run (the port's span
``sparse.col_order``: the host argsort behind a column-wise reduce or a
transpose); 0.0 where none ran."""


def read(r):
    if r.trace is None:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    s = telemetry.snapshot()["spans"].get("sparse.col_order")
    return s["total_s"] if s else 0.0

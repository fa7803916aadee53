"""Seconds of the library's SpMV plan builds over the run (the port's span
``sparse.plan_build``: the host build or the on-disk cache read, and the move
to the card)."""


def read(r):
    if r.trace is None:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    s = telemetry.snapshot()["spans"].get("sparse.plan_build")
    return s["total_s"] if s else None

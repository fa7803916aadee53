"""Milliseconds a ``to_dense`` takes, the answer read on the host: the count
read, the copies of the values and the structure, and the fill (the port's
span ``collections.to_dense``, its mean over the run's calls)."""


def read(r):
    if r.trace is None:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    s = telemetry.snapshot()["spans"].get("collections.to_dense")
    return 1e3 * s["total_s"] / s["count"] if s else None

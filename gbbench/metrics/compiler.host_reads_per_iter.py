"""Reads of a device value by the host a loop iteration: the port's counter
``host_reads`` (stop flags, ``nvals``, ``Scalar.value``, the answer's copies)
over ``compiler.iterations`` (the iterations the compiled loops ran), over
the run."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    counters = telemetry.snapshot()["counters"]
    iters = counters.get("compiler.iterations", 0)
    return counters.get("host_reads", 0) / iters if iters else None

"""Host microseconds a CUDA graph replay takes: ``graph.replay()`` and the
launch accounting (the port's span ``compiler.replay``, its own time over its
calls)."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    s = telemetry.snapshot()["spans"].get("compiler.replay")
    return 1e6 * s["self_s"] / s["count"] if s else None

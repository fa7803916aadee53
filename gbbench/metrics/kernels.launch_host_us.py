"""Host microseconds a hand-written kernel's eager launch takes: the own time
of the port's ``kernels.<wrapper>`` spans (checks, output allocation, the
ctypes call; not ``kernels.build``) over their calls (a graph replay passes
no wrapper)."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    spans = [s for k, s in telemetry.snapshot()["spans"].items() if k.startswith("kernels.") and k != "kernels.build"]
    calls = sum(s["count"] for s in spans)
    return 1e6 * sum(s["self_s"] for s in spans) / calls if calls else None

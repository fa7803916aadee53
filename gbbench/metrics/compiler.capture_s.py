"""Seconds of the compiled loops' capture over the run: the warm step and the
recording of each CUDA graph (the port's span ``compiler.capture``), its own
seconds: the plan build, the column-order sort and the kernel build that the
warm step runs keep their own spans."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    s = telemetry.snapshot()["spans"].get("compiler.capture")
    return s["self_s"] if s else None

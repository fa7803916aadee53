"""Host milliseconds of the collection front's own Python a statement: the
own time of the port's span ``collections.stmt`` (one ``.new()``, ``<<`` or
``update``, less the engine, kernel, plan and read spans inside it), over
its calls."""


def read(r):
    if r.trace is None:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    s = telemetry.snapshot()["spans"].get("collections.stmt")
    return 1e3 * s["self_s"] / s["count"] if s else None

"""Host milliseconds of the engine's dispatch a statement: the own time of
every ``ops.<entry>`` span of the port (``sparse_mxv`` and the dense
element-wise, apply, reduce and merge entries, less the kernel launches
inside them), over the calls of ``collections.stmt``."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    spans = telemetry.snapshot()["spans"]
    stmts = spans.get("collections.stmt")
    if not stmts:
        return None
    return 1e3 * sum(s["self_s"] for k, s in spans.items() if k.startswith("ops.")) / stmts["count"]

"""Share of the plan's slots that the masked sparse x dense products
streamed, in percent: a statement ``C(M) << A.mxm(F)`` computes only the
rows its mask lets it write, and streams only their slots.  The port's
counters ``ops.spmm_kept_slots`` (the slots of the kept rows) over
``ops.spmm_masked_slots`` (the plan's slots), both added on the card at
every masked product, replays included, and read once, after a traced
run.  A library without them reads nothing."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    counters = telemetry.snapshot()["counters"]
    masked = counters.get("ops.spmm_masked_slots", 0)
    return 100.0 * counters.get("ops.spmm_kept_slots", 0) / masked if masked else None

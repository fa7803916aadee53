"""Host synchronisations a loop iteration (the runtime calls that block the
host: stream, device and event synchronisations and synchronous copies, from
the profiler's trace of the slice), over the iterations the recipes counted."""


def read(r):
    if r.trace is None or not r.iters or r.trace.busy_s <= 0:
        return None
    return r.trace.syncs / r.iters

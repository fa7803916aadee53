"""Reduce a ``torch.profiler`` chrome trace of one slice of trials to numbers.

The slice is the span of the ``gbbench.slice`` annotation.  Device operations
are the trace's kernels, memory copies and memsets; the device is busy where
any of them runs (the union of their intervals), idle elsewhere in the slice.
A gap is named by the innermost host event (an operator, a runtime or driver
call, or a harness annotation) running at its middle.  Host synchronisations
are the runtime calls that block the host until the device is done.
"""

import json

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}
HARNESS = "gbbench."  # the harness's own annotations
SLICE = HARNESS + "slice"
TOP = 10


class Reduced:
    """window_s, busy_s, kernel_s (summed kernel durations), syncs, and the
    breakdown's lists: device_ops and idle_gaps, [name, seconds] each."""

    def __init__(self, window_s, busy_s, kernel_s, syncs, device_ops, idle_gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernel_s = kernel_s
        self.syncs = syncs
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps


def load(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, t):
    """What the host was doing at time ``t``: the latest-starting host event
    that holds ``t``; where that is a harness annotation (Python between the
    library's traced calls), the annotation and the last traced call that
    ended before ``t``."""
    best, last = None, None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, name)
        if e < t and not name.startswith(HARNESS) and (last is None or e >= last[0]):
            last = (e, name)
    if best is None:
        return "host, no traced event"
    if best[1].startswith(HARNESS) and last is not None:
        return f"{best[1]}, after {last[1]}"
    return best[1]


def reduce(events):
    """The slice's numbers from the trace's events (``ts`` and ``dur`` in
    microseconds).  Raises when the slice annotation is missing."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == SLICE]
    if not marks:
        raise ValueError(f"the trace has no {SLICE} annotation")
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    dev, by_name, kernel_us = [], {}, 0.0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), t0)
        f = min(float(e["ts"]) + float(e["dur"]), t1)
        if f <= s:
            continue
        dev.append((s, f))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (f - s)
        if e["cat"] == "kernel":
            kernel_us += f - s
    busy = _union(dev)
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in xs
        if e.get("cat") in HOST_CATS and t0 <= float(e["ts"]) <= t1 and e.get("name") != SLICE
    )
    gaps, cur = [], t0
    for s, f in busy + [[t1, t1]]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, f)
    syncs = sum(1 for e in xs if e.get("cat") == "cuda_runtime" and e.get("name") in SYNC_CALLS and t0 <= float(e["ts"]) <= t1)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return Reduced(
        window_s=(t1 - t0) * 1e-6,
        busy_s=sum(f - s for s, f in busy) * 1e-6,
        kernel_s=kernel_us * 1e-6,
        syncs=syncs,
        device_ops=[[name, us * 1e-6] for name, us in top_ops],
        idle_gaps=[[_innermost(host, (s + f) / 2), (f - s) * 1e-6] for s, f in top_gaps],
    )

"""The port's one registry of spans and counters.

- ``count(name, n=1)`` adds ``n`` to a named integer counter; ``counter(name)``
  reads one (0 when it never counted).
- ``span(name)`` is a context manager (``timed(name)`` the decorator of a
  function whose every call is one) that keeps, by name, the number of
  calls, their total seconds and their self seconds: the total less the time
  of the spans opened inside it on the same thread.  Each thread keeps its
  own span state, so a span of a background thread (the plan build's) never
  nests under the caller's.
- While a ``torch.profiler`` records, a span also enters
  ``torch.profiler.record_function(name)``: its start, its end and its
  parent (the enclosing span) land in the profiler's trace, on the clock of
  the device's kernels and copies.  Otherwise a span only aggregates, and
  the check for a profiler is one attribute read.
- ``host_read(site)`` counts one read of a device value by the host into
  ``host_reads`` and ``host_reads.<site>`` and gives the span
  (``collections.read``) that times it.
- ``device_counters(names, device)`` is a tensor of counts that kernels add
  to on the card, where a count is known there alone (and a replayed graph
  adds at every replay); ``snapshot()`` folds what it gained since the last
  snapshot into the counters ``names`` (one read of the card, outside any
  capture).
- ``snapshot()`` returns ``{"spans": {name: {"count", "total_s", "self_s"}},
  "counters": {name: int}}``; ``reset(*prefixes)`` clears the spans and
  counters whose names start with one of ``prefixes`` (all of them when none
  is given).

Aggregation is always on: a span costs under a microsecond of host time in
a tight loop (an H100 host's ``timeit``), a counter a dict update.  Updates
of one name from two threads may race; the port's one background thread,
the plan build, writes names of its own.  Names follow the benchmark's layers
(``collections.``, ``sparse.``, ``compiler.``, ``ops.``, ``kernels.``,
``parallel.``); the kernels' launch and plain-call counts
(``kernels.launch_counts()``) and the mesh's gathers and reshards
(``parallel.blocks.counts()``) are counters here.
"""

import functools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

_clock = time.perf_counter
_SPANS = {}  # name -> [calls, total seconds, self seconds]
_COUNTS = {}  # name -> int
_BY_NAME = {}  # name -> its _Span
_DEVICE = {}  # (names, device) -> [int64 tensor of counts, the values last folded]


class _Thread(threading.local):
    """A thread's span state.  ``covered`` is the running sum that self times
    are taken from: a span that closes sets it to its value at the span's
    start plus the span's duration, so the time its children covered is the
    rise of ``covered`` while it was open.  ``open`` keeps the context
    manager's calls: (covered at the start, record_function or None, start)."""

    def __init__(self):
        self.covered = 0.0
        self.open = []


_thread = _Thread()


class _Span:
    """The context manager of one span name.  One object serves every call
    of the name, on any thread and nested in itself: a call's state sits on
    the thread's stack."""

    __slots__ = ("name", "stats")

    def __init__(self, name):
        self.name = name
        self.stats = _SPANS.setdefault(name, [0, 0.0, 0.0])

    def __enter__(self):
        th = _thread
        rf = _profiler.record_function(self.name).__enter__() if _profiler._is_profiler_enabled else None
        th.open.append((th.covered, rf, _clock()))
        return self

    def __exit__(self, et, ev, tb):
        t1 = _clock()
        th = _thread
        covered, rf, t0 = th.open.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        dt = t1 - t0
        inner = th.covered - covered
        th.covered = covered + dt
        s = self.stats
        s[0] += 1
        s[1] += dt
        s[2] += dt - inner
        return False


def span(name):
    """The span ``name``: ``with span(name):`` times one call of it."""
    s = _BY_NAME.get(name)
    if s is None:
        s = _BY_NAME.setdefault(name, _Span(name))
    return s


def timed(name):
    """Decorator: every call of the function is one call of the span ``name``
    (the context manager's bookkeeping, inline in the wrapper)."""

    def wrap(fn):
        s = span(name).stats

        @functools.wraps(fn)
        def timed_fn(*args, **kwargs):
            th = _thread
            covered = th.covered
            rf = _profiler.record_function(name).__enter__() if _profiler._is_profiler_enabled else None
            t0 = _clock()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = _clock() - t0
                if rf is not None:
                    rf.__exit__(None, None, None)
                inner = th.covered - covered
                th.covered = covered + dt
                s[0] += 1
                s[1] += dt
                s[2] += dt - inner

        return timed_fn

    return wrap


def host_read(site, name="collections.read"):
    """One read of a device value by the host at ``site``: counted into
    ``host_reads`` and ``host_reads.<site>``; returns the span ``name`` to
    time it with (``with host_read("nvals"): n = int(s.sum())``)."""
    count("host_reads")
    count("host_reads." + site)
    return span(name)


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counter(name):
    """The counter ``name`` (0 when it never counted)."""
    return _COUNTS.get(name, 0)


def device_counters(names, device):
    """The int64 tensor of counts, one a name, that kernels on ``device`` add
    to; ``snapshot()`` folds what it gained into the counters ``names``.  Made
    (zeros) at the first call for the names and device: make it before any
    CUDA graph capture, which would record the zeroing."""
    key = (tuple(names), str(torch.device(device)))
    entry = _DEVICE.get(key)
    if entry is None:
        entry = _DEVICE.setdefault(key, [torch.zeros(len(names), dtype=torch.int64, device=device), [0] * len(names)])
    return entry[0]


def _fold():
    """Add what each device tensor of counts gained since the last fold."""
    if not _DEVICE or torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return
    for (names, _), entry in list(_DEVICE.items()):
        now = entry[0].tolist()
        for name, v, last in zip(names, now, entry[1]):
            if v != last:
                count(name, v - last)
        entry[1] = now


def snapshot():
    """Every span that ran (calls, total and self seconds) and every counter."""
    _fold()
    return {
        "spans": {k: {"count": c, "total_s": t, "self_s": s} for k, (c, t, s) in list(_SPANS.items()) if c},
        "counters": dict(_COUNTS),
    }


def reset(*prefixes):
    """Clear the spans and counters whose names start with one of
    ``prefixes``; everything when none is given."""
    for k, s in list(_SPANS.items()):
        if not prefixes or k.startswith(prefixes):
            s[:] = [0, 0.0, 0.0]
    for k in list(_COUNTS):
        if not prefixes or k.startswith(prefixes):
            del _COUNTS[k]
    for (names, _), entry in _DEVICE.items():
        if not prefixes or any(k.startswith(prefixes) for k in names):
            entry[0].zero_()  # what the card counted before the reset, queued or not
            entry[1] = [0] * len(names)

"""Run one cell of the benchmark once and print its result line.

    python3 gbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from process start to the first timed trial):
the configuration's graph generated on the card and relabelled by ``--seed``, handed to
``Matrix.from_coo`` as host numpy COO (the harness's device copies freed
first), the recipe built and one warm trial run, which builds the plan and
captures the compiled loop.  Then trials run back to back, one caller, each a
whole algorithm from its initial state to its answer read on the host,
starting until ``--seconds`` have passed.  ``--trace 1`` then traces a slice
of further trials under ``torch.profiler`` and reports the per-layer metrics
instead of the end-to-end ones.  Last, with the library's state freed, the
plain reference judges a sample of the window's answers (drawn from the seed,
with the slowest trial's).

The last lines on standard error give each number compared beside its limit;
the last line on standard output is the result, one JSON object.  A run that
finds no card, or fewer than the cell asks for, or finds JAX or the JAX
package loaded, exits non-zero and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gbbench import registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "graphblas_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, jaxlib's, flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def environment():
    """The library's settings for a run: no on-disk plan cache (every run
    builds its plans, as a user's first run on a new graph), the eager
    dispatch's plan build blocking (no background build under the window),
    the compiled loops' default layout."""
    for var in ("GRAPHBLAS_TPU_PLAN_CACHE", "GRAPHBLAS_TPU_DSL_EDGE_LAYOUT"):
        os.environ.pop(var, None)
    os.environ["GRAPHBLAS_TPU_PLAN_BACKGROUND"] = "0"


class Hooks:
    """Spans the harness records around its calls into the library, by name:
    a list of seconds each.  ``stmt`` wraps one eager statement of a recipe:
    in the window it records its span, inside a traced slice it marks the
    statement in the trace instead (the profiler slows the host)."""

    def __init__(self):
        self.spans = {}
        self.traced = False

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def stmt(self):
        if self.traced:
            import torch

            with torch.profiler.record_function("gbbench.stmt"):
                yield
        else:
            with self.span("stmt"):
                yield


class Kept:
    """The answers that the reference judges: ``k`` drawn from the seed
    (reservoir sampling over the window's trials) and the slowest trial's."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = random.Random(seed)
        self.sample = []
        self.slowest = (-1.0, None)
        self.seen = 0

    def offer(self, seconds, result):
        if self.seen < self.k:
            self.sample.append(result)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.sample[j] = result
        self.seen += 1
        if seconds > self.slowest[0]:
            self.slowest = (seconds, result)

    def results(self):
        extra = [self.slowest[1]] if self.slowest[1] is not None and all(self.slowest[1] is not r for r in self.sample) else []
        return self.sample + extra


def p95(values):
    """The 95th percentile, linear between closest ranks (numpy's default)."""
    return statistics.quantiles(values, n=20, method="inclusive")[-1] if len(values) > 1 else values[0]


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card(torch, device):
    if device.type != "cuda":
        return "cpu", device.type
    return "gpu", torch.cuda.get_device_name(device)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as ex:
        return f"nvidia-smi: {ex}"


def _traced_slice(torch, device, wl, trials, start, alg, n, nnz, hooks):
    """Run ``trials`` trials under the profiler: (reduced trace, iterations,
    algorithm bytes, launches by kernel over the slice)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from graphblas_tpu_torch import kernels

    from gbbench import trace

    before = kernels.launch_counts()
    count = nbytes = 0
    hooks.traced = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slice.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.SLICE):
                for i in range(start, start + trials):
                    with record_function("gbbench.trial"):
                        _, it, _ = wl.trial(i)
                    count += it
                    nbytes += alg.bytes_needed(n, nnz, it)
                _sync(torch, device)
        prof.export_chrome_trace(path)
        reduced = trace.reduce(trace.load(path))
    hooks.traced = False
    after = kernels.launch_counts()
    return reduced, count, nbytes, {k: after[k] - before.get(k, 0) for k in after}


class Readings:
    """What a per-layer metric's reader reads: the harness's spans, the
    reduced trace of the slice, the slice's iterations and algorithm bytes,
    the launches the library counted over it, and the card's peaks."""

    def __init__(self, spans, reduced=None, iters=0, nbytes=0, launches=None, peaks=None):
        self.spans = spans
        self.trace = reduced
        self.iters = iters
        self.bytes = nbytes
        self.launches = launches or {}
        self.peaks = peaks or {}


def peaks(kind):
    with open(os.path.join(registry.HERE, "peaks.json")) as f:
        return json.load(f).get(kind, {})


def run_cell(workload, seed, seconds, trace_on, *, device=None, config_override=None, log=sys.stderr):
    """One run of cell ``workload``: (result object, {number: (value, limit)}).
    ``device`` defaults to the first card; the tests pass the CPU."""
    w, cfg, traffic, per_layer, end_to_end = registry.cell(workload)
    cfg = dict(cfg, **(config_override or {}))
    import torch

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix

    from gbbench import generate

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    gb.tx.config["platform"] = device.type
    alg = registry.algorithm(traffic["algorithm"])
    hooks = Hooks()

    # -- inputs from the seed, on the device; the library gets host numpy ----
    rows, cols, wts, n, roots = generate.graph(cfg, seed, device, int(traffic.get("roots", 0)))
    host = {"rows": rows.cpu().numpy(), "cols": cols.cpu().numpy(), "w": wts.cpu().numpy()}
    del rows, cols, wts
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    nnz = int(host["rows"].size)

    # -- set-up: the collection, the recipe and one warm trial ----------------
    with hooks.span("collections.from_coo_s"):
        A = Matrix.from_coo(host["rows"], host["cols"], host["w"], gb.dtypes.FP32, nrows=n, ncols=n)
    with hooks.span("sparse.first_trial_s"):
        wl = alg.build(A, traffic["params"], roots, hooks)
        wl.trial(0)
        _sync(torch, device)
    hooks.spans.pop("stmt", None)

    # -- the window ------------------------------------------------------------
    kept = Kept(int(traffic["judged"]), seed)
    times, iters, raised, i = [], [], 0, 0
    t_start = time.perf_counter()
    setup_s = t_start - _T0
    while time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        try:
            result = wl.trial(i)
        except Exception as ex:  # a trial that raises is a failed trial
            raised += 1
            print(f"trial {i} raised: {ex!r}", file=log)
            if raised >= 3:
                break
            continue
        finally:
            i += 1
        t1 = time.perf_counter()
        times.append(t1 - t0)
        iters.append(result[1])
        kept.offer(t1 - t0, result)
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    platform, kind = _card(torch, device)

    readings = None
    if trace_on:
        reduced, count, nbytes, launches = _traced_slice(
            torch, device, wl, int(traffic["trace_trials"]), i, alg, n, nnz, hooks
        )
        readings = Readings(hooks.spans, reduced, count, nbytes, launches, peaks(kind))

    # -- judge the answers, the library's state freed --------------------------
    del wl, A
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    graph = {
        "rows": torch.from_numpy(host["rows"]).to(device, torch.int64),
        "cols": torch.from_numpy(host["cols"]).to(device, torch.int64),
        "w": torch.from_numpy(host["w"]).to(device),
        "n": n,
    }
    ref = registry.reference(traffic["algorithm"])
    limits = traffic["limits"]
    judged = kept.results()
    numbers = {name: 0.0 for name in limits}
    failed = raised
    for got in ref.check(graph, traffic["params"], judged):
        if any(not got[k] <= limits[k] for k in limits):
            failed += 1
        for k in limits:
            numbers[k] = max(numbers[k], got[k])
    del graph
    checks = {k: (numbers[k], limits[k]) for k in limits}
    correct = failed == 0 and bool(times) and all(v <= lim for v, lim in checks.values())

    metrics = {}
    if trace_on:
        for m in per_layer:
            value = registry.metric(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "trial_ms": window_s * 1e3 / max(len(times), 1),
            "trial_p95_ms": p95(times) * 1e3 if times else float("nan"),
            "peak_mem_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        # an end-to-end metric is named by its quantity, optionally followed by
        # ".<group>": the cells whose noise sets its own bound (trial_ms.eager)
        for m in end_to_end:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
    dev = {"platform": platform, "kind": kind, "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(times) + raised, "failed": failed, "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = readings.trace.busy_s
        dev["window_s"] = readings.trace.window_s
        result["breakdown"] = {"device_ops": readings.trace.device_ops, "idle_gaps": readings.trace.idle_gaps}
    print(
        f"cell {workload} seed {seed}: {len(times)} trials in {window_s:.3f} s, set-up {setup_s:.3f} s, "
        f"n {n}, entries {nnz}, iterations a trial {min(iters, default=0)}-{max(iters, default=0)} "
        f"(mean {sum(iters) / max(len(iters), 1):.3f}), judged {len(judged)}, spans "
        + ", ".join(f"{k} {sum(v):.4f} s x{len(v)}" for k, v in hooks.spans.items()),
        file=log,
    )
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    environment()
    import torch

    w = registry.cell(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"gbbench: the cell needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(f"card: {_power_limit()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"gbbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernels G, C, S, the generic scan, the tropical and the integer matmul
alone on the card: CUDA-event times, the L2 probe, the f32 and integer
instruction rates, ptxas and SASS.

- ``ptxas``: ``nvcc -Xptxas -v`` of ``csrc/gather.cu``, ``csrc/segscan.cu``,
  ``csrc/eqjoin.cu``, ``csrc/tropical.cu``, ``csrc/imatmul.cu`` and
  ``csrc/spmm.cu`` with the build's own flags: registers, stack and spills
  of every kernel of the six files (the whole listing goes to ``--out``).
- ``sass``: the tropical and integer matmul kernels' SASS (``cuobjdump
  -sass`` of the built library, to ``--out``'s directory as
  ``tropical.sass`` and ``imatmul.sass``): per instance the count of each
  opcode, and the f32 (integer) instructions per (i, j, k) of its unrolled
  inner loop.
- ``rate``: the rate of f32 add, min.NaN, max.NaN and min, of the pairs
  min_plus and min_max run per (i, j, k), and of the int32 and int64
  multiply-adds (mad.lo.u32, mad.lo.u64), from long independent chains
  (``tools/rate_probe.cu``, built here), in lane instructions (mad.lo.u64:
  PTX instructions) per SM per clock at the card's SM clock that
  ``nvidia-smi`` reads after the run.
- ``gather``: Kernel G's route over an int32 index of 2^log2n slots, random
  over len(x), with x of 2^20 (surely resident in the 50 MB L2), 2^21, 2^22,
  2^23 (the main path's) and 2^24 float32 slots: the L2 probe.  Then the
  PageRank epilogue and the segmented fill at 2^log2n, as
  ``chip_smoke.py`` phase 3 builds them.
- ``contrib``: Kernel C at 2^log2n, add/times, min/plus and max/first, with
  flags at 1/16 (the main path's mean segment) and with no flag at all (the
  longest look-back); then a route followed by C on its output, the main
  path's order.
- ``contrib gather``: C with x's gather fused at 2^log2n over x of
  2^(log2n - 4) slots (the main path's n), add/times, min/plus and
  max/first; then G's gather x[idx] followed by C, the same work in two
  launches.
- ``spmm``: each instance of the k-column kernel (k rounded up to 1, 2, 4
  or 8, float and double): its tile, dynamic shared memory, resident blocks
  an SM, registers and local bytes, as the card reports them; then the
  k-column product (``segscan_spmm``) at 2^spmm_log2n slots
  (the bc cell's 2^26) in segments of 32 on average over x of
  2^(spmm_log2n - 5) rows (the cell's n), k = 4, plus/first, in float64 and
  float32 with 60% and 5% of x present and with every x present, against
  its byte bound; then the same work in float32 as four SpMVs (C with x's
  gather, and the collect over the segment ends), a column at a time.
- ``segscan``: the generic scan at 2^log2n with flags at 1/16: add in every
  dtype, f32 fill, min and max, a uint8 fill, f32 add with no flag and on a
  view one slot into its buffer (the plain loads).
- ``state``: Kernel S at 2^log2n: BFS, SSSP with ``fr_reduce``, SSSP with
  per-slot changed flags, and SSSP with no flag at all.
- ``tropical``: the four semirings at 2048^3; then min_plus in both block
  tiles (the wrapper's pick marked) on (2047, 2045) x (2045, 2049) and x
  (2045, 2048) (K and N no multiple of 4: the scalar loads), and at 2048^3,
  1024^3, 512^3 and 256^3.
- ``imatmul``: int32 in both block tiles (the wrapper's pick marked) at
  2048^3, 1024^3 and on (1000, 1030) x (1030, 999); int64 at 2048^3 and
  1024^3.
- ``l2 window``, last: the route over a permutation of 2^log2n slots once
  more under an L2 access-policy window that marks x persisting (set on the
  stream by libcuda's cuStreamSetAttribute, then cleared and the carve-out
  given back): the second design for keeping x resident, beside the cache
  hints.

Each time is the mean of ``--reps`` launches between two CUDA events, after
one warm-up launch (warm L2: the inputs were just written).  One line per
time, the card's name and power limit first, then one JSON line of all times.

    python -m graphblas_tpu_torch.tools.probe_kernels [--log2n 23] [--spmm-log2n 26] [--reps 50] [--out chiprun_out/ptxas.txt]
"""

import argparse
import ctypes
import json
import os
import re
import subprocess


def ptxas_report(build, out_path):
    """Registers, stack and spills of each kernel of gather.cu, segscan.cu,
    eqjoin.cu, tropical.cu, imatmul.cu and spmm.cu, as ptxas prints them for the build's flags
    (eqjoin.cu's many instances summed up in one line, less any that
    spill)."""
    lines = []
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    nvcc = build.nvcc_path()
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    with open(out_path, "w") as f:
        for name in ("gather.cu", "segscan.cu", "eqjoin.cu", "tropical.cu", "imatmul.cu", "spmm.cu"):
            src = os.path.join(build.CSRC_DIR, name)
            obj = os.path.join(os.path.dirname(out_path) or ".", f"{name}.ptxas.o")
            proc = subprocess.run(
                [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src],
                capture_output=True, text=True, check=True,
            )
            os.remove(obj)
            f.write(f"==== {name} ====\n{proc.stderr}\n")
            func, found = None, []
            for line in proc.stderr.splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    func = m.group(1)
                    if os.path.exists(filt):
                        func = subprocess.run([filt, func], capture_output=True, text=True).stdout.strip()
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m and func:
                    stack, st, ld = m.groups()
                m = re.search(r"Used (\d+) registers", line)
                if m and func:
                    found.append((int(m.group(1)), stack, st, ld, func))
                    func = None
            if name != "eqjoin.cu":
                lines += [f"{name}: {r} regs, stack {s}, spills {st}/{ld} B: {fn[:150]}" for r, s, st, ld, fn in found]
                continue
            for family in ("eqjoin_kernel", "eqjoin_lanes", "compare_probe"):
                rows = [x for x in found if family in x[4]]
                if rows:
                    regs = [x[0] for x in rows]
                    spills = [x for x in rows if x[2] != "0" or x[3] != "0"]
                    lines.append(f"{name}: {family} x{len(rows)}: {min(regs)}-{max(regs)} regs, {len(spills)} spill")
                    lines += [f"{name}: {r} regs, spills {st}/{ld} B: {fn[:150]}" for r, _, st, ld, fn in spills]
    return lines


# (i, j, k) of an unrolled stage of each matmul kernel instance, by the
# mangled name: the tropical 128 x 128 tile (8 k of 64 (i, j) pairs) and 64 x
# 64 (16 k of 16); gb_imatmul's int32 ("j") 128 x 128 (8 k of 64) and 64 x
# 64 (16 k of 16), int64 ("y") 64 x 64 (8 k of 16)
PER_STEP = {
    "tile128_kernel": 512, "tile64_kernel": 256,
    "imatmul_kernelIjLi128": 512, "imatmul_kernelIjLi64": 256, "imatmul_kernelIyLi64": 128,
}


def sass_report(build, out_path):
    """Opcode counts of each tropical and integer matmul kernel instance in
    the built library's SASS, and the f32 add / FMNMX (integer IMAD / IADD3)
    instructions per (i, j, k) of the inner loop (unrolled: ``PER_STEP``)."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.library_path()], capture_output=True, text=True, check=True).stdout
    out_dir = os.path.dirname(out_path) or "."
    lines, func, ops = [], None, {}
    chunks = []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func, ops = m.group(1), {}
            chunks.append((func, ops, []))
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?", line)
        if m and func is not None:
            op = m.group(1) + (m.group(2) or "")
            ops[op] = ops.get(op, 0) + 1
            chunks[-1][2].append(line)
    files = {name: open(os.path.join(out_dir, name), "w") for name in ("tropical.sass", "imatmul.sass")}
    with files["tropical.sass"], files["imatmul.sass"]:
        for func, ops, body in chunks:
            per_step = next((v for k, v in PER_STEP.items() if k in func), 0)
            if not per_step:
                continue
            integer = "imatmul_kernel" in func
            files["imatmul.sass" if integer else "tropical.sass"].write(f"==== {func} ====\n" + "\n".join(body) + "\n")
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
            names = ("IMAD", "IADD3") if integer else ("FADD", "FMNMX")
            counts = [sum(v for k, v in ops.items() if k.split(".")[0] == name) for name in names]
            lines.append(
                f"{func[:90]}: {names[0]} {counts[0]}, {names[1]} {counts[1]}, ({' + '.join(names)}) / {per_step} = "
                f"{sum(counts) / per_step:.3f}; "
                f"top opcodes {top}"
            )
    return lines


def instruction_rates(build, torch, dev, reps):
    """Lane instructions a second of each probe (``tools/rate_probe.cu``),
    and per SM per clock at the card's maximum SM clock; with the SM clock
    that nvidia-smi reads right after the runs."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rate_probe.cu")
    so = os.path.join(build.BUILD_DIR, "rate_probe.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.rate_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = sms * 8, 256, 1 << 14
    out = torch.empty(blocks * threads, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {}
    for op, (name, per_step) in enumerate((
        ("f32 add", 1), ("min.NaN", 1), ("max.NaN", 1), ("min", 1), ("add + min.NaN", 2), ("max.NaN + min.NaN", 2),
        ("mad.lo.u32", 1), ("mad.lo.u64", 1),
    )):
        def run():
            rc = lib.rate_probe(op, out.data_ptr(), blocks, threads, iters, stream)
            if rc != 0:
                raise RuntimeError(f"rate_probe: CUDA error {rc}")

        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        s = start.elapsed_time(end) / reps / 1e3
        rates[name] = blocks * threads * iters * 8 * per_step / s
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    mhz = float(clock.split(",")[1])
    per_clk = {k: v / (sms * mhz * 1e6) for k, v in rates.items()}
    return rates, per_clk, clock


class _Window(ctypes.Structure):  # CUaccessPolicyWindow
    _fields_ = [
        ("base_ptr", ctypes.c_void_p), ("num_bytes", ctypes.c_size_t), ("hit_ratio", ctypes.c_float),
        ("hit_prop", ctypes.c_int), ("miss_prop", ctypes.c_int),
    ]


class _AttrValue(ctypes.Union):  # CUlaunchAttributeValue, padded to 64 bytes
    _fields_ = [("pad", ctypes.c_char * 64), ("window", _Window)]


def l2_window(stream, t):
    """Set (t a tensor) or clear (t None) an L2 access-policy window on the
    stream by libcuda's cuStreamSetAttribute: t's bytes persisting, as far
    as the card's persisting carve-out reaches.  Returns the window's bytes
    and hit ratio."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *a):
        rc = getattr(cu, name)(*a)
        if rc != 0:
            raise RuntimeError(f"probe_kernels: {name} returned CUresult {rc}")

    dev = ctypes.c_int()
    call("cuCtxGetDevice", ctypes.byref(dev))
    max_persist, max_window = ctypes.c_int(), ctypes.c_int()
    call("cuDeviceGetAttribute", ctypes.byref(max_persist), 108, dev)  # MAX_PERSISTING_L2_CACHE_SIZE
    call("cuDeviceGetAttribute", ctypes.byref(max_window), 109, dev)  # MAX_ACCESS_POLICY_WINDOW_SIZE
    value = _AttrValue()
    if t is not None:
        call("cuCtxSetLimit", 0x06, ctypes.c_size_t(max_persist.value))  # PERSISTING_L2_CACHE_SIZE
        nbytes = min(t.numel() * t.element_size(), max_window.value)
        ratio = min(1.0, max_persist.value / nbytes)
        value.window = _Window(t.data_ptr(), nbytes, ratio, 2, 1)  # hit PERSISTING, miss STREAMING
    call("cuStreamSetAttribute", ctypes.c_void_p(stream), 1, ctypes.byref(value))  # ACCESS_POLICY_WINDOW
    if t is None:  # give the carve-out back to normal lines too
        call("cuCtxResetPersistingL2Cache")
        call("cuCtxSetLimit", 0x06, ctypes.c_size_t(0))
        return 0, 0.0
    return nbytes, ratio


def spmm_bytes(e_pad, n, k, item, x_struct):
    """The k-column product's least bytes (plus/first), as the benchmark's
    ``spmm_roofline`` counts them: the index, valid and segment-start bytes
    of each slot, x's structure bytes where given (else its values), Y's
    values and structure bytes written."""
    return 6 * e_pad + n * k * (1 if x_struct else item) + n * k * (item + 1)


def spmm_probe(torch, ks, kg, gen, dev, log2n, ms, report):
    """The k-column product at 2^log2n slots over x of 2^(log2n - 5) rows,
    k = 4, against its byte bound and against four SpMVs in float32."""
    ep, n, k = 1 << log2n, 1 << (log2n - 5), 4
    flags = torch.zeros(ep, dtype=torch.bool, device=dev)
    flags[torch.randperm(ep - 1, generator=gen, device=dev)[: n - 1] + 1] = True
    flags[0] = True
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    idx = torch.randint(0, n, (ep,), generator=gen, device=dev, dtype=torch.int32)
    valid = torch.rand(ep, generator=gen, device=dev) < 0.95
    base = ks.spmm_tile_base(flags)
    for dt in (torch.float64, torch.float32):
        for kp in (1, 2, 4, 8):
            geo = ks.spmm_geometry(kp, dt)
            print(
                f"[spmm] {str(dt)[6:]} KP {kp}: tile {geo['tile']}, {geo['smem']} B dynamic shared memory, "
                f"{geo['blocks_per_sm']} blocks an SM, {geo['registers']} registers, {geo['local_bytes']} B local",
                flush=True,
            )
    for dt in (torch.float64, torch.float32):
        x = (torch.rand((n, k), generator=gen, device=dev) * 9 + 1).to(dt)
        for dens in (0.6, 0.05, None):
            xs = None if dens is None else torch.rand((n, k), generator=gen, device=dev) < dens
            t = ms(lambda: ks.segscan_spmm(x, xs, idx, None, valid, flags, rows, n, "add", "first", base))
            bound = spmm_bytes(ep, n, k, x.element_size(), xs is not None) / 3.35e12 * 1e3
            present = "every x" if dens is None else f"{int(dens * 100)}% of x"
            report(f"spmm {str(dt)[6:]} k {k}, 2^{log2n} slots, {present} present (bound {bound:.4f})", t)
    ends = torch.cat([flags[1:], torch.ones(1, dtype=torch.bool, device=dev)]).nonzero().flatten().int()
    xs = torch.rand((n, k), generator=gen, device=dev) < 0.6
    cols = [x[:, j].contiguous() for j in range(k)]
    vcol = [valid & xs[:, j][idx.long()] for j in range(k)]

    def spmvs():
        for j in range(k):
            kg.gather(ks.segscan_contrib_gather(cols[j], idx, None, vcol[j], flags, "add", "first"), ends)

    report(f"spmm as {k} SpMVs (C with x's gather + collect), float32, 60% of x present", ms(spmvs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=23)
    ap.add_argument("--spmm-log2n", type=int, default=26)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default="chiprun_out/ptxas.txt")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels: no CUDA device")
    from graphblas_tpu_torch.kernels import _build
    from graphblas_tpu_torch.kernels import gather as kg
    from graphblas_tpu_torch.kernels import imatmul as ki
    from graphblas_tpu_torch.kernels import segscan as ks
    from graphblas_tpu_torch.kernels import tropical as kt
    from graphblas_tpu_torch.ops.scan import STATE_BIG, build_fill_tables

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    for line in ptxas_report(_build, args.out):
        print(f"[ptxas] {line}", flush=True)
    _build.library()
    for line in sass_report(_build, args.out):
        print(f"[sass] {line}", flush=True)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    times = {}

    def report(key, t):
        times[key] = t
        print(f"[time] {key}: {t:.4f} ms", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    n = 1 << args.log2n
    for k in (20, 21, 22, 23, 24):
        x = torch.rand(1 << k, generator=gen, device=dev)
        idx = torch.randint(0, 1 << k, (n,), generator=gen, device=dev, dtype=torch.int32)
        report(f"gather route, x 2^{k}", ms(lambda: kg.gather(x, idx)))
    x = torch.rand(n, generator=gen, device=dev)
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    aux = torch.randint(1, 30, (n,), generator=gen, device=dev).float()
    aux = aux * torch.where(torch.rand(n, generator=gen, device=dev) < 0.8, 1.0, -1.0)
    c = torch.tensor(0.37, device=dev)
    report("gather route, permutation", ms(lambda: kg.gather(x, perm)))
    report("gather pagerank", ms(lambda: kg.gather(x, perm, "pagerank", aux, c)))
    flags = torch.rand(n, generator=gen, device=dev) < 1 / 16
    fill_src = torch.from_numpy(build_fill_tables(flags.cpu().numpy())).to(dev)
    report("gather fill", ms(lambda: kg.gather(x, fill_src, "fill")))
    w = torch.rand(n, generator=gen, device=dev) * 9 + 1
    valid = torch.rand(n, generator=gen, device=dev) < 0.9
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    for label, fl in (("flags 1/16", flags), ("no flags", none)):
        for op, mul in (("add", "times"), ("min", "plus"), ("max", "first")):
            wv = None if mul == "first" else w
            report(f"contrib {op}/{mul}, {label}", ms(lambda: ks.segscan_contrib(x, wv, valid, fl, op, mul)))
    # C with x's gather fused, over the main path's n; then G's gather and C
    xg = torch.rand(n >> 4, generator=gen, device=dev)
    idx_g = torch.randint(0, n >> 4, (n,), generator=gen, device=dev, dtype=torch.int32)
    for op, mul in (("add", "times"), ("min", "plus"), ("max", "first")):
        wv = None if mul == "first" else w
        report(
            f"contrib gather {op}/{mul}, x 2^{args.log2n - 4}",
            ms(lambda: ks.segscan_contrib_gather(xg, idx_g, wv, valid, flags, op, mul)),
        )
    report(
        f"gather then contrib add/times, x 2^{args.log2n - 4}",
        ms(lambda: ks.segscan_contrib(kg.gather(xg, idx_g), w, valid, flags, "add", "times")),
    )
    spmm_probe(torch, ks, kg, gen, dev, args.spmm_log2n, ms, report)
    # the path's order: a route, then C on its output (does x's evict-last
    # residency slow the next kernel?)
    report(
        "route then contrib add/times",
        ms(lambda: ks.segscan_contrib(kg.gather(x, perm), w, valid, flags, "add", "times")),
    )
    # the generic scan: every dtype's add, f32's other ops, a uint8 fill, no
    # flags, and a view one slot into its buffer
    vals = {
        "f32": x,
        "int32": torch.randint(-(2**30), 2**30, (n,), generator=gen, device=dev, dtype=torch.int32),
        "int16": torch.randint(-(2**15), 2**15, (n,), generator=gen, device=dev, dtype=torch.int16),
        "int8": torch.randint(-128, 128, (n,), generator=gen, device=dev, dtype=torch.int8),
        "uint8": torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8),
    }
    for label, v in vals.items():
        report(f"segscan {label} add", ms(lambda: ks.segscan(v, flags, "add")))
    for op in ("fill", "min", "max"):
        report(f"segscan f32 {op}", ms(lambda: ks.segscan(x, flags, op)))
    report("segscan uint8 fill", ms(lambda: ks.segscan(vals["uint8"], flags, "fill")))
    report("segscan f32 add, no flags", ms(lambda: ks.segscan(x, none, "add")))
    x_buf = torch.empty(n + 128, device=dev)
    x_buf[1 : n + 1] = x
    report("segscan f32 add, view at slot 1", ms(lambda: ks.segscan(x_buf[1 : n + 1], flags, "add")))
    # Kernel S, as chip_smoke.py phase 3 builds its inputs
    is_last = torch.cat([flags[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    frontier = (torch.rand(n, generator=gen, device=dev) < 0.05).float()
    levels = torch.where(
        torch.rand(n, generator=gen, device=dev) < 0.7, -1, torch.randint(0, 4, (n,), generator=gen, device=dev)
    ).to(torch.int32)
    big = torch.tensor(STATE_BIG, device=dev)
    xs = torch.where(torch.rand(n, generator=gen, device=dev) < 0.3, big, torch.rand(n, generator=gen, device=dev) * 20)
    dist = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, big, torch.rand(n, generator=gen, device=dev) * 25)
    report("state bfs", ms(lambda: ks.segscan_state("bfs", frontier, None, valid, flags, is_last, levels, 3)))
    report("state sssp fr_reduce", ms(lambda: ks.segscan_state("sssp", xs, w, valid, flags, is_last, dist, 3, True)))
    report("state sssp changed", ms(lambda: ks.segscan_state("sssp", xs, w, valid, flags, is_last, dist, 3)))
    last_only = torch.arange(n, device=dev) == n - 1  # one segment: the longest look-back
    report("state sssp fr_reduce, no flags", ms(lambda: ks.segscan_state("sssp", xs, w, valid, none, last_only, dist, 3, True)))
    # the tropical matmul: the four semirings at 2048^3, then min_plus on
    # ragged shapes and at fewer output tiles than SMs, in both block tiles
    # (the wrapper's pick marked)
    ta, tb = torch.rand(2048, 2048, generator=gen, device=dev), torch.rand(2048, 2048, generator=gen, device=dev)
    for add, mul in kt.SEMIRINGS:
        report(f"tropical {add}_{mul} 2048^3", ms(lambda: kt.tropical_mxm(ta, tb, add, mul)))
    ra, rb = torch.rand(2047, 2045, generator=gen, device=dev), torch.rand(2045, 2049, generator=gen, device=dev)
    shapes = [(ra, rb), (ra, rb[:, :2048].contiguous())]  # K and N no multiple of 4; K alone
    shapes += [(ta[:m, :m].contiguous(), tb[:m, :m].contiguous()) for m in (2048, 1024, 512, 256)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for a, b in shapes:
        pick = kt.tile_for(a.shape[0], b.shape[1], sms)
        for t in kt.TILES:
            label = f"tropical min_plus {tuple(a.shape)} x {tuple(b.shape)}, tile {t}{' (picked)' if t == pick else ''}"
            report(label, ms(lambda: kt.tropical_mxm_in_tile(a, b, "min", "plus", t)))
    # the integer matmul: int32 in both tiles, int64 (one tile), on wrapping values
    for dt, sizes in ((torch.int32, (2048, 1024, (1000, 1030, 999))), (torch.int64, (2048, 1024))):
        info = torch.iinfo(dt)
        for size in sizes:
            m, k, n = size if isinstance(size, tuple) else (size,) * 3
            ia = torch.randint(info.min, info.max, (m, k), generator=gen, device=dev, dtype=dt)
            ib = torch.randint(info.min, info.max, (k, n), generator=gen, device=dev, dtype=dt)
            pick = ki.tile_for(m, n, sms, ki.TILES[dt], ki.BLOCKS_PER_SM, ki.WAVE_COST)
            for t in ki.TILES[dt]:
                label = f"imatmul {str(dt).split('.')[-1]} ({m}, {k}) x ({k}, {n}), tile {t}{' (picked)' if t == pick else ''}"
                report(label, ms(lambda: ki.imatmul_in_tile(ia, ib, t)))
    rates, per_clk, clock = instruction_rates(_build, torch, dev, args.reps)
    for k in rates:
        print(f"[rate] {k}: {rates[k] / 1e12:.3f} x 10^12 lane instructions/s, {per_clk[k]:.1f} per SM per clock "
              "at the maximum SM clock", flush=True)
    print(f"[rate] SM clock, maximum SM clock (MHz), read after the runs: {clock}", flush=True)
    times.update({f"rate {k} per SM per clock": v for k, v in per_clk.items()})
    # last, as the persisting carve-out it sets aside slows what follows
    stream = torch.cuda.current_stream(dev).cuda_stream
    nbytes, ratio = l2_window(stream, x)
    print(f"[l2 window] {nbytes} bytes of x persisting, hit ratio {ratio:.3f}", flush=True)
    report("gather route, permutation, L2 window on x", ms(lambda: kg.gather(x, perm)))
    l2_window(stream, None)
    print(json.dumps({"card": card, "log2n": args.log2n, "reps": args.reps, "ms": times}), flush=True)


if __name__ == "__main__":
    main()

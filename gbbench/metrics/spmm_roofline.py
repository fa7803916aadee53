"""Share of its memory roofline that the k-column product's kernel
(``segscan_spmm``, device name ``spmm_onepass``) reached over the traced
slice: the bytes its launches need at the card's published HBM bandwidth,
against the kernel's summed device time, in percent.

A launch needs, each input read once and each output written once: the
plan's stream (the source index, 4 B, and the valid and segment-start
bytes of every slot; 4 B more a slot where the multiply reads the
weights), x's structure where given (1 B a cell) or else x's values (the
element size a cell), and Y's values and structure written (the element
size and 1 B a cell).  With a structure, x's present values are needed
too; their share is known on the card alone and is left out, so the share
errs low.  The library counts those sizes at each
launch (the counters ``kernels.spmm.*``); the slice's launches are its
count of ``segscan_spmm`` launches (replays included), each taken at the
run's mean launch."""

KERNEL = "spmm_onepass"
SLOT_BYTES = 4 + 1 + 1  # source index, valid byte, segment-start byte
WEIGHT_BYTES = 4
PREFIX = "kernels.spmm."


def launch_bytes(counters):
    """The mean bytes of one launch from the library's size counters, or None."""
    calls = counters.get(PREFIX + "calls", 0)
    if not calls:
        return None
    total = SLOT_BYTES * counters.get(PREFIX + "slots", 0) + WEIGHT_BYTES * counters.get(PREFIX + "weight_slots", 0)
    total += counters.get(PREFIX + "x_struct_cells", 0)
    for name, cells in counters.items():
        for kind, extra in (("x_cells.", 0), ("y_cells.", 1)):  # Y's structure: one byte a cell
            if name.startswith(PREFIX + kind):
                total += (int(name.rsplit(".", 1)[1]) + extra) * cells
    return total / calls


def read(r):
    bw = r.peaks.get("hbm_bytes_per_s")
    launches = r.launches.get("segscan_spmm", 0)
    if r.trace is None or not bw or not launches:
        return None
    seconds = sum(s for name, s in r.trace.device_ops if KERNEL in name)
    if seconds <= 0:
        return None
    try:
        from graphblas_tpu_torch.core import telemetry
    except ImportError:  # a library without the registry
        return None
    per_launch = launch_bytes(telemetry.snapshot()["counters"])
    return 100.0 * (launches * per_launch / bw) / seconds if per_launch else None

"""Share of the memory roofline: the bytes the algorithm needs over the slice
(the recipe's ``bytes_needed``, from n, the entries and the iterations only),
at the card's published HBM bandwidth, against the summed device time of the
slice's kernels, in percent."""


def read(r):
    bw = r.peaks.get("hbm_bytes_per_s")
    if r.trace is None or not bw or r.trace.kernel_s <= 0 or not r.bytes:
        return None
    return 100.0 * (r.bytes / bw) / r.trace.kernel_s

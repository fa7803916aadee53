"""Kernels C and S and the generic scan: segmented scans (``csrc/segscan.cu``).

- ``segscan_contrib`` (Kernel C) replaces
  ``graphblas_tpu/ops/pallas_scan.py:segmented_scan_contrib``: per-edge
  semiring multiply, optional integer wrap, identity at invalid slots, then a
  segmented add/min/max inclusive scan.
- ``segscan_contrib_gather`` is Kernel C whose value channel is ``x[idx]``,
  read from the n-long x inside the tile: the SpMV engine's expand (x to
  every edge slot, ``idx`` the plan's ``src_dst_order``) fused into C.  Its
  output equals ``segscan_contrib(x[idx], ...)`` bit for bit.
- ``segscan_spmm`` is the k-column product of the SpMV engine
  (``csrc/spmm.cu``): the contrib scan of a dense n x k x (k <= 8, float32
  or float64) read by row through ``idx``, all k columns in one pass over
  the plan, written only at the dst segments' last slots as rows of Y and
  of Y's structure.  No JAX counterpart: the reference densifies.  Given a
  statement's mask (``keep``), a launch of ``segscan_spmm_keep`` first lists
  the segments whose rows the mask reaches, and the product streams only
  their slots (``SpmmRows`` holds the layout's constants and scratch).
- ``segscan_state`` (Kernel S) replaces
  ``graphblas_tpu/ops/pallas_scan.py:segmented_scan_state``: the BFS (max of
  x) or SSSP (min of x + w) scan fused with the per-round state update.

On the card each is one launch of a single-pass scan with decoupled
look-back: the wrapper zeroes one scratch array, the tiles' descriptors and a
ticket counter (one memset).

The plain versions are a log-step (Hillis-Steele) segmented scan over the
flat array: floor(log2 n) + 1 shifted ``_combine`` passes with the same
prologue and epilogue.  Float sums therefore round in another order than the kernel's
(and the TPU kernel's); min and max are exact, propagate NaN and put -0.0
below +0.0, as ``jnp.minimum`` / ``jnp.maximum`` and the kernels do.
"""

import ctypes
import math

import numpy as np
import torch

from ..core import telemetry as _telemetry
from . import _build

# The loop algorithms' "unreached" distance, as
# graphblas_tpu/ops/pallas_scan.py:STATE_BIG: finite so BIG + w stays ordered.
STATE_BIG = np.float32(3.4e38) / 4

OPS = ("add", "min", "max")
MULS = ("times", "plus", "second", "first")
# the generic scan's ops and dtypes, in the order of gb_segscan's codes
SCAN_OPS = ("add", "min", "max", "fill")
SCAN_DTYPES = (torch.float32, torch.int32, torch.int16, torch.int8, torch.uint8)
# launch counts by kernel name
KERNELS = ("segscan_contrib", "segscan_state", "segscan", "segscan_contrib_gather", "segscan_spmm", "segscan_spmm_keep")
# the k-column product's multiplies (w alone for second, x alone for first,
# 1 for pair), value types and widest k
SPMM_MULS = ("times", "plus", "second", "first", "pair")
SPMM_DTYPES = (torch.float32, torch.float64)
SPMM_MAX_COLUMNS = 8
# slots a ``spmm_tile_base`` entry covers; every tile of the k-column kernel
# is a multiple (``csrc/spmm.cu`` kGranule)
SPMM_GRANULE = 256
# segments a block of ``segscan_spmm_keep`` takes (``csrc/spmm.cu`` kKeepTile)
SPMM_KEEP_TILE = 2048
# the device counts of the masked products: the slots kept, and the plan's
# slots (``core.telemetry.device_counters``)
SPMM_KEPT_COUNTERS = ("ops.spmm_kept_slots", "ops.spmm_masked_slots")


def _ident(op, dtype):
    """Identity of the scan op in ``dtype`` (graphblas_tpu/ops/pallas_scan.py:52)."""
    if op in ("fill", "add"):
        return 0
    if dtype.is_floating_point:
        return math.inf if op == "min" else -math.inf
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


# the integer view of each float width (signed-zero ties)
_FLOAT_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _tie_bits(a, b, r, join):
    """``r`` where a != b; where a == b the bits of a and b joined by ``join``
    (equal values have equal bits but for the signed zeros)."""
    bits = _FLOAT_BITS.get(a.dtype)
    if bits is None:
        return r
    tie = join(a.view(bits), b.view(bits)).view(a.dtype)
    return torch.where(a == b, tie, r)


def _minimum(a, b):
    """jnp.minimum: NaN propagates and -0.0 is below +0.0 (torch.minimum
    keeps its first operand on a tie of zeros)."""
    return _tie_bits(a, b, torch.minimum(a, b), torch.bitwise_or)


def _maximum(a, b):
    """jnp.maximum: NaN propagates and +0.0 is above -0.0."""
    return _tie_bits(a, b, torch.maximum(a, b), torch.bitwise_and)


def _combine(op, av, af, bv, bf):
    """Segmented-scan combine; b is later, a set flag in ``bf`` starts a
    segment (graphblas_tpu/ops/pallas_scan.py:36)."""
    if op == "fill":
        newv = torch.where(bf, bv, av)
    elif op == "add":
        newv = torch.where(bf, bv, av + bv)
    elif op == "min":
        newv = torch.where(bf, bv, _minimum(av, bv))
    else:
        newv = torch.where(bf, bv, _maximum(av, bv))
    return newv, af | bf


def _compute_dtype(dtype):
    """8- and 16-bit integer channels compute in int32
    (graphblas_tpu/ops/pallas_scan.py:112 widens 8-bit ones)."""
    return torch.int32 if dtype.itemsize < 4 and not dtype.is_floating_point else dtype


def _scan_plain(op, v, f):
    """Inclusive segmented scan along the first axis by shifted combines,
    until every slot's window reaches past slot 0 into the identity
    (floor(log2 n) + 1 of them): a fill before the first flag then reads 0,
    slot n - 1 of a power-of-two n included.  ``v`` may have columns; ``f``
    then has one column that every column shares."""
    ident = _ident(op, v.dtype)
    n = v.shape[0]
    d = 1
    while d <= n:
        sv = torch.cat([torch.full((d,) + v.shape[1:], ident, dtype=v.dtype, device=v.device), v[:-d]])
        sf = torch.cat([torch.zeros((d,) + f.shape[1:], dtype=torch.bool, device=f.device), f[:-d]])
        v, f = _combine(op, sv, sf, v, f)
        d *= 2
    return v


def _wrap_plain(c, bits, signed):
    """Truncate int32 contributions to ``bits`` (two's complement)."""
    mask = (1 << bits) - 1
    if signed:
        half = 1 << (bits - 1)
        return ((c + half) & mask) - half
    return c & mask


def _same_device(*ts):
    dev = ts[0].device
    for t in ts:
        if t is not None and t.device != dev:
            raise ValueError(f"segscan: tensors on {dev} and {t.device}")


def _check_common(xe, w, valid, flags):
    if xe.dim() != 1:
        raise ValueError("segscan: xe must be 1-D")
    n = xe.shape[0]
    for name, t in (("valid", valid), ("flags", flags)):
        if t.dtype != torch.bool or t.shape != (n,):
            raise ValueError(f"segscan: {name} must be bool of xe's length")
    if w is not None and w.shape != (n,):
        raise ValueError("segscan: w must have xe's length")
    _same_device(xe, w, valid, flags)


def _check_contrib(xe, w, valid, flags, op, mul, wrap, idx=None):
    """C's inputs; with ``idx``, the fused gather's: x (any length, xe's
    types) and an int32 ``idx`` that w, valid and flags are as long as."""
    if idx is not None:
        if xe.dim() != 1:
            raise ValueError("segscan_contrib_gather: x must be 1-D")
        if idx.dtype != torch.int32:
            raise TypeError(f"segscan_contrib_gather: idx must be int32, got {idx.dtype}")
        _same_device(xe, idx)
    _check_common(xe if idx is None else idx, w, valid, flags)
    if op not in OPS:
        raise ValueError(f"segscan_contrib: op {op!r} not in {OPS}")
    if mul not in MULS:
        raise ValueError(f"segscan_contrib: mul {mul!r} not in {MULS}")
    if xe.dtype not in (torch.float32, torch.int32, torch.int8):
        raise TypeError(f"segscan_contrib: xe must be float32, int32 or int8, got {xe.dtype}")
    if w is not None and w.dtype != xe.dtype:
        raise TypeError(f"segscan_contrib: w is {w.dtype} but xe is {xe.dtype}")
    if wrap is not None:
        bits, _ = wrap
        if xe.dtype.is_floating_point or bits not in (8, 16):
            raise ValueError(f"segscan_contrib: wrap {wrap} needs an integer channel and 8 or 16 bits")


def segscan_contrib_plain(xe, w, valid, flags, op, mul, wrap=None):
    """Plain PyTorch version of Kernel C (any device)."""
    _check_contrib(xe, w, valid, flags, op, mul, wrap)
    _telemetry.count("kernels.plain.segscan_contrib")
    return _contrib_plain(xe, w, valid, flags, op, mul, wrap)


def segscan_contrib_gather_plain(x, idx, w, valid, flags, op, mul, wrap=None):
    """Plain PyTorch version of the fused gather (any device):
    ``segscan_contrib_plain(x[idx], ...)``."""
    _check_contrib(x, w, valid, flags, op, mul, wrap, idx)
    _telemetry.count("kernels.plain.segscan_contrib_gather")
    return _contrib_plain(x[idx.long()], w, valid, flags, op, mul, wrap)


def _contrib_plain(xe, w, valid, flags, op, mul, wrap):
    io = xe.dtype
    cd = _compute_dtype(io)
    c = xe.to(cd)
    if w is not None:
        wc = w.to(cd)
        if mul == "times":
            c = c * wc
        elif mul == "plus":
            c = c + wc
        elif mul == "second":
            c = wc
    if wrap is not None and mul in ("times", "plus"):
        c = _wrap_plain(c, *wrap)
    c = torch.where(valid, c, torch.tensor(_ident(op, io), dtype=cd, device=c.device))
    return _scan_plain(op, c, flags).to(io)


def _tile_state(n, tile, device):
    """The single pass's scratch: the descriptors of its ``tile``-slot tiles
    and the ticket counter, zeroed (one memset)."""
    return torch.zeros(-(-n // tile) + 1, dtype=torch.int64, device=device)


def _require_cuda(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_contrib(name, x, idx, w, valid, flags, op, mul, wrap):
    """Kernel C (``idx`` None) or the fused gather: x and w widened to the
    compute type (x over its own entries), one launch, the IO type out."""
    _require_cuda(name, x, idx, w, valid, flags)
    io = x.dtype
    cd = _compute_dtype(io)
    xc = x.to(cd)
    wc = w.to(cd) if w is not None else None
    lib = _build.library()
    n = valid.numel()
    out = torch.empty(n, dtype=cd, device=x.device)
    tile_state = _tile_state(n, lib.gb_segscan_tile(), x.device)
    bits, signed = wrap if wrap is not None else (0, False)
    codes = (
        n, int(cd == torch.int32), OPS.index(op), MULS.index(mul), int(bits), int(bool(signed)),
        float(_ident(op, io)), _build.stream_of(x),
    )
    with torch.cuda.device(x.device):
        if idx is None:
            rc = lib.gb_segscan_contrib(
                xc.data_ptr(), _ptr(wc), valid.data_ptr(), flags.data_ptr(), out.data_ptr(),
                tile_state.data_ptr(), *codes,
            )
        else:
            rc = lib.gb_segscan_contrib_gather(
                xc.data_ptr(), idx.data_ptr(), _ptr(wc), valid.data_ptr(), flags.data_ptr(), out.data_ptr(),
                tile_state.data_ptr(), *codes,
            )
    _build.check(rc, name)
    _telemetry.count("kernels.launches." + name)
    return out.to(io)


def segscan_contrib(xe, w, valid, flags, op, mul, wrap=None):
    """Fused multiply + mask + segmented scan.  CPU tensors take the plain
    version; CUDA tensors launch Kernel C (int8 rides it as int32)."""
    if xe.device.type == "cpu":
        return segscan_contrib_plain(xe, w, valid, flags, op, mul, wrap)
    with _telemetry.span("kernels.segscan_contrib"):
        _check_contrib(xe, w, valid, flags, op, mul, wrap)
        return _launch_contrib("segscan_contrib", xe, None, w, valid, flags, op, mul, wrap)


def segscan_contrib_gather(x, idx, w, valid, flags, op, mul, wrap=None):
    """``segscan_contrib(x[idx], w, valid, flags, op, mul, wrap)`` in one
    launch, the gather fused into C's tiles.  ``idx`` (int32) must lie in
    ``[0, len(x))`` wherever ``valid`` is set: the caller guarantees it (the
    SpMV plans do, as built and as read from a file), since the kernel reads
    ``x[idx]`` unchecked to keep the launch free of a host read.  CPU tensors
    take the plain version, which raises on any index outside x."""
    if x.device.type == "cpu":
        return segscan_contrib_gather_plain(x, idx, w, valid, flags, op, mul, wrap)
    with _telemetry.span("kernels.segscan_contrib_gather"):
        _check_contrib(x, w, valid, flags, op, mul, wrap, idx)
        return _launch_contrib("segscan_contrib_gather", x, idx, w, valid, flags, op, mul, wrap)


def _check_spmm(x, xs, idx, w, valid, flags, seg_vertex, op, mul):
    if x.dim() != 2 or not 1 <= x.shape[1] <= SPMM_MAX_COLUMNS:
        raise ValueError(f"segscan_spmm: x must be 2-D with 1 to {SPMM_MAX_COLUMNS} columns, got {tuple(x.shape)}")
    if x.dtype not in SPMM_DTYPES:
        raise TypeError(f"segscan_spmm: x must be float32 or float64, got {x.dtype}")
    if xs is not None and (xs.dtype != torch.bool or xs.shape != x.shape):
        raise ValueError("segscan_spmm: xs must be bool of x's shape")
    if idx.dtype != torch.int32:
        raise TypeError(f"segscan_spmm: idx must be int32, got {idx.dtype}")
    if seg_vertex.dtype != torch.int32 or seg_vertex.dim() != 1:
        raise TypeError("segscan_spmm: seg_vertex must be 1-D int32")
    _check_common(idx, w, valid, flags)
    _same_device(x, xs, idx, seg_vertex)
    if op not in OPS:
        raise ValueError(f"segscan_spmm: op {op!r} not in {OPS}")
    if mul not in SPMM_MULS:
        raise ValueError(f"segscan_spmm: mul {mul!r} not in {SPMM_MULS}")
    if (w is not None) != (mul in ("times", "plus", "second")):
        raise ValueError(f"segscan_spmm: mul {mul!r} {'takes no' if w is not None else 'needs'} w")
    if w is not None and w.dtype != torch.float32:
        raise TypeError(f"segscan_spmm: w must be float32, got {w.dtype}")


class SpmmRows:
    """What the row-selected k-column product needs of one slot layout (a
    plan's dst order): segment o is row ``seg_vertex[o]`` over the slots
    ``[row_first[r], row_first[r + 1])``; ``pad_from`` is the first slot of
    the run of invalid slots that ends the layout (a plan's padding), cut
    from every segment.  On a CUDA device it also holds the scratch of
    ``segscan_spmm_keep`` (int32: the kept list, three entries a segment and
    one more, ``masked_rows``, and a tile entry for every 256 slots; its
    header and look-back words) and the device counts it adds to, all made
    here, before any capture, and reused by every product of the layout.
    ``valid`` is read once on the host."""

    def __init__(self, row_first, seg_vertex, valid):
        if row_first.dtype != torch.int32 or seg_vertex.dtype != torch.int32:
            raise TypeError("SpmmRows: row_first and seg_vertex must be int32")
        self.row_first, self.seg_vertex = row_first, seg_vertex
        self.n_slots = valid.numel()
        if self.n_slots >= 1 << 31:
            raise ValueError(f"SpmmRows: {self.n_slots} slots do not fit the kept list's int32 counts")
        v = valid.cpu().numpy()
        self.pad_from = int(v.size - np.argmax(v[::-1])) if v.any() else 0
        dev = seg_vertex.device
        self.tally = _telemetry.device_counters(SPMM_KEPT_COUNTERS, dev)
        self.scratch = None
        if dev.type == "cuda":
            nseg = seg_vertex.numel()

            def i32(size):
                return torch.zeros(size, dtype=torch.int32, device=dev)

            self.scratch = {
                "ctl": torch.zeros(2 + -(-nseg // SPMM_KEEP_TILE), dtype=torch.int64, device=dev),
                "kept_row": i32(nseg + 8),  # the product reads a tile's rows in 16-byte pieces
                "kept_start": i32(nseg),
                "kept_cum": i32(nseg + 1),
                "tile_info": i32(-(-self.n_slots // SPMM_GRANULE) + 2),
                "masked_rows": i32(nseg + 8),
            }

    @classmethod
    def of(cls, flags, seg_vertex, valid, n_out):
        """The layout of a kernel's inputs whose segments' rows increase
        with their slots (as a plan's): each row's slots from the flags."""
        starts = torch.nonzero(flags).flatten()
        lens = torch.diff(torch.cat([starts, starts.new_full((1,), flags.numel())]))
        per_row = torch.zeros(n_out, dtype=torch.int64, device=flags.device)
        per_row[seg_vertex.long()] = lens
        row_first = torch.cat([per_row.new_zeros(1), torch.cumsum(per_row, 0)]).to(torch.int32)
        if starts.numel() and not torch.equal(row_first[seg_vertex.long()], starts.to(torch.int32)):
            raise ValueError("SpmmRows.of: the segments' rows must increase with their slots")
        return cls(row_first, seg_vertex, valid)


def _kept_segments(keep, rows):
    """(kept, lens, start): the segments the mask bits ``keep`` reach with a
    slot before ``rows.pad_from``, every segment's slots so cut, and its
    first slot."""
    sv = rows.seg_vertex.long()
    rf = rows.row_first.long()
    start = rf[sv]
    lens = (torch.clamp(rf[sv + 1], max=rows.pad_from) - start).clamp(min=0)
    return keep[sv].any(1) & (lens > 0), lens, start


def spmm_keep_plain(keep, rows, tile):
    """Plain version of ``segscan_spmm_keep`` (any device; reads the card):
    the kept segments in slot order, their rows (``kept_row``), first slots
    (``kept_start``) and the kept slots before each and in all
    (``kept_cum``, one entry more), ``masked_rows`` (seg_vertex, -1 where
    not kept), ``tile_info`` (for each kept tile of ``tile`` slots and the
    one past them: 2 o + 1 where kept segment o starts at its first slot,
    else 2 (o + 1), o the one holding it; past them 2 n_kept + 1), and the
    totals ``n_kept`` and ``kept_slots``."""
    _telemetry.count("kernels.plain.segscan_spmm_keep")
    kept, lens, start = _kept_segments(keep, rows)
    lk = lens[kept]
    cum = torch.cat([lk.new_zeros(1), torch.cumsum(lk, 0)])
    n_kept, total = int(kept.sum()), int(cum[-1])
    at = torch.arange(0, -(-total // tile) * tile, tile, device=cum.device)
    j = torch.searchsorted(cum[:-1], at, right=True) - 1
    info = torch.where(cum[j.clamp(min=0)] == at, 2 * j + 1, 2 * (j + 1))
    info = torch.cat([info, info.new_full((1,), 2 * n_kept + 1)])
    sv = rows.seg_vertex
    return {
        "kept_row": sv[kept], "kept_start": start[kept].int(), "kept_cum": cum.int(),
        "masked_rows": torch.where(kept, sv, torch.full_like(sv, -1)), "tile_info": info.int(),
        "n_kept": n_kept, "kept_slots": total,
    }


def _check_keep(keep, x, n_out, rows, n):
    if keep.dtype != torch.bool or keep.shape != (n_out, x.shape[1]):
        raise ValueError(f"segscan_spmm: keep must be bool of Y's shape {(n_out, x.shape[1])}, got {tuple(keep.shape)}")
    if rows is not None and rows.n_slots != n:
        raise ValueError(f"segscan_spmm: the SpmmRows are of {rows.n_slots} slots, not {n}")
    _same_device(x, keep)


def segscan_spmm_plain(x, xs, idx, w, valid, flags, seg_vertex, n_out, op, mul, tile_base=None, keep=None, rows=None):
    """Plain PyTorch version of the k-column product (any device): the
    contributions ``x[idx] MUL w`` where ``valid`` and x's structure
    ``xs`` (None: every x present) hold, else the identity; the segmented
    scan of each column; and at each segment's last slot, the row
    ``seg_vertex[o]`` (o: the flags up to the slot, less one) of Y, 0 where
    no contribution was present, and of Y's structure.  Rows of no segment
    read 0 and absent.  ``tile_base`` is the kernel's and is not read.

    The row-selected product: with ``keep`` (bool, Y's shape: the cells a
    statement's mask lets it write), the rows where no cell of ``keep`` is
    set read 0 and absent, and ``rows`` (the layout's ``SpmmRows``, if
    given) takes the kept slots and the plan's into its device counts."""
    _check_spmm(x, xs, idx, w, valid, flags, seg_vertex, op, mul)
    if keep is not None:
        _check_keep(keep, x, n_out, rows, valid.numel())
    _telemetry.count("kernels.plain.segscan_spmm")
    j = idx.long()
    present = valid[:, None] if xs is None else valid[:, None] & xs[j]
    xe = x[j]
    wc = w.to(x.dtype)[:, None] if w is not None else None
    if mul == "times":
        c = xe * wc
    elif mul == "plus":
        c = xe + wc
    elif mul == "second":
        c = wc.expand_as(xe)
    elif mul == "pair":
        c = torch.ones_like(xe)
    else:
        c = xe
    c = torch.where(present, c, torch.tensor(_ident(op, x.dtype), dtype=x.dtype, device=x.device))
    f = flags[:, None]
    scanned = _scan_plain(op, c, f)
    seen = _scan_plain("add", present.to(torch.int32), f) > 0
    # each segment's last slot writes its row; every other slot the spare row n_out
    last = torch.ones_like(flags)
    last[:-1] = flags[1:]
    ordinal = torch.cumsum(flags, 0) - 1
    dest = seg_vertex.long()[ordinal.clamp(min=0)]
    dest = torch.where(last & (ordinal >= 0), dest, torch.full_like(dest, n_out))
    out_v = torch.zeros((n_out + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    out_s = torch.zeros((n_out + 1, x.shape[1]), dtype=torch.bool, device=x.device)
    out_v[dest] = torch.where(seen, scanned, torch.zeros((), dtype=x.dtype, device=x.device))
    out_s[dest] = seen
    out_v, out_s = out_v[:n_out], out_s[:n_out]
    if keep is None:
        return out_v, out_s
    _telemetry.count("kernels.plain.segscan_spmm_keep")
    if rows is not None:
        kept, lens, _ = _kept_segments(keep, rows)
        rows.tally.add_(torch.stack([(lens * kept).sum(), lens.new_tensor(valid.numel())]).to(rows.tally))
    sel = keep.any(1, keepdim=True)
    return torch.where(sel, out_v, torch.zeros((), dtype=x.dtype, device=x.device)), out_s & sel


def spmm_tile_base(flags):
    """The k-column kernel's flags before each ``SPMM_GRANULE``-slot block
    (int32, ``ceil(n / SPMM_GRANULE) + 1`` entries, the last the total), on
    ``flags``' device: a plan's, computed once, whatever k and dtype."""
    n = flags.numel()
    nb = -(-n // SPMM_GRANULE)
    padded = torch.zeros(nb * SPMM_GRANULE, dtype=torch.int32, device=flags.device)
    padded[:n] = flags
    counts = padded.view(nb, SPMM_GRANULE).sum(1, dtype=torch.int32)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])


def spmm_columns(k):
    """The columns a launch of k columns computes: k rounded up to 1, 2, 4 or 8."""
    return 1 if k <= 1 else 2 if k <= 2 else 4 if k <= 4 else 8


def spmm_tile(k, dtype):
    """Slots a tile of the k-column kernel holds for k columns of ``dtype``:
    its shared memory keeps, a slot, two stages of the plan's stream (10
    bytes each), a value row (the columns rounded up, in ``dtype``), a cell
    of x's structure (16 bytes from 4 columns, else the 4-byte words a row
    spans), a presence byte and a segment row (4 bytes); the tile is the
    largest multiple of 2048 / columns slots up to 2048 within 112 KiB, and
    at least 2048 / columns (``csrc/spmm.cu`` ``tile_for``)."""
    kp = spmm_columns(k)
    cell = 16 if kp >= 4 else 4 * ((kp + 6) // 4)
    slot = 2 * 10 + kp * torch.empty((), dtype=dtype).element_size() + cell + 1 + 4
    step = max(2048 // kp, SPMM_GRANULE)
    for tile in range(2048, step, -step):
        if tile * slot + 32 <= 112 * 1024:
            return tile
    return step


def spmm_tiles(n, k, dtype, idx, w, valid, flags):
    """(tiles, staged tiles) of a launch over n slots: the staged ones are
    the full tiles, where the plan's streams (idx, w, valid, flags) are
    16-byte aligned and arrive by bulk copy; the ragged last tile and every
    tile of an unaligned stream are loaded by the threads instead.  Both
    gather their x rows by ``cp.async``.  From the sizes and pointers alone,
    on any device."""
    tile = spmm_tile(k, dtype)
    aligned = all(t.data_ptr() % 16 == 0 for t in (idx, w, valid, flags) if t is not None)
    return -(-n // tile), (n // tile if aligned else 0)


def spmm_geometry(k, dtype):
    """The k-column kernel's instance for k columns of ``dtype``, as the card
    reports it: ``tile`` (slots), ``smem`` (dynamic shared memory bytes),
    ``blocks_per_sm`` (resident), ``registers`` and ``local_bytes`` (spills
    and stack) a thread of its plus instance."""
    out = (ctypes.c_int * 5)()
    lib = _build.library()
    _build.check(lib.gb_segscan_spmm_geometry(k, int(dtype == torch.float64), out), "segscan_spmm")
    return dict(zip(("tile", "smem", "blocks_per_sm", "registers", "local_bytes"), out))


def _launch_keep(lib, keep, rows, tile, stream):
    """``segscan_spmm_keep`` into ``rows``' scratch: the segments that the mask
    bits ``keep`` reach, listed for tiles of ``tile`` slots."""
    sc = rows.scratch
    sc["ctl"].zero_()
    rc = lib.gb_segscan_spmm_keep(
        keep.data_ptr(), keep.shape[1], rows.seg_vertex.data_ptr(), rows.row_first.data_ptr(),
        rows.seg_vertex.numel(), rows.pad_from, sc["kept_row"].data_ptr(), sc["kept_start"].data_ptr(),
        sc["kept_cum"].data_ptr(), sc["masked_rows"].data_ptr(), sc["tile_info"].data_ptr(), sc["ctl"].data_ptr(),
        rows.tally.data_ptr(), rows.n_slots, tile, stream,
    )
    _build.check(rc, "segscan_spmm_keep")
    _telemetry.count("kernels.launches.segscan_spmm_keep")
    return [sc[name].data_ptr() for name in ("ctl", "kept_row", "kept_start", "kept_cum", "tile_info", "masked_rows")]


def segscan_spmm(x, xs, idx, w, valid, flags, seg_vertex, n_out, op, mul, tile_base=None, keep=None, rows=None):
    """Y = A (.) X for a dense n x k X in one launch: ``segscan_spmm_plain``'s
    function.  ``idx`` must lie in [0, len(x)) wherever ``valid`` is set and
    ``seg_vertex`` in [0, n_out), as the SpMV plans keep them (the kernel
    reads both unchecked); ``tile_base`` is ``spmm_tile_base(flags)``,
    computed here when not given.  With ``keep`` (the cells a statement's
    mask lets it write) and ``rows`` (the layout's ``SpmmRows``), a launch
    of ``segscan_spmm_keep`` lists the rows it reaches first, and the
    product streams their segments alone; the other rows read absent.  CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return segscan_spmm_plain(x, xs, idx, w, valid, flags, seg_vertex, n_out, op, mul, tile_base, keep, rows)
    with _telemetry.span("kernels.segscan_spmm"):
        _check_spmm(x, xs, idx, w, valid, flags, seg_vertex, op, mul)
        _require_cuda("segscan_spmm", x, xs, idx, w, valid, flags, seg_vertex)
        lib = _build.library()
        k = x.shape[1]
        n = valid.numel()
        tiles, staged = spmm_tiles(n, k, x.dtype, idx, w, valid, flags)
        if tile_base is None:
            tile_base = spmm_tile_base(flags)
        dev = x.device
        stream = _build.stream_of(x)
        kept = [None] * 6
        if keep is not None:
            _check_keep(keep, x, n_out, rows, n)
            if rows is None or rows.scratch is None or rows.seg_vertex.numel() != seg_vertex.numel():
                raise ValueError("segscan_spmm: a mask needs the layout's SpmmRows on the card")
            with torch.cuda.device(dev):
                kept = _launch_keep(lib, keep.contiguous(), rows, spmm_tile(k, x.dtype), stream)
        out_v = torch.zeros((n_out, k), dtype=x.dtype, device=dev)
        out_s = torch.zeros((n_out, k), dtype=torch.bool, device=dev)
        status = torch.zeros(tiles + 1, dtype=torch.int64, device=dev)
        vals = torch.empty(2 * tiles * spmm_columns(k), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            rc = lib.gb_segscan_spmm(
                x.data_ptr(), _ptr(xs), idx.data_ptr(), _ptr(w), valid.data_ptr(), flags.data_ptr(),
                seg_vertex.data_ptr(), tile_base.data_ptr(), out_v.data_ptr(), out_s.data_ptr(),
                status.data_ptr(), vals.data_ptr(), n, k, int(x.dtype == torch.float64), OPS.index(op),
                SPMM_MULS.index(mul), spmm_tile(k, x.dtype), stream, *kept,
            )
        _build.check(rc, "segscan_spmm")
        _telemetry.count("kernels.launches.segscan_spmm")
        _count_spmm_sizes(x, xs, w, n, n_out, mul)
        _telemetry.count("kernels.spmm.tiles", tiles)
        _telemetry.count("kernels.spmm.async_tiles", staged)
        return out_v, out_s


def _count_spmm_sizes(x, xs, w, n, n_out, mul):
    """What one launch moves at the least, by kind (the counters
    ``kernels.spmm.*``; the benchmark's ``spmm_roofline`` prices them):
    the slots streamed, those whose weight is read, x's structure read, x's
    values read (by element size) where x is full, and Y's cells written.
    Where x's structure is given the kernel reads only the present values,
    a share known on the card alone: they are left out."""
    item = x.element_size()
    _telemetry.count("kernels.spmm.calls")
    _telemetry.count("kernels.spmm.slots", n)
    if w is not None:
        _telemetry.count("kernels.spmm.weight_slots", n)
    if xs is not None:
        _telemetry.count("kernels.spmm.x_struct_cells", xs.numel())
    elif mul not in ("second", "pair"):
        _telemetry.count(f"kernels.spmm.x_cells.{item}", x.numel())
    _telemetry.count(f"kernels.spmm.y_cells.{item}", n_out * x.shape[1])


def _check_state(mode, xe, w, valid, flags, is_last, state, fr_reduce):
    _check_common(xe, w, valid, flags)
    if mode not in ("bfs", "sssp"):
        raise ValueError(f"segscan_state: mode {mode!r} not in ('bfs', 'sssp')")
    if fr_reduce and mode != "sssp":
        raise ValueError("fr_reduce is an sssp-only contract")
    if xe.dtype != torch.float32 or (w is not None and w.dtype != torch.float32):
        raise TypeError("segscan_state: xe and w must be float32")
    want = torch.int32 if mode == "bfs" else torch.float32
    if state.dtype != want or state.shape != xe.shape:
        raise TypeError(f"segscan_state: {mode} state must be {want} of xe's length")
    if is_last.dtype != torch.bool or is_last.shape != xe.shape:
        raise ValueError("segscan_state: is_last must be bool of xe's length")
    _same_device(xe, is_last, state)


def segscan_state_plain(mode, xe, w, valid, flags, is_last, state, depth, fr_reduce=False):
    """Plain PyTorch version of Kernel S (any device).  Returns (new_state,
    frontier or changed f32); with ``fr_reduce`` the second output is one
    int32 flag, 1 if any slot changed."""
    _check_state(mode, xe, w, valid, flags, is_last, state, fr_reduce)
    _telemetry.count("kernels.plain.segscan_state")
    op = "max" if mode == "bfs" else "min"
    x = xe if w is None else xe + w
    contrib = torch.where(valid, x, torch.tensor(_ident(op, torch.float32), device=x.device))
    out = _scan_plain(op, contrib, flags)
    if mode == "bfs":
        nxt = is_last & (out > 0) & (state < 0)
        new = torch.where(nxt, torch.tensor(int(depth) + 1, dtype=torch.int32, device=state.device), state)
        return new, nxt.to(torch.float32)
    big = torch.tensor(STATE_BIG, dtype=torch.float32, device=state.device)
    new = torch.where(is_last, _minimum(state, out), big)
    ch = new < state
    if fr_reduce:
        return new, ch.any().to(torch.int32).reshape(1)
    return new, ch.to(torch.float32)


def segscan_state(mode, xe, w, valid, flags, is_last, state, depth, fr_reduce=False):
    """Fused segmented scan + BFS/SSSP state update.  CPU tensors take the
    plain version; CUDA tensors launch Kernel S.  ``depth`` is a host int."""
    if xe.device.type == "cpu":
        return segscan_state_plain(mode, xe, w, valid, flags, is_last, state, depth, fr_reduce)
    with _telemetry.span("kernels.segscan_state"):
        _check_state(mode, xe, w, valid, flags, is_last, state, fr_reduce)
        _require_cuda("segscan_state", xe, w, valid, flags, is_last, state)
        lib = _build.library()
        n = xe.numel()
        dev = xe.device
        out_state = torch.empty_like(state)
        if fr_reduce:
            out_fr = None
            any_changed = torch.zeros(1, dtype=torch.int32, device=dev)
        else:
            out_fr = torch.empty(n, dtype=torch.float32, device=dev)
            any_changed = None
        tile_state = _tile_state(n, lib.gb_segscan_state_tile(), dev)
        with torch.cuda.device(dev):
            rc = lib.gb_segscan_state(
                0 if mode == "bfs" else 1, xe.data_ptr(), _ptr(w), valid.data_ptr(), flags.data_ptr(),
                is_last.data_ptr(), state.data_ptr(), int(depth), out_state.data_ptr(), _ptr(out_fr),
                _ptr(any_changed), tile_state.data_ptr(), n, _build.stream_of(xe),
            )
        _build.check(rc, "segscan_state")
        _telemetry.count("kernels.launches.segscan_state")
        return out_state, (any_changed if fr_reduce else out_fr)


def _check_scan(values, flags, op):
    if values.dim() != 1:
        raise ValueError("segscan: values must be 1-D")
    n = values.shape[0]
    if flags.dtype != torch.bool or flags.shape != (n,):
        raise ValueError("segscan: flags must be bool of values' length")
    if op not in SCAN_OPS:
        raise ValueError(f"segscan: op {op!r} not in {SCAN_OPS}")
    if values.dtype not in SCAN_DTYPES:
        raise TypeError(f"segscan: values must be one of {SCAN_DTYPES}, got {values.dtype}")
    if n % 128:
        raise ValueError(f"segscan: length {n} is not a multiple of 128")
    _same_device(values, flags)


def segscan_plain(values, flags, op):
    """Plain PyTorch version of the generic scan (any device)."""
    _check_scan(values, flags, op)
    _telemetry.count("kernels.plain.segscan")
    io = values.dtype
    return _scan_plain(op, values.to(_compute_dtype(io)), flags).to(io)


def segscan(values, flags, op):
    """Inclusive segmented scan: ``flags`` marks segment starts; op fill, add,
    min or max; a fill before the first flag reads 0.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if values.device.type == "cpu":
        return segscan_plain(values, flags, op)
    with _telemetry.span("kernels.segscan"):
        _check_scan(values, flags, op)
        _require_cuda("segscan", values, flags)
        lib = _build.library()
        n = values.numel()
        out = torch.empty(n, dtype=values.dtype, device=values.device)
        tile_state = _tile_state(n, lib.gb_segscan_tile(), values.device)
        with torch.cuda.device(values.device):
            rc = lib.gb_segscan(
                values.data_ptr(), flags.data_ptr(), out.data_ptr(), tile_state.data_ptr(), n,
                SCAN_DTYPES.index(values.dtype), SCAN_OPS.index(op), _build.stream_of(values),
            )
        _build.check(rc, "segscan")
        _telemetry.count("kernels.launches.segscan")
        return out

"""Sharded masked SpGEMM: C(M) = A (+).(x) B by mask-row blocks.

Counterpart of ``graphblas_tpu/parallel/spgemm.py``, the same design:

- **Partition by mask-row blocks**, balanced by mask entries (the work is
  per entry, not per row).  Output entries are disjoint across blocks, so no
  collective is needed: each block runs its own analyzed plan
  (``core.sparse.sparse_spgemm_analyze(..., device=shard)``) on its shard's
  device; a block with no mask entries gets no plan.
- **Operands replicate**: A's rows outside a block are never touched by its
  tasks, B is read column-wise by every block.
- Each block's ``acc`` and ``hit`` stay on its device; they scatter into
  mask-entry order on the mesh's first device, and the one read to the host
  is ``sharded_masked_mxm_arrays``' (as ``core.sparse.sparse_mxm_masked``).
"""

import numpy as np
import torch

from ..core import dtypes as _dt


def _row_blocks(m_rows, nrows, ndev):
    """Balanced mask-row partition: split the row space so each block holds
    ~equal mask ENTRIES."""
    m_rows = np.asarray(m_rows)
    if len(m_rows) == 0:
        step = -(-nrows // ndev)
        return [(d * step, min((d + 1) * step, nrows)) for d in range(ndev)]
    counts = np.bincount(m_rows, minlength=nrows)
    csum = np.concatenate([[0], np.cumsum(counts)])
    total = csum[-1]
    bounds = [0]
    for d in range(1, ndev):
        target = total * d // ndev
        bounds.append(int(np.searchsorted(csum, target)))
    bounds.append(nrows)
    return [(bounds[d], bounds[d + 1]) for d in range(ndev)]


class ShardedSpgemmPlan:
    """Per-shard analyzed plans for one (A, B, M, partition) pattern."""

    __slots__ = ("blocks", "n_entries", "out_order", "_sel_dev")

    def __init__(self, blocks, n_entries, out_order):
        self.blocks = blocks  # [(device, plan | None, entry_idx)]
        self.n_entries = n_entries
        self.out_order = out_order  # block-concat position -> entry id
        self._sel_dev = {}

    @property
    def out_device(self):
        """Where the blocks' results gather: the first shard's device."""
        return self.blocks[0][0]


def sharded_spgemm_analyze(a_sp, b_sp, m_rows, m_cols, devices, **opts):
    """Analyze C(M) = A (.) B into per-shard mask-row-block plans, block d's
    on ``devices[d]``."""
    from ..core.sparse import sparse_spgemm_analyze

    m_rows = np.asarray(m_rows, np.int64)
    m_cols = np.asarray(m_cols, np.int64)
    ndev = len(devices)
    blocks = []
    order_parts = []
    for d, (lo, hi) in enumerate(_row_blocks(m_rows, a_sp.nrows, ndev)):
        sel = np.flatnonzero((m_rows >= lo) & (m_rows < hi))
        if len(sel) == 0:
            blocks.append((devices[d], None, sel))
            continue
        plan = sparse_spgemm_analyze(a_sp, b_sp, m_rows[sel], m_cols[sel], device=devices[d], **opts)
        blocks.append((devices[d], plan, sel))
        order_parts.append(sel)
    out_order = np.concatenate(order_parts) if order_parts else np.empty(0, np.int64)
    return ShardedSpgemmPlan(blocks, len(m_rows), out_order)


def sharded_spgemm_execute(splan, sr, out_dtype):
    """Run every shard's block; returns (values, hit, total flops) on the
    first shard's device, values and hit in mask-entry order (values in
    ``out_dtype``'s carrier, flops an int64 0-d tensor).  The JAX package
    returns host arrays here; the port reads the host once, in
    ``sharded_masked_mxm_arrays``."""
    from ..core.sparse import sparse_spgemm_execute

    dev = splan.out_device
    vals = torch.zeros(splan.n_entries, dtype=out_dtype.carrier, device=dev)
    hits = torch.zeros(splan.n_entries, dtype=torch.bool, device=dev)
    flops = torch.zeros((), dtype=torch.int64, device=dev)
    for k, (_device, plan, sel) in enumerate(splan.blocks):
        if plan is None:
            continue
        acc, hit, fl = sparse_spgemm_execute(plan, sr, out_dtype, keep_on_device=True)
        idx = splan._sel_dev.get(k)
        if idx is None:
            idx = splan._sel_dev[k] = torch.from_numpy(sel).to(dev)
        vals[idx] = acc[: len(sel)].to(dev)
        hits[idx] = hit[: len(sel)].to(dev)
        flops = flops + fl.to(dev)
    return vals, hits, flops


def sharded_masked_mxm_arrays(a_sp, b_sp, m_rows, m_cols, sr, out_dtype, context):
    """One-shot sharded masked mxm.  Same contract as
    ``core.sparse.sparse_mxm_masked``: host (rows, cols, values, flops)
    restricted to the mask entries whose intersection is non-empty."""
    m_rows = np.asarray(m_rows, np.int64)
    m_cols = np.asarray(m_cols, np.int64)
    if a_sp.nvals == 0 or b_sp.nvals == 0:
        out_np = np.dtype(out_dtype.np_type)
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, out_np), 0
    devices = context.mesh.device_list()
    use_bricks = (
        sr.monoid.parent.name == "plus"
        and sr.binaryop.parent.name in ("pair", "times")
        and out_dtype == _dt.FP32
    )
    splan = sharded_spgemm_analyze(a_sp, b_sp, m_rows, m_cols, devices, bricks=use_bricks)
    vals, hits, flops = sharded_spgemm_execute(splan, sr, out_dtype)
    keep = hits.cpu().numpy()
    return m_rows[keep], m_cols[keep], _dt.to_numpy(vals, out_dtype)[keep], int(flops)

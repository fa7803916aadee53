"""Sharded SpMV: the analyzed-COO engine over a mesh of shards.

Counterpart of ``graphblas_tpu/parallel/fastspmv.py``, the same design:

- **edge partition by destination range**: shard k owns the edges whose dst
  lies in ``[bounds[k], bounds[k + 1])``, ``bounds[k] = (k * n) // P``, so
  each segmented reduce is local to its shard;
- **one SpmvPlan per shard**, each on its shard's device, all padded to one
  ``e_pad`` (``pad_to = padded_size(max(max_e, n))``), so every shard runs
  the same kernels on its own routes; each plan's arrays equal the
  reference's stacked leaf of that shard slot for slot;
- x is copied to every shard; each shard produces the full-length y with
  its own destinations filled and the monoid identity elsewhere, and ONE
  collective per SpMV combines them on the mesh's first device
  (``parallel/_collectives.combine``: the add-monoid's fold in shard order).

The per-shard body is the single-device ``ops.fastspmv.spmv`` /
``spmv_masked``, so the mesh launches the same kernels (G, its fill, C and
the generic scan) once per shard.  Where the JAX package jits each loop into
one program, the port's loops are Python loops that read one device flag a
round, as ``models/fast.py``'s.
"""

import numpy as np
import torch

from ..kernels.segscan import _minimum
from ..ops import fastspmv as _f
from ..ops.permute import padded_size
from ..ops.scan import _ident
from . import _collectives as _c
from .mesh import Mesh, default_devices


class ShardedSpmvPlan:
    """Per-shard SpmvPlans, shard k's on ``devices[k]``."""

    def __init__(self, plans, mesh, axis_name, ndev, n, bounds):
        self.plans = plans  # [SpmvPlan], one a shard
        self.mesh = mesh  # 1-D Mesh over the shards' devices
        self.axis_name = axis_name
        self.ndev = ndev
        self.n = n
        self.bounds = bounds  # dst-range boundaries, len ndev + 1

    @property
    def devices(self):
        return self.mesh.device_list()

    @property
    def out_device(self):
        """Where the collectives land: the mesh's first device."""
        return self.devices[0]

    def nbytes(self):
        return sum(t.numel() * t.element_size() for p in self.plans for t in p.arrays().values())

    def __repr__(self):
        return f"ShardedSpmvPlan(n={self.n}, ndev={self.ndev}, axis={self.axis_name!r})"


def build_sharded_spmv_plan(src, dst, w=None, *, n=None, mesh=None, ndev=None, axis_name="d"):
    """Partition a COO graph by destination range and build one plan a shard.

    ``mesh`` may be any ``parallel.mesh.Mesh`` (its devices are flattened into
    a 1-D mesh over the same shards); otherwise the shards are
    ``mesh.default_devices(ndev)``: the cards, or 8 CPU shards on the CPU
    platform.  Host-side, once per graph: the pattern-analysis step."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    devices = default_devices(ndev)[:ndev] if mesh is None else mesh.device_list()
    mesh = Mesh(devices, (axis_name,))
    ndev = len(devices)

    bounds = [(k * n) // ndev for k in range(ndev + 1)]
    parts = []
    max_e = 0
    for k in range(ndev):
        m = (dst >= bounds[k]) & (dst < bounds[k + 1])
        parts.append(m)
        max_e = max(max_e, int(m.sum()))
    pad_to = padded_size(max(max_e, n))

    plans = []
    w_arr = None if w is None else np.asarray(w)
    for m, dev in zip(parts, mesh.device_list()):
        p = _f.build_spmv_plan(src[m], dst[m], None if w_arr is None else w_arr[m], n=n, pad_to=pad_to, device=dev)
        # only the single-device pagerank loop reads k_iso_dangling
        p.k_iso_dangling = 0
        plans.append(p)
    if len({p.e_pad for p in plans}) != 1:  # same pad_to => same slot layout
        raise AssertionError(f"shard plans disagree on e_pad: {sorted({p.e_pad for p in plans})}")
    return ShardedSpmvPlan(plans, mesh, axis_name, ndev, n, bounds)


def _as_f32(splan, x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=splan.out_device)


def sharded_spmv(splan, x, add="plus", mul="times"):
    """y[d] = ADD over edges (s -> d) of (x[s] MUL w), over the mesh.

    One collective per call; everything else is shard-local engine passes.
    y lands on the mesh's first device."""
    x = _as_f32(splan, x)
    parts = [_f.spmv(p, x.to(p.device), add=add, mul=mul) for p in splan.plans]
    return _c.combine(parts, add, splan.out_device)


def sharded_spmv_masked(splan, x, xs, add="plus", mul="times"):
    """DSL-exact masked SpMV over the mesh: honours x's structure, returns
    (values, struct) on the mesh's first device.  Absent outputs of a shard
    take the monoid's identity (``any`` as max) before the combine, the
    structure combines by ``pmax``, absent outputs read 0.  ``mul='secondi'``
    (parent BFS) works: the positional channel is per-shard static data."""
    x = _as_f32(splan, x)
    # a device tensor is taken as it is: as_tensor would count as an upload
    # inside a compiled loop and keep its step off a CUDA graph
    xs = xs if isinstance(xs, torch.Tensor) else torch.as_tensor(np.asarray(xs), device=x.device)
    xs = xs.to(device=x.device, dtype=torch.bool)
    vals, structs = [], []
    for p in splan.plans:
        yv, ys = _f.spmv_masked(p, x.to(p.device), xs.to(p.device), add=add, mul=mul)
        ident = torch.full((), _ident(_f._OPS["max" if add == "any" else add], yv.dtype), dtype=yv.dtype, device=yv.device)
        vals.append(torch.where(ys, yv, ident))
        structs.append(ys)
    yv = _c.combine(vals, add, splan.out_device)
    ys = _c.pmax(structs, splan.out_device)
    return torch.where(ys, yv, torch.zeros((), dtype=yv.dtype, device=yv.device)), ys


def sharded_bfs_level(splan, source):
    """Level BFS over the mesh: one sharded max/first SpMV per level, one
    device flag read a level.  levels[v] = hops from ``source``, -1 where
    unreachable (int32)."""
    n = splan.n
    dev = splan.out_device
    source = int(source)
    levels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    levels[source] = 0
    frontier = torch.zeros(n, dtype=torch.float32, device=dev)
    frontier[source] = 1.0
    depth = 0
    while depth < n and bool(frontier.max() > 0):
        reached = sharded_spmv(splan, frontier, "max", "first") > 0
        nxt = reached & (levels < 0)
        levels = torch.where(nxt, torch.tensor(depth + 1, dtype=torch.int32, device=dev), levels)
        frontier = nxt.to(torch.float32)
        depth += 1
    return levels


def sharded_sssp(splan, source):
    """Bellman-Ford over the mesh (min/plus; the plans must carry weights).
    Unreachable vertices read float32(3.4e38) / 4."""
    n = splan.n
    dev = splan.out_device
    big = np.float32(3.4e38) / np.float32(4)
    source = int(source)
    dist = torch.full((n,), float(big), dtype=torch.float32, device=dev)
    dist[source] = 0.0
    changed = True
    it = 0
    while changed and it < n:
        relaxed = sharded_spmv(splan, dist, "min", "plus")
        new = _minimum(dist, relaxed)
        changed = bool((new < dist).any())
        dist = new
        it += 1
    return dist


def _outdeg(splan):
    """True out-degrees: each shard counts its valid out-edges per src (the
    valid flags segment-summed by ``src_dst_order``), psum'd once."""
    n = splan.n
    parts = []
    for p in splan.plans:
        deg = torch.zeros(n, dtype=torch.float32, device=p.device)
        parts.append(deg.index_add_(0, p.src_dst_order.long(), p.valid_dst_order.to(torch.float32)))
    return _c.psum(parts, splan.out_device)


def sharded_pagerank(splan, *, damping=0.85, tol=1e-6, max_iters=100, outdeg=None):
    """PageRank over the mesh: per iteration one sharded plus/first SpMV and
    the elementwise update on the mesh's first device, one device flag read
    an iteration (the largest change against ``tol``).

    ``outdeg`` (n,) true out-degrees; derived from the plans when omitted.
    Returns (ranks, iterations)."""
    n = splan.n
    dev = splan.out_device
    if outdeg is None:
        outdeg = _outdeg(splan)
    outdeg = torch.as_tensor(outdeg, device=dev).to(torch.float32).clamp_min(0.0)
    dangling = outdeg == 0
    safe_deg = torch.where(dangling, torch.ones((), device=dev), outdeg)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    r = torch.full((n,), np.float32(1.0 / n), dtype=torch.float32, device=dev)
    it = 0
    err = float("inf")
    while err > tol and it < int(max_iters):
        pulled = sharded_spmv(splan, r / safe_deg, "plus", "first")
        dangle = torch.where(dangling, r, zero).sum()
        r_new = (1.0 - damping) / n + damping * (pulled + dangle / n)
        err = float((r_new - r).abs().max())
        r = r_new
        it += 1
    return r, it

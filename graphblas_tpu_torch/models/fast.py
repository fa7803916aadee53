"""Graph algorithms on the analyzed-COO SpMV engine, in the loop layout.

Counterpart of ``graphblas_tpu/models/fast.py``: ``pagerank`` (fused
epilogue), ``bfs_level`` and ``sssp`` (donor routing and the seed round), the
default modes of the reference, and ``bfs_parent`` (one masked SpMV per
level).  Each ``lax.while_loop`` becomes a Python loop that reads one device
flag per round; everything runs on the device of the plan.
"""

import numpy as np
import torch

from ..ops.fastspmv import _seg_fill, build_spmv_plan, spmv_masked, spmv_state, state_to_n, state_to_start_post
from ..ops.permute import apply_perm
from ..ops.scan import STATE_BIG, segmented_scan_state


def analyze(graph):
    """Build the SpmvPlan of a Graph (host-side, once), on the graph's device."""
    valid = graph.valid.cpu().numpy()
    src = graph.src.cpu().numpy()[valid]
    dst = graph.dst.cpu().numpy()[valid]
    w = graph.weights.cpu().numpy()[valid] if graph.weights is not None else None
    return build_spmv_plan(src, dst, w, n=graph.n, device=graph.src.device)


def _spmv_state_update(plan, x_start, mode, state, depth):
    """Loop-layout step with the BFS/SSSP state update fused into the scan:
    fill -> perm route -> one segmented_scan_state pass.  SSSP only asks
    whether anything changed, so its kernel reduces that to one flag."""
    xe = _seg_fill(plan, x_start)
    xe_dst = apply_perm(xe, plan.perm_idx)
    w = plan.w_dst_order if mode == "sssp" else None
    return segmented_scan_state(
        mode, xe_dst, w, plan.valid_dst_order, plan.seg_start_dst, plan.is_last_dst,
        state, depth, fr_reduce=(mode == "sssp"),
    )


def _seed_ok(plan):
    """Seeding needs the static src-id channel and the state-slot tables."""
    return plan.src_dst_order is not None and plan.seg_start_dst is not None and plan.is_last_dst is not None


def _seed_state(plan, mode, source, state0):
    """Round 1 (relax the source's own out-edges) as one scan pass with no
    routes: the source's out-edges are found in dst order through the static
    ``src_dst_order`` channel.  Returns (state, frontier or changed flag)."""
    src_eq = plan.src_dst_order == int(source)
    if mode == "sssp":
        big = torch.tensor(STATE_BIG, device=src_eq.device)
        x_seed = torch.where(src_eq, torch.zeros((), device=src_eq.device), big)
    else:
        x_seed = src_eq.to(torch.float32)
    w = plan.w_dst_order if mode == "sssp" else None
    return segmented_scan_state(
        mode, x_seed, w, plan.valid_dst_order, plan.seg_start_dst, plan.is_last_dst,
        state0, 0, fr_reduce=(mode == "sssp"),
    )


def _check_loop_plan(plan, name):
    if plan.loop_idx is None or not plan.loop_donors:
        raise NotImplementedError(f"{name}: needs a plan with the donor-routed loop route (loop_net=True)")


def _source_start(plan, source):
    """Device mask of the source's src-seg-start slot (all false when the
    source has no out-edge)."""
    s_lo = plan.indptr_src[source]
    s_hi = plan.indptr_src[source + 1]
    slot = torch.arange(plan.e_pad, dtype=torch.int32, device=s_lo.device)
    return (slot == s_lo) & (s_hi > s_lo)


def bfs_level(plan, source, n):
    """Level BFS: levels[v] = hops from ``source`` (-1 unreachable)."""
    _check_loop_plan(plan, "bfs_level")
    source = int(source)
    dev = plan.device
    src_inject = _source_start(plan, source).to(torch.float32)
    levels = torch.full((plan.e_pad,), -1, dtype=torch.int32, device=dev)
    frontier = torch.zeros(plan.e_pad, dtype=torch.float32, device=dev)
    depth = 0
    if _seed_ok(plan):
        levels, frontier = _seed_state(plan, "bfs", source, levels)
        depth = 1
    active = True
    while active and depth < n:
        # donor routing: the routed frontier IS x_start; inject the source
        x_start = torch.maximum(apply_perm(frontier, plan.loop_idx), src_inject)
        levels, frontier = _spmv_state_update(plan, x_start, "bfs", levels, depth)
        depth += 1
        active = bool(frontier.max() > 0)
    out = state_to_n(plan, levels, -1)
    out[source] = 0
    return out


def bfs_parent(plan, source, n):
    """Parent BFS over the any_secondi semiring: parents[v] is a vertex one
    level nearer ``source`` with an edge to v (the largest such id, as ``any``
    is max), the source is its own parent, unreachable vertices get -1
    (int32).  Each level is one ``spmv_masked`` with the frontier as x's
    structure; works on plans with and without endpoint routes."""
    source = int(source)
    dev = plan.device
    parents = torch.full((n,), -1, dtype=torch.int32, device=dev)
    parents[source] = source
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source] = True
    dummy_x = torch.zeros(n, dtype=torch.float32, device=dev)  # secondi reads no values
    depth = 0
    while depth < n and bool(frontier.any()):
        cand, reached = spmv_masked(plan, dummy_x, frontier, add="any", mul="secondi")
        frontier = reached & (parents < 0)
        parents = torch.where(frontier, cand, parents)
        depth += 1
    return parents


def sssp(plan, source, n):
    """min_plus Bellman-Ford from ``source``; unreachable vertices get
    STATE_BIG.  The plan must carry edge weights."""
    _check_loop_plan(plan, "sssp")
    if plan.w_dst_order is None:
        raise ValueError("sssp: the plan carries no edge weights")
    source = int(source)
    dev = plan.device
    src_inject = _source_start(plan, source)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dist = torch.full((plan.e_pad,), float(STATE_BIG), dtype=torch.float32, device=dev)
    if _seed_ok(plan):
        dist, _ = _seed_state(plan, "sssp", source, dist)
    changed = True
    it = 0
    while changed and it < n:
        # non-last state slots hold STATE_BIG, so the routed dist IS x_start
        x_start = torch.where(src_inject, zero, apply_perm(dist, plan.loop_idx))
        dist, any_changed = _spmv_state_update(plan, x_start, "sssp", dist, it)
        it += 1
        changed = bool(any_changed.item())
    out = state_to_n(plan, dist, float(STATE_BIG))
    out[source] = 0.0
    return out


def pagerank(plan, outdeg, n, *, damping=0.85, tol=1e-6, max_iters=100):
    """PageRank in the loop layout: rank state at dst-seg-last slots, one
    scalar c for the rank of vertices with no state slot.  ``tol <= 0`` runs
    exactly ``max_iters`` iterations.  ``outdeg`` is unused (the plan carries
    the degrees); it keeps the JAX signature."""
    _check_loop_plan(plan, "pagerank")
    dev = plan.device
    f32 = torch.float32
    d = torch.tensor(damping, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    is_last = plan.is_last_dst
    r = torch.where(is_last, torch.tensor(np.float32(1.0 / n), device=dev), zero)
    c = torch.tensor(np.float32(1.0 / n), device=dev)
    # one aux stream: out-degree signed by "the start slot has a state slot"
    od_signed = torch.where(plan.start_has_state, plan.outdeg_start, -plan.outdeg_start)

    def step(r, c):
        mass = torch.where(plan.last_dangling, r, zero).sum() + plan.k_iso_dangling * c
        x_start = state_to_start_post(plan, r, "pagerank", aux=od_signed, scalar=c)
        pulled = spmv_state(plan, x_start, "plus", "first")
        c_new = (1.0 - d) / n + d * mass / n
        return torch.where(is_last, c_new + d * pulled, zero), c_new

    if float(tol) <= 0.0:
        for _ in range(int(max_iters)):
            r, c = step(r, c)
    else:
        it = 0
        delta_big = True
        while delta_big and it < int(max_iters):
            r_new, c_new = step(r, c)
            delta_big = bool((r_new - r).abs().sum() > tol)
            r, c = r_new, c_new
            it += 1
    return torch.where(plan.dst_nonempty, state_to_n(plan, r, 0.0), c)

"""Compiled loops: ``gb.compile``, ``gb.loop`` and ``gb.until`` on CUDA graphs.

Counterpart of ``graphblas_tpu/core/compiler.py``.  The JAX package traces a
Python loop of DSL statements into one XLA program; the port computes the
same thing with a CUDA graph:

- A compiled loop runs its body eagerly once on copies of the initial state
  (the warm step, inside a ``core.capture.Scope``): that plays the part of
  the trace.  It builds the plans, fills the device caches and uploads every
  constant, and it decides ``mode``, ``layout`` and ``capture``.
- Then ``torch.cuda.graph`` records K body steps on static state buffers,
  the last step's output copied back into them, and each run replays the
  graph: ``fori`` replays it n / K times, ``until`` replays K = ``unroll``
  steps and reads the device stop flag after each replay.
- On CPU tensors (what the caller asked for) the same runner runs each step
  eagerly; so does a body that uploads host data or reads device values on
  the host every step (``runner.capture == "eager"``, with its reason in
  ``runner.capture_reason``).  A capture that fails raises.

Structure hoisting: GraphBLAS loops often keep a structurally stable state
(PageRank's rank vector is full every iteration).  ``loop``/``until`` first
carry only the VALUES, with every structure a constant of the loop (a
host-valued tensor, ``core/capture.py``); if the body's output structure is
traced (a BFS frontier) or differs from the input's, they carry the
structure too (``mode == "carried"``).  A constant all-present vector takes
the SpMV's ``x_full`` path, so the compiled DSL loop does the work of the
hand-written models.  With one sparse matrix and direction in the body the
state may ride the edge layout (``core/looplayout.py``, ``layout ==
"edge"``): one G route fewer per SpMV, but every state operation on e_pad
entries instead of n.  It is the reference's default and the port's on the
CPU; on the card the n space is (``CompiledLoop._edge_layout_enabled``).

A graph replays on the addresses it was captured with: the runner keeps
every tensor the capture read (``core/capture.py``), so a plan replaced in
its cache or a closed-over operand updated later stays alive, and the graph
goes on with the values it was captured with.  A closed-over collection
updated after the build (a runner) or the first call (a compiled function),
where the reference traces, is read as it was then, in every later run,
captured or eager (``core.capture.Held``).

Inside a compiled function collection values are abstract: host reads
(``.nvals`` of a traced structure, ``float(s)``, ``repr``, ``.to_coo()``,
``.value``) raise ``TracerError`` (``docs/compile.md``).
"""

import contextlib
import functools
import os

import numpy as np
import torch

from .. import exceptions as _exc
from . import capture as _cap


class _Spec:
    """Static description of one state collection (rebuild recipe)."""

    __slots__ = ("kind", "cls", "dtype", "name")

    def __init__(self, kind, cls, dtype, name):
        self.kind = kind  # "dense" | "scalar"
        self.cls = cls
        self.dtype = dtype
        self.name = name


def _flatten_one(obj):
    """(leaves, spec) for one collection: values, then the structure."""
    from .matrix import Matrix
    from .scalar import Scalar
    from .vector import Vector

    if isinstance(obj, Scalar):
        if obj.is_empty:
            raise TypeError("cannot carry an empty Scalar through a compiled loop")
        return [obj._device_value().reshape(())], _Spec("scalar", Scalar, obj.dtype, obj.name)
    if isinstance(obj, (Vector, Matrix)):
        if getattr(obj, "_sparse", None) is not None:
            raise TypeError(
                "sparse-format collections cannot be loop state (their pattern is a "
                "constant of the loop); pass them as closed-over operands instead"
            )
        return [obj._values, obj._struct], _Spec("dense", type(obj), obj.dtype, obj.name)
    raise TypeError(f"Unsupported state object for compiled loop: {type(obj)}")


def _rebuild_one(spec, leaves, struct_override=None):
    """Rebuild a collection from leaves (and optionally a fixed structure)."""
    if spec.kind == "scalar":
        sc = spec.cls(spec.dtype, name=spec.name)
        sc._set_device_value(leaves[0])
        return sc
    struct = leaves[1] if struct_override is None else struct_override
    return spec.cls._from_arrays(leaves[0], struct, spec.dtype, name=spec.name)


def _n_leaves(spec, with_struct=True):
    return 1 if spec.kind == "scalar" else 1 + int(with_struct)


def _flatten_state(objs):
    leaves, specs = [], []
    for o in objs:
        lv, sp = _flatten_one(o)
        leaves.extend(lv)
        specs.append(sp)
    return leaves, specs


def _rebuild_state(specs, leaves, structs=None):
    out, pos = [], 0
    for i, sp in enumerate(specs):
        n = _n_leaves(sp, with_struct=structs is None)
        chunk = leaves[pos : pos + n]
        pos += n
        override = None if structs is None or sp.kind == "scalar" else structs[i]
        out.append(_rebuild_one(sp, chunk, struct_override=override))
    return out


def _split_values_structs(objs):
    """(value_leaves, struct_list): one structure per collection (None for
    Scalars)."""
    values, structs = [], []
    for o in objs:
        lv, sp = _flatten_one(o)
        values.append(lv[0])
        structs.append(None if sp.kind == "scalar" else lv[1])
    return values, structs


class _StructureDiverged(Exception):
    """Internal: the body's output structure is traced or not a fixed point."""


# diagnostic: how the last loop/until carried its state ("hoisted": the
# structures were constants of the loop; "carried": they rode the state)
_LAST_MODE = {"loop": None}


def last_loop_mode():
    return _LAST_MODE["loop"]


def _as_state_tuple(state):
    if len(state) == 1 and isinstance(state[0], (tuple, list)):
        return tuple(state[0])
    return tuple(state)


def _check_body_out(out, specs, where):
    out = out if isinstance(out, (tuple, list)) else (out,)
    if len(out) != len(specs):
        raise TypeError(
            f"{where} must return the same number of state collections it was given "
            f"({len(specs)}); got {len(out)}"
        )
    return tuple(out)


def _cast_like(out, specs, ref_leaves, with_struct):
    """The body's output collections as state leaves: the values converted
    to the carried types (loop state keeps its shapes and types), and the
    structures when they ride the state."""
    from . import dtypes as _dt

    leaves = []
    for obj, spec in zip(out, specs):
        lv, _ = _flatten_one(obj)
        v = _dt.cast(lv[0], obj.dtype, spec.dtype)
        leaves.append(v)
        if spec.kind != "scalar" and with_struct:
            leaves.append(lv[1])
    for a, r in zip(leaves, ref_leaves):
        if tuple(a.shape) != tuple(r.shape):
            raise _exc.DimensionMismatch(f"loop body changed a state shape: {tuple(a.shape)} != {tuple(r.shape)}")
    return leaves


def _fresh(leaves):
    """Traced copies of state leaves (the caller's tensors stay untouched)."""
    return [_cap.traced(t.clone()) for t in leaves]


def _graph_steps(n):
    """Body steps recorded in one CUDA graph of a fixed-count loop."""
    return n if n <= 64 else 32


def _copy_back(dst, src):
    """dst[i] <- src[i] inside a capture; an output that shares storage with
    any state buffer is copied out first (a body may return its input or
    swap two states)."""
    ptrs = {d.untyped_storage().data_ptr() for d in dst}
    src = [s.clone() if s.untyped_storage().data_ptr() in ptrs else s for s in src]
    for d, s in zip(dst, src):
        d.copy_(s)


def _count_launches(delta, times):
    from .. import kernels

    kernels.add_launches(delta, times)


# ---------------------------------------------------------------------------
# gb.loop / gb.until
# ---------------------------------------------------------------------------


def loop(n_iters, body, *state):
    """Run ``body(*state) -> state`` for ``n_iters`` iterations (one CUDA
    graph of the body's steps on the card).  Returns the final state
    collections (a single collection if one was given).  For repeated runs
    use ``loop_runner``: it keeps the captured program."""
    return loop_runner(n_iters, body, *state)()


def until(cond, body, *state, max_iters=None):
    """Run ``body`` while ``cond(*state)`` is true.  ``cond`` returns a
    boolean Scalar (e.g. ``frontier.reduce(monoid.lor)``), a boolean
    expression, or a 0-d tensor.  ``max_iters`` bounds the iteration count."""
    return until_runner(cond, body, *state, max_iters=max_iters)()


def loop_runner(n_iters, body, *state):
    """Compile ``body`` over ``state`` once; returns a ``CompiledLoop``."""
    state = _as_state_tuple(state)
    leaves, specs = _flatten_state(state)
    return CompiledLoop("fori", body, specs, leaves, len(state) == 1, n_iters=int(n_iters))


def until_runner(cond, body, *state, max_iters=None, unroll=1):
    """Compile ``body``-until-``cond`` once; returns a ``CompiledLoop``.

    ``unroll=K`` runs K body steps between two reads of ``cond`` (one graph
    replay).  Valid ONLY for fixpoint bodies (extra steps past convergence
    are no-ops, as for BFS/SSSP/CC min/max accumulators): the loop may run
    up to K-1 extra body steps; ``last_iters`` counts body steps (a
    multiple of K)."""
    state = _as_state_tuple(state)
    leaves, specs = _flatten_state(state)
    return CompiledLoop(
        "while", body, specs, leaves, len(state) == 1, cond=cond, max_iters=max_iters, unroll=int(unroll)
    )


class CompiledLoop:
    """A reusable compiled DSL loop.

    ``runner()`` runs from the captured initial state; ``runner(*state)``
    from new state collections of the same shapes and types.  In hoisted
    mode the structures are constants of the loop, so new inputs must carry
    the same structures (checked on the host).  Diagnostics: ``mode``
    ("hoisted" | "carried"), ``layout`` ("n" | "edge"), ``capture``
    ("graph" | "eager") with ``capture_reason``, ``last_iters`` (body steps
    of the last ``until`` run) and ``steps_per_replay``.
    """

    def __init__(self, kind, body, specs, leaves, single, *, n_iters=None, cond=None, max_iters=None, unroll=1):
        self._kind = kind
        self._body = body
        self._specs = specs
        self._leaves0 = list(leaves)
        self._single = single
        self._n_iters = n_iters
        self._cond = cond
        self._max_iters = max_iters
        self._unroll = max(1, int(unroll))
        self.mode = None
        self.layout = "n"  # "edge" when the edge-layout lowering applied
        self.capture = None
        self.capture_reason = None
        self.last_iters = None  # while loops: body steps of the last run
        self.steps_per_replay = self._unroll if kind == "while" else _graph_steps(n_iters or 0)
        self._device = next((l.device for l in leaves if l.dim() > 0), leaves[0].device if leaves else None)
        self._structs = None  # hoisted: the constant structures, n space
        self._run_structs = None  # hoisted: the structures the body sees (edge space in edge layout)
        self._values0 = None
        self._edge = None  # (ctx, plan) in edge layout
        self._graphs = {}
        self._pool = None
        self._static = None
        self._nested = _cap.active() is not None
        # the closed-over collections the build read (a nested loop reads its
        # enclosing body's)
        self._held = None if self._nested else _cap.Held()
        self._build()
        _LAST_MODE["loop"] = self.mode

    # -- one body step ----------------------------------------------------------

    @property
    def _hoisted(self):
        return self.mode == "hoisted"

    def _step(self, leaves, structs=None):
        """One body step inside a scope: the next state leaves."""
        specs = self._specs
        structs = self._run_structs if structs is None and self._hoisted else structs
        st = _rebuild_state(specs, list(leaves), structs=structs)
        with self._layout_ctx():
            out = _check_body_out(self._body(*st), specs, "loop body")
        if structs is not None:
            _, out_structs = _split_values_structs(out)
            for s_in, s_out in zip(structs, out_structs):
                if s_in is None:
                    continue
                h_out = _cap.host_of(s_out)
                if h_out is None or not np.array_equal(_cap.host_of(s_in), h_out):
                    raise _StructureDiverged
        return _cast_like(out, specs, leaves, with_struct=structs is None)

    def _cond_value(self, leaves, structs=None):
        """The stop condition on ``leaves`` as a 0-d bool tensor."""
        from .base import BaseExpression
        from .scalar import Scalar

        structs = self._run_structs if structs is None and self._hoisted else structs
        st = _rebuild_state(self._specs, list(leaves), structs=structs)
        with self._layout_ctx():
            c = self._cond(*st)
            if isinstance(c, BaseExpression):
                c = c.new()
        if isinstance(c, Scalar):
            c = c._device_value(device=self._device)
        if not isinstance(c, torch.Tensor):
            return _cap.fill(bool(c), torch.bool, self._device)
        return c.to(torch.bool).reshape(())

    def _layout_ctx(self):
        return self._edge[0] if self._edge is not None else contextlib.nullcontext()

    def _warm(self, leaves, structs, probe=None):
        """The warm step: one body step (and the condition) on copies of the
        initial state, eagerly.  Returns its scope (uploads, host reads)."""
        with _cap.Scope("warm", held=self._held) as scope:
            with probe or contextlib.nullcontext():
                out = self._step(_fresh(leaves), structs)
            if self._kind == "while":
                self._cond_value(out, structs)
        return scope

    # -- build ------------------------------------------------------------------

    def _build(self):
        from . import looplayout as _ll

        if self._nested:
            # inside another compiled function: the steps run (and are
            # captured) within the enclosing scope, structure carried
            self.mode = "carried"
            self.capture = "eager"
            self.capture_reason = "nested in another compiled function"
            return
        # -- attempt 1: values-only state; structures constants of the loop ---
        values0, structs0 = _split_values_structs(_rebuild_state(self._specs, self._leaves0))
        consts = [None if s is None else _cap.with_host(s.clone(), s.cpu().numpy()) for s in structs0]
        probe = _ll._ProbeScope() if self._edge_layout_enabled() else None
        try:
            scope = self._warm(values0, consts, probe)
        except _StructureDiverged:
            scope = None
        if scope is not None:
            self.mode = "hoisted"
            self._structs = consts
            self._run_structs = consts
            self._values0 = values0
            if probe is not None:
                edge_scope = self._try_edge_layout(probe, values0, consts)
                if edge_scope is not None:
                    scope = edge_scope
            self._decide_capture(scope)
            return
        # -- attempt 2: the structures ride the state -------------------------
        self.mode = "carried"
        self._decide_capture(self._warm(self._leaves0, None))

    def _decide_capture(self, scope):
        reason = scope.eager_reason
        self.capture = "eager" if reason else "graph"
        self.capture_reason = reason

    # -- edge-layout upgrade (core/looplayout.py) -------------------------------

    def _edge_layout_enabled(self):
        """Whether the build tries the edge layout.  ``GRAPHBLAS_TPU_DSL_EDGE_LAYOUT``
        set to 1 asks for it and any other value keeps the n space.  Unset,
        state on the CPU takes it (the reference's default, which the CPU
        tests hold to the reference) and state on the card keeps the n space:
        there every state operation of the edge layout touches e_pad entries
        where the n space touches n, and the card ran a PageRank step 2.6-2.8x
        slower in the edge layout (PERF.md, "compiled loops")."""
        flag = os.environ.get("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT")
        if flag is None and self._device is not None and self._device.type == "cuda":
            return False
        if flag not in (None, "1"):
            return False
        from .sparse import _mxv_strategy

        # the "generic" strategy keeps exercising the generic lowering; the
        # edge layout is a plan-engine feature
        return _mxv_strategy() != "generic"

    def _try_edge_layout(self, probe, values0, consts):
        """Warm the body again with its state in the EDGE layout (values at
        the state slots of a total plan): every SpMV runs the loop route.  On
        success the loop keeps this lowering and the warm step's scope is
        returned; anything the layout cannot express keeps the n-space one
        (the same kernels and results)."""
        from . import looplayout as _ll
        from .vector import Vector

        elig = probe.eligible()
        if elig is None:
            return None
        sp, pull = elig
        for spec in self._specs:
            if spec.kind != "scalar" and spec.cls is not Vector:
                return None
        try:
            plan = sp.plan("pull" if pull else "push", self._device, loop=True)
            ctx = _ll.EdgeLayoutCtx(sp, plan, pull)
        except _ll.LayoutUnsupported:
            return None
        # all dense state must be n-sized (the virtual vertex space)
        for spec, s in zip(self._specs, consts):
            if spec.kind != "scalar" and tuple(s.shape) != (ctx.n,):
                return None
        edge_structs = []
        for spec, s in zip(self._specs, consts):
            if spec.kind == "scalar":
                edge_structs.append(None)
                continue
            es = ctx.lift_struct_np(_cap.host_of(s))
            edge_structs.append(_cap.with_host(torch.from_numpy(es).to(self._device), es))
        saved = (self._edge, self._run_structs)
        self._edge = (ctx, plan)
        self._run_structs = edge_structs
        edge_values0 = self._edge_lift_values(values0)
        try:
            scope = self._warm(edge_values0, edge_structs)
        except (_ll.LayoutUnsupported, _StructureDiverged, _exc.DimensionMismatch):
            # anything the layout cannot express (an index-dependent op, a
            # second matrix, a shape mismatch, structure divergence): keep
            # the n-space build
            self._edge, self._run_structs = saved
            return None
        self.layout = "edge"
        self._values0 = edge_values0
        return scope

    def _edge_lift_values(self, values):
        """n -> edge conversion of state values on the device (each vertex's
        value at its state slot, zero elsewhere)."""
        ctx, _ = self._edge
        out = []
        for spec, v in zip(self._specs, values):
            if spec.kind == "scalar":
                out.append(v)
                continue
            ev = torch.zeros(ctx.e_pad, dtype=v.dtype, device=v.device)
            ev[ctx.slots(v.device)] = v
            out.append(ev)
        return out

    def _edge_lower(self, values):
        """edge -> n conversion of final state values (the collect route)."""
        from . import looplayout as _ll

        _, plan = self._edge
        return [
            v if spec.kind == "scalar" else _ll.state_to_n_total(plan, v) for spec, v in zip(self._specs, values)
        ]

    # -- execute ----------------------------------------------------------------

    def _state_leaves(self, state):
        """The run's initial state leaves (values; and structures when they
        ride the state), from new collections or the captured ones."""
        specs = self._specs
        if state:
            state = _as_state_tuple(state)
            leaves, new_specs = _flatten_state(state)
            if len(new_specs) != len(specs):
                raise TypeError("runner called with a different number of state collections")
        else:
            leaves = self._leaves0
        if not self._hoisted:
            return list(leaves)
        if not state:
            return list(self._values0)
        values, structs = _split_values_structs(_rebuild_state(specs, leaves))
        for s_new, s_cap in zip(structs, self._structs):
            if s_cap is None:
                continue
            if not np.array_equal(s_new.cpu().numpy(), _cap.host_of(s_cap)):
                raise ValueError(
                    "compiled loop was specialized to a fixed structure; "
                    "input structure differs - rebuild with loop_runner"
                )
        if self.layout == "edge":
            values = self._edge_lift_values(values)
        return values

    def __call__(self, *state):
        leaves = self._state_leaves(state)
        with _cap.holding(self._held):
            if self.capture == "graph" and self._device.type == "cuda":
                final = self._run_graph(leaves)
            else:
                final = self._run_eager(leaves)
        return self._outputs(final)

    def eager(self, *state):
        """The same runner with every step run eagerly, no CUDA graph: the
        graph's reference on the card."""
        leaves = self._state_leaves(state)
        with _cap.holding(self._held):
            final = self._run_eager(leaves)
        return self._outputs(final)

    def _outputs(self, final):
        specs = self._specs
        if not self._hoisted:
            # results are new tensor objects: no scope marks reach the caller
            out = _rebuild_state(specs, [l.detach() for l in final])
        else:
            if self.layout == "edge":
                final = self._edge_lower(final)
            out_leaves, pos = [], 0
            for i, sp in enumerate(specs):
                out_leaves.append(final[pos].detach())
                pos += 1
                if sp.kind != "scalar":
                    out_leaves.append(self._structs[i])
            out = _rebuild_state(specs, out_leaves)
        return out[0] if self._single else tuple(out)

    def _steps(self, leaves, k):
        for _ in range(k):
            leaves = self._step(leaves)
        return leaves

    def _run_eager(self, leaves):
        """Each step eagerly (the CPU, an eager capture decision, or a loop
        nested in another compiled function)."""
        leaves = list(leaves) if self._nested else _fresh(leaves)
        if self._kind == "fori":
            for _ in range(self._n_iters):
                leaves = self._in_scope(self._steps, leaves, 1)
            return leaves
        k = self._unroll
        it = 0
        flag = self._in_scope(self._cond_value, leaves)
        while self._read_flag(flag) and (self._max_iters is None or it < self._max_iters):
            leaves = self._in_scope(self._steps, leaves, k)
            it += k
            flag = self._in_scope(self._cond_value, leaves)
        self.last_iters = it
        return leaves

    def _in_scope(self, fn, *args):
        """``fn`` as an eager step: in a scope of its own, or in the enclosing
        function's."""
        if self._nested:
            return fn(*args)
        with _cap.Scope("step"):
            return fn(*args)

    def _read_flag(self, flag):
        if self._nested:
            # a nested until reads its stop flag on the host, so the
            # enclosing function runs eagerly (a graph cannot hold it)
            sc = _cap.active()
            if sc.phase == "capture":
                raise _exc.TracerError("a CUDA graph cannot capture a nested gb.until")
            sc.reads.append("a nested gb.until's stop flag")
            with _cap.constants():
                return bool(flag)
        return bool(flag)

    def _graph(self, k):
        """The CUDA graph of ``k`` body steps (and the condition, for while
        loops) on the static state buffers; recorded on first use."""
        from .. import kernels

        g = self._graphs.get(k)
        if g is not None:
            return g
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = kernels.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            with _cap.Scope("capture") as scope:
                out = self._steps(list(self._static), k)
                flag = self._cond_value(out) if self._kind == "while" else None
            _copy_back(self._static, out)
        after = kernels.launch_counts()
        # the capture launched nothing: each replay launches these
        delta = {name: after[name] - before.get(name, 0) for name in after}
        _count_launches(delta, -1)
        # what the replays read at its captured addresses: the tensors made
        # outside the graph (plans, caches, closed-over operands) and the
        # step's outputs (a body may return a closed-over collection)
        kept = [*scope.kept.values(), *out]
        self._graphs[k] = (graph, delta, flag, kept)
        return self._graphs[k]

    def _run_graph(self, leaves):
        if self._static is None:
            self._static = _fresh(leaves)
        else:
            for d, s in zip(self._static, leaves):
                d.copy_(s)
        if self._kind == "fori":
            n = self._n_iters
            k = min(self.steps_per_replay, n) if n else 0
            for _ in range(n // k if k else 0):
                self._replay(k)
            if k and n % k:
                self._replay(n % k)
            return [t.clone() for t in self._static]
        k = self._unroll
        it = 0
        with _cap.Scope("step"):
            flag = self._cond_value(list(self._static))
        while bool(flag) and (self._max_iters is None or it < self._max_iters):
            flag = self._replay(k)
            it += k
        self.last_iters = it
        return [t.clone() for t in self._static]

    def _replay(self, k):
        graph, delta, flag, _ = self._graph(k)
        graph.replay()
        _count_launches(delta, 1)
        return flag


# ---------------------------------------------------------------------------
# gb.compile
# ---------------------------------------------------------------------------


def compile(fn=None):
    """Wrap ``fn`` so each call runs it as one captured program.

    Collection arguments (dense Matrix/Vector, non-empty Scalar) are the
    program's inputs; sparse-format matrices and non-collection arguments are
    static (part of the cache key, captured by identity).  The function may
    return collections, tuples of collections, or plain values.  Python loops
    inside ``fn`` unroll; use ``gb.loop``/``gb.until`` for compiled
    iteration.  On the card each key is captured once into a CUDA graph and
    every call returns clones of its output buffers; on the CPU each call
    runs eagerly.
    """
    if fn is None:
        return compile

    from .base import BaseType
    from .matrix import Matrix
    from .scalar import Scalar
    from .vector import Vector

    cache = {}

    def _is_traced_arg(a):
        if isinstance(a, (Vector, Matrix)) and getattr(a, "_sparse", None) is None:
            return True
        if isinstance(a, Scalar) and not a.is_empty:
            return True
        return False

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        traced_idx = tuple(i for i, a in enumerate(args) if _is_traced_arg(a))
        static_parts = tuple(
            (i, id(a)) if isinstance(a, BaseType) or not _hashable(a) else (i, a)
            for i, a in enumerate(args)
            if i not in traced_idx
        )
        if kwargs:
            static_parts = static_parts + tuple(sorted(kwargs.items(), key=lambda kv: kv[0]))
        leaves, specs = _flatten_state([args[i] for i in traced_idx])
        shapes = tuple((tuple(l.shape), str(l.dtype)) for l in leaves)
        key = (traced_idx, static_parts, shapes)
        entry = cache.get(key)
        if entry is None:
            entry = _CompiledFunction(fn, args, kwargs, traced_idx, specs, leaves)
            cache[key] = entry
        return entry(leaves)

    wrapper._cache = cache
    return wrapper


class _CompiledFunction:
    """One cache entry of ``gb.compile``: ``fn`` at one key."""

    def __init__(self, fn, args, kwargs, traced_idx, specs, leaves):
        self._fn = fn
        self._args = list(args)
        self._kwargs = kwargs
        self._traced_idx = traced_idx
        self._specs = specs
        self._nested = _cap.active() is not None
        self._device = leaves[0].device if leaves else None
        self._layout = None
        self._graph = None
        self._static_in = None
        self._static_out = None
        self._kept = None
        # the closed-over collections the first run read (the warm step on the
        # card, the first call on the CPU: where the reference traces)
        self._held = None if self._nested else _cap.Held()
        self._recorded = False
        self.capture = None
        self.capture_reason = None
        if self._nested:
            self.capture, self.capture_reason = "eager", "nested in another compiled function"
        elif self._device is not None and self._device.type == "cuda":
            with _cap.Scope("warm", held=self._held) as scope:
                self._run(_fresh(leaves))
            self._recorded = True
            reason = scope.eager_reason
            self.capture, self.capture_reason = ("eager", reason) if reason else ("graph", None)
        else:
            self.capture = "graph"  # decided with the first call's step on the CPU

    def _run(self, leaves):
        objs = _rebuild_state(self._specs, list(leaves))
        full_args = list(self._args)
        for obj, i in zip(objs, self._traced_idx):
            full_args[i] = obj
        flat, layout = _flatten_result(self._fn(*full_args, **self._kwargs))
        self._layout = layout
        return flat

    def __call__(self, leaves):
        if self._nested:
            flat = self._run(leaves)
            return _rebuild_result(self._layout, flat)
        if self.capture == "graph" and self._device is not None and self._device.type == "cuda":
            with _cap.holding(self._held):
                return self._replay(leaves)
        with _cap.holding(self._held), _cap.Scope("step", held=None if self._recorded else self._held) as scope:
            flat = self._run([_cap.traced(t.detach()) for t in leaves])
        self._recorded = True
        if scope.eager_reason and self.capture == "graph":
            self.capture, self.capture_reason = "eager", scope.eager_reason
        return _rebuild_result(self._layout, [t.detach() for t in flat])

    def _replay(self, leaves):
        if self._graph is None:
            self._static_in = [_cap.traced(t.clone()) for t in leaves]
            graph = torch.cuda.CUDAGraph()
            from .. import kernels

            before = kernels.launch_counts()
            with torch.cuda.graph(graph):
                with _cap.Scope("capture") as scope:
                    self._static_out = self._run(self._static_in)
            after = kernels.launch_counts()
            self._delta = {name: after[name] - before.get(name, 0) for name in after}
            _count_launches(self._delta, -1)
            # the tensors made outside the graph that it reads (see CompiledLoop._graph)
            self._kept = list(scope.kept.values())
            self._graph = graph
        else:
            for d, s in zip(self._static_in, leaves):
                d.copy_(s)
        self._graph.replay()
        _count_launches(self._delta, 1)
        return _rebuild_result(self._layout, [t.clone() for t in self._static_out])


def _hashable(x):
    try:
        hash(x)
    except TypeError:
        return False
    return True


def _flatten_result(result):
    """Flatten fn outputs (collections / tuples / values) to leaves + layout."""
    from .base import BaseType

    if isinstance(result, (tuple, list)):
        flat, layouts = [], []
        for r in result:
            f, l = _flatten_result(r)
            flat.extend(f)
            layouts.append((len(f), l))
        return flat, ("tuple", type(result), layouts)
    if isinstance(result, BaseType):
        lv, sp = _flatten_one(result)
        return lv, ("collection", sp)
    if isinstance(result, torch.Tensor):
        return [result], ("array", None)
    return [torch.as_tensor(np.asarray(result))], ("array", None)


def _rebuild_result(layout, leaves):
    kind = layout[0]
    if kind == "tuple":
        _, cls, layouts = layout
        out, pos = [], 0
        for n, l in layouts:
            out.append(_rebuild_result(l, leaves[pos : pos + n]))
            pos += n
        return cls(out)
    if kind == "collection":
        return _rebuild_one(layout[1], leaves)
    return leaves[0]

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
hand-written models.  The state lives in the n space on every device: the
port has one lowering of a loop (``layout == "n"``).  The reference's edge
layout, state at the slots of a total plan, is a TPU lowering the port
leaves out (ROADMAP.md §1).

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

import functools

import numpy as np
import torch

from .. import exceptions as _exc
from ..parallel import blocks as _b
from . import capture as _cap
from . import telemetry as _telemetry


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
        from .base import stored

        # a placed collection's state rides its blocks (parallel.blocks)
        return list(stored(obj)), _Spec("dense", type(obj), obj.dtype, obj.name)
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


def _lmap(fn, leaf):
    """``fn`` on a state leaf: a tensor, or each block of a placed one."""
    return leaf.map(fn) if _b.is_blocks(leaf) else fn(leaf)


def _tensors(leaves):
    """The tensors of state leaves (a placed leaf's blocks)."""
    out = []
    for leaf in leaves:
        out.extend(leaf.tensors() if _b.is_blocks(leaf) else (leaf,))
    return out


def _leaf_layout(leaf):
    return leaf.layout if _b.is_blocks(leaf) else None


def _like(leaf, layout):
    """``leaf`` in ``layout`` (None: a whole tensor)."""
    if layout is not None:
        return _b.relayout(leaf, layout)
    return leaf.gather() if _b.is_blocks(leaf) else leaf


def _host_value(x):
    """The host value of a structure leaf (a placed one's assembled), or None."""
    return _b.whole_host(x, _cap.host_of) if _b.is_blocks(x) else _cap.host_of(x)


def _with_host(x):
    """A constant copy of a structure leaf, its host value attached."""
    return _lmap(lambda t: _cap.with_host(t.clone(), t.cpu().numpy()), x)


def _whole_np(x):
    """A state leaf's whole array as numpy (a placed one's blocks assembled)."""
    return (_b.whole(x) if _b.is_blocks(x) else x).cpu().numpy()


def _mesh_devices_reason(leaves):
    """Why a step over the engaged mesh (or placed state) cannot be one CUDA
    graph: its shards sit on more than one device.  None otherwise."""
    from ..parallel import current_context

    ctx = current_context()
    devs = set(ctx.mesh.device_list()) if ctx is not None else set()
    for leaf in leaves:
        if _b.is_blocks(leaf):
            devs.update(leaf.layout.devices)
    if len(devs) > 1:
        return f"the mesh's shards sit on {len(devs)} devices; a CUDA graph records one device's work"
    return None


def _cast_like(out, specs, ref_leaves, with_struct):
    """The body's output collections as state leaves: the values converted
    to the carried types (loop state keeps its shapes, types and layouts),
    and the structures when they ride the state."""
    from . import dtypes as _dt

    leaves = []
    for obj, spec in zip(out, specs):
        lv, _ = _flatten_one(obj)
        leaves.append(_lmap(lambda t: _dt.cast(t, obj.dtype, spec.dtype), lv[0]))
        if spec.kind != "scalar" and with_struct:
            leaves.append(lv[1])
    for a, r in zip(leaves, ref_leaves):
        if tuple(a.shape) != tuple(r.shape):
            raise _exc.DimensionMismatch(f"loop body changed a state shape: {tuple(a.shape)} != {tuple(r.shape)}")
    return [_like(a, _leaf_layout(r)) for a, r in zip(leaves, ref_leaves)]


def _fresh(leaves):
    """Traced copies of state leaves (the caller's tensors stay untouched)."""
    return [_lmap(lambda t: _cap.traced(t.clone()), leaf) for leaf in leaves]


def _graph_steps(n):
    """Body steps recorded in one CUDA graph of a fixed-count loop."""
    return n if n <= 64 else 32


def _copy_back(dst, src):
    """dst[i] <- src[i] inside a capture; an output that shares storage with
    any state buffer is copied out first (a body may return its input or
    swap two states)."""
    dst, src = _tensors(dst), _tensors([_like(s, _leaf_layout(d)) for d, s in zip(dst, src)])
    ptrs = {d.untyped_storage().data_ptr() for d in dst}
    src = [s.clone() if s.untyped_storage().data_ptr() in ptrs else s for s in src]
    for d, s in zip(dst, src):
        d.copy_(s)


def _count_launches(delta, times):
    from .. import kernels

    kernels.add_launches(delta, times)


def _read_stop_flag(flag):
    """A replay's stop flag on the host: one read of the card (the span
    ``compiler.flag_read``, counted into ``host_reads``)."""
    with _telemetry.host_read("flag_read", "compiler.flag_read"):
        return bool(flag)


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
    from new state collections of the same shapes and types.  A fixed-count
    loop takes another count per run, ``runner(*state, n_iters=m)``: it
    replays the graph of ``steps_per_replay`` steps m // K times (and records
    one of m % K steps on first use), so a runner built for one step runs
    any count without a new recording.  In hoisted
    mode the structures are constants of the loop, so new inputs must carry
    the same structures (checked on the host).  Diagnostics: ``mode``
    ("hoisted" | "carried"), ``layout``, ``capture`` ("graph" | "eager")
    with ``capture_reason``, ``last_iters`` (body steps of the last
    ``until`` run) and ``steps_per_replay``.
    """

    #: The state's layout, the reference's public name.  The port has one
    #: lowering, the n space, on the CPU and the card; the reference's
    #: ``"edge"`` is a TPU lowering the port leaves out by design.
    layout = "n"

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
        self.capture = None
        self.capture_reason = None
        self.last_iters = None  # while loops: body steps of the last run
        self.steps_per_replay = self._unroll if kind == "while" else _graph_steps(n_iters or 0)
        self._device = next((l.device for l in leaves if l.dim() > 0), leaves[0].device if leaves else None)
        self._out_layouts = None  # the warm step's output layouts (state that mesh routes place)
        self._structs = None  # hoisted: the constant structures
        self._values0 = None
        self._graphs = {}
        self._pool = None
        self._static = None
        self._nested = _cap.active() is not None
        # the closed-over collections the build read (a nested loop reads its
        # enclosing body's)
        self._held = None if self._nested else _cap.Held()
        with _telemetry.span("compiler.capture"):
            self._build()
        _LAST_MODE["loop"] = self.mode

    # -- one body step ----------------------------------------------------------

    @property
    def _hoisted(self):
        return self.mode == "hoisted"

    def _step(self, leaves, structs=None):
        """One body step inside a scope: the next state leaves."""
        specs = self._specs
        structs = self._structs if structs is None and self._hoisted else structs
        st = _rebuild_state(specs, list(leaves), structs=structs)
        out = _check_body_out(self._body(*st), specs, "loop body")
        if self._out_layouts is None:
            self._out_layouts = [[_leaf_layout(leaf) for leaf in _flatten_one(o)[0]] for o in out]
        if structs is not None:
            _, out_structs = _split_values_structs(out)
            for s_in, s_out in zip(structs, out_structs):
                if s_in is None:
                    continue
                h_out = _host_value(s_out)
                if h_out is None or _leaf_layout(s_in) != _leaf_layout(s_out) or not np.array_equal(_host_value(s_in), h_out):
                    raise _StructureDiverged
        return _cast_like(out, specs, leaves, with_struct=structs is None)

    def _cond_value(self, leaves, structs=None):
        """The stop condition on ``leaves`` as a 0-d bool tensor."""
        from .base import BaseExpression
        from .scalar import Scalar

        structs = self._structs if structs is None and self._hoisted else structs
        st = _rebuild_state(self._specs, list(leaves), structs=structs)
        c = self._cond(*st)
        if isinstance(c, BaseExpression):
            c = c.new()
        if isinstance(c, Scalar):
            c = c._device_value(device=self._device)
        if not isinstance(c, torch.Tensor):
            return _cap.fill(bool(c), torch.bool, self._device)
        return c.to(torch.bool).reshape(())

    def _warm(self, leaves, structs):
        """The warm step: one body step (and the condition) on copies of the
        initial state, eagerly.  Returns its scope (uploads, host reads)."""
        with _cap.Scope("warm", held=self._held) as scope:
            out = self._step(_fresh(leaves), structs)
            if self._kind == "while":
                self._cond_value(out, structs)
        return scope

    # -- build ------------------------------------------------------------------

    def _build(self):
        """Build on the initial state; where the warm step's outputs sit in
        other layouts than the state (a mesh route places its product), the
        state takes theirs and the build runs again, so that the loop keeps
        its state where the routes leave it."""
        for _ in range(2):
            self._out_layouts = None
            self._build_once()
            if not self._place_state(self._out_layouts):
                return

    def _place_state(self, layouts):
        """Put the initial state in ``layouts`` (per collection, its leaves');
        True when anything moved."""
        if not layouts or self._nested:
            return False
        moved, leaves, pos = False, list(self._leaves0), 0
        for spec, lays in zip(self._specs, layouts):
            for lay in lays if spec.kind != "scalar" else ():
                if _leaf_layout(leaves[pos]) != lay:
                    leaves[pos] = _like(leaves[pos], lay)
                    moved = True
                pos += 1
            pos += 1 if spec.kind == "scalar" else 0
        if moved:
            self._leaves0 = leaves
            self._held = _cap.Held()
        return moved

    def _build_once(self):
        if self._nested:
            # inside another compiled function: the steps run (and are
            # captured) within the enclosing scope, structure carried
            self.mode = "carried"
            self.capture = "eager"
            self.capture_reason = "nested in another compiled function"
            return
        # -- attempt 1: values-only state; structures constants of the loop ---
        values0, structs0 = _split_values_structs(_rebuild_state(self._specs, self._leaves0))
        consts = [None if s is None else _with_host(s) for s in structs0]
        try:
            scope = self._warm(values0, consts)
        except _StructureDiverged:
            scope = None
        if scope is not None:
            self.mode = "hoisted"
            self._structs = consts
            self._values0 = values0
            self._decide_capture(scope)
            return
        # -- attempt 2: the structures ride the state -------------------------
        self.mode = "carried"
        self._decide_capture(self._warm(self._leaves0, None))

    def _decide_capture(self, scope):
        reason = _mesh_devices_reason(self._leaves0) or scope.eager_reason
        self.capture = "eager" if reason else "graph"
        self.capture_reason = reason

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
            return [_like(leaf, _leaf_layout(l0)) for leaf, l0 in zip(leaves, self._leaves0)]
        if not state:
            return list(self._values0)
        values, structs = _split_values_structs(_rebuild_state(specs, leaves))
        with _telemetry.span("compiler.structure_check"):
            for s_new, s_cap in zip(structs, self._structs):
                if s_cap is None:
                    continue
                with _telemetry.host_read("structure_check"):
                    s_host = _whole_np(s_new)
                if not np.array_equal(s_host, _host_value(s_cap)):
                    raise ValueError(
                        "compiled loop was specialized to a fixed structure; "
                        "input structure differs - rebuild with loop_runner"
                    )
        return [_like(v, _leaf_layout(v0)) for v, v0 in zip(values, self._values0)]

    @_telemetry.timed("compiler.run")
    def __call__(self, *state, n_iters=None):
        n = self._count(n_iters)
        leaves = self._state_leaves(state)
        with _cap.holding(self._held):
            if self.capture == "graph" and self._device.type == "cuda":
                final = self._run_graph(leaves, n)
            else:
                final = self._run_eager(leaves, n)
        return self._outputs(final)

    def eager(self, *state, n_iters=None):
        """The same runner with every step run eagerly, no CUDA graph: the
        graph's reference on the card."""
        n = self._count(n_iters)
        leaves = self._state_leaves(state)
        with _cap.holding(self._held):
            final = self._run_eager(leaves, n)
        return self._outputs(final)

    def _count(self, n_iters):
        """The body steps of a fixed-count run: the built count, or ``n_iters``."""
        if n_iters is None:
            return self._n_iters
        if self._kind != "fori":
            raise TypeError("n_iters sets the count of a loop_runner; an until_runner stops on its condition")
        if int(n_iters) < 0:
            raise ValueError(f"n_iters must be 0 or more, not {n_iters}")
        return int(n_iters)

    def _outputs(self, final):
        specs = self._specs
        if not self._hoisted:
            # results are new tensor objects: no scope marks reach the caller
            out = _rebuild_state(specs, [l.detach() for l in final])
        else:
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

    def _run_eager(self, leaves, n_iters=None):
        """Each step eagerly (the CPU, an eager capture decision, or a loop
        nested in another compiled function)."""
        leaves = list(leaves) if self._nested else _fresh(leaves)
        if self._kind == "fori":
            for _ in range(self._n_iters if n_iters is None else n_iters):
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
        loops) on the static state buffers; recorded on first use (the span
        ``compiler.capture``)."""
        g = self._graphs.get(k)
        if g is not None:
            return g
        with _telemetry.span("compiler.capture"):
            return self._record(k)

    def _record(self, k):
        from .. import kernels

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
        kept = [*scope.kept.values(), *_tensors(out)]
        self._graphs[k] = (graph, delta, flag, kept)
        return self._graphs[k]

    def _run_graph(self, leaves, n_iters=None):
        if self._static is None:
            self._static = _fresh(leaves)
        else:
            for d, s in zip(self._static, leaves):
                d.copy_(s)
        if self._kind == "fori":
            n = self._n_iters if n_iters is None else n_iters
            k = min(self.steps_per_replay, n) if n else 0
            for _ in range(n // k if k else 0):
                self._replay(k)
            if k and n % k:
                self._replay(n % k)
            _telemetry.count("compiler.iterations", n)
            return [t.clone() for t in self._static]
        k = self._unroll
        it = 0
        with _cap.Scope("step"):
            flag = self._cond_value(list(self._static))
        while _read_stop_flag(flag) and (self._max_iters is None or it < self._max_iters):
            flag = self._replay(k)
            it += k
        self.last_iters = it
        _telemetry.count("compiler.iterations", it)
        return [t.clone() for t in self._static]

    def _replay(self, k):
        graph, delta, flag, _ = self._graph(k)
        with _telemetry.span("compiler.replay"):
            graph.replay()
            _count_launches(delta, 1)
        _telemetry.count("compiler.replays")
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
        shapes = tuple((tuple(l.shape), str(l.dtype), getattr(l, "spec", None)) for l in leaves)
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
            with _telemetry.span("compiler.capture"), _cap.Scope("warm", held=self._held) as scope:
                self._run(_fresh(leaves))
            self._recorded = True
            reason = _mesh_devices_reason(leaves) or scope.eager_reason
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
            flat = self._run([_lmap(lambda t: _cap.traced(t.detach()), leaf) for leaf in leaves])
        self._recorded = True
        if scope.eager_reason and self.capture == "graph":
            self.capture, self.capture_reason = "eager", scope.eager_reason
        return _rebuild_result(self._layout, [t.detach() for t in flat])

    def _replay(self, leaves):
        if self._graph is None:
            with _telemetry.span("compiler.capture"):
                self._record(leaves)
        else:
            for d, s in zip(self._static_in, leaves):
                d.copy_(s)
        with _telemetry.span("compiler.replay"):
            self._graph.replay()
            _count_launches(self._delta, 1)
        _telemetry.count("compiler.replays")
        return _rebuild_result(self._layout, [t.clone() for t in self._static_out])

    def _record(self, leaves):
        from .. import kernels

        self._static_in = _fresh(leaves)
        graph = torch.cuda.CUDAGraph()
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

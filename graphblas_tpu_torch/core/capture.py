"""The capture scope of compiled loops: the port's twin of "inside a trace".

``gb.compile``, ``gb.loop`` and ``gb.until`` (``core/compiler.py``) run a
loop body eagerly once on the card (the warm step, which plays the part of
the JAX package's trace) and then record K body steps in one CUDA graph.
Both runs happen inside a ``Scope``; so does every eager step of a loop that
is not captured (on the CPU, or where the body cannot be captured).

Inside a scope a tensor is one of two things, as a JAX value is under a
trace:

- **traced**: made by a torch operation inside the scope (a
  ``TorchFunctionMode`` tags every tensor an operation returns), or a loop
  state buffer.  It is the analogue of a JAX tracer: its contents are not
  known on the host.
- **concrete**: made before the scope (a closed-over operand), inside a
  ``constants()`` block (device caches, plans), a view of a concrete tensor,
  or a structure the host-side combinators computed
  (``ops.densemasked.s_and`` ...): those carry their host value (a numpy
  mirror, ``host_of``), so structure algebra on them is decided on the host
  as the reference decides it on numpy arrays.

Host reads of traced values raise ``TracerError``.  Every upload of a host
array outside ``constants()`` and every host read of a concrete device value
is recorded: a step that does either cannot be replayed from a CUDA graph
(``Scope.eager_reason``), so the compiler runs such a body eagerly.

A CUDA graph replays its kernels on the addresses its inputs had at capture.
So the capture scope keeps every tensor made outside the graph that an
operation inside it reads (closed-over operands, plans, device caches:
``Scope.kept``), and the compiler holds that list beside the graph: a plan
replaced in its cache or an operand updated after the capture stays alive,
and the graph goes on reading the values it was captured with, as the
reference's trace bakes its constants.

A closed-over collection updated after the trace is read as the trace read
it, on every device and however the body runs (``Held``): the recording run
(a loop's build, where the reference traces it; a compiled function's first
call) notes each collection made before it that the body reads, with its
data slots; every later run (``holding``) puts those slots back on the
collection for its length.  An update installs new tensors (it never writes
the old ones), so the held slots are the values of the trace.
"""

import contextlib
import contextvars
import functools
import itertools
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .. import exceptions as _exc

_SCOPE = contextvars.ContextVar("graphblas_tpu_torch_capture", default=None)
_CAPTURES = itertools.count(1)
_RECORDING = 0  # active scopes that record a Held (checked on every collection slot access)

_T = torch.Tensor
# host reads: every way a tensor's contents reach Python
_READS = frozenset(
    [
        _T.item, _T.tolist, _T.numpy, _T.__bool__, _T.__int__, _T.__float__, _T.__index__,
        _T.__complex__, _T.__array__, _T.__repr__, _T.__str__, _T.__format__,
    ]
)
# copies that may leave the card for the host, or reach it from the host
_MOVES = frozenset([_T.cpu, _T.to, _T.cuda, _T.copy_])
# shape-only operations: a view of a concrete tensor is concrete
_VIEWS = frozenset(
    [_T.reshape, _T.view, _T.expand, _T.__getitem__, _T.unsqueeze, _T.clone, _T.contiguous, _T.detach]
)
_FACTORIES = frozenset([torch.tensor, torch.as_tensor])
# operations whose output size or result depends on the data: the host waits
# for the card (a JAX trace refuses them for the same reason)
_SYNCS = frozenset(
    [
        torch.equal, _T.equal, torch.allclose, torch.nonzero, _T.nonzero, torch.argwhere,
        torch.masked_select, _T.masked_select, torch.unique, _T.unique, torch.unique_consecutive,
    ]
)


def active():
    """The innermost active scope, or None outside compiled loops."""
    return _SCOPE.get()


class Scope:
    """One run of a loop body: ``phase`` is "warm" (the first eager step),
    "capture" (recording a CUDA graph) or "step" (an eager step)."""

    def __init__(self, phase, held=None):
        self.phase = phase
        self.held = held  # recording: the collections made before the scope that it reads
        self.uploads = []
        self.reads = []
        # capture: the tensors made outside the graph that it reads, by id
        self.kept = {}
        self._token = next(_CAPTURES)
        self._quiet = 0
        self._reset = None
        self._mode = None

    def __enter__(self):
        global _RECORDING
        if self.held is not None:
            _RECORDING += 1
        self._reset = _SCOPE.set(self)
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        _SCOPE.reset(self._reset)
        if self.held is not None:
            global _RECORDING
            _RECORDING -= 1
            self.held.made.clear()
        return False

    @property
    def eager_reason(self):
        """Why this step cannot be replayed from a CUDA graph, or None."""
        if self.uploads:
            return f"the body uploads host data ({self.uploads[0]})"
        if self.reads:
            return f"the body reads device values on the host ({self.reads[0]})"
        return None

    def keep(self, args, kwargs):
        """Hold the tensors among an operation's arguments that the graph did
        not make (its own outputs live in its memory pool)."""
        for a in (*args, *kwargs.values()):
            for t in a if isinstance(a, (tuple, list)) else (a,):
                if isinstance(t, torch.Tensor) and t.__dict__.get("_gb_graph") != self._token:
                    self.kept[id(t)] = t

    def made(self, out, args):
        """Mark the tensors an operation inside the graph returned."""
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(o, torch.Tensor) and not any(o is a for a in args):
                o._gb_graph = self._token

    def upload(self, what):
        """Record an upload of host data (outside ``constants()``)."""
        if self._quiet:
            return
        if self.phase == "capture":
            raise _exc.TracerError(f"a CUDA graph cannot capture an upload of host data ({what})")
        self.uploads.append(what)

    def read(self, t, what):
        if self._quiet:
            return
        if is_traced(t):
            raise _exc.TracerError(
                f"{what} reads a device value on the host inside a compiled loop body; "
                "collection values are abstract there (docs/compile.md)"
            )
        if self.phase == "capture":
            raise _exc.TracerError(f"a CUDA graph cannot capture a host read ({what})")
        self.reads.append(what)


class HeldSlot:
    """A collection's data slot (the ``__slots__`` member ``slot``) whose
    reads and writes a recording scope notes (``Held``)."""

    __slots__ = ("slot",)

    def __init__(self, slot):
        self.slot = slot

    def __get__(self, obj, cls=None):
        if obj is None:
            return self
        v = self.slot.__get__(obj, cls)
        if _RECORDING:
            _note(obj, False)
        return v

    def __set__(self, obj, v):
        if _RECORDING:
            _note(obj, True)
        self.slot.__set__(obj, v)

    def __delete__(self, obj):
        if _RECORDING:
            _note(obj, True)
        self.slot.__delete__(obj)


def hold_slots(cls, *names):
    """Route ``cls``'s data slots through ``HeldSlot``: slot ``name`` is
    stored in the ``__slots__`` member ``name + "_"``."""
    for name in names:
        setattr(cls, name, HeldSlot(cls.__dict__[name + "_"]))


_UNSET = object()


@functools.lru_cache(maxsize=None)
def _held_slots(cls):
    return tuple((n, d.slot) for c in cls.__mro__ for n, d in vars(c).items() if isinstance(d, HeldSlot))


def _slots_of(obj):
    out = {}
    for name, slot in _held_slots(type(obj)):
        try:
            out[name] = slot.__get__(obj)
        except AttributeError:
            out[name] = _UNSET
    return out


def _put(obj, data):
    for name, slot in _held_slots(type(obj)):
        v = data[name]
        if v is not _UNSET:
            slot.__set__(obj, v)
        else:
            try:
                slot.__delete__(obj)
            except AttributeError:
                pass


def _note(obj, wrote):
    sc = _SCOPE.get()
    if sc is not None and sc.held is not None:
        sc.held.note(obj, wrote)


class Held:
    """The collections made before a compiled body that its recording run
    read, each with its data slots as they were then."""

    def __init__(self):
        self.entries = {}  # id -> (collection, its slots at the recording)
        self.made = {}  # id -> weakref: the collections written in a recording scope

    def note(self, obj, wrote):
        if wrote:
            self.made[id(obj)] = weakref.ref(obj)
        elif id(obj) not in self.entries:
            r = self.made.get(id(obj))
            if r is None or r() is not obj:
                self.entries[id(obj)] = (obj, _slots_of(obj))


@contextlib.contextmanager
def holding(held):
    """Put the held collections' recorded slots back for the block, and the
    caller's after it (unless the body wrote the collection)."""
    if held is None or not held.entries:
        yield
        return
    theirs = [(obj, _slots_of(obj)) for obj, _ in held.entries.values()]
    for obj, data in held.entries.values():
        _put(obj, data)
    try:
        yield
    finally:
        for (obj, data), (_, mine) in zip(theirs, held.entries.values()):
            now = _slots_of(obj)
            if all(now[k] is mine[k] for k in now):
                _put(obj, data)


@contextlib.contextmanager
def constants():
    """Tensors made within this block are constants of the loop (device
    caches, plans, lifted operands): not traced, and their uploads are not
    per-step uploads; its host reads are the scope's own (a concrete value
    read once).  The reference's ``jax.ensure_compile_time_eval``."""
    sc = _SCOPE.get()
    if sc is None:
        yield
        return
    sc._quiet += 1
    try:
        yield
    finally:
        sc._quiet -= 1


def is_traced(t):
    if not isinstance(t, torch.Tensor):
        return False
    m = t.__dict__.get("_gb_host")
    if m is not None and m[0] == t._version:
        return False
    return bool(t.__dict__.get("_gb_traced", False))


def traced(t):
    """Mark ``t`` traced (a loop state buffer); returns it."""
    t.__dict__.pop("_gb_host", None)
    t._gb_traced = True
    return t


def with_host(t, host):
    """Attach ``host`` (numpy) as the host value of ``t``; returns ``t``.  An
    in-place write to ``t`` afterwards leaves it traced."""
    t._gb_traced = True
    t._gb_host = (t._version, np.asarray(host))
    return t


def host_of(x):
    """The host value (numpy) of a concrete tensor or host array; None for a
    traced tensor.  A concrete tensor made before the scope is read once and
    its value kept on it (in the capture phase it must already be kept)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    m = x.__dict__.get("_gb_host")
    if m is not None and m[0] == x._version:
        return m[1]
    if x.__dict__.get("_gb_traced", False):
        return None
    sc = _SCOPE.get()
    if sc is not None and sc.phase == "capture":
        raise _exc.TracerError("the capture met a constant tensor the warm step did not read")
    with constants():
        arr = x.detach().cpu().numpy()
    x._gb_host = (x._version, arr)
    return arr


def upload(arr, device):
    """A host array (numpy, or a CPU tensor) as a tensor on ``device`` (the
    port's upload helper): inside a scope and outside ``constants()`` it is
    an upload of host data, and the tensor is traced, as ``jnp.asarray`` is
    under a trace."""
    src = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    sc = _SCOPE.get()
    if sc is None or sc._quiet:
        return src.to(device)
    sc.upload(f"an array of shape {tuple(src.shape)}")
    with constants():
        t = src.to(device)
    return traced(t if t is not src else src.view(src.shape))


def fill(value, dtype, device):
    """A 0-d tensor holding a host scalar, made by a fill on ``device`` (no
    host-to-device copy, so a CUDA graph can capture it)."""
    return torch.full((), value, dtype=dtype, device=device)


def _card(x):
    return isinstance(x, torch.Tensor) and x.is_cuda


def _to_host(func, args, kwargs):
    """A copy of ``args[0]`` from the card to the host."""
    if not _card(args[0]) or func is _T.copy_ or func is _T.cuda:
        return False
    if func is _T.cpu:
        return True
    dev = kwargs.get("device")
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            dev = a
        elif isinstance(a, torch.Tensor):
            dev = a.device
    return dev is not None and torch.device(dev).type == "cpu"


def _from_host(func, args, kwargs, out):
    """An upload from the host to the card."""
    if func is _T.copy_:
        return _card(args[0]) and isinstance(args[1], torch.Tensor) and not args[1].is_cuda
    return isinstance(args[0], torch.Tensor) and not args[0].is_cuda and _card(out)


def _bool_key(key):
    parts = key if isinstance(key, tuple) else (key,)
    return any(isinstance(p, torch.Tensor) and p.dtype == torch.bool and p.dim() > 0 for p in parts)


def _view_host(func, src, args, kwargs):
    """The host value of a shape-only operation on host value ``src``."""
    name = func.__name__
    rest = args[1:]
    try:
        if name in ("clone", "contiguous", "detach"):
            return src
        if name in ("reshape", "view"):
            shape = rest[0] if len(rest) == 1 and isinstance(rest[0], (tuple, list, torch.Size)) else rest
            if any(not isinstance(d, int) for d in shape):
                return None
            return src.reshape(tuple(shape))
        if name == "expand":
            shape = rest[0] if len(rest) == 1 and isinstance(rest[0], (tuple, list, torch.Size)) else rest
            shape = tuple(s if d == -1 else d for d, s in zip(shape, (1,) * (len(shape) - src.ndim) + src.shape))
            return np.broadcast_to(src, shape)
        if name == "unsqueeze":
            return np.expand_dims(src, rest[0] if rest else kwargs["dim"])
        if name == "__getitem__":
            key = rest[0]
            parts = key if isinstance(key, tuple) else (key,)
            if any(isinstance(p, (torch.Tensor, list, np.ndarray)) for p in parts):
                return None
            return src[key]
    except (TypeError, ValueError, IndexError, KeyError):
        return None
    return None


class _Mode(TorchFunctionMode):
    """Tags what torch operations return inside a scope and watches host
    reads and uploads."""

    def __init__(self, scope):
        super().__init__()
        self.scope = scope

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        sc = self.scope
        if sc.phase == "capture":
            sc.keep(args, kwargs)
            out = self._call(func, args, kwargs)
            sc.made(out, args)
            return out
        return self._call(func, args, kwargs)

    def _call(self, func, args, kwargs):
        sc = self.scope
        if sc._quiet:
            return func(*args, **kwargs)
        if func in _READS or func in _SYNCS:
            sc.read(args[0], f"{getattr(func, '__name__', func)}")
        elif func in (_T.__getitem__, _T.__setitem__) and _bool_key(args[1]):
            sc.read(args[1], "indexing by a bool tensor")
        elif func in _MOVES and _to_host(func, args, kwargs):
            sc.read(args[0], f"Tensor.{func.__name__} to the host")
        out = func(*args, **kwargs)
        if func in _READS:
            return out
        if (func in _MOVES and _from_host(func, args, kwargs, out)) or (
            func in _FACTORIES and _card(out) and out.dim() > 0
        ):
            sc.upload(f"{getattr(func, '__name__', func)} of shape {tuple(out.shape)}")
        if isinstance(out, torch.Tensor):
            self._tag(func, args, kwargs, out)
        elif isinstance(out, (tuple, list)):
            for o in out:
                if isinstance(o, torch.Tensor):
                    self._tag(func, args, kwargs, o)
        return out

    def _tag(self, func, args, kwargs, out):
        if any(out is a for a in args):
            return  # an in-place operation or a no-op conversion returns its input
        src = args[0] if args else None
        if func in _VIEWS and isinstance(src, torch.Tensor) and not is_traced(src):
            m = src.__dict__.get("_gb_host")
            if m is not None and m[0] == src._version:
                host = _view_host(func, m[1], args, kwargs)
                if host is not None:
                    with_host(out, host)
                    return
            elif not src.__dict__.get("_gb_traced", False):
                return  # a view of a constant made before the scope is a constant
        out._gb_traced = True

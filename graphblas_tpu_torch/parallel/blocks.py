"""Placed collections' storage: one block a shard, on the shard's device.

Counterpart of the ``NamedSharding`` / ``PartitionSpec`` that the JAX
package's ``shard_matrix`` / ``shard_vector`` / ``replicate`` put on a
collection's arrays.  A ``Layout`` is a mesh, a spec (one mesh axis name or
None per array axis, trailing Nones dropped, as the reference prints
``sharding.spec``) and the global shape; a ``Blocks`` is one array (a
collection's values or its structure) cut in that layout.  Shard ``k`` of
the mesh (row-major) holds the block at its coordinates along the spec's
axes; an array axis with no mesh axis is whole on every shard.  Shards that
hold the same block on the same device share one tensor: eight shards on
one card cost one copy of a replicated axis, and nothing writes a block in
place (engine functions return new tensors).

A placed collection keeps its two ``Blocks`` in its data slots
(``core/base.py``).  The op families that have a block route read them
there and return new ``Blocks``; every other read of ``_values`` /
``_struct`` gathers the whole tensor on the mesh's first device and counts
into ``gathers``.  A route that needs an operand in another layout (an
unplaced operand, the common case) cuts it and counts into ``reshards``.
Both are counters of ``core.telemetry`` (``parallel.gathers``,
``parallel.reshards``), read by ``counts()``.

UDT values (dicts of field tensors) are blocked field by field.
"""

import numpy as np
import torch

from ..core import telemetry as _telemetry

# whole-tensor reads of a placed collection, and operands cut into another
# layout: the counters parallel.gathers and parallel.reshards
_COUNTERS = {"gathers": "parallel.gathers", "reshards": "parallel.reshards"}


def reset_counts():
    _telemetry.reset(*_COUNTERS.values())


def counts():
    return {k: _telemetry.counter(name) for k, name in _COUNTERS.items()}


def tmap(fn, x, *rest):
    """``fn`` per field of UDT values (dicts of tensors), else directly."""
    if isinstance(x, dict):
        return {k: fn(x[k], *(r[k] for r in rest)) for k in x}
    return fn(x, *rest)


def normal_spec(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _same_mesh(a, b):
    return a is b or (a.axis_names == b.axis_names and a.devices.shape == b.devices.shape and a.key() == b.key())


class Layout:
    """Where the blocks of an array of ``shape`` sit on ``mesh`` under ``spec``.

    Raises ValueError where an axis does not divide over its mesh axis, as
    the reference's ``device_put`` does."""

    __slots__ = ("mesh", "spec", "shape", "groups", "group_of", "devices", "keys", "first_of_key")

    def __init__(self, mesh, spec, shape):
        spec = normal_spec(spec)
        shape = tuple(int(s) for s in shape)
        named = [a for a in spec if a is not None]
        if len(spec) > len(shape) or len(set(named)) != len(named) or any(a not in mesh.axis_names for a in named):
            raise ValueError(f"spec {spec} does not fit an array of shape {shape} on mesh axes {mesh.axis_names}")
        for d, a in enumerate(spec):
            if a is not None and shape[d] % mesh.shape[a]:
                raise ValueError(
                    f"dimension {d} of size {shape[d]} is not divisible by mesh axis {a!r} of size {mesh.shape[a]} "
                    f"(spec {spec}, shape {shape})"
                )
        self.mesh, self.spec, self.shape = mesh, spec, shape
        full = spec + (None,) * (len(shape) - len(spec))
        pos = {a: k for k, a in enumerate(mesh.axis_names)}
        coords = np.indices(mesh.devices.shape).reshape(mesh.devices.ndim, -1).T
        devs = mesh.device_list()
        # a group: one distinct (block key, device); each shard reads its group's tensor
        index, self.groups, self.group_of, self.devices, self.keys = {}, [], [], [], []
        self.first_of_key = {}
        for k, c in enumerate(coords):
            key = tuple(int(c[pos[a]]) if a is not None else 0 for a in full)
            g = index.get((key, devs[k]))
            if g is None:
                g = index[(key, devs[k])] = len(self.groups)
                self.groups.append(k)
                self.devices.append(devs[k])
                self.keys.append(key)
                self.first_of_key.setdefault(key, g)
            self.group_of.append(g)

    def counts(self):
        """Blocks along each array axis."""
        full = self.spec + (None,) * (len(self.shape) - len(self.spec))
        return tuple(1 if a is None else self.mesh.shape[a] for a in full)

    def bounds(self, g):
        """((start, stop) per array axis) of group ``g``'s block."""
        return tuple((k * (s // c), (k + 1) * (s // c)) for k, s, c in zip(self.keys[g], self.shape, self.counts()))

    def offsets(self, g):
        return tuple(lo for lo, _ in self.bounds(g))

    def __eq__(self, other):
        return (
            isinstance(other, Layout)
            and self.spec == other.spec
            and self.shape == other.shape
            and _same_mesh(self.mesh, other.mesh)
        )

    def __hash__(self):
        return hash((self.spec, self.shape, self.mesh.key()))

    def distinct_devices(self):
        return list(dict.fromkeys(self.mesh.device_list()))

    def __repr__(self):
        return f"Layout(spec={self.spec}, shape={self.shape}, groups={len(self.groups)})"


class Blocks:
    """One array in a ``Layout``: ``parts[g]`` is group g's block (a tensor, or
    a dict of field tensors) on ``layout.devices[g]``."""

    __slots__ = ("layout", "parts")

    def __init__(self, layout, parts):
        self.layout = layout
        self.parts = list(parts)

    # -- what tests and callers compare -------------------------------------

    @property
    def spec(self):
        return self.layout.spec

    @property
    def mesh(self):
        return self.layout.mesh

    @property
    def shape(self):
        return torch.Size(self.layout.shape)

    @property
    def device(self):
        """The mesh's first device (where ``gather`` lands)."""
        return self.layout.mesh.device_list()[0]

    @property
    def dtype(self):
        p = self.parts[0]
        return None if isinstance(p, dict) else p.dtype

    def dim(self):
        return len(self.layout.shape)

    # -- whole tensors ----------------------------------------------------------

    def gather(self):
        """The whole array on the mesh's first device (counts into ``gathers``)."""
        _telemetry.count("parallel.gathers")
        return whole(self)

    def __array__(self, dtype=None, copy=None):
        """numpy's view of the whole array (a gather), as numpy reads the
        reference's sharded arrays."""
        a = self.gather().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    # -- tensor-like helpers for compiled loops' state ------------------------------

    def map(self, fn):
        return Blocks(self.layout, [tmap(fn, p) for p in self.parts])

    def clone(self):
        return self.map(lambda t: t.clone())

    def detach(self):
        return self.map(lambda t: t.detach())

    def copy_(self, src):
        src = relayout(src, self.layout)
        for d, s in zip(self.parts, src.parts):
            tmap(lambda a, b: a.copy_(b), d, s)
        return self

    def tensors(self):
        """Every block tensor (fields of UDT blocks included)."""
        out = []
        for p in self.parts:
            out.extend(p.values() if isinstance(p, dict) else (p,))
        return out

    def transpose(self):
        """The transposed view of a 2-D array (spec reversed, blocks ``.T``)."""
        lay = self.layout
        full = lay.spec + (None,) * (2 - len(lay.spec))
        t = Layout(lay.mesh, full[::-1], lay.shape[::-1])
        by_key = {(lay.keys[g][::-1], lay.devices[g]): p for g, p in enumerate(self.parts)}
        return Blocks(t, [tmap(lambda x: x.T, by_key[(t.keys[g], t.devices[g])]) for g in range(len(t.groups))])

    @property
    def T(self):
        return self.transpose()

    def __repr__(self):
        return f"Blocks(spec={self.spec}, shape={tuple(self.layout.shape)}, groups={len(self.parts)})"


def is_blocks(x):
    return type(x) is Blocks


def _slices(bounds):
    return tuple(slice(lo, hi) for lo, hi in bounds)


def cut(x, layout):
    """A whole tensor (or dict of field tensors) cut into ``layout``: each
    group's block on its device, contiguous."""
    return Blocks(
        layout,
        [tmap(lambda t, g=g: t[_slices(layout.bounds(g))].to(layout.devices[g]).contiguous(), x) for g in range(len(layout.groups))],
    )


def _assemble(parts, lay, cat):
    """The whole array from one block a key (``parts[g]`` for group g),
    joined along each split axis by ``cat(pieces, axis)``."""
    if len(lay.first_of_key) == 1:
        return parts[next(iter(lay.first_of_key.values()))]
    counts = lay.counts()

    def assemble(prefix, axis):
        if axis == len(counts):
            return parts[lay.first_of_key[prefix]]
        pieces = [assemble(prefix + (k,), axis + 1) for k in range(counts[axis])]
        return pieces[0] if len(pieces) == 1 else cat(pieces, axis)

    return assemble((), 0)


def whole(b):
    """The whole array of ``b`` on the mesh's first device (no count)."""
    dev = b.device

    def cat(pieces, axis):
        return tmap(lambda *ts: torch.cat([t.to(dev) for t in ts], dim=axis), *pieces)

    return tmap(lambda t: t.to(dev), _assemble(b.parts, b.layout, cat))


def whole_host(b, host_of):
    """The whole array of ``b`` as numpy from each block's host value
    (``host_of(tensor)``, None when a block has none); None then."""
    hosts = [host_of(p) for p in b.parts]
    if any(h is None for h in hosts):
        return None
    return _assemble(hosts, b.layout, lambda pieces, axis: np.concatenate(pieces, axis=axis))


def relayout(x, layout):
    """``x`` (Blocks, or a whole tensor) in ``layout``: as it is when it is
    there already, else cut (counts into ``reshards``).  A target block that
    one of x's blocks covers is sliced from it (on the target's device where
    one sits there); else x is assembled first."""
    if is_blocks(x):
        if x.layout == layout:
            return x
        if not _same_mesh(x.layout.mesh, layout.mesh):
            raise ValueError("operands placed on different meshes")
        _telemetry.count("parallel.reshards")
        src = x.layout
        parts = []
        for g in range(len(layout.groups)):
            tb = layout.bounds(g)
            dev = layout.devices[g]
            best = None
            for h in range(len(src.groups)):
                sb = src.bounds(h)
                if all(s0 <= t0 and t1 <= s1 for (s0, s1), (t0, t1) in zip(sb, tb)):
                    if best is None or (src.devices[h] == dev and src.devices[best] != dev):
                        best = h
            if best is None:
                return cut(whole(x), layout)
            rel = tuple(slice(t0 - s0, t1 - s0) for (s0, _), (t0, t1) in zip(src.bounds(best), tb))
            parts.append(tmap(lambda t: t[rel].to(dev).contiguous(), x.parts[best]))
        return Blocks(layout, parts)
    _telemetry.count("parallel.reshards")
    return cut(x, layout)


def blockwise(fn, layout, *args, offsets=False):
    """``fn`` on each group's blocks of ``args`` (Blocks in ``layout``; any
    other argument is passed as it is), with the block's global offsets as
    ``offset=`` when asked.  ``fn`` returns a tuple of tensors; the result is
    a tuple of Blocks in ``layout``."""
    outs = None
    for g in range(len(layout.groups)):
        parts = [a.parts[g] if is_blocks(a) else a for a in args]
        r = fn(*parts, offset=layout.offsets(g)) if offsets else fn(*parts)
        if outs is None:
            outs = [[] for _ in r]
        for o, t in zip(outs, r):
            o.append(t)
    return tuple(Blocks(layout, o) for o in outs)


def merge_layouts(layouts, shape):
    """The layout of an elementwise result over operands in ``layouts``
    (None: unplaced), as the reference's XLA propagates shardings: None when
    nothing is placed; per axis the one mesh axis the operands name; a full
    replication where they disagree."""
    placed = [lay for lay in layouts if lay is not None]
    if not placed:
        return None
    mesh = placed[0].mesh
    for lay in placed[1:]:
        if not _same_mesh(lay.mesh, mesh):
            raise ValueError("operands placed on different meshes")
    spec = [None] * len(shape)
    for lay in placed:
        for d, a in enumerate(lay.spec):
            if a is None:
                continue
            if spec[d] not in (None, a):
                return Layout(mesh, (), shape)
            spec[d] = a
    named = [a for a in spec if a is not None]
    if len(set(named)) != len(named):
        return Layout(mesh, (), shape)
    return Layout(mesh, spec, shape)


def combine_fn(monoid):
    """The cross-block combine of a monoid's partials: jnp.minimum /
    jnp.maximum order for float min and max (NaN propagates, -0.0 below
    +0.0), else the monoid's own function."""
    from ..kernels.segscan import _maximum, _minimum

    name = monoid.parent.name if hasattr(monoid, "parent") else None
    if name in ("min", "max") and monoid.type_._is_float:
        return _minimum if name == "min" else _maximum
    return monoid.fn if monoid.fn is not None else (lambda a, b: a)


def fold(partials, fn, device):
    """Present-aware fold of ``[(values, present)]`` in order on ``device``:
    where both are present ``fn``, else the present one; absent is 0."""
    v, p = (tmap(lambda t: t.to(device), partials[0][0]), partials[0][1].to(device))
    for v2, p2 in partials[1:]:
        v2, p2 = tmap(lambda t: t.to(device), v2), p2.to(device)
        both = p & p2
        v = tmap(lambda o, a, b: torch.where(both, o, torch.where(p, a, b)), fn(v, v2), v, v2)
        p = p | p2
    return tmap(lambda t: torch.where(p, t, torch.zeros((), dtype=t.dtype, device=t.device)), v), p


def reduce_axis(vals, struct, monoid, axis, reduce_block):
    """Rowwise (axis=1) / columnwise (axis=0) reduce of a placed matrix:
    each block reduces along ``axis`` (``reduce_block(v, s)`` -> (values,
    present)), then the partials of one kept block fold across the reduced
    mesh axis in shard order, on each output block's device.  The output
    spec is the kept axis's: ``('i',)`` rowwise and ``('j',)`` columnwise of
    ``('i', 'j')``."""
    lay = vals.layout
    keep = 1 - axis
    full = lay.spec + (None,) * (2 - len(lay.spec))
    out = Layout(lay.mesh, (full[keep],), (lay.shape[keep],))
    partial = {key: reduce_block(vals.parts[g], struct.parts[g]) for key, g in lay.first_of_key.items()}
    fn = combine_fn(monoid)
    vs, ss = [], []
    for g in range(len(out.groups)):
        k = out.keys[g][0]
        parts = [partial[key] for key in sorted(partial) if key[keep] == k]
        v, s = fold(parts, fn, out.devices[g])
        vs.append(v)
        ss.append(s)
    return Blocks(out, vs), Blocks(out, ss)


def reduce_all(vals, struct, monoid, reduce_block):
    """Full reduce of a placed array: each distinct block's reduce, folded
    in shard order on the mesh's first device; (0-d value, 0-d present)."""
    lay = vals.layout
    parts = [reduce_block(vals.parts[g], struct.parts[g]) for _, g in sorted(lay.first_of_key.items())]
    return fold(parts, combine_fn(monoid), vals.device)


def count_present(struct):
    """The number of present entries of a placed structure (one host read)."""
    lay = struct.layout
    dev = struct.device
    total = None
    for _, g in sorted(lay.first_of_key.items()):
        c = struct.parts[g].sum().to(dev)
        total = c if total is None else total + c
    return int(total)

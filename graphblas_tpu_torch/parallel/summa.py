"""SUMMA-style sharded semiring matmul and the edge-partitioned SpMV step.

Counterpart of ``graphblas_tpu/parallel/summa.py``.  Dense-masked operands
cut into blocks over a 2-D mesh: A as P(i, j), B (or x) as P(j, None).  Shard
(i, j) computes its local block product with the single-device engine
(``ops.densemasked.mxm`` / ``mxv``: a tropical block of at least 128 x 128
outputs on a card reaches ``gb_tropical``), and the partials of row block i
combine over j with the semiring's add monoid on each device of row i: a
plus monoid zeroes absent partials and sums them in shard order (``psum``),
any other monoid gathers them and folds left to right.  The operands are
read where their blocks sit (``parallel.blocks``), and the product stays
placed: Blocks P(i,), row block i on each of that row's devices, as the
reference's ``out_specs=P(i, None)``.  Shapes not divisible by the mesh are
padded with absent entries and the result, cut back, is replicated.
"""

import numpy as np
import torch

from ..core import dtypes as _dt
from ..ops import densemasked as _dm
from . import _collectives as _c
from . import blocks as _b


def _pad_dim(v, s, axis, mult):
    """Pad (values, struct) along ``axis`` to a multiple of ``mult``.

    Padding carries struct=False, so it is absent: every masked-engine op
    ignores it and the add-monoid combines skip it."""
    size = v.shape[axis]
    target = -(-size // mult) * mult
    if target == size:
        return v, s
    shape = list(v.shape)
    shape[axis] = target - size
    return (
        torch.cat([v, v.new_zeros(shape)], dim=axis),
        torch.cat([s, s.new_zeros(shape)], dim=axis),
    )


def _whole(x):
    """A whole tensor of ``x`` (a placed operand's blocks assembled; counted
    into the counter ``parallel.gathers``)."""
    return x.gather() if _b.is_blocks(x) else x


def _combine_partials(parts, add, out_dtype, device):
    """Partials [(values, struct)] of one row block, combined over j on
    ``device``."""
    if add.parent.name == "plus":
        # absent partials are canonical 0: the plain sum is the monoid combine
        cv = _c.psum([torch.where(s, v, torch.zeros((), dtype=v.dtype, device=v.device)) for v, s in parts], device)
        return cv, _c.pmax([s for _, s in parts], device)
    all_v = _c.all_gather([v for v, _ in parts], device)
    all_s = _c.all_gather([s for _, s in parts], device)
    fn = add.fn if add.fn is not None else (lambda a, b: a)
    v, s = all_v[0], all_s[0]
    for t in range(1, all_v.shape[0]):
        both = s & all_s[t]
        v = torch.where(both, _dt.cast(fn(v, all_v[t]), add.return_type, out_dtype), torch.where(s, v, all_v[t]))
        s = s | all_s[t]
    return torch.where(s, v, torch.zeros((), dtype=v.dtype, device=v.device)), s


def _summa(local, AV, AS, BV, BS, semiring_typed, out_dtype, mesh, axis_names, ncols):
    """Shard (i, j) multiplies A's block (i, j) by B's row block j with
    ``local``; the partials of row block i combine over j on each of that
    row's devices.  The operands are read where they sit: A in layout
    (ai, aj) and B in (aj,) cost nothing, any other layout is cut into
    them (the counter ``parallel.reshards``).  Returns (values, struct) as Blocks (ai,)
    (``ncols`` None: a vector).  A shape that does not divide by the mesh
    is padded with absent entries on the mesh's first device and the
    product, cut back, is replicated (spec ()), as the reference's."""
    ai, aj = axis_names
    pi, pj = mesh.shape[ai], mesh.shape[aj]
    m, k = AS.shape
    tail = () if ncols is None else (ncols,)
    if m % pi or k % pj:
        av, as_ = _pad_dim(*_pad_dim(_whole(AV), _whole(AS), 0, pi), 1, pj)
        bv, bs = _pad_dim(_whole(BV), _whole(BS), 0, pj)
        a_lay = _b.Layout(mesh, (ai, aj), as_.shape)
        b_lay = _b.Layout(mesh, (aj,), bs.shape)
        cv, cs = _summa(local, _b.cut(av, a_lay), _b.cut(as_, a_lay), _b.cut(bv, b_lay), _b.cut(bs, b_lay), semiring_typed, out_dtype, mesh, axis_names, ncols)
        rep = _b.Layout(mesh, (), (m,) + tail)
        return _b.cut(_b.whole(cv)[:m], rep), _b.cut(_b.whole(cs)[:m], rep)
    a_lay = _b.Layout(mesh, (ai, aj), (m, k))
    b_lay = _b.Layout(mesh, (aj,), (k,) + tail)
    av, as_ = _b.relayout(AV, a_lay), _b.relayout(AS, a_lay)
    bv, bs = _b.relayout(BV, b_lay), _b.relayout(BS, b_lay)
    out = _b.Layout(mesh, (ai,), (m,) + tail)
    ia, ja = mesh.axis_names.index(ai), mesh.axis_names.index(aj)
    coords = np.indices(mesh.devices.shape).reshape(mesh.devices.ndim, -1).T
    b_group = {(b_lay.keys[g][0], b_lay.devices[g]): g for g in range(len(b_lay.groups))}
    partials = {}  # row block -> [(values, struct)] in j order
    for kk in sorted(range(mesh.size), key=lambda kk: (coords[kk][ia], coords[kk][ja])):
        i, j = int(coords[kk][ia]), int(coords[kk][ja])
        ga = a_lay.group_of[kk]
        gb = b_group[(j, a_lay.devices[ga])]
        partials.setdefault(i, []).append(local(av.parts[ga], as_.parts[ga], bv.parts[gb], bs.parts[gb], semiring_typed, out_dtype))
    vs, ss = [], []
    for g in range(len(out.groups)):
        v, s = _combine_partials(partials[out.keys[g][0]], semiring_typed.monoid, out_dtype, out.devices[g])
        vs.append(v)
        ss.append(s)
    return _b.Blocks(out, vs), _b.Blocks(out, ss)


def _cast(x, frm, to):
    return x.map(lambda t: _dt.cast(t, frm, to)) if _b.is_blocks(x) else _dt.cast(x, frm, to)


def summa_mxm(A, B, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxm of two dense-format Matrix objects (see
    summa_mxm_arrays); their values are converted to the multiply's input
    types first."""
    from ..core.base import stored

    (av, as_), (bv, bs) = stored(A), stored(B)
    av = _cast(av, A.dtype, semiring_typed.binaryop.type_)
    bv = _cast(bv, B.dtype, semiring_typed.binaryop.type2)
    return summa_mxm_arrays(av, as_, bv, bs, semiring_typed, out_dtype, mesh, axis_names=axis_names)


def summa_mxm_arrays(AV, AS, BV, BS, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxm over dense-masked arrays (tensors, or the Blocks
    of placed operands), the values in the multiply's input types
    (``ops.densemasked.mxm``'s contract).

    A is read as P(i, j) and B as P(j, None); shard (i, j) computes its
    (m/pi, k/pj) x (k/pj, n) block product on its device, then the partials
    combine over j with the add monoid.  Returns (values, struct) as Blocks
    P(i,): row block i on each of that row's devices."""
    return _summa(_dm.mxm, AV, AS, BV, BS, semiring_typed, out_dtype, mesh, axis_names, BS.shape[1])


def summa_mxv(A, x, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxv (see summa_mxv_arrays)."""
    from ..core.base import stored

    (av, as_), (xv, xs) = stored(A), stored(x)
    av = _cast(av, A.dtype, semiring_typed.binaryop.type_)
    xv = _cast(xv, x.dtype, semiring_typed.binaryop.type2)
    return summa_mxv_arrays(av, as_, xv, xs, semiring_typed, out_dtype, mesh, axis_names=axis_names)


def summa_mxv_arrays(AV, AS, XV, XS, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxv: A read as P(i, j), x as P(j); the result Blocks
    P(i,).  Non-divisible shapes are padded with absent entries and cut
    back (a replicated result)."""
    return _summa(_dm.mxv, AV, AS, XV, XS, semiring_typed, out_dtype, mesh, axis_names, None)


def sharded_spmv_step(mesh, n, *, axis_names=("i", "j")):
    """An edge-partitioned plus_times SpMV step over the mesh.

    The edge arrays cut into equal parts over ALL shards (the flattened
    mesh); x goes to every shard; each shard segment-sums its edges'
    contributions and the partials psum in shard order on the mesh's first
    device: the O(E) analogue of SUMMA for irregular graphs.  Returns a
    function (src, dst, w, valid, x) -> y.  ``axis_names`` keeps the
    reference's signature: the edges cut over every shard of the mesh."""
    devices = mesh.device_list()
    ndev = len(devices)

    def step(src, dst, w, valid, x):
        e = src.shape[0]
        if e % ndev:
            raise ValueError(f"sharded_spmv_step: {e} edges do not split evenly over {ndev} shards")
        per = e // ndev
        parts = []
        for k, dev in enumerate(devices):
            sl = slice(k * per, (k + 1) * per)
            xk = x.to(dev)
            contrib = w[sl].to(dev) * xk[src[sl].to(dev).long()]
            contrib = torch.where(valid[sl].to(dev), contrib, torch.zeros((), dtype=contrib.dtype, device=dev))
            part = torch.zeros(n, dtype=contrib.dtype, device=dev)
            parts.append(part.index_add_(0, dst[sl].to(dev).long(), contrib))
        return _c.psum(parts, devices[0])

    return step

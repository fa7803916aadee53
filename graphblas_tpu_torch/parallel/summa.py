"""SUMMA-style sharded semiring matmul and the edge-partitioned SpMV step.

Counterpart of ``graphblas_tpu/parallel/summa.py``.  Dense-masked operands
cut into blocks over a 2-D mesh: A as P(i, j), B (or x) as P(j, None).  Shard
(i, j) computes its local block product with the single-device engine
(``ops.densemasked.mxm`` / ``mxv``: a tropical block of at least 128 x 128
outputs on a card reaches ``gb_tropical``), and the partials of row block i
combine over j with the semiring's add monoid on the mesh's first device: a
plus monoid zeroes absent partials and sums them in shard order (``psum``),
any other monoid gathers them and folds left to right.  Shapes not divisible
by the mesh are padded with absent entries and the result is cut back.
"""

import torch

from ..core import dtypes as _dt
from ..ops import densemasked as _dm
from . import _collectives as _c


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


def _grid(mesh, axis_names):
    """The mesh's devices as a (pi, pj) grid in the order of ``axis_names``."""
    ai, aj = axis_names
    order = [mesh.axis_names.index(ai), mesh.axis_names.index(aj)]
    return mesh.devices.transpose(order)


def _blocks(dev, *ts):
    """A shard's operand blocks, contiguous on its device."""
    return [t.to(dev).contiguous() for t in ts]


def _combine_partials(parts, add, out_dtype, device):
    """Partials [(values, struct)] of one row block, combined over j."""
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


def summa_mxm(A, B, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxm of two dense-format Matrix objects (see
    summa_mxm_arrays); their values are converted to the multiply's input
    types first."""
    av = _dt.cast(A._values, A.dtype, semiring_typed.binaryop.type_)
    bv = _dt.cast(B._values, B.dtype, semiring_typed.binaryop.type2)
    return summa_mxm_arrays(av, A._struct, bv, B._struct, semiring_typed, out_dtype, mesh, axis_names=axis_names)


def summa_mxm_arrays(AV, AS, BV, BS, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxm over dense-masked arrays, the values in the
    multiply's input types (``ops.densemasked.mxm``'s contract).

    Shard (i, j) computes its (m/pi, k/pj) x (k/pj, n) block product on its
    device, then the partials combine over j with the add monoid.  Returns
    (values, struct) on the mesh's first device."""
    grid = _grid(mesh, axis_names)
    pi, pj = grid.shape
    m = AV.shape[0]
    av, as_ = _pad_dim(*_pad_dim(AV, AS, 0, pi), 1, pj)
    bv, bs = _pad_dim(BV, BS, 0, pj)
    mloc, kloc = av.shape[0] // pi, av.shape[1] // pj
    out_dev = grid[0, 0]
    rows = []
    for i in range(pi):
        parts = []
        for j in range(pj):
            dev = grid[i, j]
            r, c = slice(i * mloc, (i + 1) * mloc), slice(j * kloc, (j + 1) * kloc)
            parts.append(_dm.mxm(*_blocks(dev, av[r, c], as_[r, c], bv[c], bs[c]), semiring_typed, out_dtype))
        rows.append(_combine_partials(parts, semiring_typed.monoid, out_dtype, out_dev))
    cv = torch.cat([v for v, _ in rows])[:m]
    cs = torch.cat([s for _, s in rows])[:m]
    return cv, cs


def summa_mxv(A, x, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxv (see summa_mxv_arrays)."""
    av = _dt.cast(A._values, A.dtype, semiring_typed.binaryop.type_)
    xv = _dt.cast(x._values, x.dtype, semiring_typed.binaryop.type2)
    return summa_mxv_arrays(av, A._struct, xv, x._struct, semiring_typed, out_dtype, mesh, axis_names=axis_names)


def summa_mxv_arrays(AV, AS, XV, XS, semiring_typed, out_dtype, mesh, *, axis_names=("i", "j")):
    """Sharded semiring mxv: A P(i, j), x cut over j; the result on the
    mesh's first device.  Non-divisible shapes are padded with absent
    entries and cut back."""
    grid = _grid(mesh, axis_names)
    pi, pj = grid.shape
    m = AV.shape[0]
    av, as_ = _pad_dim(*_pad_dim(AV, AS, 0, pi), 1, pj)
    xv, xs = _pad_dim(XV, XS, 0, pj)
    mloc, kloc = av.shape[0] // pi, av.shape[1] // pj
    out_dev = grid[0, 0]
    rows = []
    for i in range(pi):
        parts = []
        for j in range(pj):
            dev = grid[i, j]
            r, c = slice(i * mloc, (i + 1) * mloc), slice(j * kloc, (j + 1) * kloc)
            parts.append(_dm.mxv(*_blocks(dev, av[r, c], as_[r, c], xv[c], xs[c]), semiring_typed, out_dtype))
        rows.append(_combine_partials(parts, semiring_typed.monoid, out_dtype, out_dev))
    yv = torch.cat([v for v, _ in rows])[:m]
    ys = torch.cat([s for _, s in rows])[:m]
    return yv, ys


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

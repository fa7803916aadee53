"""Per-Matrix extension namespace ``A.tx`` (aliased as ``A.ss``).

Counterpart of ``graphblas_tpu/tx/matrix.py`` (the analogue of
python-graphblas's ``Matrix.ss``, core/ss/matrix.py): format introspection,
split/concat tiling, scan, selectk/compactify/sort, serialize/deserialize,
iterators, import/export of raw buffers.  Dense-masked operands compute with
torch ops on the matrix's device; sparse ones on their host COO with numpy,
as the reference computes them, and the result keeps the matrix's device.
"""

import pickle

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.utils import normalize_chunks
from ..ops import densemasked as _dm


class MatrixTx:
    def __init__(self, parent):
        self._parent = parent

    # -- introspection (reference: core/ss/matrix.py:183-251) -------------------

    @property
    def format(self):
        return "coo" if self._parent._sparse is not None else "densemasked"

    @property
    def nbytes(self):
        """Bytes of the storage: the host COO's arrays, or the device values
        and structure in their carriers (UINT16 and UINT32 take wider
        carriers than the reference's buffers)."""
        p = self._parent
        sp = p._sparse
        if sp is not None:
            return sp.rows.nbytes + sp.cols.nbytes + sp.vals.nbytes
        return p._values.nbytes + p._struct.nbytes

    @property
    def is_iso(self):
        p = self._parent
        if p.nvals == 0:
            return True
        sp = p._sparse
        if sp is not None:
            return bool(np.all(sp.vals == sp.vals[0]))
        vals = p._values[p._struct]
        return bool(torch.all(vals == vals[0])) if vals.numel() else True

    @property
    def config(self):
        """Per-object config (reference: MatrixConfig core/ss/matrix.py:124).

        Persistent per Matrix; setting ``storage`` converts the storage
        format in place ("coo" / "densemasked" / "auto")."""
        return _object_config(self._parent, "Matrix")

    def build_diag(self, vector, k=0, **opts):
        """Build the k'th diagonal from a Vector into this (empty) Matrix
        (reference: Matrix.ss.build_diag core/ss/matrix.py:252)."""
        from .. import exceptions as _exc

        p = self._parent
        if p.nvals > 0:
            raise _exc.OutputNotEmpty("build_diag requires an empty Matrix")
        p.setdiag(vector, k)  # honors the vector's pattern (absent stays absent)
        return p

    def build_scalar(self, rows, columns, value):
        """Iso build: every entry gets the same value
        (reference: Matrix.ss.build_scalar core/ss/matrix.py:382)."""
        from .. import exceptions as _exc
        from ..core.matrix import Matrix

        p = self._parent
        if p.nvals > 0:
            raise _exc.OutputNotEmpty("build_scalar requires an empty Matrix")
        with _built_on(p._device):
            new = Matrix.from_coo(rows, columns, value, p.dtype, nrows=p.nrows, ncols=p.ncols)
        if new._sparse is not None:
            p._adopt_sparse(new._sparse)
        else:
            p._set_arrays(new._values, new._struct)
        return p

    # -- tiling (reference: core/ss/matrix.py:280-380) --------------------------

    def split(self, chunks, *, name=None):
        """Split into a 2-D grid of tiles (reference: Matrix.ss.split :280)."""
        from ..core.matrix import Matrix

        p = self._parent
        chunksizes = normalize_chunks(chunks, p.shape)
        row_sizes, col_sizes = chunksizes
        tiles = []
        r0 = 0
        for ri, rs in enumerate(row_sizes):
            row_tiles = []
            c0 = 0
            for ci, cs_ in enumerate(col_sizes):
                v = p._values[r0 : r0 + rs, c0 : c0 + cs_].clone()
                s = p._struct[r0 : r0 + rs, c0 : c0 + cs_].clone()
                row_tiles.append(
                    Matrix._from_arrays(v, s, p.dtype, name=f"{name or p.name or 'split'}_{ri}x{ci}")
                )
                c0 += cs_
            tiles.append(row_tiles)
            r0 += rs
        return tiles

    # -- sparse-native order helpers (reference: core/ss/matrix.py:3806-4049
    # run these format-natively) ------------------------------------------------

    @staticmethod
    def _sparse_row_order(sp, *, by_value, descending):
        """Within-row stable order of a sparse matrix's entries (host)."""
        if by_value:
            key = sp.vals.astype(np.float64) if sp.vals.dtype == np.bool_ else sp.vals
            if descending:
                order = np.lexsort((-key.astype(np.float64), sp.rows))
            else:
                order = np.lexsort((key, sp.rows))
        else:
            idx = np.arange(sp.nvals)
            order = idx if not descending else np.lexsort((-idx, sp.rows))
        return order

    @staticmethod
    def _row_positions(sp, order):
        """Per-entry position within its row, under ``order``."""
        rows_o = sp.rows[order]
        starts = np.flatnonzero(np.concatenate([[True], rows_o[1:] != rows_o[:-1]]))
        pos = np.arange(len(order)) - np.repeat(starts, np.diff(np.concatenate([starts, [len(order)]])))
        return rows_o, pos

    @staticmethod
    def _present_order(v, s, axis, *, dtype, descending=False, by_value=True):
        """Stable order along ``axis`` with present entries first.

        Two stable sorts: first by key (value or position; with
        ``descending=True``, never by negating keys, which wraps unsigned
        types so a present 0 outranks 200), then by presence, pushing absent
        slots to the end without displacing present entries that tie with
        any fill value.  The keys are in an order-preserving carrier: BOOL as
        uint8 (as the reference), UINT64 with its sign bit flipped.
        """
        if by_value:
            key = v.to(torch.uint8) if v.dtype == torch.bool else _dt.ordered(v, dtype)
        else:
            key = broadcasted_iota(s.shape, axis, s.device)
        order1 = _stable_argsort(key, axis, descending)
        s1 = torch.take_along_dim(s, order1, dim=axis)
        order2 = _stable_argsort((~s1).to(torch.uint8), axis, False)
        return torch.take_along_dim(order1, order2, dim=axis)

    # -- scans and sorts (reference: core/ss/matrix.py:3689,3983) ----------------

    def scan(self, op="plus", order="rowwise", *, name=None):
        """Prefix scan over present entries (reference: Matrix.ss.scan :3689)."""
        from ..core.matrix import Matrix
        from ..core.operator import get_typed_op

        p = self._parent
        monoid = get_typed_op(op, p.dtype, kind="monoid")
        axis = 1 if order in {"rowwise", "row"} else 0
        if p._sparse is not None:
            from ..core.sparse import SparseMatrixData

            sp = p._sparse if axis == 1 else p._sparse.transposed()
            out_np = np.dtype(monoid.return_type.np_type)
            vals = sp.vals.astype(out_np)
            # per-row running reduce over present entries (host; pattern kept)
            starts = np.flatnonzero(np.concatenate([[True], sp.rows[1:] != sp.rows[:-1]]))
            name_m = monoid.parent.name
            np_fn = {"plus": np.add, "times": np.multiply, "min": np.minimum, "max": np.maximum}.get(name_m)
            if np_fn is not None and len(vals):
                acc = np_fn.accumulate(vals)
                if name_m == "plus":
                    out = acc - np.repeat(acc[starts] - vals[starts], np.diff(np.concatenate([starts, [len(vals)]])))
                else:
                    # non-invertible: per-segment accumulate
                    out = np.empty_like(vals)
                    ends = np.concatenate([starts[1:], [len(vals)]])
                    for s0, e0 in zip(starts, ends):
                        out[s0:e0] = np_fn.accumulate(vals[s0:e0])
            else:
                out = _scan_runs(vals, starts, monoid)
            sp2 = SparseMatrixData(sp.rows, sp.cols, out, sp.nrows, sp.ncols)
            if axis == 0:
                sp2 = sp2.transposed()
            return Matrix._from_sparse(sp2, monoid.return_type, name=name, device=p._device)
        v, s = _dm.prefix_scan(_dt.cast(p._values, p.dtype, monoid.type_), p._struct, monoid, axis)
        return Matrix._from_arrays(v, s, monoid.return_type, name=name)

    def sort(self, op="lt", order="rowwise", *, values=True, permutation=True, nthreads=None):
        """Sort values within each row/column (reference: GxB_Matrix_sort,
        core/ss/matrix.py:3983)."""
        from ..core.matrix import Matrix

        p = self._parent
        axis = 1 if order in {"rowwise", "row"} else 0
        opname = op if isinstance(op, str) else getattr(op, "name", "lt")
        descending = opname in {"gt", "ge"}
        if p._sparse is not None:
            from ..core.sparse import SparseMatrixData

            sp = p._sparse if axis == 1 else p._sparse.transposed()
            ordr = self._sparse_row_order(sp, by_value=True, descending=descending)
            rows_o, pos = self._row_positions(sp, ordr)
            result_v = result_p = None
            if values:
                sp_v = SparseMatrixData(rows_o, pos, sp.vals[ordr], sp.nrows, sp.ncols)
                if axis == 0:
                    sp_v = sp_v.transposed()
                result_v = Matrix._from_sparse(sp_v, p.dtype, device=p._device)
            if permutation:
                sp_p = SparseMatrixData(rows_o, pos.copy(), sp.cols[ordr].astype(np.int64), sp.nrows, sp.ncols)
                if axis == 0:
                    sp_p = sp_p.transposed()
                result_p = Matrix._from_sparse(sp_p, _dt.INT64, device=p._device)
            if values and permutation:
                return result_v, result_p
            return result_v if values else result_p
        order_idx = self._present_order(p._values, p._struct, axis, dtype=p.dtype, descending=descending)
        sorted_v = torch.take_along_dim(p._values, order_idx, dim=axis)
        # compact: present entries first in sort order
        counts = p._struct.sum(dim=axis, keepdim=True)
        pos = broadcasted_iota(p._struct.shape, axis, p._struct.device)
        new_s = pos < counts
        out_v = torch.where(new_s, sorted_v, torch.zeros_like(sorted_v))
        result_v = Matrix._from_arrays(out_v, new_s, p.dtype) if values else None
        result_p = None
        if permutation:
            result_p = Matrix._from_arrays(order_idx.to(torch.int64), new_s, _dt.INT64)
        if values and permutation:
            return result_v, result_p
        return result_v if values else result_p

    def _dense_order(self, how, what):
        p = self._parent
        if how in {"first", "last"}:
            return self._present_order(p._values, p._struct, 1, dtype=p.dtype, by_value=False, descending=how == "last")
        if how in {"smallest", "largest"}:
            return self._present_order(p._values, p._struct, 1, dtype=p.dtype, descending=how == "largest")
        raise ValueError(f"Invalid `how` for {what}: {how}")

    def selectk(self, how, k, *, name=None):
        """Select k entries per row: first/last/smallest/largest
        (reference: core/ss/matrix.py:3806)."""
        from ..core.matrix import Matrix

        p = self._parent
        if p._sparse is not None:
            from ..core.sparse import SparseMatrixData

            sp = p._sparse
            if how in {"first", "last"}:
                ordr = self._sparse_row_order(sp, by_value=False, descending=how == "last")
            elif how in {"smallest", "largest"}:
                ordr = self._sparse_row_order(sp, by_value=True, descending=how == "largest")
            else:
                raise ValueError(f"Invalid `how` for selectk: {how}")
            _, pos = self._row_positions(sp, ordr)
            keep = ordr[pos < k]
            keep.sort()
            sp2 = SparseMatrixData(sp.rows[keep], sp.cols[keep], sp.vals[keep], sp.nrows, sp.ncols)
            return Matrix._from_sparse(sp2, p.dtype, name=name, device=p._device)
        s, v = p._struct, p._values
        order = self._dense_order(how, "selectk")
        rank = _stable_argsort(order, 1, False)
        keep = s & (rank < k)
        return Matrix._from_arrays(torch.where(keep, v, torch.zeros_like(v)), keep, p.dtype, name=name)

    def compactify(self, how="first", ncols=None, *, name=None):
        """Push entries left within each row (reference: core/ss/matrix.py:3890)."""
        from ..core.matrix import Matrix

        p = self._parent
        out_cols = p.ncols if ncols is None else int(ncols)
        reverse = how in {"last", "largest"}
        if p._sparse is not None:
            from ..core.sparse import SparseMatrixData

            sp = p._sparse
            if how in {"first", "last"}:
                ordr = self._sparse_row_order(sp, by_value=False, descending=reverse)
            elif how in {"smallest", "largest"}:
                ordr = self._sparse_row_order(sp, by_value=True, descending=reverse)
            else:
                raise ValueError(f"Invalid `how` for compactify: {how}")
            rows_o, pos = self._row_positions(sp, ordr)
            keep = pos < out_cols
            sp2 = SparseMatrixData(rows_o[keep], pos[keep], sp.vals[ordr][keep], sp.nrows, out_cols)
            return Matrix._from_sparse(sp2, p.dtype, name=name, device=p._device)
        s, v = p._struct, p._values
        order = self._dense_order(how, "compactify")
        sorted_v = torch.take_along_dim(v, order, dim=1)
        counts = s.sum(dim=1, keepdim=True)
        pos = broadcasted_iota(s.shape, 1, s.device)
        new_s = pos < counts
        out_v = torch.where(new_s, sorted_v, torch.zeros_like(sorted_v))
        if out_cols < p.ncols:
            out_v, new_s = out_v[:, :out_cols], new_s[:, :out_cols]
        elif out_cols > p.ncols:
            pad = (p.nrows, out_cols - p.ncols)
            out_v = torch.cat([out_v, out_v.new_zeros(pad)], dim=1)
            new_s = torch.cat([new_s, new_s.new_zeros(pad)], dim=1)
        return Matrix._from_arrays(out_v, new_s, p.dtype, name=name)

    def flatten(self, order="rowwise", *, name=None):
        """Flatten to a Vector (reference: core/ss/matrix.py:3706)."""
        from ..core.vector import Vector

        p = self._parent
        if p._sparse is not None:
            from ..core.sparse import SparseVectorData

            sp = p._sparse if order not in {"columnwise", "col"} else p._sparse.transposed()
            total = sp.nrows * sp.ncols
            if total >= (1 << 62):
                raise _exc_overflow(sp.nrows, sp.ncols)
            idx = sp.rows * sp.ncols + sp.cols
            order_i = np.argsort(idx, kind="stable")
            return Vector._from_sparse(SparseVectorData(idx[order_i], sp.vals[order_i], total), p.dtype, name=name, device=p._device)
        v, s = p._values, p._struct
        if order in {"columnwise", "col"}:
            v, s = v.T, s.T
        return Vector._from_arrays(v.reshape(-1), s.reshape(-1), p.dtype, name=name)

    def reshape(self, nrows, ncols=None, order="rowwise", *, name=None):
        """Reshape (reference: core/ss/matrix.py:3750)."""
        from ..core.matrix import Matrix

        p = self._parent
        if ncols is None:
            if isinstance(nrows, tuple):
                nrows, ncols = nrows
            else:
                ncols = p.nrows * p.ncols // nrows
        if nrows * ncols != p.nrows * p.ncols:
            raise ValueError(f"Cannot reshape {p.shape} to ({nrows}, {ncols})")
        if p._sparse is not None:
            from ..core.sparse import SparseMatrixData

            colwise = order in {"columnwise", "col"}
            sp = p._sparse.transposed() if colwise else p._sparse
            # flat index in the chosen traversal order (transposed row-major
            # IS the original column-major)
            flat = sp.rows * sp.ncols + sp.cols
            if colwise:
                nr, nc = flat % nrows, flat // nrows
            else:
                nr, nc = flat // ncols, flat % ncols
            sp2 = SparseMatrixData.from_arrays(nr, nc, sp.vals, nrows, ncols, dup_op="first")
            return Matrix._from_sparse(sp2, p.dtype, name=name, device=p._device)
        v, s = p._values, p._struct
        if order in {"columnwise", "col"}:
            v, s = v.T.reshape(ncols, nrows).T, s.T.reshape(ncols, nrows).T
        else:
            v, s = v.reshape(nrows, ncols), s.reshape(nrows, ncols)
        return Matrix._from_arrays(v, s, p.dtype, name=name)

    def head(self, n=10, dtype=None, *, sort=False):
        """First n entries as (rows, cols, values) (reference: core/ss/matrix.py:3686)."""
        r, c, v = self._parent.to_coo(dtype)
        return r[:n], c[:n], v[:n]

    # -- iterators (reference: core/ss/matrix.py:411-536) ------------------------

    def iterkeys(self):
        r, c, _ = self._parent.to_coo(values=False)
        return iter(zip(r.tolist(), c.tolist()))

    def itervalues(self):
        _, _, v = self._parent.to_coo()
        return iter(v.tolist())

    def iteritems(self):
        r, c, v = self._parent.to_coo()
        return iter(zip(zip(r.tolist(), c.tolist()), v.tolist()))

    # -- serialization (reference: core/ss/matrix.py:4050-4168) ------------------

    def serialize(self, compression="default", level=None, **opts):
        """Serialize to GBTX, the reference's binary format, with optional
        zstd (the GxB_Matrix_serialize analogue, reference: core/ss/matrix.py:
        4050-4168): the same bytes as the reference for the same matrix.
        Preserves storage format and iso-ness; not pickle.  The values come
        to the host once (``to_coo``)."""
        from . import _binary

        p = self._parent
        r, c, v = p.to_coo()
        iso = len(v) > 0 and bool(np.all(v == v[0]))
        arrays = {"rows": r.astype(np.int64), "cols": c.astype(np.int64)}
        arrays["values"] = v[:1] if iso else v
        body = _binary.pack(
            "Matrix",
            _dt._dtype_to_string(p.dtype.np_type),
            (p.nrows, p.ncols),
            arrays,
            meta={"format": self.format, "iso": int(iso), "nvals": p.nvals},
        )
        return _binary.compress(body, compression, level)

    def export(self, format=None, *, sort=False, give_ownership=False, raw=False):
        """Export raw host buffers (reference: zero-copy export
        core/ss/matrix.py:537+).

        Supported formats: coo/coor/cooc, csr, csc, hypercsr, hypercsc,
        bitmapr, bitmapc, fullr, fullc, densemasked.
        """
        p = self._parent
        format = (format or "coo").lower()
        if format in {"coo", "coor", "cooc"}:
            r, c, v = p.to_coo()
            if format == "cooc":
                # column-sorted variant (reference: export "cooc",
                # core/ss/matrix.py:537-3649 — cols ascending, rows within)
                order = np.lexsort((r, c))
                r, c, v = r[order], c[order], v[order]
            return {
                "format": format,
                "rows": r,
                "cols": c,
                "values": v,
                "nrows": p.nrows,
                "ncols": p.ncols,
                "sorted_rows": format != "cooc",
                "sorted_cols": format == "cooc",
            }
        if format in {"bitmapr", "bitmapc"}:
            vals = np.asarray(p.to_dense(fill_value=0))
            if p._sparse is None:
                bm = p._struct.cpu().numpy()
            else:
                bm = np.zeros((p.nrows, p.ncols), bool)
                rr, cc, _ = p.to_coo()
                bm[rr.astype(np.int64), cc.astype(np.int64)] = True
            if format == "bitmapc":
                # flat column-major buffers, like the reference's by-column
                return {
                    "format": format,
                    "bitmap": np.ascontiguousarray(bm.T).reshape(-1),
                    "values": np.ascontiguousarray(vals.T).reshape(-1),
                    "nrows": p.nrows,
                    "ncols": p.ncols,
                    "nvals": int(p.nvals),
                }
            return {
                "format": format,
                "bitmap": bm,
                "values": vals,
                "nrows": p.nrows,
                "ncols": p.ncols,
                "nvals": int(p.nvals),
            }
        if format == "csr":
            indptr, col_indices, values = p.to_csr()
            return {"format": "csr", "indptr": indptr, "col_indices": col_indices, "values": values, "nrows": p.nrows, "ncols": p.ncols}
        if format == "csc":
            indptr, row_indices, values = p.to_csc()
            return {"format": "csc", "indptr": indptr, "row_indices": row_indices, "values": values, "nrows": p.nrows, "ncols": p.ncols}
        if format == "hypercsr":
            rows, indptr, col_indices, values = p.to_dcsr()
            return {"format": "hypercsr", "rows": rows, "indptr": indptr, "col_indices": col_indices, "values": values, "nrows": p.nrows, "ncols": p.ncols}
        if format == "hypercsc":
            cols, indptr, row_indices, values = p.to_dcsc()
            return {"format": "hypercsc", "cols": cols, "indptr": indptr, "row_indices": row_indices, "values": values, "nrows": p.nrows, "ncols": p.ncols}
        if format in {"fullr", "fullc"}:
            vals = np.asarray(p.to_dense(fill_value=0))
            if format == "fullc":
                vals = np.asfortranarray(vals)  # column-major memory order
            return {"format": format, "values": vals, "nrows": p.nrows, "ncols": p.ncols}
        if format == "densemasked":
            return {
                "format": "densemasked",
                "values": _dt.to_numpy(p._values, p.dtype),
                "struct": p._struct.cpu().numpy(),
                "nrows": p.nrows,
                "ncols": p.ncols,
            }
        raise ValueError(f"Invalid format for export: {format}")


def broadcasted_iota(shape, dim, device):
    """int64 positions along ``dim``, broadcast to ``shape`` (the torch
    counterpart of ``jax.lax.broadcasted_iota``)."""
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(shape[dim], dtype=torch.int64, device=device).reshape(view).expand(tuple(shape))


def _stable_argsort(key, dim, descending):
    """``jnp.argsort(key, axis=dim, stable=True, descending=descending)``:
    ties keep their order in either direction, NaN sorts last ascending
    (first descending), and -0.0 ties +0.0.  Complex keys order by the real
    part, then the imaginary part."""
    if key.is_complex():
        o1 = torch.sort(key.imag, dim=dim, stable=True, descending=descending).indices
        re = torch.take_along_dim(key.real, o1, dim=dim)
        return torch.take_along_dim(o1, torch.sort(re, dim=dim, stable=True, descending=descending).indices, dim=dim)
    return torch.sort(key, dim=dim, stable=True, descending=descending).indices


def _scan_runs(vals, starts, monoid):
    """Running reduce of host ``vals`` within each run that starts at
    ``starts``, by a typed monoid's own function (the monoids numpy has no
    ``accumulate`` for)."""
    t = monoid.return_type
    out = np.empty_like(vals)
    ends = np.concatenate([starts[1:], [len(vals)]]) if len(vals) else []
    for s0, e0 in zip(starts, ends):
        run = _dt.to_tensor(vals[s0:e0], t, "cpu")
        acc = run[:1]
        accs = [acc]
        for i in range(1, e0 - s0):
            acc = monoid.fn(acc, run[i : i + 1])
            accs.append(acc)
        out[s0:e0] = _dt.to_numpy(torch.cat(accs), t)
    return out


def _built_on(device):
    """``tx.config`` pinned to ``device``'s kind: the collections built in
    the block land beside ``device``."""
    from . import config

    return config.set(platform=device.type)


def _object_config(parent, kind):
    """Persistent per-object config with a live ``storage`` key."""
    try:
        cfg = parent._tx_config
    except AttributeError:
        cfg = None
    if cfg is None:
        cfg = _TxObjectConfig(parent, kind)
        parent._tx_config = cfg
    return cfg


class _TxObjectConfig:
    """MutableMapping-lite per-object config (reference: MatrixConfig /
    VectorConfig, core/ss/matrix.py:124).  Setting ``storage`` converts the
    parent's storage format in place; values persist with the object."""

    def __init__(self, parent, kind):
        import weakref

        self._parent_ref = weakref.ref(parent)
        self._kind = kind
        self._values = {"storage": "auto"}

    def __getitem__(self, key):
        return self._values[key]

    def get(self, key, default=None):
        return self._values.get(key, default)

    def __setitem__(self, key, value):
        if key not in self._values:
            raise KeyError(f"Unknown config key for {self._kind}.tx: {key!r}")
        self._values[key] = value
        parent = self._parent_ref()
        if key == "storage" and parent is not None and value != "auto":
            parent._set_storage(value)

    def __contains__(self, key):
        return key in self._values

    def __iter__(self):
        return iter(self._values)

    def __len__(self):
        return len(self._values)

    def __repr__(self):
        return f"{self._kind}.tx.config({self._values})"


def deserialize_matrix(data):
    """Inverse of MatrixTx.serialize (GBTX binary; legacy pickle accepted),
    on ``tx.config["platform"]``."""
    from ..core.matrix import Matrix
    from . import _binary

    raw = _binary.decompress(data)
    if raw[:4] == _binary.MAGIC:
        header, arrays = _binary.unpack(raw)
        dtype = _dt._string_to_dtype(header["dtype"])
        nrows, ncols = header["dims"]
        vals = arrays["values"]
        if header["meta"].get("iso"):
            vals = np.broadcast_to(vals[:1], arrays["rows"].shape)
        A = Matrix.from_coo(arrays["rows"], arrays["cols"], vals, dtype, nrows=nrows, ncols=ncols)
        if header["meta"].get("format") == "coo" and A._sparse is None:
            A._set_storage("coo")
        return A
    payload = pickle.loads(raw)
    dtype = _dt._string_to_dtype(payload["dtype"])
    return Matrix.from_coo(
        payload["rows"], payload["cols"], payload["values"], dtype, nrows=payload["nrows"], ncols=payload["ncols"]
    )


def _exc_overflow(nrows, ncols):
    from .. import exceptions as _exc

    return _exc.OutOfMemory(f"flatten of a {nrows}x{ncols} matrix exceeds the int64 index space")

"""Per-Vector extension namespace ``v.tx`` (aliased as ``v.ss``).

Counterpart of ``graphblas_tpu/tx/vector.py`` (the analogue of
python-graphblas's ``Vector.ss``, core/ss/vector.py).  Scans, sorts,
selectk and compactify run the matrix namespace's code on the vector as a
1-row Matrix (``_as_row``).
"""

import pickle

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.utils import normalize_chunks


class VectorTx:
    def __init__(self, parent):
        self._parent = parent

    @property
    def format(self):
        return "densemasked"

    @property
    def config(self):
        """Per-object config (reference: VectorConfig core/ss/vector.py:50)."""
        from .matrix import _object_config

        return _object_config(self._parent, "Vector")

    @property
    def nbytes(self):
        """Bytes of the storage (the port's own: the device carriers of a
        dense vector, the host arrays of a sparse one)."""
        p = self._parent
        sv = p._sparse
        if sv is not None:
            return sv.idx.nbytes + sv.vals.nbytes
        return p._values.nbytes + p._struct.nbytes

    @property
    def is_iso(self):
        p = self._parent
        if p.nvals == 0:
            return True
        sv = p._sparse
        if sv is not None:
            return bool(np.all(sv.vals == sv.vals[0]))
        vals = p._values[p._struct]
        return bool(torch.all(vals == vals[0])) if vals.numel() else True

    def split(self, chunks, *, name=None):
        """Split into tiles (reference: core/ss/vector.py split)."""
        from ..core.vector import Vector

        p = self._parent
        (sizes,) = normalize_chunks(chunks, p.shape)
        tiles = []
        start = 0
        for i, size in enumerate(sizes):
            tiles.append(
                Vector._from_arrays(
                    p._values[start : start + size].clone(),
                    p._struct[start : start + size].clone(),
                    p.dtype,
                    name=f"{name or p.name or 'split'}_{i}",
                )
            )
            start += size
        return tiles

    def _as_row(self):
        """The vector as a 1-row Matrix: a sparse one shares its host arrays
        (the matrix namespace's host code then runs on them), a dense one is
        its 1-row transpose on the vector's device."""
        from ..core.matrix import Matrix
        from ..core.sparse import SparseMatrixData

        p = self._parent
        sv = p._sparse
        if sv is not None:
            sp = SparseMatrixData(np.zeros(sv.nvals, np.int64), sv.idx, sv.vals, 1, sv.size)
            return Matrix._from_sparse(sp, p.dtype, device=p._device)
        m = p._as_matrix()
        return Matrix._from_arrays(m._values.T, m._struct.T, m.dtype)

    @staticmethod
    def _row_back(mat, dtype, name=None):
        """A 1-row Matrix back as a Vector, in its storage format."""
        from ..core.sparse import SparseVectorData
        from ..core.vector import Vector

        sp = mat._sparse
        if sp is not None:
            return Vector._from_sparse(
                SparseVectorData(sp.cols.copy(), sp.vals.copy(), sp.ncols), dtype, name=name, device=mat._device
            )
        return Vector._from_arrays(mat._values[0], mat._struct[0], dtype, name=name)

    def scan(self, op="plus", *, name=None):
        """Prefix scan (reference: core/ss/vector.py:1359)."""
        from ..core.operator import get_typed_op

        monoid = get_typed_op(op, self._parent.dtype, kind="monoid")
        return self._row_back(self._as_row().tx.scan(op, "rowwise"), monoid.return_type, name)

    def reshape(self, nrows, ncols=None, order="rowwise", *, name=None):
        """Reshape to a Matrix (reference: core/ss/vector.py:1372)."""
        from ..core.matrix import Matrix

        p = self._parent
        if ncols is None:
            if isinstance(nrows, tuple):
                nrows, ncols = nrows
            else:
                ncols = p.size // nrows
        if nrows * ncols != p.size:
            raise ValueError(f"Cannot reshape {p.size} to ({nrows}, {ncols})")
        v, s = p._values, p._struct
        if order in {"columnwise", "col"}:
            v = v.reshape(ncols, nrows).T
            s = s.reshape(ncols, nrows).T
        else:
            v = v.reshape(nrows, ncols)
            s = s.reshape(nrows, ncols)
        return Matrix._from_arrays(v, s, p.dtype, name=name)

    def selectk(self, how, k, *, name=None):
        """Select k entries (reference: core/ss/vector.py:1403)."""
        return self._row_back(self._as_row().tx.selectk(how, k), self._parent.dtype, name)

    def compactify(self, how="first", size=None, *, name=None):
        """Push entries to the front (reference: core/ss/vector.py:1500)."""
        return self._row_back(self._as_row().tx.compactify(how, size), self._parent.dtype, name)

    def sort(self, op="lt", *, values=True, permutation=True, nthreads=None):
        """Sort entries (reference: core/ss/vector.py:1560)."""
        out = self._as_row().tx.sort(op, values=values, permutation=permutation)
        if values and permutation:
            return self._row_back(out[0], self._parent.dtype), self._row_back(out[1], _dt.INT64)
        return self._row_back(out, self._parent.dtype if values else _dt.INT64)

    def head(self, n=10, dtype=None, *, sort=False):
        idx, vals = self._parent.to_coo(dtype)
        return idx[:n], vals[:n]

    def iterkeys(self):
        idx, _ = self._parent.to_coo(values=False)
        return iter(idx.tolist())

    def itervalues(self):
        _, vals = self._parent.to_coo()
        return iter(vals.tolist())

    def iteritems(self):
        idx, vals = self._parent.to_coo()
        return iter(zip(idx.tolist(), vals.tolist()))

    def serialize(self, compression="default", level=None, **opts):
        """GBTX binary serialize (reference: core/ss/vector.py:1621): the
        same bytes as the reference for the same vector; the values come to
        the host once (``to_coo``)."""
        from . import _binary

        p = self._parent
        idx, vals = p.to_coo()
        iso = len(vals) > 0 and bool(np.all(vals == vals[0]))
        arrays = {"indices": np.asarray(idx, np.int64)}
        arrays["values"] = vals[:1] if iso else vals
        body = _binary.pack(
            "Vector",
            _dt._dtype_to_string(p.dtype.np_type),
            (p.size,),
            arrays,
            meta={"format": self.format, "iso": int(iso), "nvals": p.nvals},
        )
        return _binary.compress(body, compression, level)

    def export(self, format=None, *, sort=False, give_ownership=False, raw=False):
        p = self._parent
        format = (format or "sparse").lower()
        if format == "sparse":
            idx, vals = p.to_coo()
            return {"format": "sparse", "indices": idx, "values": vals, "size": p.size}
        if format == "bitmap":
            return {
                "format": "bitmap",
                "bitmap": p._struct.cpu().numpy(),
                "values": _dt.to_numpy(p._values, p.dtype),
                "size": p.size,
            }
        if format == "full":
            return {"format": "full", "values": p.to_dense(fill_value=0), "size": p.size}
        raise ValueError(f"Invalid format for export: {format}")


def deserialize_vector(data):
    """Inverse of VectorTx.serialize (GBTX binary; legacy pickle accepted),
    on ``tx.config["platform"]``."""
    from ..core.vector import Vector
    from . import _binary

    raw = _binary.decompress(data)
    if raw[:4] == _binary.MAGIC:
        header, arrays = _binary.unpack(raw)
        dtype = _dt._string_to_dtype(header["dtype"])
        vals = arrays["values"]
        if header["meta"].get("iso"):
            vals = np.broadcast_to(vals[:1], arrays["indices"].shape)
        return Vector.from_coo(arrays["indices"], vals, dtype, size=header["dims"][0])
    payload = pickle.loads(raw)
    dtype = _dt._string_to_dtype(payload["dtype"])
    return Vector.from_coo(payload["indices"], payload["values"], dtype, size=payload["size"])

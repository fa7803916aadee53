"""Text/HTML reprs for collections, masks, and expressions.

Counterpart of ``graphblas_tpu/core/formatting.py``, string for string: a
two-line right-justified header

    "A"          nvals  nrows  ncols  dtype       format
    gb.Matrix        3      7      6  FP64   densemasked
    ----------------------------------------------------

— over a truncated pandas-style grid (blank cells = absent entries), a
COO triplet table for very sparse displays, mask reprs rendering 0/1
selection bits, and expression reprs showing the delayed op plus the
autocomputed value.  Truncation is done explicitly (head ... tail) so
repr strings are deterministic across pandas versions.  The values are read
from the card once per repr.
"""

import numpy as np

# deterministic truncation constants (python-graphblas uses pandas display options)
MAX_ROWS = 20
HEAD_ROWS = 5
MAX_COLS = 14
HEAD_COLS = 6
COO_LIMIT = 10


def _has_pandas():
    try:
        import pandas  # noqa: F401

        return True
    except ImportError:  # pragma: no cover
        return False


def _fmt_value(v):
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


def _chunk(length, max_len, head):
    """Indices to display (None marks the '...' separator)."""
    if length <= max_len:
        return list(range(length))
    tail = max_len - head - 1
    return list(range(head)) + [None] + list(range(length - tail, length))


# ---------------------------------------------------------------------------
# headers
# ---------------------------------------------------------------------------


def create_header(type_name, keys, vals, *, lower_border=False, name="", quote=True):
    vals = [str(x) for x in vals]
    if name and quote:
        name = f'"{name}"'
    key_text = []
    val_text = []
    for key, val in zip(keys, vals):
        width = max(len(key), len(val)) + 2
        key_text.append(key.rjust(width))
        val_text.append(val.rjust(width))
    if isinstance(type_name, str):
        name_width = max(len(type_name), len(name))
        lines = [
            f"{name.ljust(name_width)}{''.join(key_text)}",
            f"{type_name.ljust(name_width)}{''.join(val_text)}",
        ]
    else:
        name_width = max(max(map(len, type_name)), len(name))
        lines = [f"{name.ljust(name_width)}{''.join(key_text)}"]
        lines.extend(line.ljust(name_width) for line in type_name)
        lines[-1] += "".join(val_text)
    if lower_border:
        lines.append("-" * len(lines[0]))
    return "\n".join(lines)


def _is_iso(x):
    """All present values equal (the reference's ``x.tx.is_iso``)."""
    sp = x._sparse
    if sp is not None:
        return bool(np.all(sp.vals == sp.vals[0]))
    vals = x._values[x._struct]
    return bool((vals == vals[0]).all()) if vals.numel() else True


def get_format(x, is_transposed=False):
    """Storage format string incl. iso marker: a sparse Matrix is "coo" (the
    reference's ``Matrix.tx.format``; its ``Vector.tx.format`` always says
    "densemasked")."""
    fmt = "coo" if x.ndim == 2 and x._sparse is not None else "densemasked"
    if x.nvals and _is_iso(x):
        return f"{fmt} (iso)"
    return fmt


def matrix_info(matrix, *, mask=None, expr=None, for_html=False):
    if mask is not None:
        if for_html:
            name = f"{type(mask).__name__}\nof\ngb.{type(matrix).__name__}"
        else:
            name = [f"{type(mask).__name__}", f"of gb.{type(matrix).__name__}"]
    else:
        name = f"gb.{type(matrix).__name__}"
    keys = ["nvals", "nrows", "ncols", "dtype"]
    vals = [matrix.nvals, matrix.nrows, matrix.ncols, matrix.dtype.name]
    if expr is None:
        keys.append("format")
        from .matrix import Matrix

        if type(matrix) is Matrix:
            vals.append(get_format(matrix))
        else:  # TransposedMatrix view
            vals.append(get_format(matrix._matrix, is_transposed=True) + " (T)")
    return name, keys, vals


def vector_info(vector, *, mask=None, expr=None, for_html=False):
    if mask is not None:
        if for_html:
            name = f"{type(mask).__name__}\nof\ngb.{type(vector).__name__}"
        else:
            name = [f"{type(mask).__name__}", f"of gb.{type(vector).__name__}"]
    else:
        name = f"gb.{type(vector).__name__}"
    keys = ["nvals", "size", "dtype"]
    vals = [vector.nvals, vector.size, vector.dtype.name]
    if expr is None:
        keys.append("format")
        vals.append(get_format(vector))
    return name, keys, vals


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------


def _cell(values, struct, i, j):
    if not struct[i, j]:
        return ""
    return _fmt_value(values[i, j])


def _host(obj):
    """(values, struct) of a collection as numpy, in the reference's dtype."""
    from . import dtypes as _dt

    return _dt.to_numpy(obj._values, obj.dtype), obj._struct.cpu().numpy()


def _grid_lines(matrix, mask=None, max_rows=MAX_ROWS, max_cols=MAX_COLS):
    """Explicitly truncated grid rendered like a pandas frame."""
    import pandas as pd

    nrows, ncols = matrix.shape if matrix.ndim == 2 else (1, matrix.shape[0])
    values, struct = _host(matrix)
    if matrix.ndim == 1:
        values, struct = values[None, :], struct[None, :]
    bits = mask._bits().cpu().numpy() if mask is not None else None
    if bits is not None and bits.ndim == 1:
        bits = bits[None, :]
    rows = _chunk(nrows, max_rows, HEAD_ROWS)
    cols = _chunk(ncols, max_cols, HEAD_COLS)

    def render(i, j):
        if i is None or j is None:
            return "..."
        if bits is not None:
            if not struct[i, j] and not (mask.complement and bits[i, j]):
                return ""
            return str(int(bits[i, j]))
        return _cell(values, struct, i, j)

    data = [[render(i, j) for j in cols] for i in rows]
    index = ["..." if i is None else i for i in rows]
    columns = ["..." if j is None else j for j in cols]
    df = pd.DataFrame(data, index=index, columns=columns)
    if matrix.ndim == 1:
        df.index = ["value"]
        df.columns.name = "index"
    return df.to_string()


def _coo_table(matrix, limit=COO_LIMIT):
    import pandas as pd

    if matrix.ndim == 2:
        r, c, v = matrix.to_coo()
        data = {"row": r[:limit], "col": c[:limit], "val": v[:limit]}
    else:
        idx, v = matrix.to_coo()
        data = {"index": idx[:limit], "val": v[:limit]}
    df = pd.DataFrame(data)
    if matrix.nvals > limit:
        df.loc["..."] = ["..."] * len(data)
    return df.to_string()


def _body(obj, mask=None):
    """Grid for small/dense display; COO triplet table otherwise."""
    if not _has_pandas():
        return None
    nrows, ncols = obj.shape if obj.ndim == 2 else (1, obj.shape[0])
    if 0 in (nrows, ncols):
        return None
    sparse_fmt = getattr(obj, "_sparse", None) is not None or getattr(getattr(obj, "_matrix", None), "_sparse", None) is not None
    truncated = nrows > MAX_ROWS or ncols > MAX_COLS
    if sparse_fmt:
        if truncated or mask is not None:
            return _coo_table(obj)
        # small sparse collection: the grid, rendered from a throwaway dense
        # view (a repr never densifies the object itself)
        return _grid_lines(_dense_view(obj), mask=None)
    if truncated and obj.nvals * 4 < nrows * ncols and mask is None:
        return _coo_table(obj)
    return _grid_lines(obj, mask=mask)


def _dense_view(obj):
    """Throwaway dense-format copy of a small sparse collection for display."""
    from .matrix import Matrix
    from .vector import Vector

    coo = obj.to_coo()
    flat = coo[0].astype(np.int64)
    if obj.ndim == 2:
        flat = flat * obj.shape[1] + coo[1].astype(np.int64)
    from .sparse import _scatter_dense

    v, s = _scatter_dense(flat, coo[-1], obj.dtype, tuple(obj.shape), "cpu")
    return (Matrix if obj.ndim == 2 else Vector)._from_arrays(v, s, obj.dtype, name=obj.name)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def format_matrix(matrix, *, mask=None, expr=None, title=None):
    name, keys, vals = matrix_info(matrix, mask=mask, expr=expr)
    if title is not None and mask is None:
        name = title
    header = create_header(
        name,
        keys,
        vals,
        lower_border=_has_pandas(),
        name=(matrix.name if mask is None else (mask.name or matrix.name)) or "",
    )
    body = _body(matrix, mask=mask)
    return header if body is None else f"{header}\n{body}"


def format_vector(vector, *, mask=None, expr=None):
    name, keys, vals = vector_info(vector, mask=mask, expr=expr)
    header = create_header(
        name,
        keys,
        vals,
        lower_border=_has_pandas(),
        name=(vector.name if mask is None else (mask.name or vector.name)) or "",
    )
    body = _body(vector, mask=mask)
    return header if body is None else f"{header}\n{body}"


def format_scalar(sc, expr=None):
    header = create_header(
        f"gb.{type(sc).__name__}", ["value", "dtype"],
        ["" if sc.is_empty else _fmt_value(sc.value), sc.dtype.name],
        name=sc.name or "",
    )
    return header


def format_mask(mask):
    parent = mask.parent
    if parent.ndim == 2:
        return format_matrix(parent, mask=mask)
    return format_vector(parent, mask=mask)


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


def format_expression(expr):
    """Delayed-expression repr: header, functional description, and the
    autocomputed value when enabled."""
    from .. import config as _config

    shape = expr._shape or ()
    if len(shape) == 2:
        keys = ["nrows", "ncols", "dtype"]
        vals = [shape[0], shape[1], expr.dtype.name if expr.dtype else "?"]
    elif len(shape) == 1:
        keys = ["size", "dtype"]
        vals = [shape[0], expr.dtype.name if expr.dtype else "?"]
    else:
        keys = ["dtype"]
        vals = [expr.dtype.name if expr.dtype else "?"]
    out_name = getattr(expr.output_type, "__name__", "Base")
    header = create_header(f"gb.{out_name}Expression", keys, vals)
    lines = [header, "", expr._format_call_string(), ""]
    if _config.get("autocompute") and all(d <= 64 for d in shape):
        try:
            value = expr._get_value()
        except Exception:
            value = None
        if value is not None:
            lines.append("Computed result (autocompute is enabled):")
            lines.append(repr(value))
            return "\n".join(lines)
    lines.append("Do expr.new() or other << expr to compute the result.")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# HTML
# ---------------------------------------------------------------------------

CSS_STYLE = """
<style>
table.gb-info-table { border: 1px solid black; max-width: 100%; }
td.gb-info-name-cell { white-space: nowrap; }
</style>
"""


def _header_html(name, keys, vals):
    cells = "".join(
        f"<td><pre>{k}</pre></td>" for k in keys
    )
    vcells = "".join(f"<td>{v}</td>" for v in vals)
    return (
        f'{CSS_STYLE}<table class="gb-info-table">'
        f'<tr><td rowspan="2" class="gb-info-name-cell"><pre>{name}</pre></td>{cells}</tr>'
        f"<tr>{vcells}</tr></table>"
    )


def format_matrix_html(matrix, *, mask=None):
    name, keys, vals = matrix_info(matrix, mask=mask, for_html=True)
    nm = (matrix.name if mask is None else (mask.name or matrix.name)) or ""
    title = f'"{nm}"<br>{name}' if nm else name
    body = _body(matrix, mask=mask)
    pre = f"<pre>{body}</pre>" if body is not None else ""
    return f"<div>{_header_html(title, keys, vals)}{pre}</div>"


def format_vector_html(vector, *, mask=None):
    name, keys, vals = vector_info(vector, mask=mask, for_html=True)
    nm = (vector.name if mask is None else (mask.name or vector.name)) or ""
    title = f'"{nm}"<br>{name}' if nm else name
    body = _body(vector, mask=mask)
    pre = f"<pre>{body}</pre>" if body is not None else ""
    return f"<div>{_header_html(title, keys, vals)}{pre}</div>"


def format_scalar_html(sc):
    return f"<div><pre>{format_scalar(sc)}</pre></div>"

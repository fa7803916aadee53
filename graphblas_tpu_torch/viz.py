"""Visualization helpers (python-graphblas: graphblas/viz.py; the
reference's ``graphblas_tpu/viz.py``).

``draw`` (networkx layout), ``spy`` (matplotlib sparsity plot), ``datashade``
(datashader when installed, else the same canvas aggregation in numpy).  Each
reads the collection to the host once.
"""

import numpy as np


def _get_imports(names, within):
    import importlib

    out = []
    for name in names.split():
        try:
            out.append(importlib.import_module(name))
        except ImportError:
            raise ImportError(f"`{name}` is required for {within}") from None
    return out if len(out) > 1 else out[0]


def draw(m, **kwargs):
    """Draw a Matrix as a directed graph (reference: viz.py:45)."""
    nx = _get_imports("networkx", "draw")
    plt = _get_imports("matplotlib.pyplot", "draw")

    from .io import to_networkx

    g = to_networkx(m)
    pos = nx.spring_layout(g)
    edge_labels = {(i, j): d["weight"] for i, j, d in g.edges(data=True)}
    nx.draw_networkx(g, pos, node_color="red", node_size=500, **kwargs)
    nx.draw_networkx_edge_labels(g, pos, edge_labels=edge_labels)
    return g


def spy(m, *, show=True, **kwargs):
    """Plot the sparsity pattern (reference: viz.py:68)."""
    plt = _get_imports("matplotlib.pyplot", "spy")
    from .io import to_scipy_sparse

    s = to_scipy_sparse(m, "coo")
    fig, ax = plt.subplots()
    ax.spy(s, **kwargs)
    if show:
        plt.show()
    return ax


def _canvas_aggregate(m, agg, width, height):
    """Rasterize matrix entries onto a (height, width) canvas — the core of
    datashader's Canvas.points aggregation, in numpy."""
    r, c, v = (np.asarray(a) for a in m.to_coo())
    v = v.astype(np.float64)
    px = np.minimum((c * width) // max(m.ncols, 1), width - 1).astype(np.int64)
    py = np.minimum((r * height) // max(m.nrows, 1), height - 1).astype(np.int64)
    flat = py * width + px
    canvas = np.zeros(width * height, np.float64)
    if agg == "count":
        np.add.at(canvas, flat, 1.0)
    elif agg == "sum":
        np.add.at(canvas, flat, v)
    elif agg == "mean":
        cnt = np.zeros(width * height, np.float64)
        np.add.at(canvas, flat, v)
        np.add.at(cnt, flat, 1.0)
        canvas = np.divide(canvas, cnt, out=np.zeros_like(canvas), where=cnt > 0)
    elif agg == "min":
        canvas[:] = np.inf
        np.minimum.at(canvas, flat, v)
        canvas[~np.isfinite(canvas)] = 0.0
    elif agg == "max":
        canvas[:] = -np.inf
        np.maximum.at(canvas, flat, v)
        canvas[~np.isfinite(canvas)] = 0.0
    else:
        raise ValueError(f"agg must be one of count/sum/mean/min/max; got {agg!r}")
    return canvas.reshape(height, width)


def datashade(m, agg="count", *, width=None, height=None, show=True, **kwargs):
    """Density plot of a (large) matrix's entries (reference: viz.py:106).

    The reference delegates to datashader/hvplot (optional deps).  When
    datashader is installed the same path is used; otherwise this computes
    the identical canvas aggregation (count/sum/mean/min/max per pixel over
    the entries) in numpy and renders it with matplotlib — datashade works
    out of the box in this build instead of being import-gated.
    Returns the matplotlib Axes (or the hvplot object when the optional
    stack is present).
    """
    width = 500 if width is None else int(width)
    height = 500 if height is None else int(height)
    try:
        import datashader  # noqa: F401
        import hvplot.pandas  # noqa: F401
        import pandas as pd

        r, c, v = (np.asarray(a) for a in m.to_coo())
        df = pd.DataFrame({"row": r, "col": c, "val": v})
        return df.hvplot.scatter(
            x="col", y="row", c="val", aggregator=agg, datashade=True,
            width=width, height=height, flip_yaxis=True, **kwargs
        )
    except ImportError:
        pass
    plt = _get_imports("matplotlib.pyplot", "datashade")
    canvas = _canvas_aggregate(m, agg, width, height)
    fig, ax = plt.subplots()
    im = ax.imshow(canvas, origin="upper", aspect="auto", interpolation="nearest", **kwargs)
    fig.colorbar(im, ax=ax, label=agg)
    ax.set_xlabel("col")
    ax.set_ylabel("row")
    if show:
        plt.show()
    return ax

"""networkx interop (python-graphblas: graphblas/io/_networkx.py; the
reference's ``graphblas_tpu/io/_networkx.py``)."""


def from_networkx(G, nodelist=None, dtype=None, weight="weight", name=None):
    """Create a Matrix from a networkx graph (adjacency)."""
    import networkx as nx

    from ._scipy import from_scipy_sparse

    A = nx.to_scipy_sparse_array(G, nodelist=nodelist, dtype=dtype and _np_dtype(dtype), weight=weight)
    return from_scipy_sparse(A, name=name)


def _np_dtype(dtype):
    from ..core import dtypes as _dt

    return _dt.lookup_dtype(dtype).np_type


def to_networkx(m, edge_attribute="weight"):
    """Convert a Matrix to a networkx DiGraph."""
    import networkx as nx

    rows, cols, vals = m.to_coo()
    G = nx.DiGraph()
    G.add_nodes_from(range(m.nrows))
    if edge_attribute is None:
        G.add_edges_from(zip(rows.tolist(), cols.tolist()))
    else:
        G.add_weighted_edges_from(zip(rows.tolist(), cols.tolist(), vals.tolist()), weight=edge_attribute)
    return G

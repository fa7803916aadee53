"""IO converters: from/to scipy.sparse, networkx, Matrix Market, pydata
sparse and awkward (the last two gated on their packages, as in
python-graphblas's ``graphblas.io``).

Counterpart of ``graphblas_tpu/io``.  Every reader puts its result on
``tx.config["platform"]``; every writer reads the collection to the host once
(``to_coo``).
"""

from ._awkward import from_awkward, to_awkward  # noqa: F401
from ._matrixmarket import mmread, mmwrite  # noqa: F401
from ._networkx import from_networkx, to_networkx  # noqa: F401
from ._scipy import from_scipy_sparse, to_scipy_sparse  # noqa: F401
from ._sparse import from_pydata_sparse, to_pydata_sparse  # noqa: F401

"""The benchmark of ``graphblas_tpu_torch``: whole graph algorithms, written in
the library's DSL, on seeded Graph500 and GAP graphs, on one NVIDIA card.

    python3 gbbench/run.py --workload kron21.pagerank --seed 7 --seconds 20 --trace 0

``BENCHMARK.json`` at the repository root names the cells.  A cell names a
configuration (``configs/<config>.json``: the graph generator and its scale)
and a traffic mix (``traffic/<mix>.json``: the algorithm, its parameters and
how trials draw their roots); the algorithm's DSL recipe is
``algorithms/<algorithm>.py`` and its plain reference
``reference/<algorithm>.py``; each per-layer metric has its reader in
``metrics/<metric>.py``.  Everything is found by name (``registry.py``).
"""

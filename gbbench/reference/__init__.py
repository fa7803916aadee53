"""Plain torch references of the benchmark's algorithms.

Each module works the answer out again from the COO the harness generated,
imports nothing of the library under test, and judges the trials' answers:
``check(graph, params, results, ...)`` returns the numbers that decide
``correct``.  ``store`` runs the reference itself with its vectors and
weights held in a lower precision (the control).
"""

import torch

BLOCK = 1 << 24  # entries a gather works on at once


def blocks(nnz):
    for lo in range(0, nnz, BLOCK):
        yield lo, min(lo + BLOCK, nnz)


def rounded(x, store):
    """``x`` rounded to the storage type ``store`` (None: kept as it is) and
    widened back to float32 for the arithmetic that follows."""
    return x if store is None else x.to(store).to(torch.float32)

"""Graph: a padded-COO graph container of tensors.

Counterpart of ``graphblas_tpu/models/graph.py``, convertible from and to
the DSL's Matrix.  ``rmat`` draws its edges with numpy exactly as the JAX
package does, so both packages see identical graphs from one seed.
"""

import numpy as np
import torch

from ..ops import edgewise as _ew


class Graph:
    """Directed graph as padded COO tensors.

    n: number of nodes; src, dst: int32 (padded); weights: float32 or None;
    valid: bool marking real edges; nedges: number of real edges.  The
    builders put the tensors on the card unless given ``device="cpu"``."""

    def __init__(self, n, src, dst, weights, valid, nedges):
        self.n = int(n)
        self.src = src
        self.dst = dst
        self.weights = weights
        self.valid = valid
        self.nedges = int(nedges)

    @classmethod
    def from_arrays(cls, src, dst, weights=None, *, n=None, pad_to=None, device="cuda"):
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        if n is None:
            n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
        psrc, pdst, pw, valid = _ew.pad_edges(src, dst, weights, pad_to=pad_to)
        return cls(
            n,
            torch.from_numpy(psrc).to(device),
            torch.from_numpy(pdst).to(device),
            torch.from_numpy(np.asarray(pw, np.float32)).to(device) if pw is not None else None,
            torch.from_numpy(valid).to(device),
            len(src),
        )

    @classmethod
    def from_matrix(cls, A):
        """From a Matrix (adjacency; A[i, j] = weight of i->j), on its device."""
        rows, cols, vals = A.to_coo()
        return cls.from_arrays(rows.astype(np.int32), cols.astype(np.int32), vals, n=A.nrows, device=A._device)

    def to_matrix(self, dtype=None):
        """The adjacency Matrix on the graph's device; parallel (duplicate)
        edges collapse additively, multigraph-style."""
        from .. import binary
        from ..core.matrix import Matrix
        from ..tx import config as _txconfig

        valid = self.valid.cpu().numpy()
        src = self.src.cpu().numpy()[valid]
        dst = self.dst.cpu().numpy()[valid]
        w = self.weights.cpu().numpy()[valid] if self.weights is not None else np.ones(len(src))
        with _txconfig.set(platform=self.src.device.type):
            return Matrix.from_coo(src, dst, w, dtype, nrows=self.n, ncols=self.n, dup_op=binary.plus)

    @property
    def has_weights(self):
        return self.weights is not None

    def reverse(self):
        """Graph with all edges flipped."""
        return Graph(self.n, self.dst, self.src, self.weights, self.valid, self.nedges)

    def to(self, device):
        w = self.weights.to(device) if self.weights is not None else None
        return Graph(self.n, self.src.to(device), self.dst.to(device), w, self.valid.to(device), self.nedges)

    def __repr__(self):
        return f"Graph(n={self.n}, nedges={self.nedges}, padded={self.src.numel()}, device={self.src.device})"


def rmat(scale, edge_factor=16, *, a=0.57, b=0.19, c=0.19, seed=0, weighted=False, device="cuda"):
    """Synthetic RMAT/Graph500-style power-law graph (GAP-style benchmark input)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    e = n * edge_factor
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for bit in range(scale):
        r = rng.random(e)
        src_bit = (r > a + b).astype(np.int64)
        r2 = rng.random(e)
        thresh = np.where(src_bit == 0, a / (a + b), c / (1 - a - b))
        dst_bit = (r2 > thresh).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    # permute ids to break locality artifacts
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    w = rng.random(e).astype(np.float32) * 9 + 1 if weighted else None
    return Graph.from_arrays(src.astype(np.int32), dst.astype(np.int32), w, n=n, device=device)

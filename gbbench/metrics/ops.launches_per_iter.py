"""Launches of the library's hand-written kernels an iteration:
``graphblas_tpu_torch.kernels.launch_counts()`` over the slice (replays add
what their capture recorded), over the iterations the recipes counted."""


def read(r):
    total = sum(r.launches.values())
    if not total or not r.iters:
        return None
    return total / r.iters

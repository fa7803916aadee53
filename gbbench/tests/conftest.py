"""Fixtures of the benchmark's own tests (``python -m pytest gbbench/tests -q``).

They run on the CPU at tiny scales.  ``library`` sets the library up as it
runs on the card, at a scale where that means something: the matrix in the
sparse format with dense vectors (a ``dense_limit`` between n and n^2), the
n-space loop layout (the card's default; the CPU's edge layout is another
path), and a blocking plan build.  ``card`` skips a test, inside the fixture,
where there is no CUDA device.
"""

import pytest

SCALE = 8  # 256 vertices


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(params=["auto", "plan"])
def library(request, monkeypatch):
    """The library on the CPU; the SpMV through the generic path ("auto" on
    CPU tensors) or the plan engine's plain versions ("plan")."""
    import graphblas_tpu_torch as gb

    monkeypatch.delenv("GRAPHBLAS_TPU_PLAN_CACHE", raising=False)
    monkeypatch.setenv("GRAPHBLAS_TPU_PLAN_BACKGROUND", "0")
    monkeypatch.setenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", "0")
    with gb.tx.config.set(platform="cpu", dense_limit=4096, mxv_strategy=request.param):
        yield request.param

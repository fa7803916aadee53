"""The port imports torch and numpy only: never JAX, never a compiler."""

import os
import re
import subprocess
import sys

import graphblas_tpu_torch

PKG_DIR = os.path.dirname(os.path.abspath(graphblas_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)


def _run_fresh(code):
    """Run ``code`` in a fresh interpreter with only the repository on the path."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_import_leaves_no_jax_module():
    _run_fresh(
        "import sys, graphblas_tpu_torch, graphblas_tpu_torch.models.fast;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'graphblas_tpu'));"
        "assert not bad, bad"
    )


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import graphblas_tpu\b|from graphblas_tpu\b)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, name) for name in files if name.endswith((".py", ".cu", ".cuh"))]
    offenders = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders


def test_import_builds_nothing():
    # the library is built on the first launch on a CUDA tensor only
    _run_fresh("import graphblas_tpu_torch as g; assert g.kernels._build._LIB is None")

"""The port imports torch and numpy only: never JAX, never anything of the
JAX package (not even a module of it that does not import JAX), never a
compiler at import time."""

import ast
import os
import subprocess
import sys

import pytest

import graphblas_tpu_torch

PKG_DIR = os.path.dirname(os.path.abspath(graphblas_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "graphblas_tpu")


def _run_fresh(code):
    """Run ``code`` in a fresh interpreter with only the repository on the path."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_import_leaves_no_jax_module():
    _run_fresh(
        "import pkgutil, sys, graphblas_tpu_torch;"
        "[__import__(m.name) for m in pkgutil.walk_packages(graphblas_tpu_torch.__path__, 'graphblas_tpu_torch.')];"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('triton',)!r});"
        "assert not bad, bad"
    )


def forbidden_imports(source):
    """The forbidden modules a Python source imports: ``import`` and ``from``
    statements anywhere (also inside functions), and ``importlib.import_module``
    or ``__import__`` of a constant name."""
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                names = [node.args[0].value]
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    return paths


def test_no_source_file_imports_jax():
    offenders = {}
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            bad = forbidden_imports(f.read())
        if bad:
            offenders[os.path.relpath(path, REPO)] = bad
    assert not offenders


@pytest.mark.parametrize(
    "source,bad",
    [
        ("import jax.numpy as jnp", ["jax.numpy"]),
        ("import os, graphblas_tpu", ["graphblas_tpu"]),
        ("def f():\n    from graphblas_tpu.ops import permute", ["graphblas_tpu.ops"]),
        ("from graphblas_tpu import native", ["graphblas_tpu"]),
        ("import importlib\nimportlib.import_module('graphblas_tpu.ops.pallas_scan')", ["graphblas_tpu.ops.pallas_scan"]),
        ("__import__('jax')", ["jax"]),
        ("import graphblas_tpu_torch\nfrom graphblas_tpu_torch.ops import permute\nfrom . import x", []),
    ],
)
def test_import_check_sees_every_form(source, bad):
    assert forbidden_imports(source) == bad


def test_import_builds_nothing():
    # the library is built on the first launch on a CUDA tensor only
    _run_fresh("import graphblas_tpu_torch as g; assert g.kernels._build._LIB is None")

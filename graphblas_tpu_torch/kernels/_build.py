"""Build the port's CUDA kernels on first use and bind them with ctypes.

Every ``graphblas_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
for Hopper (``sm_90a``), all at once, and the objects are linked into one
shared library with a plain C interface, under ``graphblas_tpu_torch/_build/``.
The file name carries a hash of the sources (``*.cu`` and ``*.cuh``) and the
flags, so an edit rebuilds and an unchanged tree reuses the library.  The
build writes to temporary files and renames the library into place, so two
processes building at once never load a half-written library.

Counterpart of ``graphblas_tpu/native/__init__.py:_build_lib`` (the JAX
package's g++ build of its host router).  There is no fallback: without
``nvcc`` the first kernel launch raises.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from ..core import telemetry as _telemetry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C entry points and their argument types (every pointer and the stream as
# c_void_p, or ctypes would pass a 32-bit int and cut the pointer)
_SIGNATURES = {
    "gb_gather": [_P, _P, _P, _I64, _I, _P],
    "gb_gather_pagerank": [_P, _P, _P, _P, _P, _I64, _P],
    "gb_segscan_contrib": [_P] * 6 + [_I64, _I, _I, _I, _I, _I, ctypes.c_double, _P],
    "gb_segscan_contrib_gather": [_P] * 7 + [_I64, _I, _I, _I, _I, _I, ctypes.c_double, _P],
    "gb_segscan_state": [_I] + [_P] * 6 + [_I] + [_P] * 4 + [_I64, _P],
    "gb_segscan": [_P] * 4 + [_I64, _I, _I, _P],
    "gb_segscan_tile": [],
    "gb_segscan_state_tile": [],
    "gb_segscan_spmm": [_P] * 12 + [_I64, _I, _I, _I, _I, _I, _P] + [_P] * 6,
    "gb_segscan_spmm_keep": [_P, _I, _P, _P, _I64, _I] + [_P] * 7 + [_I64, _I, _P],
    "gb_segscan_spmm_geometry": [_I, _I, _P],
    "gb_eqjoin": [_P] * 6 + [_I, _I, _I64, _I, _I, _I, _P],
    "gb_compare_probe": [_P] * 3 + [_I64, _P],
    "gb_compare_probe_k": [],
    "gb_tropical": [_P] * 3 + [_I] * 6 + [_P],
    "gb_imatmul": [_P] * 3 + [_I] * 5 + [_P],
}

_LOCK = threading.Lock()
_LIB = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _hashed_files():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def nvcc_path():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "graphblas_tpu_torch: nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def library_path():
    digest = hashlib.sha256()
    for path in _hashed_files():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgbtorch_{digest.hexdigest()[:16]}.so")


def _compile(so_path):
    """One nvcc per source, all started together, then one link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"tmp{os.getpid()}"
    jobs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs = [obj for _, obj, _ in jobs]
    try:
        failed = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{so_path}.{tag}"
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def library():
    """The loaded kernel library, built from the sources on first use (the
    span ``kernels.build`` holds the build and the load; ``kernels.builds``
    counts the builds)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK, _telemetry.span("kernels.build"):
        if _LIB is None:
            so_path = library_path()
            if not os.path.exists(so_path):
                _compile(so_path)
                _telemetry.count("kernels.builds")
            lib = ctypes.CDLL(so_path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gb_error_string.argtypes = [ctypes.c_int]
            lib.gb_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(rc, name):
    """Raise if a C entry point reported a CUDA error (its cudaGetLastError)."""
    if rc != 0:
        msg = _LIB.gb_error_string(rc).decode() if _LIB is not None else "?"
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t):
    """The current CUDA stream of the tensor's device, as a C pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

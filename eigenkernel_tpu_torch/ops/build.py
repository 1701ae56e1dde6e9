"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
library lives in ``eigenkernel_tpu_torch/_build/<hash>/``, keyed by a hash
of the sources and the flags, so an edited source rebuilds and an unchanged
one loads at once.  The build runs at the first kernel launch of a process,
never at import: a machine without ``nvcc`` can import every module and run
the plain PyTorch versions on CPU tensors.

A failed build raises :class:`KernelCompileError` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("sturm_bisect.cu", "tridiag_solve.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: (name, argtypes); every function returns cudaError_t as int
_SIGNATURES = {
    "ek_sturm_bisect_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ek_sturm_bisect_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "ek_tridiag_solve_f64": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                             ctypes.c_double, _P),
    "ek_tridiag_solve_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                             ctypes.c_float, _P),
}

_LIB = None
BUILD_SECONDS = 0.0   # wall time of this process's build (0 if cached)
BUILD_LOG = ""        # nvcc's output (-Xptxas -v register/spill report)


class KernelCompileError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelCompileError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "the CUDA kernels")
    return found


def _build(out_dir: str) -> str:
    global BUILD_SECONDS, BUILD_LOG
    lib_path = os.path.join(out_dir, "libek_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    # build to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(CSRC, s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelCompileError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_LOG}")
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(BUILD_LOG)
    os.replace(tmp, lib_path)
    BUILD_SECONDS = time.time() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build(os.path.join(BUILD_ROOT, _source_hash())))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if status != 0:
        raise KernelLaunchError(f"{name}: CUDA error {status}")

"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
of its own with a plain C interface, which is loaded with ``ctypes``.  The
``nvcc`` processes of all sources start together, so the build takes as
long as the slowest source, not the sum.  A library lives in
``eigenkernel_tpu_torch/_build/<stem>-<hash>/``, keyed by a hash of its
source and the flags, so an edited source rebuilds and an unchanged one
loads at once.  The build runs at the first kernel launch of a process,
never at import: a machine without ``nvcc`` can import every module and run
the plain PyTorch versions on CPU tensors.

A failed build raises :class:`KernelCompileError` with the compiler's output.

:func:`host_library` builds a host C++ source (``csrc/mmio.cpp``, the
MatrixMarket parser) with ``g++ -O2 -shared -fPIC`` the same way, into
the same ``_build/``, at its first use.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
# source -> {C function: argtypes}; every function returns an int: a
# launch's cudaError_t, or a getter's value
_SIGNATURES = {
    "sturm_bisect.cu": {
        "ek_sturm_bisect_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "ek_sturm_bisect_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "ek_sturm_max_warps": (),
    },
    "tridiag_solve.cu": {
        "ek_tridiag_solve_f64": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 ctypes.c_double, _P),
        "ek_tridiag_solve_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 ctypes.c_float, _P),
        "ek_tridiag_solve_rows": (),
    },
    "band_chase.cu": {
        "ek_band_chase_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P),
        "ek_band_chase_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P),
        "ek_band_chase_resident_f64": (_I, _I, _P),
        "ek_band_chase_resident_f32": (_I, _I, _P),
    },
    "wf_bt.cu": {
        "ek_wf_bt_f64": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P),
        "ek_wf_bt_f32": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P),
    },
    "chase_bt.cu": {
        "ek_chase_bt_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "ek_chase_bt_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "ek_chase_bt_smem": (_I, _I, _I, _I),
    },
    "dc_deflate.cu": {
        "ek_dc_deflate_f64": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P),
        "ek_dc_deflate_f32": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P),
    },
    "panel_qr.cu": {
        "ek_panel_qr_f64": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
        "ek_panel_qr_f32": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
        "ek_panel_qr_smem": (_I, _I, _I),
    },
    "panel_trd.cu": {
        "ek_panel_trd_f64": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P),
        "ek_panel_trd_f32": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P),
        "ek_panel_trd_scratch": (_I, _I, _I, _I),
    },
    "pair_jacobi.cu": {
        "ek_pair_jacobi_f64": (_P, _I, _I, _I, _P, _P, _P, _P, _P),
        "ek_pair_jacobi_f32": (_P, _I, _I, _I, _P, _P, _P, _P, _P),
        "ek_pair_jacobi_smem": (_I, _I),
        "ek_pair_jacobi_resident": (_I, _I),
    },
}
SOURCES = tuple(_SIGNATURES)

_LIB = None
BUILD_SECONDS = 0.0   # wall time of this process's build (0 if cached)
BUILD_LOG = ""        # nvcc's output (-Xptxas -v register/spill report)


class KernelCompileError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _source_hash(name: str, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
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


def _lib_path(name: str, flags=NVCC_FLAGS) -> str:
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_ROOT, f"{stem}-{_source_hash(name, flags)}",
                        f"lib{stem}.so")


def _build_all() -> dict:
    """Build every source whose library is missing, all ``nvcc`` processes
    at once; returns {source: library path}."""
    global BUILD_SECONDS, BUILD_LOG
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = [name for name, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths
    t0 = time.time()
    nvcc = _nvcc()
    jobs = []
    for name in todo:
        out_dir = os.path.dirname(paths[name])
        os.makedirs(out_dir, exist_ok=True)
        # build to a temporary name, then rename: a concurrent or
        # interrupted build never leaves a half-written library behind
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, cmd, tmp, proc))
    logs, failed = [], []
    for name, cmd, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
            continue
        with open(os.path.join(os.path.dirname(paths[name]), "build.log"),
                  "w") as f:
            f.write(out)
        os.replace(tmp, paths[name])
    BUILD_LOG = "\n".join(logs)
    BUILD_SECONDS = time.time() - t0
    if failed:
        raise KernelCompileError("\n".join(failed))
    return paths


class _Kernels:
    """The C functions of every kernel library, by name."""

    def __init__(self, paths: dict):
        for name, sigs in _SIGNATURES.items():
            lib = ctypes.CDLL(paths[name])
            for fn_name, argtypes in sigs.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                setattr(self, fn_name, fn)


def library() -> _Kernels:
    """The loaded kernel functions, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = _Kernels(_build_all())
    return _LIB


_HOST = {}


def host_library(name: str) -> ctypes.CDLL:
    """The host C++ source ``csrc/<name>`` as a loaded shared library,
    built with ``g++`` on first use (:class:`KernelCompileError` if the
    build fails)."""
    if name in _HOST:
        return _HOST[name]
    path = _lib_path(name, GXX_FLAGS)
    if not os.path.exists(path):
        gxx = shutil.which("g++")
        if gxx is None:
            raise KernelCompileError(f"g++ not found: it builds {name}")
        out_dir = os.path.dirname(path)
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [gxx, *GXX_FLAGS, "-o", tmp, os.path.join(CSRC, name)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelCompileError(f"g++ failed ({proc.returncode}): "
                                     f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    _HOST[name] = ctypes.CDLL(path)
    return _HOST[name]


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if status != 0:
        raise KernelLaunchError(f"{name}: CUDA error {status}")

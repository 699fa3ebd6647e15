"""Build and load the CUDA SpMV kernels (``csrc/spmv.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface at first use, under ``build/kernels/`` at the repository root,
named by a hash of the source and flags (a changed source never loads a
stale library).  ``ctypes`` loads it; :mod:`repro_torch.kernels.ops` calls
the five entry points with tensor pointers and the current CUDA stream.

Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.  A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "SOURCE", "build", "library", "loads"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmv.cu"
#: <repo>/build/kernels (this file is <repo>/src/repro_torch/kernels/...)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIB: ctypes.CDLL | None = None
#: times this process has loaded a kernel library (each load follows its
#: build at first use): 0 before the first CUDA launch, 1 after
_LOADS = 0

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "repro_ell_spmv": [_i, _p, _p, _p, _i, _p, _p, _p, _i, _p, _i64, _p,
                       _i64, _p, _i, _i, _i, _p],
    "repro_sell_spmv": [_i, _p, _p, _p, _p, _i64, _p, _p, _p, _p, _i64, _i,
                        _i, _i, _p, _i64, _p, _i64, _p, _i, _i, _i, _p],
    "repro_balanced_spmv": [_i, _p, _p, _p, _p, _i, _p, _p, _p],
    "repro_ell_spmv_batched": [_i, _p, _p, _p, _i, _p, _p, _p, _i, _p, _i64,
                               _p, _i64, _p, _i, _i, _i, _i, _p],
    "repro_sell_spmv_batched": [_i, _p, _p, _p, _p, _i64, _p, _p, _p, _p,
                                _i64, _i, _i, _i, _p, _i64, _p, _i64, _p,
                                _i, _i, _i, _i, _p],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``spmv.cu`` unless a library of the same source and flags
    exists.  Returns ``(library path, compiler log)``; ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel) to a
    fresh build's log."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libreprospmv_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or nothing
    return out, res.stdout + res.stderr


def loads() -> int:
    """How many times this process has built-or-found and loaded the
    kernel library (:func:`library`); it stays 1 for the life of a
    process that launched a kernel."""
    return _LOADS


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB, _LOADS
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        _LOADS += 1
    return _LIB

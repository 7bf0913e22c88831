"""Native (C++) host-runtime kernels with lazy compilation.

The compute path of this framework is JAX/XLA on the GPU; the host
runtime around it (mesh indexing, assembly reduction, reordering, host
operator application) offloads its hot loops to ``host_kernels.cpp``,
compiled here on first use with the system toolchain and loaded via
ctypes.  Every entry point has a numpy fallback, so the package works
(slower) when no compiler is available.

Set ``WAE_NO_NATIVE=1`` to disable the native library entirely.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_kernels.cpp")
_LIB_NAME = "libwae_host.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _build(lib_path: str) -> bool:
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", lib_path]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0 and os.path.exists(lib_path)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("WAE_NO_NATIVE"):
            return None
        lib_path = os.path.join(_HERE, _LIB_NAME)
        if (not os.path.exists(lib_path)
                or os.path.getmtime(lib_path) < os.path.getmtime(_SRC)):
            # build into a temp file first so concurrent processes never
            # dlopen a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
            os.close(fd)
            if not _build(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return None
            os.replace(tmp, lib_path)
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.wae_rcm.argtypes = [i64, p_i64, p_i64, p_i64]
        lib.wae_rcm.restype = None
        lib.wae_coo_dedup.argtypes = [i64, p_i64, p_i64, p_f64, i64]
        lib.wae_coo_dedup.restype = i64
        lib.wae_csr_spmm.argtypes = [i64, i64, p_i64, p_i64, p_f64, p_f64,
                                     p_f64, i64]
        lib.wae_csr_spmm.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is (or can be) loaded."""
    return _load() is not None


def rcm(indptr: np.ndarray, indices: np.ndarray):
    """Native reverse Cuthill–McKee; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(indptr) - 1
    perm = np.empty(n, dtype=np.int64)
    lib.wae_rcm(n, np.ascontiguousarray(indptr, np.int64),
                np.ascontiguousarray(indices, np.int64), perm)
    return perm


def coo_dedup(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              n_cols: int = 0):
    """Native COO sort+dedup (duplicates summed, exact zeros dropped);
    None when the library is unavailable.  ``n_cols`` > 0 enables the
    packed-key parallel sort (requires n_rows·n_cols < 2⁶³)."""
    lib = _load()
    if lib is None:
        return None
    rows = np.array(rows, np.int64, copy=True, order="C")
    cols = np.array(cols, np.int64, copy=True, order="C")
    vals = np.array(vals, np.complex128, copy=True, order="C")
    if n_cols and rows.size and int(rows.max()) >= (1 << 62) // max(n_cols, 1):
        n_cols = 0
    m = lib.wae_coo_dedup(len(rows), rows, cols,
                          vals.view(np.float64), n_cols)
    return rows[:m], cols[:m], vals[:m]


def csr_spmm(indptr, indices, data, X, n_threads: int = 0):
    """Native multithreaded complex CSR @ panel; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(indptr) - 1
    X = np.ascontiguousarray(X, np.complex128)
    k = X.shape[1] if X.ndim == 2 else 1
    Y = np.empty((n, k), dtype=np.complex128)
    lib.wae_csr_spmm(n, k, np.ascontiguousarray(indptr, np.int64),
                     np.ascontiguousarray(indices, np.int64),
                     np.ascontiguousarray(data, np.complex128).view(np.float64),
                     X.reshape(n, k).view(np.float64),
                     Y.view(np.float64), n_threads)
    return Y if X.ndim == 2 else Y[:, 0]


__all__ = ["available", "rcm", "coo_dedup", "csr_spmm"]

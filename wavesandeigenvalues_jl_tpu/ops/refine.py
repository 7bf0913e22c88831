"""Mixed-precision iterative refinement.

Where a device solve runs in single precision (complex64), classical
iterative refinement recovers reference (complex128) accuracy: the residual is evaluated in
full precision on host, only the *correction* solve runs at device
precision.  Converges to f64-level backward error in 2–4 sweeps whenever
κ(A)·ε_f32 < 1 — the regime the block-Jacobi-preconditioned GMRES and the
batched dense LU device paths operate in.

    x₀ = solve32(b);  repeat: r = b − A x (f64);  x += solve32(r)
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np

from ..utils.config import CDTYPE, DEVICE_CDTYPE
from .sparse import CSR


def refine(A: Union[CSR, np.ndarray], b: np.ndarray,
           solve_lowprec: Callable[[np.ndarray], np.ndarray],
           iters: int = 4, tol: float = 1e-13):
    """Iteratively refine ``solve_lowprec`` (any f32/c64 solver: device LU,
    GMRES) to complex128 accuracy.

    Returns (x, relres_history)."""
    b = np.asarray(b, dtype=CDTYPE)
    matvec = (lambda v: A @ v) if not isinstance(A, np.ndarray) \
        else (lambda v: A.dot(v))
    bnorm = np.linalg.norm(b)
    bnorm = bnorm if bnorm else 1.0

    x = np.asarray(solve_lowprec(b.astype(DEVICE_CDTYPE)), dtype=CDTYPE)
    hist = []
    for _ in range(iters):
        r = b - matvec(x)
        relres = np.linalg.norm(r) / bnorm
        hist.append(relres)
        if relres < tol:
            break
        dx = np.asarray(solve_lowprec(r.astype(DEVICE_CDTYPE)), dtype=CDTYPE)
        x = x + dx
    hist.append(np.linalg.norm(b - matvec(x)) / bnorm)
    return x, np.asarray(hist)


__all__ = ["refine"]

"""Global configuration for the waves/eigenvalues framework.

The framework runs in two numeric regimes:

* **reference precision** (complex128) — used for all correctness-critical
  orchestration (NLEVP outer iterations, perturbation recurrences, Padé
  algebra) and by the device solvers, since the GPU computes float64 and
  complex128 natively.
* **low precision** (complex64 / float32 planes) — the inner Krylov and
  block solves of the fused local solvers, lifted to full accuracy by
  mixed-precision iterative refinement (see :mod:`..ops.refine`).

Reference behaviour being reproduced: WavesAndEigenvalues.jl works in
``ComplexF64`` throughout (e.g. /root/reference/src/NLEVP/LinOpFam.jl:133).
"""
from __future__ import annotations

import os

import jax

# Enable x64 so the CPU path matches the reference's ComplexF64 semantics.
jax.config.update("jax_enable_x64", True)
# A float32 matmul on the GPU may run in TF32 (about three decimal digits),
# which destroys Gram-Schmidt orthogonality inside GMRES (relres stalls
# ~1) and the accuracy of every coefficient contraction.  This is a
# numerics framework: full f32 matmul precision everywhere (kernels that
# want a lower precision opt in explicitly).
jax.config.update("jax_default_matmul_precision", "highest")

#: compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not
#: set: one fixed path inside the checkout (listed in .gitignore), so every
#: process run from this checkout finds what an earlier one compiled
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir():
    """Directory this process should configure as the persistent
    compilation cache, or None when JAX reads it from
    ``JAX_COMPILATION_CACHE_DIR`` itself or caching is off
    (``WAE_COMPILE_CACHE=0``)."""
    if os.environ.get("WAE_COMPILE_CACHE", "1") == "0":
        return None
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return COMPILE_CACHE_DIR


# Persistent compilation cache: the slab/panel programs take seconds to
# compile and every fresh process (tests, bench, smoke runs) re-pays it
# otherwise.
if compile_cache_dir() is not None:
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import numpy as np  # noqa: E402

#: dtype used by the orchestration layer (matches the reference).
CDTYPE = np.complex128
#: real counterpart.
RDTYPE = np.float64

#: low-precision dtype of the inner solves that iterative refinement lifts.
DEVICE_CDTYPE = np.complex64

#: index dtype for sparse structures.
IDTYPE = np.int32


def default_backend() -> str:
    """The JAX backend currently in use ('cpu', 'gpu')."""
    return jax.default_backend()


def device_complex_dtype():
    """Complex dtype of the device solve paths: complex128, which the GPU
    and the CPU both compute natively."""
    return CDTYPE


#: perturbation order for which multi-index tables are pre-generated
#: (reference: deps/build.jl:4-11, env JULIA_WAE_PERT_ORDER, default 16).
PERT_ORDER = int(os.environ.get("WAE_PERT_ORDER", "16"))


# ---------------------------------------------------------------------------
# shifted-solve backend (the reference's UMFPACK role):
#   'host'         scipy SuperLU / LAPACK on CPU
#   'device'       XLA dense LU below DEVICE_DENSE_MAX_DIM, GMRES above
#   'device_lu' / 'device_gmres'   force one device path

_SOLVE_BACKENDS = ("host", "device", "device_lu", "device_gmres")
_solve_backend = os.environ.get("WAE_SOLVE_BACKEND", "host")


def solve_backend() -> str:
    """Current default backend for :func:`..ops.linsolve.factorize`."""
    return _solve_backend


def set_solve_backend(backend: str) -> str:
    """Set the default shifted-solve backend; returns the previous value
    (so callers can restore it)."""
    global _solve_backend
    if backend not in _SOLVE_BACKENDS:
        raise ValueError(f"unknown solve backend {backend!r}; "
                         f"one of {_SOLVE_BACKENDS}")
    prev = _solve_backend
    _solve_backend = backend
    return prev

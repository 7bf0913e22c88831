"""Fused-device local NLEVP solver — one device program per Newton step.

The reference's local solvers run ARPACK shift-invert Arnoldi over UMFPACK
factorizations at every outer iteration (Householder.jl:70-192,
iterative_solvers.jl:93-252).  A 1:1 translation of that host-driven loop
makes O(10-50) device dispatches per Newton step.  This engine fuses the
step instead (the step itself is :class:`.fused_slab.FusedSlabPencilSolver`):

* **Host does scalars, device does vectors.**  Per Newton step the host
  evaluates the family's coefficient vectors c(z), ∂_z c(z) exactly in
  complex128 (K ≈ 10 numbers) and enqueues ONE fused program: assembly,
  one block-Thomas factorization, σ-regularized inverse iteration with
  f64-refined block-Thomas re-solves, and the two-sided Rayleigh
  quotients λ, λ′ in float64 (re, im) pairs.
* **σ-regularization**: the inner solves use (A+σM), whose pencil
  spectrum is λ_j+σ, so κ stays bounded even at the Newton fixed point
  where A itself is singular.  The Rayleigh quotients use the PURE A, so
  λ and dz are σ-independent.
* Eigenvector carries stay device-resident between steps (f32 planes).

Accuracy model: the two-sided Rayleigh quotient is quadratically accurate
in the vector errors, so the device loop lands inside the Newton basin;
one to three complex128 host polish steps supply the last digits
(BASELINE.md active Rijke ω).
"""
from __future__ import annotations

import numpy as np

from ..utils.config import CDTYPE
from .family import OperatorFamily, Solution
from .fused_slab import FusedSlabPencilSolver, _planes32


def try_fused_local(L: OperatorFamily, z, *, maxiter, tol, relax, lam_tol,
                    v0, v0_adj, output, scale):
    """Fused-device engine for the mslp/householder order-1 iteration.

    Returns (Solution, n_iters, flag).  Semantics mirror
    ``solvers._local_engine`` for nev=1, order=1 (Newton update
    dz = −λ/λ′, which is both the householder order-1 update and the
    [1/0]-Padé root).  Errors on the device path propagate; a non-finite
    device update ends the device loop and, unless the host polish
    recovers a converged iterate, is reported as ``ITSOL_ISNAN``."""
    import jax

    from .solvers import (ITSOL_CONVERGED, ITSOL_IMPOSSIBLE, ITSOL_ISNAN,
                          ITSOL_MAXITER, ITSOL_SLOW_CONVERGENCE)

    stack = L._stack()
    cached = getattr(L, "_fused_solver", None)
    if cached is not None and cached[0] is stack:
        solver = cached[1]
    else:
        solver = FusedSlabPencilSolver(L)
        L._fused_solver = (stack, solver)

    z = complex(z) * scale
    tol_s = tol * abs(scale) if scale != 1 else tol
    d = L.size
    if v0 is None or len(v0) == 0:
        v0 = np.ones(d, dtype=CDTYPE)
    if v0_adj is None or len(v0_adj) == 0:
        v0_adj = np.conj(np.asarray(v0))
    v0 = np.asarray(v0, CDTYPE)
    v0_adj = np.asarray(v0_adj, CDTYPE)
    vr, vi = _planes32(v0)
    wr, wi = _planes32(v0_adj)
    carries = tuple(jax.device_put(p) for p in (vr, vi, wr, wi))

    saved_active, saved_mode = list(L.active), L.mode
    eig, aux = L.eigval, L.auxval
    z0 = complex(np.inf)
    lam = complex(np.inf)
    n_it = 0
    flag = ITSOL_CONVERGED
    best_dz, n_stall = np.inf, 0
    nan_dz = False
    #: device-backend attainable |dz| floor, tied to the requested tol
    floor = lambda zz: max(tol_s, 1e-12 * max(abs(zz), 1.0))
    if output:
        print("Launching fused-device mslp solver...")
        print("Iter    Res:         dz:          z:")

    sigma = 0.0 + 0.0j
    # the device loop only needs to land inside the Newton basin — the
    # complex128 host polish below supplies the last digits at one host
    # iteration's cost, so chasing tol on device (RQ f64-cancellation
    # floor ~5e-9·|z|) would waste 3-6 extra device steps
    dev_tol = max(tol_s, 1e-5 * max(abs(z), 1.0))
    try:
        while abs(z - z0) > dev_tol and n_it < maxiter:
            if output:
                print(f"{n_it}\t{abs(lam):.3e}\t{abs(z - z0):.3e}\t{z / scale}")
            dz, lam, carries, _res = solver.step(z, carries, sigma)
            if not np.isfinite(dz):
                nan_dz = True
                break
            if n_it == 0:
                # gap-scale regularization: λ(z₀) is O(|z₀−z*|·λ′), a
                # proxy for the pencil's eigenvalue spacing.  σ keeps
                # (A+σM) nonsingular at the Newton fixed point; λ itself
                # is σ-independent (see module docstring).
                sigma = 0.1 * abs(lam)
            z0 = z
            z = z + relax * dz
            n_it += 1
            adz = abs(relax * dz)
            if np.isfinite(adz) and adz < best_dz:
                best_dz, n_stall = adz, 0
            else:
                n_stall += 1
                if n_stall >= 3 and best_dz <= floor(z):
                    if output:
                        print("dz stagnated at attainable accuracy — "
                              "stopping.")
                    z0 = z
                    break
    finally:
        L.active, L.mode = saved_active, saved_mode

    v, v_adj = solver.fetch_vectors(carries)

    # ---- host complex128 polish steps -----------------------------------
    # The device loop lands inside the Newton basin (dev_tol above); the
    # f64 Rayleigh-quotient numerator wᴴAv cancels ~8 digits against the
    # operator's 1e15-penalty scale, so the last digits come from 1-2
    # warm-started host Newton steps (sparse LU + shift-invert — exactly
    # the reference's per-iteration machinery) at ~1/7 of the full host
    # solve cost each.
    polished = False
    try:
        from ..ops.linsolve import factorize
        from .eigs import eigs_shift_invert
        for _ in range(3):
            if n_it >= maxiter:
                break
            L.params[eig] = z
            L.params[aux] = 0.0
            A = L(z)
            M = L.aux_weight()
            F = factorize(A, check=True, backend="host")
            lam_arr, V = eigs_shift_invert(A, M, nev=1, v0=v, m=8,
                                           factor=F)
            lam_adj, W = eigs_shift_invert(A, M, nev=1, v0=v_adj, m=8,
                                           factor=F, adjoint=True)
            lam_p = complex(lam_arr[0])
            vh = V[:, 0]
            wh = W[:, 0]
            A1 = L(z, 1)
            den = np.vdot(wh, M @ vh)
            lam_d = np.vdot(wh, A1 @ vh) / den
            dz = -lam_p / lam_d
            if not (np.isfinite(dz) and abs(dz) < 1e-2 * max(abs(z), 1.0)):
                break
            z0 = z
            z = z + dz
            v, v_adj = vh, wh
            lam = lam_p
            n_it += 1
            if abs(dz) <= tol_s:
                polished = True
                break
    except np.linalg.LinAlgError:
        pass                       # singular shift: keep the device result

    L.params[eig] = z
    L.params[aux] = lam
    if nan_dz and not polished:
        flag = ITSOL_ISNAN
    elif n_it >= maxiter:
        flag = ITSOL_MAXITER
    elif abs(lam) <= lam_tol:
        flag = ITSOL_CONVERGED
    elif abs(z - z0) <= tol_s:
        flag = ITSOL_SLOW_CONVERGENCE
    elif np.isnan(z):
        flag = ITSOL_ISNAN
    else:
        # device loop exited at dev_tol but the host polish never reached
        # the requested tol — mirror _local_engine's tail instead of
        # returning the initial ITSOL_CONVERGED for an unpolished iterate
        flag = ITSOL_IMPOSSIBLE
    if output:
        print(f"{n_it}\t{abs(lam):.3e}\t{abs(z - z0):.3e}\t{z / scale}")
        print(f"Eigenvalue: {z / scale}  ({z / scale / 2 / np.pi} /2π)")
    L.active, L.mode = saved_active, saved_mode
    # reference normalization (Householder.jl:189-190)
    M = L.aux_weight()
    with np.errstate(all="ignore"):
        nmv = np.sqrt(v.conj() @ (M @ v))
        if nmv != 0 and np.isfinite(nmv):
            v = v / nmv
        L1v = L(L.params[eig], 1) @ v
        cnorm = np.conj(v_adj.conj() @ L1v)
        if cnorm != 0 and np.isfinite(cnorm):
            v_adj = v_adj / cnorm
    return Solution(L.params, v, v_adj, eig), n_it, flag


__all__ = ["try_fused_local"]

"""Nonlinear-eigenvalue solvers.

Local iterations (householder / padesolve / mslp / inveriter / lancaster /
traceiter / rf2s / nicoud / picard) and the global Beyn contour solver plus
the hybrid global-local ``solve`` driver.  Reference implementations:
/root/reference/src/NLEVP/{Householder.jl,iterative_solvers.jl,beyn.jl,
nicoud.jl,picard.jl,solver.jl}.

All ARPACK/UMFPACK calls of the reference are replaced by the framework's
own shift-invert Arnoldi (:mod:`.eigs`) over XLA dense LU solves
(:mod:`..ops.linsolve`); the Beyn quadrature is expressed as a batch of
independent shifted solves — the axis that is sharded across devices in
:mod:`..parallel.dist_beyn`.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..ops.linsolve import SingularMatrixError, factorize
from ..utils.config import CDTYPE
from .eigs import eigs_pencil_pair, eigs_shift_invert
from .family import OperatorFamily, Solution
from .pade import pade, poly_roots, polyval
from .perturbation import perturb

# ---------------------------------------------------------------------------
# status flags (iterative_solvers.jl:4-14)
ITSOL_CONVERGED = 0
ITSOL_MAXITER = 1
ITSOL_SLOW_CONVERGENCE = 2
ITSOL_IMPOSSIBLE = -1
ITSOL_SINGULAR_EXCEPTION = -2
ITSOL_EIGS_EXCEPTION = -3
ITSOL_ISNAN = -4
ITSOL_UNKNOWN = -5

_FLAG_MSG = {
    ITSOL_CONVERGED: "Solution converged, everything OK!",
    ITSOL_MAXITER: "Warning: Maximum number of iterations has been reached!",
    ITSOL_SLOW_CONVERGENCE: "Warning: Slow progress!",
    ITSOL_IMPOSSIBLE: "Error: This error should be impossible. Please contact the developers!",
    ITSOL_SINGULAR_EXCEPTION: "Error: Singular matrix (iterate may be fully converged)!",
    ITSOL_EIGS_EXCEPTION: "Error: inner eigensolver failed!",
    ITSOL_ISNAN: "Error: eigenvalue is NaN!",
    ITSOL_UNKNOWN: "Error: Unknown error occurred!",
}


def decode_error_flag(flag: int) -> str:
    """Human-readable meaning of a solver status flag (fixed re-write of the
    reference's buggy decode_error_flag, iterative_solvers.jl:22-44)."""
    return _FLAG_MSG.get(flag, "Unknown flag code.")


def householder_update(f) -> complex:
    """Closed-form Householder update of order len(f)-1 (max 5) from
    derivative values f = [λ, λ', λ'', ...] (Householder.jl:21-35)."""
    order = len(f) - 1
    if order == 1:
        return -f[0] / f[1]
    if order == 2:
        return -f[0] * f[1] / (f[1] ** 2 - 0.5 * f[0] * f[2])
    if order == 3:
        return (-(6 * f[0] * f[1] ** 2 - 3 * f[0] ** 2 * f[2])
                / (6 * f[1] ** 3 - 6 * f[0] * f[1] * f[2] + f[0] ** 2 * f[3]))
    if order == 4:
        return (-(4 * f[0] * (6 * f[1] ** 3 - 6 * f[0] * f[1] * f[2] + f[0] ** 2 * f[3]))
                / (24 * f[1] ** 4 - 36 * f[0] * f[1] ** 2 * f[2] + 6 * f[0] ** 2 * f[2] ** 2
                   + 8 * f[0] ** 2 * f[1] * f[3] - f[0] ** 3 * f[4]))
    return ((5 * f[0] * (24 * f[1] ** 4 - 36 * f[0] * f[1] ** 2 * f[2]
                         + 6 * f[0] ** 2 * f[2] ** 2 + 8 * f[0] ** 2 * f[1] * f[3]
                         - f[0] ** 3 * f[4]))
            / (-120 * f[1] ** 5 + 240 * f[0] * f[1] ** 3 * f[2]
               - 60 * f[0] ** 2 * f[1] ** 2 * f[3]
               + 10 * f[0] ** 2 * f[1] * (-9 * f[2] ** 2 + f[0] * f[4])
               + f[0] ** 3 * (20 * f[2] * f[3] - f[0] * f[5])))


# ---------------------------------------------------------------------------
# shared local-iteration engine (householder / padesolve / mslp skeleton,
# Householder.jl:70-192, iterative_solvers.jl:93-252)


def _local_engine(L: OperatorFamily, z, *, maxiter, tol, relax, lam_tol,
                  order, nev, v0, v0_adj, output, update, num_order, scale):
    # Fused-device path: for the order-1/nev-1 iteration (mslp default and
    # householder order 1 — both reduce to the Newton update dz = -λ/λ′)
    # on the device backend, the whole step runs as ONE device program
    # instead of O(m) dispatches.
    from ..utils.config import solve_backend
    if (nev == 1 and order == 1 and num_order <= 1
            and update in ("householder", "pade")
            and solve_backend().startswith("device")):
        from .fused_local import try_fused_local
        return try_fused_local(L, z, maxiter=maxiter, tol=tol, relax=relax,
                               lam_tol=lam_tol, v0=v0, v0_adj=v0_adj,
                               output=output, scale=scale)
    z = complex(z) * scale
    tol = tol * abs(scale) if scale != 1 else tol
    saved_active, saved_mode = list(L.active), L.mode
    d = L.size
    if v0 is None or len(v0) == 0:
        v0 = np.ones(d, dtype=CDTYPE)
    v0 = np.asarray(v0, dtype=CDTYPE).copy()
    if v0_adj is None or len(v0_adj) == 0:
        v0_adj = np.conj(v0)
    v0_adj = np.asarray(v0_adj, dtype=CDTYPE).copy()

    L.ensure_aux()
    M = L.aux_weight()
    eig, aux = L.eigval, L.auxval

    z0 = complex(np.inf)
    lam = complex(np.inf)
    lam0 = complex(np.inf)
    n = 0
    flag = ITSOL_CONVERGED
    best_dz, n_stall = np.inf, 0
    if output:
        print(f"Launching {update} solver...")
        print("Iter    Res:         dz:          z:")

    try:
        while abs(z - z0) > tol and n < maxiter:
            if output:
                print(f"{n}\t{abs(lam):.3e}\t{abs(z - z0):.3e}\t{z / scale}")
            z_prev = z
            L.params[eig] = z
            L.params[aux] = 0.0
            A = L(z)
            lam_arr, V, lam_adj_arr, Vadj = eigs_pencil_pair(
                A, M, nev=nev, v0=v0, v0_adj=v0_adj)
            delta_z: List[complex] = []
            back_delta: List[complex] = []
            L.active = [aux, eig]
            for i in range(len(lam_arr)):
                L.params[aux] = lam_arr[i]
                s = Solution(L.params, V[:, i], Vadj[:, i], aux)
                perturb(s, L, eig, order, mode="householder",
                        normalize_series=False)
                coeffs = s.eigval_pert[f"{eig}/Taylor"]
                if update == "householder":
                    f = [math.factorial(j) * c for j, c in enumerate(coeffs)]
                    dz = householder_update(f)
                    delta_z.append(dz)
                else:
                    num, den = pade(coeffs, num_order, order - num_order)
                    roots = poly_roots(num)
                    if len(roots) == 0:
                        dz = complex("nan")
                    else:
                        dz = roots[np.argmin(np.abs(roots))]
                    delta_z.append(dz)
                    if np.isfinite(z0):
                        # backward continuity check (iterative_solvers.jl:166-174)
                        back_lam = polyval(num, z0 - z) / polyval(den, z0 - z)
                        back_delta.append(lam0 - back_lam)
            L.active = [eig]
            if update != "householder" and np.isfinite(z0):
                pick = int(np.argmin(np.abs(np.asarray(back_delta))))
            else:
                pick = int(np.argmin(np.abs(np.asarray(delta_z))))
            lam = lam_arr[pick]
            L.params[aux] = lam
            z0 = z_prev
            lam0 = lam
            z = z + relax * delta_z[pick]
            v0 = (1 - relax) * v0 + relax * V[:, pick]
            v0_adj = (1 - relax) * v0_adj + relax * Vadj[:, pick]
            n += 1
            # attainable-accuracy stall: once |dz| is tiny relative to z
            # and stops improving (precision noise floor bounces below
            # the requested tol), accept instead of spinning to maxiter.
            # The floor is tied to the requested tol and the backend's
            # attainable accuracy (ADVICE r3 #2 — a fixed 1e-6 could
            # report ~6 correct digits as converged when the caller
            # asked for 12): complex128 host ~1e-13·|z|, f32-refined
            # device ~1e-9·|z|.
            from ..utils.config import solve_backend as _sb
            eps_backend = 1e-9 if _sb().startswith("device") else 1e-13
            stall_floor = max(tol, eps_backend * max(abs(z), 1.0))
            adz = abs(relax * delta_z[pick])
            if np.isfinite(adz) and adz < best_dz:
                best_dz, n_stall = adz, 0
            else:
                n_stall += 1
                if n_stall >= 3 and best_dz <= stall_floor:
                    if output:
                        print("dz stagnated at attainable accuracy — "
                              "stopping.")
                    z0 = z  # converged-at-floor: |z-z0| = 0 <= tol
                    break
    except SingularMatrixError:
        flag = ITSOL_SINGULAR_EXCEPTION
        L.params[eig] = z
        if output:
            print("Singular matrix: iterate may already be converged.")
    except np.linalg.LinAlgError as e:
        flag = ITSOL_EIGS_EXCEPTION
        if output:
            print(f"Inner eigensolver failed: {e}")

    if flag == ITSOL_CONVERGED:
        L.params[eig] = z
        if output:
            print(f"{n}\t{abs(lam):.3e}\t{abs(z - z0):.3e}\t{z / scale}")
        if n >= maxiter:
            flag = ITSOL_MAXITER
        elif abs(lam) <= lam_tol:
            flag = ITSOL_CONVERGED
        elif abs(z - z0) <= tol:
            flag = ITSOL_SLOW_CONVERGENCE
        elif np.isnan(z):
            flag = ITSOL_ISNAN
        else:
            flag = ITSOL_IMPOSSIBLE
        if output:
            print(decode_error_flag(flag))
            print(f"Eigenvalue: {z / scale}  ({z / scale / 2 / np.pi} /2π)")

    L.active, L.mode = saved_active, saved_mode
    # normalization (Householder.jl:189-190)
    with np.errstate(all="ignore"):
        nmv = np.sqrt(v0.conj() @ (M @ v0))
        if nmv != 0 and np.isfinite(nmv):
            v0 = v0 / nmv
        L1v = L(L.params[eig], 1) @ v0
        c = np.conj(v0_adj.conj() @ L1v)
        if c != 0 and np.isfinite(c):
            v0_adj = v0_adj / c
    return Solution(L.params, v0, v0_adj, eig), n, flag


def householder(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
                lam_tol=np.inf, order=1, nev=1, v0=None, v0_adj=None,
                output=False):
    """Generalized Rayleigh-quotient / Householder iteration
    (Householder.jl:70-192)."""
    return _local_engine(L, z, maxiter=maxiter, tol=tol, relax=relax,
                         lam_tol=lam_tol, order=order, nev=nev, v0=v0,
                         v0_adj=v0_adj, output=output, update="householder",
                         num_order=1, scale=1)


def padesolve(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
              lam_tol=np.inf, order=1, nev=1, v0=None, v0_adj=None,
              num_order=1, output=False):
    """Padé-accelerated Householder variant (Householder.jl:205-355)."""
    return _local_engine(L, z, maxiter=maxiter, tol=tol, relax=relax,
                         lam_tol=lam_tol, order=order, nev=nev, v0=v0,
                         v0_adj=v0_adj, output=output, update="pade",
                         num_order=num_order, scale=1)


def mslp(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
         lam_tol=np.inf, order=1, nev=1, v0=None, v0_adj=None, num_order=1,
         scale=1, output=False):
    """Method of successive linear problems (iterative_solvers.jl:93-252)."""
    return _local_engine(L, z, maxiter=maxiter, tol=tol, relax=relax,
                         lam_tol=lam_tol, order=order, nev=nev, v0=v0,
                         v0_adj=v0_adj, output=output, update="pade",
                         num_order=num_order, scale=scale)


# ---------------------------------------------------------------------------
# classic iterations (iterative_solvers.jl:285-614)


def _classify(z, z0, n, maxiter, tol, output):
    if n >= maxiter:
        return ITSOL_MAXITER
    if abs(z - z0) <= tol:
        return ITSOL_CONVERGED
    if np.isnan(z):
        return ITSOL_ISNAN
    return ITSOL_IMPOSSIBLE


def inveriter(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0, x0=None,
              v=None, output=False):
    """Newton inverse iteration (Algorithm 1 in Mehrmann & Voss 2004;
    iterative_solvers.jl:285-347)."""
    d = L.size
    x0 = np.ones(d, dtype=CDTYPE) if x0 is None else np.asarray(x0, CDTYPE).copy()
    v = np.ones(d, dtype=CDTYPE) if v is None else np.asarray(v, CDTYPE)
    x0 = x0 / (v.conj() @ x0)
    z = complex(z)
    z0 = complex(np.inf)
    n = 0
    flag = ITSOL_CONVERGED
    try:
        while abs(z - z0) > tol and n < maxiter:
            if output:
                print(f"{n}\t{abs(z - z0):.3e}\t{z}")
            z0 = z
            F = factorize(L(z, 0), check=True)
            u = F.solve(L(z, 1) @ x0)
            z = z0 - (v.conj() @ x0) / (v.conj() @ u)
            x0 = u / (v.conj() @ u)
            n += 1
    except (SingularMatrixError, np.linalg.LinAlgError):
        flag = ITSOL_UNKNOWN
    if flag == ITSOL_CONVERGED:
        flag = _classify(z, z0, n, maxiter, tol, output)
        L.params[L.eigval] = z
    return Solution(L.params, x0, None, L.eigval, L.auxval), n, flag


def lancaster(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0, x0=None,
              y0=None, output=False):
    """Lancaster's generalized Rayleigh-quotient iteration
    (iterative_solvers.jl:378-434)."""
    d = L.size
    x0 = np.ones(d, dtype=CDTYPE) if x0 is None else np.asarray(x0, CDTYPE)
    y0 = np.ones(d, dtype=CDTYPE) if y0 is None else np.asarray(y0, CDTYPE)
    z = complex(z)
    z0 = complex(np.inf)
    n = 0
    flag = ITSOL_CONVERGED
    try:
        while abs(z - z0) > tol and n < maxiter:
            if output:
                print(f"{n}\t{abs(z - z0):.3e}\t{z}")
            z0 = z
            F = factorize(L(z), check=True)
            xi = F.solve(x0)
            eta = F.solve(y0, trans="H")
            L1 = L(z, 1)
            z = z0 - (eta.conj() @ (L(z0, 0) @ xi)) / (eta.conj() @ (L1 @ xi))
            n += 1
    except (SingularMatrixError, np.linalg.LinAlgError):
        flag = ITSOL_UNKNOWN
    if flag == ITSOL_CONVERGED:
        flag = _classify(z, z0, n, maxiter, tol, output)
        L.params[L.eigval] = z
    return Solution(L.params, np.zeros(d, dtype=CDTYPE), None, L.eigval), n, flag


def mehrmann(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0, x0=None,
             v=None, output=False):
    """Mehrmann–Voss nonlinear inverse iteration with a left eigenvector at
    convergence.

    The reference ships this solver in mehrmann.jl:1-72 but never includes
    the file (NLEVP.jl:17 comments the include out), leaving its hybrid
    ``solve`` with a dangling call; the iteration body is identical to
    ``inveriter`` (iterative_solvers.jl:285-347).  This is a *working*
    implementation: the same Newton inverse iteration, plus the adjoint
    eigenvector (one shift-invert solve on L(z)ᴴ, the step that is only a
    comment in mehrmann.jl:57-60) so the result can seed the moment
    corrections in :func:`solve`."""
    sol, n, flag = inveriter(L, z, maxiter=maxiter, tol=tol, relax=relax,
                             x0=x0, v=v, output=output)
    if flag >= 0 and sol.v is not None:
        z = sol.params[sol.eigval]
        try:
            F = factorize(L(z, 0), check=True)
            y = np.asarray(sol.v, CDTYPE).conj()
            for _ in range(2):
                y = F.solve(y, trans="H")
                y = y / np.linalg.norm(y)
            sol.v_adj = y
        except (SingularMatrixError, np.linalg.LinAlgError):
            pass  # singular at an exact eigenvalue: keep right vector only
    return sol, n, flag


def juniper(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
            output=False):
    """Newton on det L via the trace formula — the reference's dead
    ``juniper`` variant (mehrmann.jl:136-187, excluded at NLEVP.jl:17) is
    algorithmically :func:`traceiter`; provided as a working alias."""
    return traceiter(L, z, maxiter=maxiter, tol=tol, relax=relax,
                     output=output)


def guettel(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0, x0=None,
            y0=None, output=False):
    """Two-sided Rayleigh-functional iteration — the reference's dead
    ``guettel`` variant (mehrmann.jl:192-258, excluded at NLEVP.jl:17) is
    algorithmically :func:`rf2s`; provided as a working alias."""
    return rf2s(L, z, maxiter=maxiter, tol=tol, relax=relax, x0=x0, y0=y0,
                output=output)


def traceiter(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
              output=False):
    """Newton on det L(z) via Jacobi's trace formula
    (iterative_solvers.jl:463-517)."""
    z = complex(z)
    z0 = complex(np.inf)
    n = 0
    flag = ITSOL_CONVERGED
    try:
        while abs(z - z0) > tol and n < maxiter:
            if output:
                print(f"{n}\t{abs(z - z0):.3e}\t{z}")
            z0 = z
            F = factorize(L(z), check=True)
            L1 = L(z, 1).to_dense()
            tr = np.trace(F.solve(L1))
            z = z0 + relax * (-1.0 / tr)
            n += 1
    except (SingularMatrixError, np.linalg.LinAlgError):
        flag = ITSOL_UNKNOWN
    if flag == ITSOL_CONVERGED:
        flag = _classify(z, z0, n, maxiter, tol, output)
        L.params[L.eigval] = z
    return Solution(L.params, None, None, L.eigval), n, flag


def rf2s(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0, x0=None,
         y0=None, output=False):
    """Two-sided Rayleigh-functional iteration, cubic convergence
    (Algorithm 4.9 of Güttel & Tisseur; iterative_solvers.jl:548-614)."""
    d = L.size
    if x0 is None:
        x0 = np.zeros(d, dtype=CDTYPE)
        x0[0] = 1.0
    if y0 is None:
        y0 = np.zeros(d, dtype=CDTYPE)
        y0[0] = 1.0
    x0 = np.asarray(x0, CDTYPE) / np.sqrt(np.asarray(x0, CDTYPE).conj() @ x0)
    y0 = np.asarray(y0, CDTYPE) / np.sqrt(np.asarray(y0, CDTYPE).conj() @ y0)
    z = complex(z)
    z0 = complex(np.inf)
    n = 0
    flag = ITSOL_CONVERGED
    try:
        while abs(z - z0) > tol and n < maxiter:
            if output:
                print(f"{n}\t{abs(z - z0):.3e}\t{z}")
            z0 = z
            F = factorize(L(z), check=True)
            L1 = L(z, 1)
            x0 = F.solve(L1 @ x0)
            y0 = F.solve(L1.conj_transpose() @ y0, trans="H")
            x0 = x0 / np.sqrt(x0.conj() @ x0)
            y0 = y0 / np.sqrt(y0.conj() @ y0)
            idx = 0
            z00 = complex(np.inf)
            while abs(z - z00) > tol and idx < 10:
                z00 = z
                z = z - (y0.conj() @ (L(z) @ x0)) / (y0.conj() @ (L(z, 1) @ x0))
                idx += 1
            n += 1
    except (SingularMatrixError, np.linalg.LinAlgError):
        flag = ITSOL_UNKNOWN
    if flag == ITSOL_CONVERGED:
        flag = _classify(z, z0, n, maxiter, tol, output)
        L.params[L.eigval] = z
    return Solution(L.params, x0, y0, L.eigval), n, flag


def nicoud(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
           n_eig_val=3, v0=None, output=False):
    """Fixed-point iteration on the companion linearization
    [0 -I; K+Q(ω₀)  C] x = -ω [I 0; 0 M] x (nicoud.jl:1-85).

    Legacy method: densifies the 2d×2d companion pencil — O(d²) memory —
    appropriate only for the small-model regime it historically served."""
    M = L(1, oplist=["M"], in_or_ex=True).to_dense()
    K = L(1, oplist=["K"], in_or_ex=True).to_dense()
    C = L(1, oplist=["C"], in_or_ex=True).to_dense()
    d = M.shape[0]
    I = np.eye(d, dtype=CDTYPE)
    O = np.zeros((d, d), dtype=CDTYPE)
    Y = np.block([[I, O], [O, M]])
    if v0 is None:
        v0 = np.ones(d, dtype=CDTYPE)
    z = complex(z)
    v0 = np.concatenate([v0, z * v0])
    z0 = complex(np.inf)
    n = 0
    flag = ITSOL_CONVERGED
    try:
        while abs(z - z0) > tol and n < maxiter:
            if output:
                print(f"{n}\t{abs(z - z0):.3e}\t{z}")
            z0 = z
            Q = L(z, oplist=["Q"], in_or_ex=True).to_dense()
            X = np.block([[O, -I], [K + Q, C]])
            lam, V = eigs_shift_invert(-X, Y, nev=n_eig_val, sigma=z0, v0=v0)
            idx = int(np.argmin(np.abs(lam - z0)))
            z, v0 = lam[idx], V[:, idx]
            z = z0 + relax * (z - z0)
            n += 1
    except (SingularMatrixError, np.linalg.LinAlgError):
        flag = ITSOL_UNKNOWN
    if flag == ITSOL_CONVERGED:
        flag = _classify(z, z0, n, maxiter, tol, output)
        L.params[L.eigval] = z
    return Solution(L.params, v0[:d], None, L.eigval), n, flag


def picard(L: OperatorFamily, z, maxiter=10, tol=0.0, relax=1.0,
           n_eig_val=3, v0=None, output=False):
    """ω²-fixed-point iteration: ω² = eig of (-(K+ωC+Q), M) nearest ω₀²
    (picard.jl:1-77; the shift is taken at ω₀² — the eigenvalues of the
    linearized pencil live on the ω² scale).

    Legacy method: the nonzero-shift inner eigensolve densifies the pencil
    (O(d²) memory); appropriate only for small models."""
    d = L.size
    if v0 is None:
        v0 = np.ones(d, dtype=CDTYPE)
    M = L(1, oplist=["M"], in_or_ex=True)
    z = complex(z)
    z0 = complex(np.inf)
    n = 0
    flag = ITSOL_CONVERGED
    try:
        while abs(z - z0) > tol and n < maxiter:
            if output:
                print(f"{n}\t{abs(z - z0):.3e}\t{z}")
            z0 = z
            X = L(z0, oplist=["M", "__aux__"])  # exclude mass + aux terms
            lam, V = eigs_shift_invert(X.scaled(-1.0), M, nev=n_eig_val,
                                       sigma=z0 ** 2, v0=v0)
            lam = np.sqrt(lam)
            idx = int(np.argmin(np.abs(lam - z0)))
            z, v0 = lam[idx], V[:, idx]
            z = z0 + relax * (z - z0)
            n += 1
    except (SingularMatrixError, np.linalg.LinAlgError):
        flag = ITSOL_UNKNOWN
    if flag == ITSOL_CONVERGED:
        flag = _classify(z, z0, n, maxiter, tol, output)
        L.params[L.eigval] = z
    return Solution(L.params, v0, None, L.eigval), n, flag


# ---------------------------------------------------------------------------
# Beyn contour solver (beyn.jl)


def gauss_nodes(Gamma, N: int):
    """Gauss-Legendre nodes/weights along the closed polygon ``Gamma``;
    returns flat arrays z[B], w[B] (w includes the (b-a)/2 edge scaling)
    (gauss, beyn.jl:112-138)."""
    X, W = np.polynomial.legendre.leggauss(N)
    zs, ws = [], []
    nG = len(Gamma)
    for i in range(nG):
        a, b = Gamma[i], Gamma[(i + 1) % nG]
        zs.append(X * (b - a) / 2 + (a + b) / 2)
        ws.append(W * (b - a) / 2)
    return np.concatenate(zs).astype(CDTYPE), np.concatenate(ws).astype(CDTYPE)


def initialize_V(d: int, l: int, random: bool = False, seed: int = 0):
    """Initial probe block (beyn.jl:379-392)."""
    if random:
        rng = np.random.default_rng(seed)
        V = rng.standard_normal((d, l)) + 1j * rng.standard_normal((d, l))
        V /= np.linalg.norm(V, axis=0, keepdims=True)
        return V.astype(CDTYPE)
    V = np.zeros((d, l), dtype=CDTYPE)
    for i in range(min(d, l)):
        V[i, i] = 1.0
    return V


def compute_moment_matrices(L: OperatorFamily, Gamma, V=None, l=5, K=1,
                            N=16, output=False, random=False,
                            checkpoint: Optional[str] = None,
                            checkpoint_every: int = 8):
    """Moment matrices A_p = ∮_Γ z^p L(z)^{-1} V dz, p = 0..2K-1
    (compute_moment_matrices, beyn.jl:233-268).

    The quadrature nodes are independent shifted multi-RHS solves — the
    prime batching axis (each node = one dense LU + l triangular solves).

    ``checkpoint``: optional path; the partial moment sums are persisted
    there every ``checkpoint_every`` nodes (atomic npz) and an interrupted
    contour integration resumes from the last saved node.  The reference
    has no restart story for long runs (SURVEY §5); on a big contour every
    node is a full sparse factorization, so losing hours to a preemption
    is otherwise real.  A checkpoint written for a different contour,
    probe block or K is detected by digest and ignored."""
    import hashlib
    import os

    from ..utils.timing import phase
    d = L.size
    if V is None:
        V = initialize_V(d, l, random=random)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    A = np.zeros((d, l, 2 * K), dtype=CDTYPE)
    start = 0
    digest = ""
    if checkpoint:
        h = hashlib.sha256()
        for part in (zs.tobytes(), ws.tobytes(), np.asarray(V).tobytes(),
                     str(K).encode()):
            h.update(part)
        # the moments depend on the operator itself, not only the contour:
        # fold in the family's parameter values and a term fingerprint so a
        # checkpoint written for different params (e.g. a new τ) or a
        # re-assembled operator is detected and recomputed, never resumed.
        # The eigval/auxval entries are excluded: the quadrature overwrites
        # the eigenvalue per node, so their pre-run values are irrelevant
        # (and the first run leaves eigval at the last node, which would
        # spuriously invalidate every legitimate resume).
        h.update(repr(sorted((str(k), complex(v))
                             for k, v in L.params.items()
                             if k not in (L.eigval, L.auxval))).encode())
        for t in L.terms:
            h.update(t.symbol.encode())
            h.update(str(t.params).encode())
            h.update(np.ascontiguousarray(t.coeff.data).tobytes())
        digest = h.hexdigest()
        if os.path.exists(checkpoint):
            with np.load(checkpoint, allow_pickle=False) as ck:
                if str(ck["digest"]) == digest:
                    A = ck["A"]
                    start = int(ck["next"])
                    if output:
                        print(f"resuming moments at node {start}/{len(zs)}")
                elif output:
                    print("checkpoint digest mismatch — recomputing")

    def _save(next_idx: int):
        tmp = checkpoint + ".tmp.npz"
        np.savez(tmp, A=A, next=next_idx, digest=digest)
        os.replace(tmp, checkpoint)

    with phase("beyn.moments"):
        for idx in range(start, len(zs)):
            z, w = zs[idx], ws[idx]
            X = factorize(L(z), check=True).solve(V)
            zp = w
            for p in range(2 * K):
                A[:, :, p] += zp * X
                zp = zp * z
            if checkpoint and ((idx + 1) % checkpoint_every == 0
                               or idx + 1 == len(zs)):
                _save(idx + 1)
    return A


def moments2eigs(A, tol_sigma: float = 0.0, return_sigma: bool = False,
                 rtol_sigma: float = 0.0):
    """Eigenpairs from moment matrices via block-Hankel SVD filtering
    (moments2eigs, beyn.jl:289-323).  ``A`` is one [d,l,2K] array or a list
    of them (incremental column blocks).

    ``tol_sigma`` is the reference's absolute σ cutoff;``rtol_sigma``
    additionally drops directions with σ < rtol·σmax — essential when the
    operator is badly scaled (e.g. penalty admittance Y~1e15): Σ⁻¹ amplifies
    those pure-noise directions by σmax/σ ≳ 1/ε otherwise."""
    if isinstance(A, np.ndarray):
        A = [A]
    d = A[0].shape[0]
    dl = A[0].shape[1]
    l = len(A) * dl
    K = A[0].shape[2] // 2
    B0 = np.zeros((d * K, l * K), dtype=CDTYPE)
    B1 = np.zeros((d * K, l * K), dtype=CDTYPE)
    for i in range(K):
        for j in range(K):
            for ll, Ai in enumerate(A):
                r = slice(d * i, d * (i + 1))
                c = slice(ll * dl + l * j, ll * dl + l * j + dl)
                B0[r, c] = Ai[:, :, i + j]
                B1[r, c] = Ai[:, :, i + j + 1]
    V, S, Wh = np.linalg.svd(B0, full_matrices=False)
    cutoff = max(tol_sigma,
                 rtol_sigma * (S[0] if len(S) else 0.0))
    if cutoff > 0:
        mask = S > cutoff
        V, S, Wh = V[:, mask], S[mask], Wh[mask, :]
    W = Wh.conj().T
    Om, P = np.linalg.eig(V.conj().T @ B1 @ W @ np.diag(1.0 / S))
    P = V[:d, :] @ P
    if return_sigma:
        return Om, P, S
    return Om, P


def _isleft(a, b, c):
    return ((b.real - a.real) * (c.imag - a.imag)
            - (c.real - a.real) * (b.imag - a.imag))


def wn(z, Gamma) -> int:
    """Winding number of polygon Γ around z (wn, beyn.jl:185-209)."""
    w = 0
    nG = len(Gamma)
    for i in range(nG):
        a, b = Gamma[i], Gamma[(i + 1) % nG]
        if a.imag <= z.imag:
            if b.imag > z.imag and _isleft(a, b, z) > 0:
                w += 1
        else:
            if b.imag <= z.imag and _isleft(a, b, z) < 0:
                w -= 1
    return w


def inpoly(z, Gamma) -> bool:
    return wn(z, Gamma) != 0


def pos_test(Om, P, Gamma):
    """Keep only eigenpairs enclosed by Γ (pos_test, beyn.jl:333-337)."""
    mask = np.array([inpoly(z, Gamma) for z in Om], dtype=bool)
    return Om[mask], P[:, mask]


def row_equilibrated_residual(Lz, v) -> float:
    """Row-equilibrated relative eigenpair residual ‖D⁻¹L(ω)v‖/‖v‖ with
    D = diag of per-row max-abs of L(ω).

    The plain Frobenius-normalized residual ‖Lv‖/(‖L‖_F‖v‖) is deflated
    by ~16 orders of magnitude on operators with 1e15 penalty rows
    (κ(L) ~ 5e16): ‖L‖_F is dominated by the penalty entries, so a
    corrupted eigenpair whose residual lives in the O(1)-scaled rows
    still reports ~1e-17.  Equilibrating each row by its max-abs entry
    puts every row on the same O(1) scale (each row of D⁻¹L has unit
    max-abs, row 2-norm ≈ √nnz_row), making the value an honest relative
    residual.  O(nnz): one matvec + one segmented row reduction."""
    r = Lz @ v
    n = Lz.shape[0]
    indptr = np.asarray(Lz.indptr)
    rowmax = np.zeros(n)
    nonempty = indptr[:-1] < indptr[1:]
    if nonempty.any():
        rowmax[nonempty] = np.maximum.reduceat(
            np.abs(Lz.data), indptr[:-1][nonempty])
    rowmax[rowmax == 0.0] = 1.0
    return float(np.linalg.norm(r / rowmax)
                 / max(np.linalg.norm(v), 1e-300))


def verify_eigenpairs(L: OperatorFamily, Om, P, res_tol: Optional[float]
                      = None, output: bool = False):
    """Per-eigenpair sparse residuals for Beyn candidates, O(nnz) per
    candidate (one CSR assembly + matvec + row reduction).

    The primary metric (used for ``res_tol`` filtering and returned) is
    the ROW-EQUILIBRATED relative residual ‖D⁻¹L(ω)v‖/‖v‖
    (:func:`row_equilibrated_residual`) — the Frobenius-normalized
    variant the reference documents (docs/src/tutorial_00_NLEVP.md:
    291-302) is reported alongside for reference compatibility but is
    unusable as an acceptance test on penalty-BC operators: Y=1e15 rows
    inflate ‖L‖_F by ~16 orders, so every candidate (including spurious
    ones) passes any sane cutoff.  At scale, inexact quadrature solves
    can push a spurious direction through the σ cutoff (a
    plausible-but-wrong eigenvalue with residual orders above the true
    modes).  ``res_tol``: drop candidates with equilibrated residual
    above it (None = keep all, report only).  Returns (Om, P, res)
    filtered consistently."""
    Om = np.asarray(Om)
    res = np.empty(len(Om))
    res_frob = np.empty(len(Om))
    saved = L.params[L.eigval]
    for i, om in enumerate(Om):
        if not np.isfinite(om):
            res[i] = np.inf
            res_frob[i] = np.inf
            continue
        Lz = L(complex(om))
        v = P[:, i]
        res[i] = row_equilibrated_residual(Lz, v)
        res_frob[i] = (np.linalg.norm(Lz @ v)
                       / max(Lz.norm(), 1e-300)
                       / max(np.linalg.norm(v), 1e-300))
    L.params[L.eigval] = saved
    if output and len(Om):
        for om, r, rf in zip(Om, res, res_frob):
            print(f"  eigenpair {om}: residual {r:.3e} "
                  f"(frobenius-normalized {rf:.3e})")
    if res_tol is not None:
        keep = res <= res_tol
        if output and (~keep).any():
            print(f"verify_eigenpairs: dropping {int((~keep).sum())} "
                  f"candidate(s) with residual > {res_tol:g}")
        return Om[keep], P[:, keep], res[keep]
    return Om, P, res


def _moments_backend(L: OperatorFamily, Gamma, V, K: int, N: int,
                     backend: str, output=False,
                     checkpoint: Optional[str] = None, **solver_kw):
    """Moment matrices through the selected quadrature backend.

    ``backend``: "host" = serial sparse-LU loop
    (:func:`compute_moment_matrices`, the reference's UMFPACK model);
    "slab" / "gmres" / "matfree" = device matrix-free panel solves
    (:func:`..parallel.dist_beyn.matfree_moments`); "dense" = batched
    dense device LU (:func:`..parallel.dist_beyn.batched_moments`)."""
    if backend == "host":
        return compute_moment_matrices(L, Gamma, V, K=K, N=N, output=output,
                                       checkpoint=checkpoint)
    from ..parallel.dist_beyn import batched_moments, matfree_moments
    if backend == "dense":
        return batched_moments(L, Gamma, V=V, K=K, N=N)
    method = "auto" if backend == "matfree" else backend
    A, _info = matfree_moments(L, Gamma, V=V, K=K, N=N, output=output,
                               checkpoint=checkpoint, method=method,
                               **solver_kw)
    return A


def beyn(L: OperatorFamily, Gamma, l=5, K=1, N=16, tol=0.0, rtol=0.0,
         pos_test_flag=True, output=False, random=False,
         checkpoint: Optional[str] = None, res_tol: Optional[float] = None,
         backend: str = "host", **solver_kw):
    """Beyn's contour-integral global eigensolver (beyn.jl:34-110).

    Finds all eigenvalues inside the polygon Γ; follows the pseudocode of
    Buschmann et al. 2020.  ``tol``/``rtol``: absolute/relative singular-
    value cutoffs (see :func:`moments2eigs`; use rtol≈1e-12 on badly scaled
    operators).  ``checkpoint``: optional path to persist/resume the
    quadrature (see :func:`compute_moment_matrices`).  ``res_tol``:
    per-eigenpair residual cutoff (see :func:`verify_eigenpairs`; None
    keeps every candidate).  ``backend``: where the quadrature solves
    run — "host" (serial sparse LU, the reference's model), "slab" /
    "gmres" / "matfree" (device matrix-free panels, scalable), "dense"
    (batched device LU, small operators); extra keywords pass to the
    device solver."""
    d = L.size
    K = max(K, (l + d - 1) // d)
    V = initialize_V(d, l, random=random)
    A = _moments_backend(L, Gamma, V, K, N, backend, output=output,
                         checkpoint=checkpoint, **solver_kw)
    Om, P, S = moments2eigs(A, tol_sigma=tol, rtol_sigma=rtol,
                            return_sigma=True)
    if output:
        print("singular values:", S)
    if pos_test_flag:
        Om, P = pos_test(Om, P, Gamma)
    if res_tol is not None or output:
        Om, P, _res = verify_eigenpairs(L, Om, P, res_tol=res_tol,
                                        output=output)
    return Om, P


def count_poles_and_zeros(L: OperatorFamily, Gamma, N=16, output=False):
    """#zeros − #poles of det L inside Γ via the residue theorem on
    tr(L⁻¹L') (count_poles_and_zeros, beyn.jl:355-368)."""
    zs, ws = gauss_nodes(Gamma, N)
    total = 0.0 + 0.0j
    for z, w in zip(zs, ws):
        F = factorize(L(z), check=True)
        L1 = L(z, 1).to_dense()
        total += w * np.trace(F.solve(L1))
    return total / (2 * np.pi * 1j)


# ---------------------------------------------------------------------------
# residual-controlled projection subspace (beyn.jl:429-595)


def generate_subspace(L: OperatorFamily, Y, tol, Z, N: Optional[int] = None,
                      output=False, include_Y=True):
    """Orthonormal basis Q such that ‖L(z)(Q x_z) − Y‖ < tol for every
    sample point z (generate_subspace, beyn.jl:429-569).  Z is either a
    list of sample points or, if N is given, polygon vertices that are
    expanded into N Gauss-Legendre nodes per edge.

    Fully matrix-free: the projected operator QᴴL(z)Q is built from
    sparse CSR matmats (O(nnz·q) per sample) and the exact solves go
    through :func:`..ops.linsolve.factorize` (sparse LU above the dense
    cutoff) — no [d,d] materialization, so the subspace compression
    works at the same scale as the solvers it feeds (the reference's
    one mechanism for compressing large problems, beyn.jl:429-595)."""
    Y = np.asarray(Y, dtype=CDTYPE)
    if Y.ndim == 1:
        Y = Y[:, None]
    d, k = Y.shape
    if N is not None:
        Z, _ = gauss_nodes(Z, N)
    cols = []
    if include_Y:
        for kk in range(k):
            cols.append(Y[:, kk])
    else:
        F = factorize(L(Z[0]), check=True)
        for kk in range(k):
            cols.append(F.solve(Y[:, kk]))
    Q = np.linalg.qr(np.stack(cols, axis=1))[0]
    resnorm = []
    for z in Z:
        if Q.shape[1] >= d:
            break
        Lz = L(z)
        LQ = Lz @ Q                       # sparse matmat, O(nnz·q)
        QLQ = Q.conj().T @ LQ
        QY = Q.conj().T @ Y
        F = None
        for kk in range(k):
            x = np.linalg.solve(QLQ, QY[:, kk])
            res = np.linalg.norm(LQ @ x - Y[:, kk])
            if res > tol:
                if F is None:
                    F = factorize(Lz, check=True)
                Xe = F.solve(Y[:, kk])
                # orthogonalize against Q and append
                h = Q.conj().T @ Xe
                w = Xe - Q @ h
                w -= Q @ (Q.conj().T @ w)
                nw = np.linalg.norm(w)
                if nw > 1e-14:
                    Q = np.concatenate([Q, (w / nw)[:, None]], axis=1)
                    LQ = np.concatenate([LQ, (Lz @ (w / nw))[:, None]],
                                        axis=1)
                    QLQ = Q.conj().T @ LQ
                    QY = Q.conj().T @ Y
                x = np.linalg.solve(QLQ, QY[:, kk])
                res = np.linalg.norm(LQ @ x - Y[:, kk])
            resnorm.append(res)
    return Q, np.asarray(resnorm)


# ---------------------------------------------------------------------------
# hybrid global-local solve (solver.jl:36-184)


def solve(L: OperatorFamily, Gamma, dl=1, N=16, tol=1e-8, eigvals=None,
          maxcycles=1, nev=1, max_outer_cycles=1, atol_sigma=1e-12,
          rtol_sigma=1e-8, loglevel=0, backend: str = "host", **solver_kw):
    """Hybrid solver: low-order Beyn integral → local refinement of each
    estimate → analytic rank-one correction of the moment matrices with the
    converged eigenpairs → repeat; the outer loop grows the search space by
    Δl columns.  (solve, solver.jl:36-184; the reference's dangling
    ``mehrmann`` call is replaced by :func:`householder`, which returns the
    adjoint eigenvectors the moment correction needs.)

    ``backend`` routes the contour quadrature ("host" serial sparse LU /
    "slab" / "gmres" / "matfree" device panels / "dense" batched device
    LU — see :func:`_moments_backend`); the local refinement keeps the
    host factorization path."""
    if eigvals is None:
        eigvals = {}
    d = L.size
    A: List[np.ndarray] = []
    probe_rows: List[List[int]] = []  # which unit vector each column probes
    l = dl
    sigma_max = sigma0 = sigma = 0.0
    while l <= max_outer_cycles * dl:
        V = np.zeros((d, dl), dtype=CDTYPE)
        rows = [((l - dl) + ll) % d for ll in range(dl)]
        for ll, row in enumerate(rows):
            V[row, ll] = 1.0
        probe_rows.append(rows)
        A.append(_moments_backend(L, Gamma, V, 1, N, backend,
                                  output=loglevel >= 2, **solver_kw))
        if l > dl:
            _, _, S = moments2eigs(A, return_sigma=True)
            sigma_max, sigma0, sigma = max(sigma_max, S.max()), S.max(), 0.0
        # correct with known eigenpairs
        for om, (s, inside) in eigvals.items():
            w = wn(om, Gamma)
            for ll in range(dl):
                moment = (-2j * np.pi * w * s.v
                          * np.conj(s.v_adj[probe_rows[-1][ll]]))
                A[-1][:, ll, 0] += moment
                A[-1][:, ll, 1] += om * moment
        n_inside = sum(1 for _, inside in eigvals.values() if inside)
        cycle = 0
        while cycle < maxcycles:
            cycle += 1
            Om, P, S = moments2eigs(A, return_sigma=True)
            sigma_max, sigma0, sigma = max(sigma_max, sigma), sigma, S.max()
            scale_G = max(abs(g) for g in Gamma)
            for idx in range(len(Om)):
                om = Om[idx]
                # guard: skip wildly out-of-range estimates produced by
                # near-zero singular values of the moment pencil
                if not np.isfinite(om) or abs(om) > 100 * scale_G:
                    continue
                v0 = P[:, idx]
                v0 = v0 / np.sqrt(v0.conj() @ v0)
                for _, (s, _inside) in eigvals.items():
                    v = s.v / np.sqrt(s.v.conj() @ s.v)
                    v0 = v0 - (v.conj() @ v0) * v
                    nv = np.sqrt(np.abs(v0.conj() @ v0))
                    if nv > 0:
                        v0 = v0 / nv
                s, nn, flag = householder(L, om, maxiter=10, tol=tol,
                                          output=loglevel >= 2, order=3,
                                          nev=nev, v0=v0)
                om = s.params[s.eigval]
                # verified acceptance: the reference accepts any flag>=0
                # (solver.jl:118-127) which lets maxiter-terminated
                # non-eigenvalues through; verify the ROW-EQUILIBRATED
                # eigenpair residual (penalty rows deflate the plain
                # Frobenius-normalized norm by ~16 orders — see
                # row_equilibrated_residual).  Sparse throughout: O(nnz).
                Lz = L(om)
                resid = row_equilibrated_residual(Lz, s.v)
                is_new = (flag >= 0 and resid < max(1e-8, tol)
                          and all(abs(om - known) >= 10 * tol
                                  for known in eigvals))
                if loglevel >= 2:
                    print(f"conv:{om} flag:{flag} new:{is_new}")
                if is_new and inpoly(om, Gamma):
                    w = wn(om, Gamma)
                    for aidx in range(len(A)):
                        for ll in range(dl):
                            moment = (-2j * np.pi * w * s.v
                                      * np.conj(s.v_adj[probe_rows[aidx][ll]]))
                            A[aidx][:, ll, 0] += moment
                            A[aidx][:, ll, 1] += om * moment
                    eigvals[om] = [s, True]
                elif is_new:
                    eigvals[om] = [s, False]
            new_inside = sum(1 for _, inside in eigvals.values() if inside)
            if new_inside == n_inside:
                break
            n_inside = new_inside
        if sigma_max > 0 and (sigma / sigma_max < rtol_sigma or sigma < atol_sigma):
            break
        l += dl
    return eigvals


__all__ = [
    "decode_error_flag", "householder_update", "householder", "padesolve",
    "mslp", "inveriter", "lancaster", "traceiter", "rf2s", "nicoud",
    "picard", "beyn", "gauss_nodes", "initialize_V",
    "compute_moment_matrices", "moments2eigs", "wn", "inpoly", "pos_test",
    "count_poles_and_zeros", "generate_subspace", "solve",
    "verify_eigenpairs", "row_equilibrated_residual",
    "mehrmann", "juniper", "guettel",
    "ITSOL_CONVERGED", "ITSOL_MAXITER", "ITSOL_SLOW_CONVERGENCE",
    "ITSOL_IMPOSSIBLE", "ITSOL_SINGULAR_EXCEPTION", "ITSOL_EIGS_EXCEPTION",
    "ITSOL_ISNAN", "ITSOL_UNKNOWN",
]

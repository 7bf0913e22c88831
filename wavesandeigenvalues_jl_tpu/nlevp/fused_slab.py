"""The fused device Newton step of the local NLEVP solver — slab
(block-tridiagonal) DIRECT inner solves over the repo's slab structure
(ops/slab_solve.py); :func:`.fused_local.try_fused_local` drives it:

* **One factorization per Newton step** (the operator changes with z):
  a ``lax.scan`` block-Thomas
  elimination over the BFS-slab partition, batched over both sides
  (direct + adjoint), producing per-slab inverses and the coupling
  products  Wᵀ_i = (Dt_i⁻¹L_i)ᵀ,  Cᵀ_i = (Dt_i⁻¹U_i)ᵀ.
* **Every inner solve is the block-Thomas forward/backward recursion**
  (:func:`..ops.slab_thomas.slab_thomas`) — 2m sequential [1,s]×[s,s]
  products per side, both sides batched.  No GMRES, no convergence risk.
* Rows are equilibrated ON DEVICE per side (ELL row-max of |data|,
  gather+reduce): penalty-BC rows (Y~1e15) otherwise destroy the f32
  block factorization.
* σ-regularization, f64 refinement, and the two-sided f64 Rayleigh
  quotients: see :mod:`.fused_local` (device lands in the Newton basin,
  the host c128 polish supplies the final digits).

Reference counterpart: Householder.jl:70-192 / iterative_solvers.jl —
ARPACK shift-invert over one UMFPACK factorization per outer iteration;
here the factorization is the batched slab elimination and the ARPACK
role is inverse iteration with refined direct solves.
"""
from __future__ import annotations

import functools

import numpy as np

from ..ops.slab_solve import SlabPartition
from ..ops.slab_thomas import slab_thomas
from ..utils.config import CDTYPE
from .family import AUX_OPERATOR, OperatorFamily

#: cap on the W/C/Dt⁻¹ slab blocks (device bytes, both sides): the
#: factorization must coexist with the family stacks
SLAB_FUSED_MAX_STREAM = 4.0e9

REFINE_SWEEPS = 1


def _planes64(x):
    x = np.asarray(x, np.complex128)
    return (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))


def _planes32(x):
    x = np.asarray(x)
    return (np.ascontiguousarray(x.real).astype(np.float32),
            np.ascontiguousarray(x.imag).astype(np.float32))


def _ell_ids(rows_sorted, n: int, nnz: int):
    """Padded-ELL entry-id map [n, w] (sentinel = nnz) for per-row max
    reductions over data laid out in row-sorted order."""
    counts = np.bincount(rows_sorted, minlength=n)
    w = max(int(counts.max()), 1)
    ids = np.full((n, w), nnz, np.int32)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(rows_sorted)) - starts[rows_sorted]
    ids[rows_sorted, slot] = np.arange(len(rows_sorted), dtype=np.int32)
    return ids


@functools.lru_cache(maxsize=16)
def _build_slab_step_fn(meta, thomas):
    """meta = (n, K, nnz, m, s).  Returns the jitted per-Newton-step fn:
    (scalars [dz, λ, λ′, residuals], refined v and w carries)."""
    import jax
    import jax.numpy as jnp

    n, K, nnz, m, s = meta
    f32 = jnp.float32
    hiP = jax.lax.Precision.HIGHEST

    @jax.jit
    def step(rows2, cols2, vals_r, vals_i, cr, ci, dcr, dci, sr, si,
             mdat_r, mdat_i, fdest2, ell2, cell2, rmap, src, sizes,
             vr, vi, wr, wi):
        # ---- device-side assembly (f64 pairs) ---------------------------
        def contract(cr_, ci_, Vr, Vi):
            return cr_ @ Vr - ci_ @ Vi, cr_ @ Vi + ci_ @ Vr

        a_r, a_i = contract(cr, ci, vals_r[0], vals_i[0])        # A data
        ah_r, ah_i = contract(cr, -ci, vals_r[1], vals_i[1])     # Aᴴ data
        g_r = a_r + sr * mdat_r[0] - si * mdat_i[0]              # A + σM
        g_i = a_i + sr * mdat_i[0] + si * mdat_r[0]
        gh_r = ah_r + sr * mdat_r[1] + si * mdat_i[1]            # Aᴴ + σ̄Mᴴ
        gh_i = ah_i + sr * mdat_i[1] - si * mdat_r[1]

        # ---- per-side row equilibration (ELL gather+max, f64) -----------
        def rowscale(side, gr_, gi_):
            absg = jnp.sqrt(gr_ * gr_ + gi_ * gi_)
            a_pad = jnp.concatenate([absg, jnp.zeros(1, absg.dtype)])
            rm = jnp.max(a_pad[ell2[side]], axis=1)              # [n]
            return 1.0 / jnp.where(rm == 0, 1.0, rm)

        s0 = rowscale(0, g_r, g_i)
        s1 = rowscale(1, gh_r, gh_i)
        s0_32 = s0.astype(f32)
        s1_32 = s1.astype(f32)

        # ---- scaled band panels [m, 2, 3, s, s] (f32) -------------------
        fd0 = fdest2[0]
        fd1 = fdest2[1]
        gs0_r = (g_r * s0[rows2[0]]).astype(f32)
        gs0_i = (g_i * s0[rows2[0]]).astype(f32)
        gs1_r = (gh_r * s1[rows2[1]]).astype(f32)
        gs1_i = (gh_i * s1[rows2[1]]).astype(f32)

        def scat(fd, dr):
            return jnp.zeros(m * 3 * s * s, f32).at[fd].add(dr)

        blk_r = jnp.stack([scat(fd0, gs0_r), scat(fd1, gs1_r)])
        blk_i = jnp.stack([scat(fd0, gs0_i), scat(fd1, gs1_i)])
        blk = jax.lax.complex(blk_r, blk_i).reshape(2, m, 3, s, s)
        blk = blk.transpose(1, 0, 2, 3, 4)                   # [m, 2, 3, s, s]

        # ---- block-Thomas factorization scan (batched over sides) ------
        arange_s = jnp.arange(s)
        Eye = jnp.broadcast_to(jnp.eye(s, dtype=blk.dtype), (2, s, s))

        def body(C, xs):
            blk_i_, size_i = xs
            Lb, Db, Ub = blk_i_[:, 0], blk_i_[:, 1], blk_i_[:, 2]
            pad = (arange_s >= size_i).astype(blk.dtype)
            Dt = Db - jnp.matmul(Lb, C, precision=hiP) + jnp.diag(pad)[None]
            Dtinv = jnp.linalg.solve(Dt, Eye)
            Cn = jnp.matmul(Dtinv, Ub, precision=hiP)
            Wt = jnp.matmul(Dtinv, Lb, precision=hiP).transpose(0, 2, 1)
            return Cn, (Dtinv, Wt, Cn.transpose(0, 2, 1))

        C0 = jnp.zeros((2, s, s), blk.dtype)
        # DT, WT, CT: [m, 2, s, s] complex64
        _, (DT, WT, CT) = jax.lax.scan(body, C0, (blk, sizes))

        # ---- slab direct solve (scale → pack → Dt⁻¹b → Thomas → unpack)
        def solve_both(b0r, b0i, b1r, b1i):
            """Both sides' f32 [n] UNSCALED rhs -> f32 [n] solutions
            (row scaling does not change x)."""
            b = jnp.stack([jax.lax.complex(b0r, b0i) * s0_32,
                           jax.lax.complex(b1r, b1i) * s1_32])
            b = jnp.concatenate([b, jnp.zeros((2, 1), b.dtype)], axis=1)
            bt = jnp.einsum("mbij,bmj->mbi", DT, b[:, rmap],
                            precision=hiP)                   # [m, 2, s]
            x = thomas(WT, CT, bt).transpose(1, 0, 2)
            x = x.reshape(2, m * s)[:, src]                  # [2, n]
            xr_, xi_ = jnp.real(x), jnp.imag(x)
            return ((xr_[0], xi_[0]), (xr_[1], xi_[1]))

        # ---- f64-pair helpers -------------------------------------------
        # ELL gather+row-reduce: the entry-id ELL map (ell2) and the
        # per-slot column map (cell2) turn each SpMV into two gathers +
        # one row reduction.
        def pair_spmv(side, dr, di, xr_, xi_):
            ids = ell2[side]                         # [n, w] (sentinel nnz)
            dpr = jnp.concatenate([dr, jnp.zeros(1, dr.dtype)])[ids]
            dpi = jnp.concatenate([di, jnp.zeros(1, di.dtype)])[ids]
            cg = cell2[side]                         # [n, w] (sentinel 0)
            xr_g = xr_[cg]
            xi_g = xi_[cg]
            yr = jnp.sum(dpr * xr_g - dpi * xi_g, axis=1)
            yi = jnp.sum(dpr * xi_g + dpi * xr_g, axis=1)
            return yr, yi

        def pair_dot(wr_, wi_, yr, yi):                      # wᴴ y
            return (jnp.sum(wr_ * yr + wi_ * yi),
                    jnp.sum(wr_ * yi - wi_ * yr))

        def pair_div(ar_, ai_, br_, bi_):
            d = br_ * br_ + bi_ * bi_
            return ((ar_ * br_ + ai_ * bi_) / d,
                    (ai_ * br_ - ar_ * bi_) / d)

        mdat32_r = mdat_r.astype(f32)
        mdat32_i = mdat_i.astype(f32)

        def mspmv32(side, xr_, xi_):
            return pair_spmv(side, mdat32_r[side], mdat32_i[side], xr_, xi_)

        g64 = (jnp.stack([g_r, gh_r]), jnp.stack([g_i, gh_i]))

        def refined_inverse_step(v_r, v_i, w_r, w_i, sweeps,
                                 diagnostics=False):
            b0r, b0i = mspmv32(0, v_r, v_i)
            b1r, b1i = mspmv32(1, w_r, w_i)
            (x0r, x0i), (x1r, x1i) = solve_both(b0r, b0i, b1r, b1i)
            X = [[x0r.astype(jnp.float64), x0i.astype(jnp.float64)],
                 [x1r.astype(jnp.float64), x1i.astype(jnp.float64)]]
            B = [[b0r.astype(jnp.float64), b0i.astype(jnp.float64)],
                 [b1r.astype(jnp.float64), b1i.astype(jnp.float64)]]
            for _ in range(sweeps):
                RR = []
                for s_ in (0, 1):
                    yr, yi = pair_spmv(s_, g64[0][s_], g64[1][s_],
                                       X[s_][0], X[s_][1])
                    RR.append(((B[s_][0] - yr).astype(f32),
                               (B[s_][1] - yi).astype(f32)))
                (d0r, d0i), (d1r, d1i) = solve_both(RR[0][0], RR[0][1],
                                                    RR[1][0], RR[1][1])
                X[0][0] = X[0][0] + d0r.astype(jnp.float64)
                X[0][1] = X[0][1] + d0i.astype(jnp.float64)
                X[1][0] = X[1][0] + d1r.astype(jnp.float64)
                X[1][1] = X[1][1] + d1i.astype(jnp.float64)
            if not diagnostics:
                return X, None
            res = []
            for s_ in (0, 1):
                yr, yi = pair_spmv(s_, g64[0][s_], g64[1][s_],
                                   X[s_][0], X[s_][1])
                num = jnp.sum((B[s_][0] - yr) ** 2 + (B[s_][1] - yi) ** 2)
                den = jnp.maximum(
                    jnp.sum(B[s_][0] ** 2 + B[s_][1] ** 2), 1e-300)
                res.append(jnp.sqrt(num / den))
            return X, jnp.stack(res)

        def pnorm(xr_, xi_):
            return jnp.sqrt(jnp.sum(xr_ * xr_ + xi_ * xi_))

        X, _ = refined_inverse_step(vr, vi, wr, wi, sweeps=0)
        nv0 = jnp.maximum(pnorm(X[0][0], X[0][1]), 1e-300)
        nw0 = jnp.maximum(pnorm(X[1][0], X[1][1]), 1e-300)
        v1r = (X[0][0] / nv0).astype(f32)
        v1i = (X[0][1] / nv0).astype(f32)
        w1r = (X[1][0] / nw0).astype(f32)
        w1i = (X[1][1] / nw0).astype(f32)
        X, res2 = refined_inverse_step(v1r, v1i, w1r, w1i,
                                       sweeps=REFINE_SWEEPS,
                                       diagnostics=True)
        nv = jnp.maximum(pnorm(X[0][0], X[0][1]), 1e-300)
        nw = jnp.maximum(pnorm(X[1][0], X[1][1]), 1e-300)
        vr64, vi64 = X[0][0] / nv, X[0][1] / nv
        wr64, wi64 = X[1][0] / nw, X[1][1] / nw

        # ---- two-sided Rayleigh quotients in f64 pairs ------------------
        av_r, av_i = pair_spmv(0, a_r, a_i, vr64, vi64)
        ap_r, ap_i = contract(dcr, dci, vals_r[0], vals_i[0])
        apv_r, apv_i = pair_spmv(0, ap_r, ap_i, vr64, vi64)
        mv_r, mv_i = pair_spmv(0, mdat_r[0], mdat_i[0], vr64, vi64)

        num_r, num_i = pair_dot(wr64, wi64, av_r, av_i)
        dnum_r, dnum_i = pair_dot(wr64, wi64, apv_r, apv_i)
        den_r, den_i = pair_dot(wr64, wi64, mv_r, mv_i)

        lam_r, lam_i = pair_div(num_r, num_i, den_r, den_i)
        lamd_r, lamd_i = pair_div(dnum_r, dnum_i, den_r, den_i)
        dz_r, dz_i = pair_div(-lam_r, -lam_i, lamd_r, lamd_i)

        scal = jnp.stack([dz_r, dz_i, lam_r, lam_i, lamd_r, lamd_i,
                          res2[0], res2[1]])
        return (scal, vr64.astype(f32), vi64.astype(f32),
                wr64.astype(f32), wi64.astype(f32))

    return step


class FusedSlabPencilSolver:
    """Device-resident slab-direct Newton state for one family."""

    def __init__(self, L: OperatorFamily):
        import jax

        L.ensure_aux()
        S = L._stack()
        self.L = L
        self.n = int(S.shape[0])
        self.eig, self.aux = L.eigval, L.auxval
        rows = np.asarray(S.row_ids(), np.int64)
        cols = np.asarray(S.indices, np.int64)
        nnz = len(cols)
        vals = np.asarray(S.values)
        self.K = vals.shape[0]
        self.k_aux = next(i for i, t in enumerate(L.terms)
                          if t.operator == AUX_OPERATOR)

        part = SlabPartition(S.indptr, S.indices, self.n)
        self.part = part
        m = part.m
        s = part.smax
        self.m, self.s = m, s
        stream_bytes = 2 * 3 * m * s * s * 8
        if stream_bytes > SLAB_FUSED_MAX_STREAM:
            raise ValueError(
                f"slab stream {stream_bytes / 1e9:.1f} GB above "
                f"SLAB_FUSED_MAX_STREAM for n={self.n}")

        # adjoint pattern (Aᴴ): conj data on (cols, rows), row-sorted
        perm = np.lexsort((rows, cols))
        rows_h = cols[perm]
        cols_h = rows[perm]
        valsH = np.conj(vals[:, perm])

        # per-side slab destinations
        si0, d0, rl0, cl0 = part.entry_destinations(rows, cols)
        si1, d1, rl1, cl1 = part.entry_destinations(rows_h, cols_h)
        fd0 = (((si0 * 3 + d0) * s + rl0) * s + cl0).astype(np.int32)
        fd1 = (((si1 * 3 + d1) * s + rl1) * s + cl1).astype(np.int32)

        # slab row map / inverse gather
        rmap = np.full((m, s), self.n, np.int32)
        for i in range(m):
            rows_i = part.perm[part.starts[i]:part.starts[i + 1]]
            rmap[i, :len(rows_i)] = rows_i
        newidx = part.iperm
        src = (part.slab_of_new[newidx] * s
               + part.loc_of_new[newidx]).astype(np.int32)

        self.rows2 = jax.device_put(np.stack([rows, rows_h]).astype(np.int32))
        self.cols2 = jax.device_put(np.stack([cols, cols_h]).astype(np.int32))
        self.vals_r = jax.device_put(np.stack([vals.real, valsH.real]))
        self.vals_i = jax.device_put(np.stack([vals.imag, valsH.imag]))
        e = np.zeros(self.K, np.complex128)
        e[self.k_aux] = -1.0
        mdat = e @ vals
        mdatH = np.conj(mdat[perm])
        mr, mi = _planes64(np.stack([mdat, mdatH]))
        self.mdat_r = jax.device_put(mr)
        self.mdat_i = jax.device_put(mi)
        self.fdest2 = jax.device_put(np.stack([fd0, fd1]))
        ell0 = _ell_ids(rows, self.n, nnz)
        ell1 = _ell_ids(rows_h, self.n, nnz)
        w = max(ell0.shape[1], ell1.shape[1])

        def padw(a):
            out = np.full((self.n, w), nnz, np.int32)
            out[:, :a.shape[1]] = a
            return out

        ell2h = np.stack([padw(ell0), padw(ell1)])
        self.ell2 = jax.device_put(ell2h)
        # per-slot COLUMN map (sentinel slot -> col 0; its data is 0)
        colpad0 = np.concatenate([cols, [0]]).astype(np.int32)
        colpad1 = np.concatenate([cols_h, [0]]).astype(np.int32)
        self.cell2 = jax.device_put(np.stack([colpad0[ell2h[0]],
                                              colpad1[ell2h[1]]]))
        self.rmap = jax.device_put(rmap)
        self.src = jax.device_put(src)
        self.sizes = jax.device_put(part.sizes.astype(np.int32))
        self.meta = (self.n, self.K, nnz, m, s)
        self._step_fn = _build_slab_step_fn(self.meta, slab_thomas)

    # -- host-side per-step scalar work -----------------------------------
    def coefficients(self, z: complex):
        L = self.L
        L.params[self.eig] = z
        L.params[self.aux] = 0.0
        saved_mode = L.mode
        L.mode = "householder"
        try:
            c = L.coefficients({})
            dc = L.coefficients({self.eig: 1})
        finally:
            L.mode = saved_mode
        c[self.k_aux] = 0.0
        dc[self.k_aux] = 0.0
        return c, dc

    def step(self, z: complex, carries, sigma: complex):
        c, dc = self.coefficients(z)
        cr, ci = _planes64(c)
        dcr, dci = _planes64(dc)
        sr = np.float64(sigma.real)
        si = np.float64(sigma.imag)
        vr, vi, wr, wi = carries
        out = self._step_fn(self.rows2, self.cols2, self.vals_r,
                            self.vals_i, cr, ci, dcr, dci, sr, si,
                            self.mdat_r, self.mdat_i, self.fdest2,
                            self.ell2, self.cell2, self.rmap, self.src,
                            self.sizes, vr, vi, wr, wi)
        scal, vr, vi, wr, wi = out
        sc = np.asarray(scal, np.float64)
        dz = complex(sc[0], sc[1])
        lam = complex(sc[2], sc[3])
        res = sc[6:8]
        return dz, lam, (vr, vi, wr, wi), res

    def fetch_vectors(self, carries):
        vr, vi, wr, wi = carries
        v = (np.asarray(vr, np.float64) + 1j * np.asarray(vi, np.float64))
        w = (np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64))
        return v.astype(CDTYPE), w.astype(CDTYPE)


__all__ = ["FusedSlabPencilSolver", "SLAB_FUSED_MAX_STREAM"]

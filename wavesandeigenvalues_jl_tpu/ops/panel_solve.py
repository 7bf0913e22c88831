"""Matrix-free batched shifted panel solves: X_j = L(z_j)⁻¹ V on device.

This is the scalable device path for the Beyn contour quadrature
(/root/reference/src/NLEVP/beyn.jl:62-74: |Γ|·N independent sparse LU
solves with an l-column probe block).  The round-1 device Beyn densified
each node as a [d,d] solve, capping scale at ~10⁴ DOF; here every node is
solved matrix-free:

* the operator family evaluates on device as ``data = c @ values`` over
  the union-pattern stack (one tiny contraction per shift) — no dense
  materialization anywhere;
* the per-shift LEFT block-Jacobi preconditioner (and the optional
  two-grid coarse inverse) are inverted on HOST at complex128 in one
  batched LAPACK call per chunk and applied on device as einsums/matmuls.
  Left, not right, because penalty-BC rows (admittance Y~1e15) span ~16
  orders of magnitude and must be normalized out of the residual norm
  for single precision to converge;
* GMRES(m) instances are vmapped over (shift × column) and chunked so the
  Krylov bases fit device memory at any problem size;
* mixed-precision iterative refinement against exact complex128 host
  residuals (scipy CSR matmat on the shared structure) recovers reference
  accuracy from the complex64 device solves.

Complex data crosses the host↔device boundary as (re, im) float planes
recombined with ``lax.complex`` on device.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import CDTYPE, device_complex_dtype
from .gmres import gmres_impl

#: device-memory budget (bytes) for one chunk's Krylov bases
PANEL_BUDGET = float(os.environ.get("WAE_PANEL_BUDGET", "1.5e9"))


def _planes(x, rdt):
    x = np.asarray(x)
    return (np.ascontiguousarray(x.real).astype(rdt),
            np.ascontiguousarray(x.imag).astype(rdt))


@partial(jax.jit, static_argnames=("n", "restart", "max_restarts"))
def _panel_gmres(vr, vi, ecols, egather, dvr, dvi,
                 cr, ci, br, bi, xr, xi, tol,
                 n: int, restart: int, max_restarts: int):
    """One chunk of shifted panel solves.

    ``vr/vi``: [K, nnz] family value-stack planes (shared);
    ``rows/cols``: [nnz] union-pattern structure; ``dvr/dvi``:
    [S, nb, bs, bs] HOST-inverted block-Jacobi planes (inverted at
    complex128 on host; the apply is just an einsum); ``cr/ci``: [S, K] per-shift coefficient
    planes; ``br/bi``: [S, l, n] RHS planes; ``xr/xi``: [S, l, n]
    warm-start planes (zeros for a cold start).  Returns solution planes
    [S, l, n], preconditioned relative residuals [S, l] and restart
    counts [S, l]."""
    vals = jax.lax.complex(vr, vi)

    def one_shift(c, Dinv, B, X0):
        data = c @ vals                                        # [nnz]
        # pack to padded ELL once per shift: the SpMV becomes gather +
        # multiply + row-reduce (a batched scatter under a wide vmap
        # serializes; the gather form vectorizes)
        dell = jnp.concatenate([data, jnp.zeros(1, data.dtype)])[egather]
        nb, bs = Dinv.shape[0], Dinv.shape[1]
        npad = nb * bs

        def spmv(x):
            return jnp.sum(dell * x[ecols], axis=1)

        def dinv(v):
            vp = jnp.zeros(npad, v.dtype).at[:n].set(v)
            out = jnp.einsum("bij,bj->bi", Dinv, vp.reshape(nb, bs))
            return out.reshape(-1)[:n]

        def one_col(b, x0):
            x, res, its = gmres_impl(lambda x: dinv(spmv(x)), dinv(b),
                                     x0=x0, tol=tol, restart=restart,
                                     max_restarts=max_restarts)
            return x, res, its

        return jax.vmap(one_col)(B, X0)

    X, res, its = jax.vmap(one_shift)(jax.lax.complex(cr, ci),
                                      jax.lax.complex(dvr, dvi),
                                      jax.lax.complex(br, bi),
                                      jax.lax.complex(xr, xi))
    return jnp.real(X), jnp.imag(X), res, its


@partial(jax.jit, static_argnames=("n", "nc", "restart", "max_restarts"))
def _panel_gmres_tg(vr, vi, ecols, egather, dvr, dvi,
                    air, aii, pell_cols, pell_vals, ptell_cols, ptell_vals,
                    cr, ci, br, bi, xr, xi, tol,
                    n: int, nc: int, restart: int, max_restarts: int):
    """Two-grid-preconditioned variant of :func:`_panel_gmres`.

    The LEFT preconditioner is one multiplicative two-grid cycle
    pre-smooth -> coarse correction -> post-smooth:

        y  = D^-1 v
        y += P . A_c^-1 . P^T (v - A y)
        y += D^-1 (v - A y)

    with D^-1 the block-Jacobi smoother, P the geometric P1 interpolation
    from the octosplit hierarchy (mesh/refine.p1_prolongation) and
    A_c(z)^-1 the SAME operator family assembled on the coarse mesh and
    inverted ONCE per shift on host at complex128 (``air/aii``
    [S, nc, nc] planes) — the coarse correction is then a single
    matmul per application, with no triangular-solve loop programs to
    compile.  This is what lets the matrix-free Beyn quadrature scale
    past the plain block-Jacobi regime (~5x10^3 DOF) to the reference's
    UMFPACK envelope (beyn.jl:62-74)."""
    vals = jax.lax.complex(vr, vi)

    def one_shift(c, Dinv, Acinv, B, X0):
        data = c @ vals
        dell = jnp.concatenate([data, jnp.zeros(1, data.dtype)])[egather]
        nb, bs = Dinv.shape[0], Dinv.shape[1]
        npad = nb * bs

        def spmv(x):
            return jnp.sum(dell * x[ecols], axis=1)

        def dinv(v):
            vp = jnp.zeros(npad, v.dtype).at[:n].set(v)
            out = jnp.einsum("bij,bj->bi", Dinv, vp.reshape(nb, bs))
            return out.reshape(-1)[:n]

        pv = pell_vals.astype(data.dtype)
        ptv = ptell_vals.astype(data.dtype)

        def P(vc):      # prolongation, ELL-gather form [n, wp]
            return jnp.sum(pv * vc[pell_cols], axis=1)

        def Pt(r):      # restriction = Pᵀ, ELL-gather form [nc, wr]
            return jnp.sum(ptv * r[ptell_cols], axis=1)

        def minv(v):
            y = dinv(v)
            r = v - spmv(y)
            y = y + P(Acinv @ Pt(r))
            r = v - spmv(y)
            return y + dinv(r)

        def one_col(b, x0):
            x, res, its = gmres_impl(lambda x: minv(spmv(x)), minv(b),
                                     x0=x0, tol=tol, restart=restart,
                                     max_restarts=max_restarts)
            return x, res, its

        return jax.vmap(one_col)(B, X0)

    X, res, its = jax.vmap(one_shift)(jax.lax.complex(cr, ci),
                                      jax.lax.complex(dvr, dvi),
                                      jax.lax.complex(air, aii),
                                      jax.lax.complex(br, bi),
                                      jax.lax.complex(xr, xi))
    return jnp.real(X), jnp.imag(X), res, its


class CoarseGrid:
    """Geometric coarse level for the two-grid preconditioner: the SAME
    operator family assembled on a coarser octosplit ancestor, plus the
    P1 interpolation COO from :func:`..mesh.refine.p1_prolongation`
    (possibly composed across several levels)."""

    def __init__(self, coarse_family, prolongation):
        import scipy.sparse as sp

        from .sparse import csr_to_ell
        rows, cols, vals, (n_f, n_c) = prolongation
        Sc = coarse_family._stack()
        if Sc.shape[0] != n_c:
            raise ValueError(f"coarse family dim {Sc.shape[0]} != "
                             f"prolongation n_coarse {n_c}")
        self.n_fine, self.n_coarse = int(n_f), int(n_c)
        self.values = Sc.values                        # [K, nnz_c] host
        self.crows = np.asarray(Sc.row_ids(), np.int64)
        self.ccols = np.asarray(Sc.indices, np.int64)
        # transfer operators in padded-ELL gather form (P and Pᵀ):
        # padded slots carry zero values, so their column index 0 is inert
        Pm = sp.coo_matrix((vals, (rows, cols)), shape=(n_f, n_c)).tocsr()
        pc, pg, _ = csr_to_ell(Pm.indptr, Pm.indices, n_c)
        self.pell_cols = pc.astype(np.int32)
        self.pell_vals = np.concatenate([Pm.data, [0.0]])[pg]
        Pt = Pm.T.tocsr()
        tc, tg, _ = csr_to_ell(Pt.indptr, Pt.indices, n_f)
        self.ptell_cols = tc.astype(np.int32)
        self.ptell_vals = np.concatenate([Pt.data, [0.0]])[tg]


class MultiGrid:
    """Geometric multilevel hierarchy for the panel GMRES preconditioner.

    ``families``: the SAME operator family discretized on successively
    coarser octosplit ancestors, fine-ward first (EXCLUDING the solve
    level); ``prolongations``: P1 interpolation COOs
    (mesh/refine.p1_prolongation), ``prolongations[k]`` mapping
    ``families[k]`` up to the level above (the solve level for k=0).
    The deepest family is inverted exactly per shift (host complex128);
    every intermediate level gets a block-Jacobi smoother.  A 2-level
    jump (e.g. 42k DOF → 1006) leaves the smoother covering a 64×
    frequency span and the cycle stalls near 1e-3; with the full
    hierarchy each level only bridges the 8× octosplit refinement."""

    def __init__(self, families, prolongations, bs: int = 64):
        from .sparse import csr_to_ell
        if len(families) != len(prolongations):
            raise ValueError("need one prolongation per coarse family")
        self.bs = bs
        self.n_fine = int(prolongations[0][3][0])
        self.levels = []       # intermediate: (values, rows, cols, ell)
        self.xfers = []        # (pell_cols, pell_vals, ptell_cols, ptell_vals)
        n_above = self.n_fine
        for k, (fam, pro) in enumerate(zip(families, prolongations)):
            S = fam._stack()
            nk = int(S.shape[0])
            if pro[3] != (n_above, nk):
                raise ValueError(f"prolongation {k} maps {pro[3]}, "
                                 f"expected ({n_above}, {nk})")
            cg = CoarseGrid(fam, pro)      # reuse its ELL transfer build
            self.xfers.append((cg.pell_cols, cg.pell_vals.astype(np.float64),
                               cg.ptell_cols,
                               cg.ptell_vals.astype(np.float64)))
            if k < len(families) - 1:      # intermediate: smoother + op
                ec, eg, _ = csr_to_ell(S.indptr, S.indices, nk)
                self.levels.append((S.values,
                                    np.asarray(S.row_ids(), np.int64),
                                    np.asarray(S.indices, np.int64),
                                    ec.astype(np.int32),
                                    eg.astype(np.int32), nk))
            else:                          # deepest: exact inverse
                self.n_coarse = nk
                self.values = S.values
                self.crows = np.asarray(S.row_ids(), np.int64)
                self.ccols = np.asarray(S.indices, np.int64)
            n_above = nk


@partial(jax.jit, static_argnames=("n", "restart", "max_restarts"))
def _panel_gmres_mg(vr, vi, ecols, egather, dvr, dvi,
                    lvl_ops, lvl_dinv, xfers, air, aii,
                    cr, ci, br, bi, xr, xi, tol,
                    n: int, restart: int, max_restarts: int):
    """Multilevel-V-cycle-preconditioned panel GMRES (the L-level
    generalization of :func:`_panel_gmres_tg`).

    ``lvl_ops``: tuple per intermediate level of (lvr, lvi, lecols,
    legather); ``lvl_dinv``: tuple per intermediate level of (ldvr, ldvi)
    [S, nb, bs, bs] host-inverted smoother planes; ``xfers``: tuple per
    level transition of (pell_cols, pell_vals, ptell_cols, ptell_vals);
    ``air/aii``: [S, nc, nc] deepest-level exact inverses.  The V-cycle
    recursion unrolls at trace time — every op is a gather/einsum/matmul,
    nothing that lowers to a loop program."""
    vals0 = jax.lax.complex(vr, vi)
    lvl_vals = [jax.lax.complex(a, b) for (a, b, _, _) in lvl_ops]

    def one_shift(c, Dinv0, Dlv, Acinv, B, X0):
        # per-level shifted data packed to ELL
        data0 = c @ vals0
        dell0 = jnp.concatenate([data0,
                                 jnp.zeros(1, data0.dtype)])[egather]
        dells, lcols = [dell0], [ecols]
        dinvs = [(Dinv0,)]
        for (lv, (_, _, lec, leg)) in zip(lvl_vals, lvl_ops):
            dk = c @ lv
            dells.append(jnp.concatenate(
                [dk, jnp.zeros(1, dk.dtype)])[leg])
            lcols.append(lec)
        for (ldr, ldi) in Dlv:
            dinvs.append((jax.lax.complex(ldr, ldi),))

        def spmv_k(k, x):
            return jnp.sum(dells[k] * x[lcols[k]], axis=1)

        def dinv_k(k, v):
            Dk = dinvs[k][0]
            nb, bs = Dk.shape[0], Dk.shape[1]
            nk = lcols[k].shape[0]
            vp = jnp.zeros(nb * bs, v.dtype).at[:nk].set(v)
            out = jnp.einsum("bij,bj->bi", Dk, vp.reshape(nb, bs))
            return out.reshape(-1)[:nk]

        n_lvl = len(xfers)     # transitions; deepest solve after the last

        def vcycle(k, v):
            """Approximately solve A_k y = v (k = 0 is the solve level)."""
            if k == n_lvl:
                return Acinv @ v
            pc, pvv, tc, tvv = xfers[k]
            pv = pvv.astype(v.dtype)
            tv = tvv.astype(v.dtype)
            y = dinv_k(k, v)
            r = v - spmv_k(k, y)
            y = y + jnp.sum(pv * vcycle(k + 1,
                                        jnp.sum(tv * r[tc], axis=1))[pc],
                            axis=1)
            r = v - spmv_k(k, y)
            return y + dinv_k(k, r)

        def one_col(b, x0):
            x, res, its = gmres_impl(lambda x: vcycle(0, spmv_k(0, x)),
                                     vcycle(0, b), x0=x0, tol=tol,
                                     restart=restart,
                                     max_restarts=max_restarts)
            return x, res, its

        return jax.vmap(one_col)(B, X0)

    X, res, its = jax.vmap(one_shift)(
        jax.lax.complex(cr, ci), jax.lax.complex(dvr, dvi),
        lvl_dinv, jax.lax.complex(air, aii), jax.lax.complex(br, bi),
        jax.lax.complex(xr, xi))
    return jnp.real(X), jnp.imag(X), res, its


def acinv_batch(cg: "CoarseGrid", coeffs: np.ndarray) -> np.ndarray:
    """[S, nc, nc] complex128 host inverses of the coarse operator at
    each shift's coefficient vector (one batched LAPACK inversion)."""
    nc = cg.n_coarse
    A = np.zeros((coeffs.shape[0], nc, nc), np.complex128)
    data = np.asarray(coeffs, np.complex128) @ cg.values    # [S, nnz_c]
    A[:, cg.crows, cg.ccols] = data
    return np.linalg.inv(A)


class ShiftedPanelSolver:
    """Matrix-free device solver for L(z) X = B panels at many shifts.

    Built once per operator family (structure, value stack and the
    diagonal-block scatter map are shift-independent); :meth:`solve`
    accepts any batch of shifts/RHS panels.  The UMFPACK-per-node role of
    the reference's contour quadrature (beyn.jl:62-74), re-designed as
    chunked vmapped GMRES + host-residual refinement."""

    def __init__(self, family, bs: int = 64, tol: float = 1e-8,
                 restart: int = 60, max_restarts: int = 50,
                 chunk: Optional[int] = None,
                 refine_sweeps: int = 4, refine_tol: float = 1e-11,
                 coarse: Optional[CoarseGrid] = None):
        self.family = family
        self.coarse = coarse
        S = family._stack()
        self._stack_obj = S
        self.n = int(S.shape[0])
        self.K = int(S.values.shape[0])
        self.nnz = int(S.nnz)
        self.bs = bs
        self.nb = -(-self.n // bs)
        self.restart = restart
        self.max_restarts = max_restarts
        self.refine_sweeps, self.refine_tol = refine_sweeps, refine_tol
        cdt = device_complex_dtype()
        self._rdt = np.float32 if cdt == np.complex64 else np.float64
        # f32 devices solve to their attainable ~1e-7 and rely on
        # refinement for the rest; an f64 backend can hit the refinement
        # target directly (no extra sweeps)
        self.tol = max(tol, 3e-7) if self._rdt == np.float32 \
            else min(tol, 0.1 * refine_tol)
        self._csize = 8 if cdt == np.complex64 else 16
        rows = np.asarray(S.row_ids(), np.int64)
        cols = np.asarray(S.indices, np.int64)
        self._rows64, self._cols64 = rows, cols
        from .sparse import csr_to_ell
        ecols, egather, _ = csr_to_ell(S.indptr, S.indices, self.n)
        self._ecols = ecols.astype(np.int32)
        self._egather = egather.astype(np.int32)
        self._vr, self._vi = _planes(S.values, self._rdt)
        if coarse is not None and coarse.n_fine != self.n:
            raise ValueError(f"prolongation n_fine {coarse.n_fine} != "
                             f"operator dim {self.n}")
        if isinstance(coarse, MultiGrid):
            # device-ready per-level operator planes + transfer ELLs
            self._mg_ops = tuple(
                (*_planes(values, self._rdt), ec, eg)
                for (values, _r, _c, ec, eg, _nk) in coarse.levels)
            self._mg_xfers = tuple(
                (pc, pv.astype(self._rdt), tc, tv.astype(self._rdt))
                for (pc, pv, tc, tv) in coarse.xfers)
        self._chunk = chunk
        # host-exact structure for refinement residuals
        import scipy.sparse as sp
        self._sp = sp
        self._indptr = np.asarray(S.indptr)
        self._indices = np.asarray(S.indices)
        self._values128 = np.asarray(S.values, np.complex128)
        # batched block-Jacobi structure (fine level + MultiGrid levels):
        # built once, inverted per chunk with ONE batched LAPACK call
        from .gmres import BatchedBlockDiagInv
        self._dbb = BatchedBlockDiagInv(rows, cols, self.n, bs)
        if isinstance(coarse, MultiGrid):
            self._mg_dbb = [
                BatchedBlockDiagInv(lrows, lcols, nk, coarse.bs)
                for (_v, lrows, lcols, _ec, _eg, nk) in coarse.levels]
        self.timings = {"prep_s": 0.0, "device_s": 0.0, "residual_s": 0.0}
        self.total_restarts = 0
        self.n_solves = 0

    # -- host helpers ------------------------------------------------------

    def coefficients(self, zs) -> np.ndarray:
        """[B, K] exact per-shift family coefficients."""
        L = self.family
        eig = L.eigval
        saved = L.params[eig]
        out = np.zeros((len(zs), self.K), np.complex128)
        for i, z in enumerate(np.asarray(zs)):
            L.params[eig] = complex(z)
            out[i] = L.coefficients({})
        L.params[eig] = saved
        return out

    def _host_csr(self, coeff):
        data = coeff @ self._values128
        return self._sp.csr_matrix((data, self._indices, self._indptr),
                                   shape=(self.n, self.n))

    def _auto_chunk(self, l: int) -> int:
        per_instance = (self.restart + 1) * self.n * self._csize * 2
        per_shift = (self.nb * self.bs * self.bs + 2 * self.nnz) * self._csize
        if self.coarse is not None:  # dense coarse inverse per shift
            per_shift += 2 * self.coarse.n_coarse ** 2 * self._csize
        c = int(PANEL_BUDGET // (l * per_instance + per_shift))
        return max(1, c)

    def default_group(self, l: int) -> int:
        """Natural shift-group size for contour drivers (one chunk)."""
        return self._chunk or self._auto_chunk(l)

    def _dinv_chunk(self, coeffs):
        """[c, nb, bs, bs] complex128 host block-Jacobi inverses, one
        batched LAPACK call over the whole chunk (per-shift Python loops
        would serialize the host prep)."""
        return self._dbb.inv(coeffs @ self._values128)

    def _acinv_chunk(self, coeffs):
        """[c, nc, nc] complex128 host coarse-operator inverses."""
        return acinv_batch(self.coarse, coeffs)

    def _mg_dinv_chunk(self, coeffs):
        """Per intermediate level: [c, nb_k, bs, bs] smoother inverses
        (batched over the chunk per level)."""
        return [dbb.inv(coeffs @ lvl[0])
                for dbb, lvl in zip(self._mg_dbb, self.coarse.levels)]

    # -- device passes -----------------------------------------------------

    def _solve_chunks(self, coeffs, B, X0=None):
        """Raw device pass: [S,K] coeffs, [S,l,n] RHS -> [S,l,n] X c128.

        ``X0``: optional [S,l,n] warm-start iterates (e.g. the solution at
        a neighboring contour node)."""
        import time as _time
        Sn = coeffs.shape[0]
        l = B.shape[1]
        cmax = self._chunk or self._auto_chunk(l)
        X = np.empty((Sn, l, self.n), np.complex128)
        res = np.empty((Sn, l), np.float64)
        tol = np.asarray(self.tol, self._rdt)
        s0 = 0
        while s0 < Sn:
            # power-of-two chunk sizes, never exceeding the remaining batch
            # rounded up: bounds both padding waste (<2×) and the number of
            # distinct compiled shapes (≤ log₂ cmax over the lifetime —
            # refinement calls with shrinking live sets reuse them)
            rem = Sn - s0
            chunk = min(cmax, 1 << (rem - 1).bit_length())
            s1 = min(s0 + chunk, Sn)
            pad = chunk - (s1 - s0)
            c = coeffs[s0:s1]
            b = B[s0:s1]
            x0 = (X0[s0:s1] if X0 is not None
                  else np.zeros_like(b))
            if pad:  # fixed chunk shape -> one compiled program
                c = np.concatenate([c, np.repeat(c[-1:], pad, 0)])
                b = np.concatenate([b, np.repeat(b[-1:], pad, 0)])
                x0 = np.concatenate([x0, np.repeat(x0[-1:], pad, 0)])
            t0 = _time.perf_counter()
            Dinv = self._dinv_chunk(c)
            if self.coarse is None:
                args = ()
                fn = _panel_gmres
                kw = {}
            elif isinstance(self.coarse, MultiGrid):
                Acinv = acinv_batch(self.coarse, c)
                lvl_dinv = tuple(_planes(Dk, self._rdt)
                                 for Dk in self._mg_dinv_chunk(c))
                args = (self._mg_ops, lvl_dinv, self._mg_xfers,
                        *_planes(Acinv, self._rdt))
                fn = _panel_gmres_mg
                kw = {}
            else:
                cg = self.coarse
                Acinv = self._acinv_chunk(c)
                args = (*_planes(Acinv, self._rdt),
                        cg.pell_cols, cg.pell_vals.astype(self._rdt),
                        cg.ptell_cols, cg.ptell_vals.astype(self._rdt))
                fn = _panel_gmres_tg
                kw = {"nc": cg.n_coarse}
            t1 = _time.perf_counter()
            Xr, Xi, r, its = fn(
                self._vr, self._vi, self._ecols, self._egather,
                *_planes(Dinv, self._rdt), *args,
                *_planes(c, self._rdt), *_planes(b, self._rdt),
                *_planes(x0, self._rdt), tol,
                n=self.n, restart=self.restart,
                max_restarts=self.max_restarts, **kw)
            Xr, Xi = np.asarray(Xr), np.asarray(Xi)
            r, its = np.asarray(r), np.asarray(its)
            t2 = _time.perf_counter()
            self.timings["prep_s"] += t1 - t0
            self.timings["device_s"] += t2 - t1
            self.total_restarts += int(its[:s1 - s0].sum())
            self.n_solves += (s1 - s0) * l
            X[s0:s1] = (Xr.astype(np.float64)
                        + 1j * Xi.astype(np.float64))[:s1 - s0]
            res[s0:s1] = r[:s1 - s0]
            s0 = s1
        return X, res

    def solve(self, zs, V, output: bool = False, X0=None):
        """X[j] = L(z_j)⁻¹ V to complex128 accuracy.

        ``zs``: [S] shifts; ``V``: [n, l] shared probe panel or [S, n, l]
        per-shift RHS.  ``X0``: optional [S, n, l] warm-start iterates.
        Returns (X [S, n, l], info) where info carries the final exact
        relative residuals per shift."""
        import time as _time
        zs = np.asarray(zs)
        Sn = len(zs)
        V = np.asarray(V, np.complex128)
        if V.ndim == 2:
            Bfull = np.broadcast_to(V.T[None], (Sn,) + V.T.shape).copy()
        else:
            Bfull = np.ascontiguousarray(np.swapaxes(V, 1, 2))   # [S, l, n]
        if X0 is not None:
            X0 = np.ascontiguousarray(
                np.swapaxes(np.asarray(X0, np.complex128), 1, 2))
        l = Bfull.shape[1]
        coeffs = self.coefficients(zs)
        mats = [self._host_csr(coeffs[j]) for j in range(Sn)]
        # residuals are judged in the ROW-EQUILIBRATED norm ‖S(b−Ax)‖ with
        # S = diag(1/maxⱼ|Aᵢⱼ|): penalty-BC rows (Y~1e15) otherwise
        # dominate the plain norm by ~16 orders of magnitude, and the
        # device GMRES minimizes exactly this scaled (left-preconditioned)
        # residual — an unscaled acceptance test would reject every
        # correction the device path can produce
        srow = np.empty((Sn, self.n))
        for j in range(Sn):
            rm = np.abs(mats[j]).max(axis=1).toarray().ravel()
            srow[j] = 1.0 / np.where(rm == 0, 1.0, rm)
        bnorm = np.linalg.norm(Bfull * srow[:, None, :], axis=2)  # [S, l]
        bnorm = np.where(bnorm == 0, 1.0, bnorm)

        best, _ = self._solve_chunks(coeffs, Bfull, X0=X0)
        t_res = _time.perf_counter()
        best_res = np.empty((Sn, l))
        R = np.empty_like(Bfull)
        for j in range(Sn):  # exact c128 residuals
            R[j] = Bfull[j] - (mats[j] @ best[j].T).T
            best_res[j] = np.linalg.norm(R[j] * srow[j], axis=1) / bnorm[j]
        self.timings["residual_s"] += _time.perf_counter() - t_res
        prev_max = np.inf
        for sweep in range(self.refine_sweeps):
            live = np.where(np.any(best_res > self.refine_tol, axis=1))[0]
            cur_max = float(best_res.max())
            if output:
                print(f"panel refine sweep {sweep}: max relres "
                      f"{cur_max:.3e}, {len(live)} shifts live")
            # stop on convergence or stagnation (the device solver has
            # reached its attainable accuracy — keep the best iterate)
            if len(live) == 0 or cur_max > 0.25 * prev_max:
                break
            prev_max = cur_max
            dX, _ = self._solve_chunks(coeffs[live], R[live])
            cand = best[live] + dX
            t_res = _time.perf_counter()
            # accept per-column only if the exact residual improved
            for i, j in enumerate(live):
                Rc = Bfull[j] - (mats[j] @ cand[i].T).T
                rc = np.linalg.norm(Rc * srow[j], axis=1) / bnorm[j]
                upd = rc < best_res[j]
                best[j][upd] = cand[i][upd]
                best_res[j][upd] = rc[upd]
                R[j][upd] = Rc[upd]
            self.timings["residual_s"] += _time.perf_counter() - t_res
        info = {"relres": best_res, "max_relres": float(best_res.max()),
                "timings": dict(self.timings),
                "restarts_per_solve": (self.total_restarts
                                       / max(self.n_solves, 1))}
        return np.ascontiguousarray(np.swapaxes(best, 1, 2)), info


def solve_shifted_panel(family, zs, V, **kw):
    """One-shot convenience wrapper around :class:`ShiftedPanelSolver`."""
    output = kw.pop("output", False)
    return ShiftedPanelSolver(family, **kw).solve(zs, V, output=output)


__all__ = ["ShiftedPanelSolver", "solve_shifted_panel", "CoarseGrid",
           "MultiGrid", "acinv_batch", "PANEL_BUDGET"]

"""Device-side restarted GMRES for shifted sparse systems.

The reference hands every shifted solve L(z)x = b to UMFPACK
(SparseArrays.lu — Householder.jl:100, beyn.jl:62-74).  On the device
the large / row-partitioned regime instead uses matrix-free GMRES(m):
the Arnoldi loop is a fixed-shape `lax.fori_loop` (jit-compiles once per
(n, m)), the matvec is any jittable closure — the XLA BSR SpMM, the
distributed halo-exchange SpMV, or a plain XLA scatter SpMV — and many
independent shifts batch with `jax.vmap` (the Beyn quadrature axis).

Everything is complex-dtype jax.numpy.

A block-Jacobi right preconditioner built from the assembled diagonal
blocks is provided (`block_jacobi`) — the natural choice for the
RCM-reordered FEM operators whose mass is near the diagonal.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


def _givens(a, b):
    """Complex Givens rotation zeroing b: returns (c, s) with
    [c  s; -conj(s) c]ᴴ-style application, c real.

    All scalar constants are materialized in the operand dtypes: weak-typed
    f64/c128 literals would promote complex64 work to complex128."""
    rone = jnp.ones((), jnp.abs(a).dtype)
    cone = jnp.ones((), a.dtype)
    czero = jnp.zeros((), a.dtype)
    denom = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(b) ** 2)
    safe = jnp.where(denom == 0, rone, denom)
    c = jnp.where(denom == 0, rone, jnp.abs(a) / safe)
    absa = jnp.abs(a)
    phase = a / jnp.where(absa == 0, rone, absa)
    s = jnp.where(denom == 0, czero,
                  jnp.where(absa == 0, cone, phase * jnp.conj(b) / safe))
    return c, s


def gmres_impl(matvec: Callable, b: jnp.ndarray,
               x0: Optional[jnp.ndarray] = None, tol: float = 1e-8,
               restart: int = 40, max_restarts: int = 20,
               precond: Optional[Callable] = None,
               reduce_fn: Optional[Callable] = None,
               stagnation: float = 0.9,
               vma_axes: tuple = ()):
    """Unjitted GMRES(m) body — call this from *inside* an already-jitted
    program (fresh closures would defeat :func:`gmres`'s jit cache there);
    top-level callers use the jitted :func:`gmres` wrapper below.

    ``reduce_fn``: cross-shard sum for inner products (identity when the
    vectors are whole).  Under ``shard_map`` with row-sharded vectors pass
    ``lambda s: lax.psum(s, 'row')`` — every norm/dot here reduces through
    it, so the SAME Arnoldi body runs distributed (the small rotated
    least-squares state is then replicated per shard).

    ``stagnation``: stop restarting when a restart improves the residual
    by less than this factor (res >= stagnation·prev) — appropriate for
    mixed-precision callers that recover accuracy by refinement, where
    iterating at the dtype's attainable accuracy only burns matvecs.
    Pass ``float('inf')`` to disable (restarted GMRES on indefinite
    operators can plateau for a few restarts before converging; the
    public :func:`gmres` wrapper defaults to disabled)."""
    dtype = b.dtype
    n = b.shape[0]
    m = restart
    if x0 is None:
        x0 = jnp.zeros_like(b)
    # Inside shard_map with per-axis-varying operator data, loop carries
    # initialized from constants are axis-INVARIANT while the body's
    # updates are axis-VARYING — scan/while type-check (check_vma)
    # rejects the mix.  Callers under a varying mesh axis pass its name
    # so every zero init is pcast to varying up front.
    if vma_axes:
        def vcast(t):
            try:
                return jax.lax.pcast(t, vma_axes, to="varying")
            except ValueError:
                return t          # already varying over these axes
    else:
        vcast = lambda t: t
    x0 = vcast(x0)
    Minv = precond if precond is not None else (lambda v: v)
    reduce_ = reduce_fn if reduce_fn is not None else (lambda s: s)

    def vnorm(v):
        return jnp.sqrt(jnp.real(reduce_(jnp.sum(jnp.abs(v) ** 2))))

    rdtype = jnp.zeros(0, dtype).real.dtype
    rone = jnp.ones((), rdtype)
    czero = jnp.zeros((), dtype)
    bnorm = vnorm(b)
    bnorm = jnp.where(bnorm == 0, rone, bnorm)

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = vnorm(r)
        V = vcast(jnp.zeros((m + 1, n), dtype))
        H = vcast(jnp.zeros((m + 1, m), dtype))
        V = V.at[0].set(r / jnp.where(beta == 0, rone, beta))
        # Givens-rotated least-squares state (cs real in b's REAL dtype:
        # a float64 default would promote complex64 work to complex128)
        cs = vcast(jnp.zeros(m, rdtype))
        sn = vcast(jnp.zeros(m, dtype))
        g = vcast(jnp.zeros(m + 1, dtype)).at[0].set(beta.astype(dtype))

        def body(j, carry):
            V, H, cs, sn, g = carry
            w = matvec(Minv(V[j]))
            # classical Gram-Schmidt WITH re-orthogonalization (CGS2):
            # one-pass CGS loses orthogonality like ε·κ², flooring the
            # attainable residual near √ε — at float32 that is ~1e-4,
            # which poisons both convergence and the refinement loop
            # built on top.  The second projection restores orthogonality
            # to O(ε) for one extra fused einsum per iteration.  (Fixed
            # shape over all m+1 rows; rows > j are zero so dots vanish.)
            mask = (jnp.arange(m + 1) <= j)
            h1 = reduce_(jnp.einsum("kn,n->k", jnp.conj(V), w))
            h1 = jnp.where(mask, h1, czero)
            w = w - jnp.einsum("k,kn->n", h1, V)
            h2 = reduce_(jnp.einsum("kn,n->k", jnp.conj(V), w))
            h2 = jnp.where(mask, h2, czero)
            w = w - jnp.einsum("k,kn->n", h2, V)
            h = h1 + h2
            hn = vnorm(w)
            V2 = V.at[j + 1].set(w / jnp.where(hn == 0, rone, hn))
            Hcol = h.at[j + 1].set(hn.astype(dtype))
            # apply accumulated rotations to the new column
            def rot(i, col):
                hi = cs[i] * col[i] + sn[i] * col[i + 1]
                hip = -jnp.conj(sn[i]) * col[i] + cs[i] * col[i + 1]
                return col.at[i].set(hi).at[i + 1].set(hip)
            Hcol = jax.lax.fori_loop(0, j, rot, Hcol)
            c, s = _givens(Hcol[j], Hcol[j + 1])
            Hcol = Hcol.at[j].set(c * Hcol[j]
                                  + s * Hcol[j + 1]).at[j + 1].set(czero)
            g2 = g.at[j + 1].set(-jnp.conj(s) * g[j]).at[j].set(c * g[j]
                                                                + s * g[j + 1])
            return (V2, H.at[:, j].set(Hcol), cs.at[j].set(c),
                    sn.at[j].set(s), g2)

        V, H, cs, sn, g = jax.lax.fori_loop(0, m, body, (V, H, cs, sn, g))
        # back substitution on the m×m triangular H
        cone = jnp.ones((), dtype)

        def back(i_rev, y):
            i = m - 1 - i_rev
            num = g[i] - jnp.dot(H[i, :], y)
            return y.at[i].set(num / jnp.where(H[i, i] == 0, cone, H[i, i]))
        y = jax.lax.fori_loop(0, m, back, vcast(jnp.zeros(m, dtype)))
        x_new = x + Minv(jnp.einsum("k,kn->n", y, V[:m]))
        return x_new

    tol_r = jnp.asarray(tol, rdtype)
    stag_r = jnp.asarray(stagnation, rdtype)

    def cond(state):
        x, it, res, prev = state
        # stop on convergence, budget, or stagnation (see docstring)
        return jnp.logical_and(
            jnp.logical_and(it < max_restarts, res > tol_r),
            res < stag_r * prev)

    def step(state):
        x, it, res, _ = state
        x = arnoldi_cycle(x)
        res_new = vnorm(b - matvec(x)) / bnorm
        return (x, it + 1, res_new, res)

    res0 = vnorm(b - matvec(x0)) / bnorm
    inf0 = vcast(jnp.asarray(jnp.inf, rdtype))
    x, its, res, _ = jax.lax.while_loop(cond, step,
                                        (x0, vcast(jnp.array(0)), res0,
                                         inf0))
    return x, res, its


gmres = partial(jax.jit, static_argnames=("matvec", "precond", "restart",
                                          "max_restarts", "reduce_fn",
                                          "stagnation"))(
    partial(gmres_impl, stagnation=float("inf")))
gmres.__doc__ = """Restarted GMRES(m) for A x = b with an optional RIGHT
preconditioner (solves A M⁻¹ u = b, x = M⁻¹ u — residuals are true
residuals).  Returns (x, relres, n_restarts).  Fully jit-compiled: the
Arnoldi inner loop is fixed shape ``restart``; convergence is checked per
restart in a `lax.while_loop`.  The stagnation cutoff is DISABLED here
(runs to tol or max_restarts); mixed-precision callers that refine on top
pass an explicit ``stagnation`` factor (see :func:`gmres_impl`)."""


def _block_diag_inv(rows, cols, data, n: int, bs: int) -> np.ndarray:
    """[nb, bs, bs] inverted diagonal blocks of a COO matrix (duplicates
    summed); empty pad rows regularized to identity."""
    nb = (n + bs - 1) // bs
    D = np.zeros((nb, bs, bs), np.complex128)
    sel = (rows // bs) == (cols // bs)
    np.add.at(D, (rows[sel] // bs, rows[sel] % bs, cols[sel] % bs),
              data[sel])
    idx = np.arange(bs)
    dead = np.abs(D[:, idx, idx]) == 0
    D[:, idx, idx] = np.where(dead, 1.0, D[:, idx, idx])
    return np.linalg.inv(D)


class BatchedBlockDiagInv:
    """Precomputed diagonal-block structure for inverting the [bs,bs]
    block-Jacobi smoother at MANY shifts in one shot: structure indices
    are built once, each batch is one fancy-index scatter + one batched
    LAPACK inversion — no per-shift Python loop (the per-chunk host-prep
    cost that previously serialized the matrix-free Beyn quadrature)."""

    def __init__(self, rows, cols, n: int, bs: int):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        self.n, self.bs = int(n), int(bs)
        self.nb = (n + bs - 1) // bs
        sel = (rows // bs) == (cols // bs)
        self.sel = np.where(sel)[0]
        self.bi = rows[self.sel] // bs
        self.ri = rows[self.sel] % bs
        self.ci = cols[self.sel] % bs
        # COO inputs may carry duplicate entries (to be summed); union-CSR
        # patterns are unique and take the direct-assignment fast path
        key = (self.bi * bs + self.ri) * bs + self.ci
        self.unique = len(np.unique(key)) == len(key)

    def inv(self, data: np.ndarray) -> np.ndarray:
        """[c, nnz] per-shift data -> [c, nb, bs, bs] inverted blocks."""
        data = np.atleast_2d(np.asarray(data, np.complex128))
        c = data.shape[0]
        D = np.zeros((c, self.nb, self.bs, self.bs), np.complex128)
        if self.unique:
            D[:, self.bi, self.ri, self.ci] = data[:, self.sel]
        else:
            np.add.at(D, (np.arange(c)[:, None], self.bi[None, :],
                          self.ri[None, :], self.ci[None, :]),
                      data[:, self.sel])
        idx = np.arange(self.bs)
        diag = D[:, :, idx, idx]
        D[:, :, idx, idx] = np.where(np.abs(diag) == 0, 1.0, diag)
        return np.linalg.inv(D)


def _block_apply(Dinv_dev, n: int):
    """Jittable closure v ↦ D⁻¹v over the device block inverses."""
    nb, bs = Dinv_dev.shape[0], Dinv_dev.shape[1]
    npad = nb * bs

    def apply(v):
        vp = jnp.zeros(npad, v.dtype).at[:n].set(v)
        out = jnp.einsum("bij,bj->bi", Dinv_dev, vp.reshape(nb, bs))
        return out.reshape(-1)[:n]

    return apply


def block_jacobi(A, bs: int = 64):
    """Right preconditioner v ↦ D⁻¹v from the inverted [bs,bs] diagonal
    blocks of a host CSR matrix (the standard smoother for RCM-ordered FEM
    operators).  The block inverses stay HOST numpy and are embedded as
    program constants by jit."""
    from ..utils.config import device_complex_dtype
    rows, cols, vals = A.to_coo()
    Dinv = _block_diag_inv(np.asarray(rows, np.int64),
                           np.asarray(cols, np.int64),
                           np.asarray(vals, np.complex128), A.shape[0], bs)
    return _block_apply(Dinv.astype(device_complex_dtype()), A.shape[0])


def solve_shifted_batch(family, zs, B, tol: float = 1e-8, restart: int = 60,
                        max_restarts: int = 50, bs: int = 64):
    """Solve L(z_s) X_s = B_s for a batch of shifts on device — the Beyn
    quadrature axis (beyn.jl:62-74) as one vmapped GMRES.

    ``family``: an OperatorFamily; ``zs``: [S] complex shifts; ``B``:
    [S, n] right-hand sides.  Uses the union-pattern stacked operator (one
    gather/scatter structure for every shift) and per-shift LEFT
    block-Jacobi preconditioners.  Returns [S, n] solutions (host
    complex); the reported residuals are the *preconditioned* residuals
    ‖D⁻¹(b−Ax)‖/‖D⁻¹b‖.

    Batched complex inputs ship as (re, im) float planes recombined with
    lax.complex inside the jitted function; shift-independent complex
    data (the value stack) stays host numpy and is embedded as a program
    constant.  With a complex64 compute dtype, use :func:`.refine.refine`
    on top for complex128 accuracy when κ(D⁻¹A)·ε_f32 ≪ 1."""
    from ..utils.config import device_complex_dtype
    cdt = device_complex_dtype()
    rdt = np.float32 if cdt == np.complex64 else np.float64
    S = family._stack()
    vals_h = S.values.astype(cdt)             # [K, nnz] host constant
    rows = np.asarray(S.row_ids(), np.int32)
    cols = np.asarray(S.indices, np.int32)
    n = S.shape[0]

    zs = np.asarray(zs)
    coeffs = np.zeros((len(zs), vals_h.shape[0]), np.complex128)
    eig = family.eigval
    z_saved = family.params[eig]
    for i, z in enumerate(zs):
        family.params[eig] = complex(z)
        coeffs[i] = family.coefficients({})
    family.params[eig] = z_saved

    # per-shift block-Jacobi built on host (sparse diag extraction)
    r_h, c_h = np.asarray(S.row_ids()), np.asarray(S.indices)
    vals_full = np.asarray(S.values)
    Dinv = np.stack([_block_diag_inv(r_h, c_h, coeffs[i] @ vals_full, n, bs)
                     for i in range(len(zs))])
    nb = Dinv.shape[1]
    npad = nb * bs

    def solve_one(cr, ci, dr, di, br, bi):
        c = jax.lax.complex(cr, ci)
        Dinv_s = jax.lax.complex(dr, di)
        b_s = jax.lax.complex(br, bi)
        data = c @ vals_h

        def spmv(x):
            return jnp.zeros(n, data.dtype).at[rows].add(data * x[cols])

        def dinv(v):
            vp = jnp.zeros(npad, v.dtype).at[:n].set(v)
            out = jnp.einsum("bij,bj->bi", Dinv_s, vp.reshape(nb, bs))
            return out.reshape(-1)[:n]

        # LEFT block-Jacobi: D⁻¹A x = D⁻¹b.  Left (not right) because
        # penalty-BC operators have rows spanning ~16 orders of magnitude;
        # left scaling normalizes them so single precision converges
        # (right scaling leaves the huge rows in the residual norm).
        x, res, its = gmres(lambda x: dinv(spmv(x)), dinv(b_s), tol=tol,
                            restart=restart, max_restarts=max_restarts,
                            stagnation=0.9)
        return jnp.real(x), jnp.imag(x), res

    def planes(x):
        x = np.asarray(x)
        return (np.ascontiguousarray(x.real).astype(rdt),
                np.ascontiguousarray(x.imag).astype(rdt))

    Xr, Xi, res = jax.jit(jax.vmap(solve_one))(*planes(coeffs), *planes(Dinv),
                                               *planes(np.asarray(B)))
    return np.asarray(Xr) + 1j * np.asarray(Xi), np.asarray(res)


__all__ = ["gmres", "block_jacobi", "solve_shifted_batch",
           "BatchedBlockDiagInv"]

"""Distributed / device-batched Beyn contour integration.

The premier batching axis of the NLEVP stack (SURVEY §2.9 #2): the
|Γ|·N contour-quadrature solves L(z_j)⁻¹V are independent.  Here they are
(a) assembled on device from the family's stacked layout (coefficient
contraction + scatter), (b) LU-solved as one batched dense solve,
and (c) reduced into moment matrices with a ``psum`` over the shift axis
of the device mesh.  The small dense eigen-tail (SVD + eig) stays on
host.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..nlevp.family import OperatorFamily
from ..nlevp.solvers import gauss_nodes, moments2eigs, pos_test
from ..ops.sparse import StackedOperator
from ..utils.config import device_complex_dtype


def _family_device_data(L: OperatorFamily, dtype):
    """Family stack as HOST arrays: complex values stay numpy so jit
    embeds them as program constants."""
    S = L._stack()
    values = S.values.astype(dtype)                       # [K, nnz] host
    rows = np.asarray(S.row_ids(), np.int32)
    cols = np.asarray(S.indices, np.int32)
    return values, rows, cols, S.shape[0]


def _coeff_batch(L: OperatorFamily, zs: np.ndarray) -> np.ndarray:
    """Per-term coefficients at each quadrature node (host, exact)."""
    eig = L.eigval
    saved = L.params[eig]
    out = np.zeros((len(zs), len(L.terms)), dtype=np.complex128)
    for b, z in enumerate(zs):
        L.params[eig] = complex(z)
        out[b] = L.coefficients({})
    L.params[eig] = saved
    return out


#: above this dimension ``dense=None`` switches to the matrix-free path
DENSE_BEYN_MAX_DIM = 4096


#: GMRES-only solver keywords — their presence pins ``method="auto"`` to
#: the iterative panel path
_GMRES_KW = {"bs", "tol", "restart", "max_restarts", "coarse"}


def _make_matfree_solver(L: OperatorFamily, method: str, solver_kw: dict):
    """Construct the matrix-free panel solver backend.

    ``method``: "slab" (block-tridiagonal direct, :mod:`..ops.slab_solve`),
    "gmres" (multigrid-preconditioned iterative,
    :mod:`..ops.panel_solve`), or "auto" — slab when the BFS slab
    partition is favorable and no GMRES-specific keyword was passed."""
    from ..ops.panel_solve import ShiftedPanelSolver
    from ..ops.slab_solve import SlabSolver
    if method == "auto":
        if _GMRES_KW & set(solver_kw):
            method = "gmres"
        else:
            probe = SlabSolver(L, **solver_kw)
            # favorable: enough slabs to amortize, blocks small enough
            # for the batched dense factorization to stay efficient
            if probe.part.m >= 8 and probe.part.smax <= 2048:
                return probe
            method = "gmres"
    if method == "slab":
        return SlabSolver(L, **solver_kw)
    if method == "gmres":
        return ShiftedPanelSolver(L, **solver_kw)
    raise ValueError(f"unknown matfree method {method!r} "
                     "(expected 'slab', 'gmres' or 'auto')")


def matfree_moments(L: OperatorFamily, Gamma, V=None, l=5, K=1, N=16,
                    output=False, group: Optional[int] = None,
                    checkpoint: Optional[str] = None, method: str = "auto",
                    **solver_kw):
    """Moment matrices via the matrix-free device panel solver — the
    scalable path (no [d,d] materialization anywhere).  ``method``
    selects the backend: "slab" = block-tridiagonal direct solver
    (:mod:`..ops.slab_solve`, the fast path for mesh operators),
    "gmres" = multigrid-preconditioned panel GMRES
    (:mod:`..ops.panel_solve`), "auto" picks slab when the partition is
    favorable.  Solver keywords (``chunk``, ``refine_tol``, …; for
    gmres also ``bs``, ``tol``, ``restart``, ``coarse``) pass through to
    the backend constructor.

    Nodes are processed in groups of ``group`` shifts (default: the
    solver chunk) and reduced into the moment sums immediately, bounding
    host memory to one group of solutions.  ``checkpoint``: optional npz
    path — partial moment sums persist after every group and a preempted
    contour integration resumes at the last completed group (digest over
    contour, probe block, K and the family's parameters/terms, matching
    nlevp.solvers.compute_moment_matrices)."""
    import hashlib
    import os

    from ..nlevp.solvers import initialize_V
    d = L.size
    if V is None:
        V = initialize_V(d, l)
    V = np.asarray(V)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    B = len(zs)
    solver = _make_matfree_solver(L, method, solver_kw)
    g = group or solver.default_group(l)
    powers = ws[:, None] * zs[:, None] ** np.arange(2 * K)[None, :]
    A = np.zeros((d, l, 2 * K), np.complex128)
    start = 0
    digest = ""
    if checkpoint:
        h = hashlib.sha256()
        for part in (zs.tobytes(), ws.tobytes(), V.tobytes(),
                     str(K).encode()):
            h.update(part)
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
                        print(f"resuming matfree moments at node "
                              f"{start}/{B}")
                elif output:
                    print("checkpoint digest mismatch — recomputing")
    max_relres = 0.0
    for s0 in range(start, B, g):
        s1 = min(s0 + g, B)
        X, info = solver.solve(zs[s0:s1], V, output=output)   # [g, d, l]
        max_relres = max(max_relres, info["max_relres"])
        A += np.einsum("bp,bil->ilp", powers[s0:s1], X)
        if checkpoint:
            tmp = checkpoint + ".tmp.npz"
            np.savez(tmp, A=A, next=s1, digest=digest)
            os.replace(tmp, checkpoint)
        if output:
            print(f"matfree moments: nodes {s1}/{B} done")
    return A.astype(np.complex128), {
        "max_relres": max_relres,
        # per-phase wall profile of the panel solver (VERDICT r3 #3):
        # prep (host coefficient/equilibration), device (transfers +
        # factor/re-solve dispatches), residual (host c128 residuals)
        "solver_timings": dict(getattr(solver, "timings", {}))}


def batched_moments(L: OperatorFamily, Gamma, V=None, l=5, K=1, N=16,
                    mesh: Optional[Mesh] = None, axis: str = "shift",
                    dtype=None):
    """Moment matrices A_p = Σ_j w_j z_j^p L(z_j)⁻¹V computed as one batched
    dense LU solve over all quadrature nodes — sharded over ``axis`` when a
    device mesh is given (each chip solves its node subset; the weighted
    sums reduce with psum)."""
    dtype = dtype or device_complex_dtype()
    d = L.size
    if V is None:
        from ..nlevp.solvers import initialize_V
        V = initialize_V(d, l)
    V = np.asarray(V)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    B = len(zs)
    coeffs = _coeff_batch(L, zs)                      # [B, K]
    values, rows, cols, _ = _family_device_data(L, dtype)

    # pad batch to a multiple of the mesh axis size
    n_dev = mesh.shape[axis] if mesh is not None else 1
    Bp = -(-B // n_dev) * n_dev
    cpad = np.zeros((Bp, coeffs.shape[1]), coeffs.dtype)
    cpad[:B] = coeffs
    cpad[B:] = coeffs[0]  # padded solves reuse a regular node (weight 0)
    zpad = np.zeros(Bp, np.complex128)
    zpad[:B] = zs
    wpad = np.zeros(Bp, np.complex128)
    wpad[:B] = ws
    # powers z^p·w for p = 0..2K-1: [Bp, 2K]
    powers = wpad[:, None] * zpad[:, None] ** np.arange(2 * K)[None, :]

    Vr = np.ascontiguousarray(V.real).astype(np.float32 if dtype == np.complex64
                                             else np.float64)
    Vi = np.ascontiguousarray(V.imag).astype(Vr.dtype)
    cr = np.ascontiguousarray(cpad.real).astype(Vr.dtype)
    ci = np.ascontiguousarray(cpad.imag).astype(Vr.dtype)
    pr = np.ascontiguousarray(powers.real).astype(Vr.dtype)
    pi = np.ascontiguousarray(powers.imag).astype(Vr.dtype)

    def node_solve(c_re, c_im, Vc):
        c = jax.lax.complex(c_re, c_im).astype(dtype)
        data = c @ values
        A = jnp.zeros((d, d), dtype).at[rows, cols].set(data)
        return jnp.linalg.solve(A, Vc)

    def moments_local(cr_l, ci_l, pr_l, pi_l, Vr_, Vi_):
        Vc = jax.lax.complex(Vr_, Vi_).astype(dtype)
        X = jax.vmap(node_solve, in_axes=(0, 0, None))(cr_l, ci_l, Vc)
        pw = jax.lax.complex(pr_l, pi_l).astype(dtype)  # [b, 2K]
        Am = jnp.einsum("bp,bil->ilp", pw, X)
        return jnp.real(Am), jnp.imag(Am)

    if mesh is None:
        f = jax.jit(moments_local)
        Ar, Ai = f(cr, ci, pr, pi, Vr, Vi)
    else:
        from jax import shard_map

        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
                 out_specs=(P(), P()))
        def f(cr_l, ci_l, pr_l, pi_l, Vr_, Vi_):
            Ar, Ai = moments_local(cr_l, ci_l, pr_l, pi_l, Vr_, Vi_)
            return jax.lax.psum(Ar, axis), jax.lax.psum(Ai, axis)

        Ar, Ai = f(cr, ci, pr, pi, Vr, Vi)
    return (np.asarray(Ar) + 1j * np.asarray(Ai)).astype(np.complex128)


def beyn_batched(L: OperatorFamily, Gamma, l=5, K=1, N=16, tol=0.0,
                 rtol=0.0, pos_test_flag=True, mesh: Optional[Mesh] = None,
                 axis: str = "shift", dtype=None, dense: Optional[bool] = None,
                 output=False, method: str = "auto",
                 res_tol: Optional[float] = None,
                 return_residuals: bool = False,
                 return_info: bool = False, **solver_kw):
    """Beyn's algorithm with device-batched (and optionally chip-sharded)
    quadrature (drop-in for nlevp.solvers.beyn; ``tol``/``rtol`` are the
    absolute/relative singular-value cutoffs of the Hankel SVD filter).

    ``dense``: True → batched dense LU per node (fastest below ~4k DOF);
    False → matrix-free panel solves (scales with nnz, the regime the
    reference serves with UMFPACK, beyn.jl:62-74); None → auto by size.
    ``method``: matrix-free backend ("slab"/"gmres"/"auto", see
    :func:`matfree_moments`).  ``res_tol``: per-eigenpair sparse residual
    cutoff ‖L(ω)v‖/(‖L‖‖v‖); None keeps every σ-filtered candidate and
    only reports residuals (see :func:`..nlevp.solvers.verify_eigenpairs`)."""
    from ..nlevp.solvers import verify_eigenpairs
    d = L.size
    # minimum augmentation so the Hankel blocks can hold l probes —
    # identical to the reference's K=max(K, l÷d + (l%d≠0)) at beyn.jl:39
    K = max(K, (l + d - 1) // d)
    if dense is None:
        dense = d <= DENSE_BEYN_MAX_DIM
    _info = {}
    if dense:
        if solver_kw:
            import warnings
            warnings.warn(
                "beyn_batched: dense path selected — matrix-free solver "
                f"keywords {sorted(solver_kw)} are ignored; pass "
                "dense=False to force the matrix-free path",
                stacklevel=2)
        A = batched_moments(L, Gamma, l=l, K=K, N=N, mesh=mesh, axis=axis,
                            dtype=dtype)
    else:
        A, _info = matfree_moments(L, Gamma, l=l, K=K, N=N, output=output,
                                   method=method, **solver_kw)
    Om, Pv = moments2eigs([A], tol_sigma=tol, rtol_sigma=rtol)
    if pos_test_flag:
        Om, Pv = pos_test(Om, Pv, Gamma)
    Om, Pv, res = verify_eigenpairs(L, Om, Pv, res_tol=res_tol,
                                    output=output)
    out = [Om, Pv]
    if return_residuals:
        out.append(res)
    if return_info:
        out.append(_info)
    return tuple(out)


def dist_moments(L: OperatorFamily, Gamma, mesh: Mesh, n_row_parts: int,
                 V=None, l=5, K=1, N=16, row_axis: str = "row",
                 shift_axis: Optional[str] = "shift", **solver_kw):
    """Moment matrices with FULLY distributed node solves: the operator
    row-sharded over ``row_axis`` (halo-exchange SpMV inside GMRES, psum
    inner products) and the quadrature shifts riding ``shift_axis``
    communication-free — the complete 2-D re-design of the reference's
    serial quadrature loop (beyn.jl:62-74) over a device mesh.

    Solver keywords pass to :func:`.dist_solve.make_dist_gmres`."""
    from .dist_solve import make_dist_gmres
    from .partition import partition_stack
    d = L.size
    if V is None:
        from ..nlevp.solvers import initialize_V
        V = initialize_V(d, l)
    V = np.asarray(V)
    d, l = V.shape
    zs, ws = gauss_nodes(Gamma, N)
    B = len(zs)
    n_shift = mesh.shape[shift_axis] if shift_axis else 1
    part = partition_stack(L._stack(), n_row_parts)
    solve = make_dist_gmres(part, mesh, row_axis=row_axis,
                            shift_axis=shift_axis, **solver_kw)
    coeffs = _coeff_batch(L, zs)
    Bp = -(-B // n_shift) * n_shift
    cpad = np.concatenate([coeffs,
                           np.repeat(coeffs[-1:], Bp - B, 0)])
    Vt = np.broadcast_to(V.T[None], (Bp, l, d))
    X = np.empty((B, l, d), np.complex128)
    for s0 in range(0, Bp, n_shift):  # one mesh-wide solve per slice
        Xs, _res = solve(cpad[s0:s0 + n_shift], Vt[s0:s0 + n_shift])
        keep = min(n_shift, B - s0)
        if keep > 0:
            X[s0:s0 + keep] = Xs[:keep]
    powers = ws[:, None] * zs[:, None] ** np.arange(2 * K)[None, :]
    return np.einsum("bp,bli->ilp", powers, X).astype(np.complex128)


def beyn_dist(L: OperatorFamily, Gamma, mesh: Mesh, n_row_parts: int,
              l=5, K=1, N=16, tol=0.0, rtol=0.0, pos_test_flag=True,
              res_tol: Optional[float] = None, output=False, **kw):
    """Beyn's algorithm with every quadrature solve running distributed
    on the (shift × row) device mesh (see :func:`dist_moments`).
    ``res_tol``: per-eigenpair residual cutoff (verify_eigenpairs)."""
    from ..nlevp.solvers import verify_eigenpairs
    d = L.size
    K = max(K, (l + d - 1) // d)
    A = dist_moments(L, Gamma, mesh, n_row_parts, l=l, K=K, N=N, **kw)
    Om, Pv = moments2eigs([A], tol_sigma=tol, rtol_sigma=rtol)
    if pos_test_flag:
        Om, Pv = pos_test(Om, Pv, Gamma)
    Om, Pv, _res = verify_eigenpairs(L, Om, Pv, res_tol=res_tol,
                                     output=output)
    return Om, Pv


__all__ = ["batched_moments", "matfree_moments", "dist_moments",
           "beyn_batched", "beyn_dist", "DENSE_BEYN_MAX_DIM"]

"""Matrix-free shifted panel solver + matrix-free device Beyn.

Covers the scalable contour-quadrature path (ops/panel_solve.py,
parallel/dist_beyn.matfree_moments) that replaces the round-1 dense
[d,d] node solves — the device counterpart of the reference's UMFPACK loop
at /root/reference/src/NLEVP/beyn.jl:62-74."""
import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu.nlevp import gallery
from wavesandeigenvalues_jl_tpu.nlevp.solvers import beyn, initialize_V
from wavesandeigenvalues_jl_tpu.ops.panel_solve import ShiftedPanelSolver
from wavesandeigenvalues_jl_tpu.parallel.dist_beyn import (beyn_batched,
                                                           matfree_moments)


@pytest.fixture(scope="module")
def rijke1d():
    L, grid = gallery.rijke_tube(64)
    return L


def test_panel_solver_matches_direct(rijke1d):
    """GMRES panel solves reproduce direct solves at several shifts."""
    L = rijke1d
    d = L.size
    rng = np.random.default_rng(3)
    V = (rng.standard_normal((d, 3))
         + 1j * rng.standard_normal((d, 3))).astype(np.complex128)
    zs = np.array([0.8 + 0.2j, 1.5 - 0.1j, 2.2 + 0.4j])
    solver = ShiftedPanelSolver(L, bs=16, refine_tol=1e-11)
    X, info = solver.solve(zs, V)
    assert info["max_relres"] < 1e-10
    for j, z in enumerate(zs):
        A = L(complex(z)).to_dense()
        Xd = np.linalg.solve(A, V)
        assert np.linalg.norm(X[j] - Xd) / np.linalg.norm(Xd) < 1e-8


def test_panel_solver_per_shift_rhs(rijke1d):
    """[S, n, l] per-shift right-hand sides (the refinement shape)."""
    L = rijke1d
    d = L.size
    rng = np.random.default_rng(4)
    B = (rng.standard_normal((2, d, 2))
         + 1j * rng.standard_normal((2, d, 2)))
    zs = np.array([1.0 + 0.3j, 1.8 - 0.2j])
    X, info = ShiftedPanelSolver(L, bs=16).solve(zs, B)
    assert info["max_relres"] < 1e-10
    for j, z in enumerate(zs):
        A = L(complex(z)).to_dense()
        assert np.allclose(A @ X[j], B[j], rtol=0, atol=1e-8
                           * np.linalg.norm(B[j]))


def test_matfree_beyn_matches_host(rijke1d):
    """Matrix-free device Beyn == host (LU) Beyn on the 1-D Rijke model."""
    L = rijke1d
    # contour around the first passive/active cluster
    Gamma = [0.5 - 0.5j, 2.5 - 0.5j, 2.5 + 1.0j, 0.5 + 1.0j]
    Om_h, P_h = beyn(L, Gamma, l=6, N=32, rtol=1e-12)
    Om_m, P_m = beyn_batched(L, Gamma, l=6, N=32, rtol=1e-12, dense=False,
                             bs=16)
    assert len(Om_m) == len(Om_h)
    oh = np.sort_complex(Om_h)
    om = np.sort_complex(Om_m)
    assert np.max(np.abs(oh - om)) < 1e-8
    # eigenvector quality: L(ω)v ≈ 0 for each matrix-free pair
    for k in range(len(Om_m)):
        A = L(complex(Om_m[k])).to_dense()
        v = P_m[:, k] / np.linalg.norm(P_m[:, k])
        assert np.linalg.norm(A @ v) < 1e-6


def test_two_grid_panel_solver():
    """Geometric two-grid preconditioning (octosplit hierarchy): the
    device pass alone reaches near-f64 residuals where plain block-Jacobi
    GMRES stagnates — the scaling mechanism of the matrix-free Beyn."""
    from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu.mesh.refine import (octosplit,
                                                        p1_prolongation)
    from wavesandeigenvalues_jl_tpu.models import discretize
    from wavesandeigenvalues_jl_tpu.ops.panel_solve import CoarseGrid

    coarse = rijke_mesh(n_rings=2, nz_cold=8, nz_hot=8)
    P = p1_prolongation(coarse)
    fine = octosplit(coarse)
    fld = lambda m: m.generate_field(
        lambda x, y, z: np.where(z < 0, 347.0, 694.0))
    ds = {"Interior": ("interior", ()),
          "Outlet": ("admittance", ("Y", 1e15))}
    Lc = discretize(coarse, ds, fld(coarse))
    Lf = discretize(fine, ds, fld(fine))
    assert P[3] == (Lf.size, Lc.size)
    d = Lf.size
    V = np.zeros((d, 2), np.complex128)
    V[0, 0] = V[1, 1] = 1.0
    zs = 2 * np.pi * np.array([250 + 5j, 600 + 5j])
    solver = ShiftedPanelSolver(Lf, bs=64, restart=30, max_restarts=10,
                                coarse=CoarseGrid(Lc, P))
    X, info = solver.solve(zs, V)
    assert info["max_relres"] < 1e-10
    from wavesandeigenvalues_jl_tpu.ops.linsolve import factorize
    for j, z in enumerate(zs):
        Xd = factorize(Lf(complex(z))).solve(V)
        assert np.linalg.norm(X[j] - Xd) / np.linalg.norm(Xd) < 1e-8


def test_matfree_moments_match_host_quadrature(rijke1d):
    """Moment matrices agree with the host loop node-for-node."""
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import \
        compute_moment_matrices
    L = rijke1d
    Gamma = [0.5 - 0.5j, 2.5 - 0.5j, 2.5 + 1.0j, 0.5 + 1.0j]
    V = initialize_V(L.size, 4)
    A_host = compute_moment_matrices(L, Gamma, V, K=2, N=12)
    A_mf, info = matfree_moments(L, Gamma, V=V, K=2, N=12, bs=16)
    assert info["max_relres"] < 1e-9
    assert np.linalg.norm(A_mf - A_host) / np.linalg.norm(A_host) < 1e-9


def test_matfree_moments_checkpoint_resume(rijke1d, tmp_path):
    """Group-wise matfree moments: checkpoint mid-contour, resume, and
    match the uninterrupted result; a changed parameter invalidates."""
    L = rijke1d
    Gamma = [0.5 - 0.5j, 2.5 - 0.5j, 2.5 + 1.0j, 0.5 + 1.0j]
    V = initialize_V(L.size, 3)
    ck = str(tmp_path / "mf.npz")
    A_full, _ = matfree_moments(L, Gamma, V=V, K=1, N=8, bs=16)
    # run grouped with checkpointing
    A_ck, _ = matfree_moments(L, Gamma, V=V, K=1, N=8, bs=16, group=10,
                              checkpoint=ck)
    assert np.allclose(A_ck, A_full, rtol=1e-10)
    # simulate preemption: rewind the checkpoint to a mid-contour state
    with np.load(ck) as d:
        A_mid, digest = d["A"], str(d["digest"])
    np.savez(ck, A=A_mid * 0, next=32, digest=digest)  # wrong partial sums
    A_res, _ = matfree_moments(L, Gamma, V=V, K=1, N=8, bs=16, group=10,
                               checkpoint=ck)
    assert not np.allclose(A_res, A_full)  # resumed from doctored state
    # changed parameter -> digest mismatch -> full recompute
    L.params["τ"] = L.params["τ"] * 1.001
    A_new, _ = matfree_moments(L, Gamma, V=V, K=1, N=8, bs=16, group=10,
                               checkpoint=ck)
    L.params["τ"] = L.params["τ"] / 1.001
    A_ref, _ = matfree_moments(L, Gamma, V=V, K=1, N=8, bs=16)
    assert not np.allclose(A_new, A_ref)


def test_multigrid_panel_solver():
    """Full multilevel V-cycle (3 levels): one device pass reaches ~1e-11
    where the 2-level-jump coarse stalls near 1e-3 — the production
    preconditioner of the big-mesh matrix-free Beyn (SCALE.json)."""
    from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu.mesh.refine import (octosplit,
                                                        p1_prolongation)
    from wavesandeigenvalues_jl_tpu.models import discretize
    from wavesandeigenvalues_jl_tpu.ops.linsolve import factorize
    from wavesandeigenvalues_jl_tpu.ops.panel_solve import MultiGrid

    m0 = rijke_mesh(n_rings=1, nz_cold=5, nz_hot=5)
    P0 = p1_prolongation(m0)
    m1 = octosplit(m0)
    P1 = p1_prolongation(m1)
    m2 = octosplit(m1)
    fld = lambda m: m.generate_field(
        lambda x, y, z: np.where(z < 0, 347.0, 694.0))
    ds = {"Interior": ("interior", ()),
          "Outlet": ("admittance", ("Y", 1e15))}
    L0, L1, L2 = (discretize(m, ds, fld(m)) for m in (m0, m1, m2))
    mg = MultiGrid([L1, L0], [P1, P0], bs=32)
    solver = ShiftedPanelSolver(L2, bs=64, restart=20, max_restarts=5,
                                coarse=mg)
    d = L2.size
    V = np.zeros((d, 2), np.complex128)
    V[0, 0] = V[1, 1] = 1.0
    zs = 2 * np.pi * np.array([250 + 5j, 600 + 5j])
    X, info = solver.solve(zs, V)
    assert info["max_relres"] < 1e-10
    for j, z in enumerate(zs):
        Xd = factorize(L2(complex(z))).solve(V)
        assert np.linalg.norm(X[j] - Xd) / np.linalg.norm(Xd) < 1e-8

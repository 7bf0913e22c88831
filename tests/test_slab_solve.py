"""Block-tridiagonal slab direct solver (ops/slab_solve.py).

Validates the BFS slab partition invariants and the batched block-Thomas
panel solve against scipy sparse LU on a generated Rijke-tube operator —
the direct device path for the Beyn quadrature (beyn.jl:62-74)."""
import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu.ops.slab_solve import (SlabPartition,
                                                       SlabSolver,
                                                       bfs_levels)


@pytest.fixture(scope="module")
def rijke_family():
    from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu.models import discretize
    g, R, Tu, Tb = 1.4, 287.05, 300.0, 1200.0
    # 285 DOF, 8 slabs: small enough for the CPU unit tests, with both
    # passive modes (~273 / ~699 Hz) inside the test contour
    mesh = rijke_mesh(n_rings=2, nz_cold=6, nz_hot=6)
    c = mesh.generate_field(
        lambda x, y, z: np.where(z < 0, np.sqrt(g * R * Tu),
                                 np.sqrt(g * R * Tb)), order="const")
    return discretize(mesh, {"Interior": ("interior", ()),
                             "Outlet": ("admittance", ("Y", 1e15))}, c)


def test_bfs_levels_edge_property(rijke_family):
    """Every union-pattern entry must connect levels differing by <= 1 —
    the property that makes the slab ordering block tridiagonal."""
    S = rijke_family._stack()
    part = SlabPartition(S.indptr, S.indices, int(S.shape[0]))
    si, d, rl, cl = part.entry_destinations(
        np.asarray(S.row_ids()), np.asarray(S.indices))
    assert d.min() >= 0 and d.max() <= 2
    assert (rl < part.sizes[si]).all()
    assert np.bincount(part.slab_of_new, minlength=part.m).max() == part.smax


def test_bfs_levels_disconnected():
    """Two disconnected chains level consecutively, no cross edges."""
    # chain 0-1-2, chain 3-4
    indptr = np.array([0, 1, 3, 4, 5, 6])
    nbrs = np.array([1, 0, 2, 1, 4, 3])
    lvl = bfs_levels(indptr, nbrs, 5)
    assert (lvl >= 0).all()
    # within each chain, adjacent vertices differ by exactly one level
    assert abs(lvl[0] - lvl[1]) == 1 and abs(lvl[1] - lvl[2]) == 1
    assert abs(lvl[3] - lvl[4]) == 1


def test_slab_solve_matches_sparse_lu(rijke_family):
    import scipy.sparse.linalg as spl
    L = rijke_family
    sv = SlabSolver(L, chunk=4)
    zs = 2 * np.pi * np.array([250 + 5j, 400 - 5j, 600 + 5j])
    rng = np.random.default_rng(0)
    V = (rng.standard_normal((L.size, 3))
         + 1j * rng.standard_normal((L.size, 3)))
    X, info = sv.solve(zs, V)
    assert info["max_relres"] < 1e-10
    for j, z in enumerate(zs):
        A = sv._host_csr(sv.coefficients([z])[0])
        Xe = spl.spsolve(A.tocsc(), V)
        err = np.linalg.norm(X[j] - Xe) / np.linalg.norm(Xe)
        assert err < 1e-8, f"shift {j}: {err}"


def test_slab_solve_shared_and_per_shift_rhs(rijke_family):
    """[n,l] shared panel and [S,n,l] per-shift RHS give identical
    results; odd shift counts exercise the chunk padding."""
    L = rijke_family
    sv = SlabSolver(L, chunk=2)
    zs = 2 * np.pi * np.array([300 + 5j, 500 + 5j, 700 - 5j])
    rng = np.random.default_rng(1)
    V = (rng.standard_normal((L.size, 2))
         + 1j * rng.standard_normal((L.size, 2)))
    X1, _ = sv.solve(zs, V)
    X2, _ = sv.solve(zs, np.broadcast_to(V[None], (3,) + V.shape).copy())
    np.testing.assert_allclose(X1, X2, rtol=1e-9, atol=1e-12)


def test_slab_matfree_beyn_rijke(rijke_family):
    """End-to-end: Beyn passive modes through the slab direct backend
    reproduce the host-LU contour result (272 / 695 Hz, BASELINE.md)."""
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import beyn
    from wavesandeigenvalues_jl_tpu.parallel.dist_beyn import beyn_batched
    L = rijke_family
    Gamma = [2 * np.pi * (150 - 5j), 2 * np.pi * (1000 - 5j),
             2 * np.pi * (1000 + 5j), 2 * np.pi * (150 + 5j)]
    Om_ref, _ = beyn(L, Gamma, l=8, N=24, rtol=1e-12)
    Om, _ = beyn_batched(L, Gamma, l=8, N=24, rtol=1e-12, dense=False,
                         method="slab", chunk=8)
    f_ref = np.sort(Om_ref.real) / 2 / np.pi
    f = np.sort(Om.real) / 2 / np.pi
    assert len(f) == len(f_ref)
    np.testing.assert_allclose(f, f_ref, atol=1e-6)


def test_front_door_beyn_backends(rijke_family):
    """The public beyn() entry point routes every backend to the same
    spectrum (one entry point like the reference's).
    The slab leg runs on the mesh operator; the gmres leg on a small
    gallery operator (plain block-Jacobi GMRES on the CPU backend is too
    slow at mesh size for a unit test — its mesh-scale coverage lives in
    the multigrid panel tests)."""
    from wavesandeigenvalues_jl_tpu.nlevp import gallery
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import beyn
    L = rijke_family
    Gamma = [2 * np.pi * (150 - 5j), 2 * np.pi * (1000 - 5j),
             2 * np.pi * (1000 + 5j), 2 * np.pi * (150 + 5j)]
    Om_h, _ = beyn(L, Gamma, l=8, N=24, rtol=1e-12, res_tol=1e-6,
                   backend="host")
    f_h = np.sort(Om_h.real) / 2 / np.pi
    Om, _ = beyn(L, Gamma, l=8, N=24, rtol=1e-12, res_tol=1e-6,
                 backend="slab", chunk=8)
    f = np.sort(Om.real) / 2 / np.pi
    assert len(f) == len(f_h)
    np.testing.assert_allclose(f, f_h, atol=1e-5)

    Lg, _ = gallery.rijke_tube(60)
    Lg.params["n"], Lg.params["τ"] = 1.0, 0.5
    Gg = [0.2 - 1j, 4.0 - 1j, 4.0 + 1j, 0.2 + 1j]
    Og_h, _ = beyn(Lg, Gg, l=8, N=48, rtol=1e-12, res_tol=1e-8,
                   backend="host")       # one active mode ~2.147+0.327j
    Og, _ = beyn(Lg, Gg, l=8, N=48, rtol=1e-12, res_tol=1e-8,
                 backend="gmres", bs=16, tol=1e-10, restart=60,
                 max_restarts=20)
    assert len(Og) == len(Og_h) == 1
    np.testing.assert_allclose(np.sort_complex(Og), np.sort_complex(Og_h),
                               atol=1e-6)

"""Fused slab-direct local eigensolve (nlevp/fused_slab.py) — the
device Newton step of mslp/householder — and its block-Thomas recursion
(ops/slab_thomas.py)."""
import numpy as np

from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
from wavesandeigenvalues_jl_tpu.models import discretize
from wavesandeigenvalues_jl_tpu.nlevp import mslp
from wavesandeigenvalues_jl_tpu.nlevp.fused_slab import FusedSlabPencilSolver
from wavesandeigenvalues_jl_tpu.utils.config import set_solve_backend

G, R, TU, TB, P0, RHO = 1.4, 287.05, 300.0, 1200.0, 101325.0, 1.225
Q02U0 = P0 * (TB / TU - 1) * np.pi * 0.025 ** 2 * G / (G - 1)


def _active_family():
    mesh = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    c = mesh.generate_field(
        lambda x, y, z: np.where(z < 0, np.sqrt(G * R * TU),
                                 np.sqrt(G * R * TB)), order="const")
    return discretize(mesh, {
        "Interior": ("interior", ()),
        "Outlet": ("admittance", ("Y", 1e15)),
        "Flame": ("flame", (G, RHO, Q02U0, [0.0, 0.0, -0.0101],
                            [0.0, 0.0, 1.0], "n", "τ", 1.0, 1e-3)),
    }, c)


def test_fused_slab_matches_host_mslp():
    """The slab solver on a tiny active (flame, complex ω) family must
    agree with the host mslp path to the digits."""
    L = _active_family()
    sol_h, _its, flag_h = mslp(L, 340 * 2 * np.pi, maxiter=30, tol=1e-11)
    assert flag_h == 0
    om_h = sol_h.params[sol_h.eigval]

    L2 = _active_family()
    prev = set_solve_backend("device")
    try:
        sol_d, _its_d, flag_d = mslp(L2, 340 * 2 * np.pi, maxiter=30,
                                     tol=1e-11)
    finally:
        set_solve_backend(prev)
    assert flag_d == 0
    om_d = sol_d.params[sol_d.eigval]
    assert abs(om_d - om_h) < 1e-8 * abs(om_h)
    # eigenvector sanity: normalized v from the device carries
    assert np.isfinite(sol_d.v).all()


def test_fused_slab_solver_direct_solve_accuracy():
    """The slab step's inner solve path (factor scan + Thomas recursion)
    must land inside the Newton basin from one
    step: |dz| consistent with the host Newton update."""
    L = _active_family()
    solver = FusedSlabPencilSolver(L)
    import jax
    v0 = np.ones(L.size)
    vr, vi = np.float32(v0), np.zeros(L.size, np.float32)
    carries = tuple(jax.device_put(p) for p in (vr, vi, vr, vi))
    z = 340 * 2 * np.pi
    dz, lam, carries, res = solver.step(complex(z), carries, 0.0 + 0.0j)
    assert np.isfinite(dz)
    assert res.max() < 1e-5          # refined f32 solves, f64 sweep


def test_slab_thomas_matches_numpy_recursion():
    """The lax.scan block-Thomas recursion against the same recursion
    written as a plain numpy loop (complex64, both sides)."""
    from wavesandeigenvalues_jl_tpu.ops.slab_thomas import slab_thomas
    rng = np.random.default_rng(0)
    m, sides, s = 6, 2, 24
    c = lambda *sh: (rng.standard_normal(sh)
                     + 1j * rng.standard_normal(sh)).astype(np.complex64)
    WT, CT, bt = c(m, sides, s, s) * 0.1, c(m, sides, s, s) * 0.1, \
        c(m, sides, s)
    Y = np.zeros_like(bt)
    prev = np.zeros((sides, s), np.complex64)
    for i in range(m):
        prev = bt[i] - np.einsum("bk,bkj->bj", prev, WT[i])
        Y[i] = prev
    X = np.zeros_like(bt)
    prev = np.zeros((sides, s), np.complex64)
    for i in reversed(range(m)):
        prev = Y[i] - np.einsum("bk,bkj->bj", prev, CT[i])
        X[i] = prev
    np.testing.assert_allclose(np.asarray(slab_thomas(WT, CT, bt)), X,
                               rtol=1e-4, atol=1e-5)

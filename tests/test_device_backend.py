"""Device-resident shifted-solve backend (ops/device_solve.py): the device
counterpart of the reference's ARPACK/UMFPACK hot path
(Householder.jl:100-101, perturbation.jl:385) behind the
``WAE_SOLVE_BACKEND`` / ``set_solve_backend`` switch."""
import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu.nlevp import gallery, mslp, perturb_fast
from wavesandeigenvalues_jl_tpu.ops.device_solve import (DeviceGMRES,
                                                         DeviceLU,
                                                         device_factorize)
from wavesandeigenvalues_jl_tpu.ops.linsolve import factorize
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR
from wavesandeigenvalues_jl_tpu.utils.config import (set_solve_backend,
                                                     solve_backend)


@pytest.fixture
def penalty_system():
    """Dense-ish complex system with one penalty-scaled row (the admittance
    BC pattern, Y~1e15, that kills unequilibrated single precision)."""
    rng = np.random.default_rng(0)
    n = 96
    A = (np.eye(n) * 4 + 0.3 * rng.standard_normal((n, n))
         + 0.1j * rng.standard_normal((n, n)))
    A[0] *= 1e12
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A, b


@pytest.mark.parametrize("cls", [DeviceLU,
                                 lambda A: DeviceGMRES(A, bs=16, tol=1e-10)])
def test_device_solve_all_transposes(cls, penalty_system):
    A, b = penalty_system
    F = cls(CSR.from_dense(A))
    for trans, M in (("N", A), ("T", A.T), ("H", A.conj().T)):
        x = F.solve(b, trans=trans)
        ref = np.linalg.solve(M, b)
        assert np.linalg.norm(x - ref) / np.linalg.norm(ref) < 1e-8, trans


def test_device_lu_multirhs(penalty_system):
    A, b = penalty_system
    F = DeviceLU(CSR.from_dense(A))
    B = np.stack([b, 2 * b, 1j * b], axis=1)
    X = F.solve(B)
    ref = np.linalg.solve(A, B)
    assert np.linalg.norm(X - ref) / np.linalg.norm(ref) < 1e-9


def test_device_lu_detects_singular():
    A = np.zeros((4, 4), complex)
    A[0, 0] = A[1, 1] = A[2, 2] = 1.0  # structurally singular last row
    F = DeviceLU(A)
    assert not F.ok
    from wavesandeigenvalues_jl_tpu.ops.linsolve import (SingularMatrixError,
                                                         factorize)
    with pytest.raises(SingularMatrixError):
        factorize(A, check=True, backend="device_lu")


def test_backend_switch_and_dispatch():
    prev = set_solve_backend("device")
    try:
        assert solve_backend() == "device"
        A = np.eye(8, dtype=complex)
        assert isinstance(factorize(A), DeviceLU)
        assert isinstance(factorize(A, backend="host"), object)
        assert isinstance(device_factorize(A, "device_gmres"), DeviceGMRES)
    finally:
        set_solve_backend(prev)
    assert solve_backend() == prev


def test_mslp_device_backend_matches_host():
    """The VERDICT r1 acceptance: the local NLEVP solve routed through the
    device path reproduces the host eigenvalue (gallery Rijke; the full
    Rijke_mm.msh check runs in bench.py on real hardware)."""
    L, _ = gallery.rijke_tube(60)
    L.params["n"], L.params["τ"] = 1.0, 0.5
    sol_h, n_h, flag_h = mslp(L, 1.0 + 0.3j, tol=1e-12, maxiter=30)
    assert flag_h >= 0
    prev = set_solve_backend("device")
    try:
        L2, _ = gallery.rijke_tube(60)
        L2.params["n"], L2.params["τ"] = 1.0, 0.5
        sol_d, n_d, flag_d = mslp(L2, 1.0 + 0.3j, tol=1e-12, maxiter=30)
    finally:
        set_solve_backend(prev)
    assert flag_d >= 0
    assert abs(sol_d.params["ω"] - sol_h.params["ω"]) < 1e-9


def test_mslp_device_gmres_backend():
    """Forcing the matrix-free GMRES path end-to-end through mslp."""
    L, _ = gallery.rijke_tube(40)
    sol_h, _, flag_h = mslp(L, 1.0 + 0.3j, tol=1e-11, maxiter=30)
    prev = set_solve_backend("device_gmres")
    try:
        L2, _ = gallery.rijke_tube(40)
        sol_d, _, flag_d = mslp(L2, 1.0 + 0.3j, tol=1e-11, maxiter=30)
    finally:
        set_solve_backend(prev)
    assert flag_h >= 0 and flag_d >= 0
    assert abs(sol_d.params["ω"] - sol_h.params["ω"]) < 1e-8


def test_perturb_device_backend():
    """Perturbation recurrence's reused factorization (perturbation.jl:385)
    through the device path: Taylor coefficients match host."""
    L, _ = gallery.rijke_tube(48)
    L.params["n"], L.params["τ"] = 1.0, 0.4
    sol, _, flag = mslp(L, 1.0 + 0.3j, tol=1e-12, maxiter=30)
    assert flag >= 0
    perturb_fast(sol, L, "τ", 6)
    host_coeffs = np.asarray(sol.eigval_pert["τ/Taylor"]).copy()
    sol.eigval_pert.clear()
    prev = set_solve_backend("device")
    try:
        perturb_fast(sol, L, "τ", 6)
    finally:
        set_solve_backend(prev)
    dev_coeffs = np.asarray(sol.eigval_pert["τ/Taylor"])
    assert np.all(np.abs(dev_coeffs - host_coeffs)
                  <= 1e-7 * np.maximum(np.abs(host_coeffs), 1e-30))


def test_dual_arnoldi_pair_matches_host():
    """The one-dispatch device dual Arnoldi (DeviceLU.dual_arnoldi +
    eigs_pencil_pair fast path) reproduces the host-loop eigentriple:
    eigenvalue to c128-refined accuracy, vectors to the same invariant
    subspace (VERDICT r2 #5)."""
    from wavesandeigenvalues_jl_tpu.nlevp.eigs import eigs_pencil_pair

    L, _ = gallery.rijke_tube(64)
    L.params["n"], L.params["τ"] = 1.0, 0.5
    L.ensure_aux()
    L.params[L.eigval] = 1.1 + 0.25j
    L.params[L.auxval] = 0.0
    A = L(1.1 + 0.25j)
    M = L.aux_weight()
    lam_h, V_h, lam_adj_h, W_h = eigs_pencil_pair(A, M, nev=1)
    prev = set_solve_backend("device")
    try:
        lam_d, V_d, lam_adj_d, W_d = eigs_pencil_pair(A, M, nev=1)
    finally:
        set_solve_backend(prev)
    assert abs(lam_d[0] - lam_h[0]) <= 1e-9 * max(1.0, abs(lam_h[0]))
    # vectors agree up to phase
    for a, b in ((V_d[:, 0], V_h[:, 0]), (W_d[:, 0], W_h[:, 0])):
        c = np.vdot(b, a)
        assert abs(abs(c) - 1.0) < 1e-6


def test_device_gmres_multirhs_panel():
    """DeviceGMRES panel solve (one vmapped device call per refinement
    sweep) matches per-column direct solves."""
    rng = np.random.default_rng(3)
    n = 80
    A = (np.eye(n) * 5 + 0.3 * rng.standard_normal((n, n))
         + 0.2j * rng.standard_normal((n, n)))
    A[1] *= 1e10
    B = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    F = DeviceGMRES(CSR.from_dense(A), bs=16, tol=1e-10)
    X = F.solve(B)
    ref = np.linalg.solve(A, B)
    assert np.linalg.norm(X - ref) / np.linalg.norm(ref) < 1e-8


def test_local_engine_stall_detection():
    """With tol below the attainable |dz| floor, the local engine stops
    at the noise floor (flag 0 via the stall rule) instead of spinning
    to maxiter (the f32 device backend floors near |dz|/|z| ~ 1e-10 on
    real hardware; at complex128 the same rule trips near 1e-15)."""
    L, _ = gallery.rijke_tube(60)
    L.params["n"], L.params["τ"] = 1.0, 0.5
    sol, iters, flag = mslp(L, 1.0 + 0.3j, tol=0.0, maxiter=60)
    assert flag >= 0
    assert iters < 60

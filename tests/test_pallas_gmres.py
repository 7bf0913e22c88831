"""The fused-device local solver engine (nlevp/fused_local.py): agreement
with the host engine, and how device errors and non-finite updates
surface."""
import numpy as np
import pytest



def test_fused_local_matches_host_on_gallery():
    """mslp via the fused-device engine == host engine on the 1-D Rijke
    gallery problem."""
    from wavesandeigenvalues_jl_tpu.nlevp import mslp
    from wavesandeigenvalues_jl_tpu.nlevp.gallery import rijke_tube
    from wavesandeigenvalues_jl_tpu.nlevp.fused_local import try_fused_local
    from wavesandeigenvalues_jl_tpu.utils.config import set_solve_backend

    L, _grid = rijke_tube()
    L.params["n"], L.params["τ"] = 1.0, 0.5
    sol_h, its_h, flag_h = mslp(L, 1.0 + 0.3j, maxiter=30, tol=1e-10)
    om_host = sol_h.params[L.eigval]
    assert flag_h == 0

    L2, _g2 = rijke_tube()
    L2.params["n"], L2.params["τ"] = 1.0, 0.5
    out = try_fused_local(L2, 1.0 + 0.3j, maxiter=30, tol=1e-10, relax=1.0,
                          lam_tol=np.inf, v0=None, v0_adj=None,
                          output=False, scale=1)
    sol_d, its_d, flag_d = out
    om_dev = sol_d.params[L2.eigval]
    assert abs(om_dev - om_host) < 1e-8 * max(abs(om_host), 1.0)
    # eigentriple quality: residual of the returned eigenpair
    A = L2(om_dev)
    r = np.linalg.norm(A @ sol_d.v) / np.linalg.norm(sol_d.v)
    rh = np.linalg.norm(L(om_host) @ sol_h.v) / np.linalg.norm(sol_h.v)
    assert r < max(10 * rh, 1e-6)


def _gallery_family():
    from wavesandeigenvalues_jl_tpu.nlevp.gallery import rijke_tube
    L, _grid = rijke_tube()
    L.params["n"], L.params["τ"] = 1.0, 0.5
    return L


def test_fused_local_device_error_propagates(monkeypatch):
    """An error on the device path reaches the caller; no host engine
    runs in its place."""
    from wavesandeigenvalues_jl_tpu.nlevp import mslp
    from wavesandeigenvalues_jl_tpu.nlevp.fused_slab import (
        FusedSlabPencilSolver)
    from wavesandeigenvalues_jl_tpu.utils.config import set_solve_backend

    def broken(self, *a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(FusedSlabPencilSolver, "step", broken)
    prev = set_solve_backend("device")
    try:
        with pytest.raises(RuntimeError, match="injected"):
            mslp(_gallery_family(), 1.0 + 0.3j, maxiter=30, tol=1e-10)
    finally:
        set_solve_backend(prev)


def test_fused_local_nan_update_reports_flag(monkeypatch):
    """A non-finite device update ends the device loop and is reported by
    flag when the host polish cannot recover a converged iterate."""
    from wavesandeigenvalues_jl_tpu.nlevp.fused_local import try_fused_local
    from wavesandeigenvalues_jl_tpu.nlevp.fused_slab import (
        FusedSlabPencilSolver)
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import ITSOL_ISNAN

    def nan_step(self, z, carries, sigma):
        return complex(np.nan), complex(np.nan), carries, np.zeros(2)

    monkeypatch.setattr(FusedSlabPencilSolver, "step", nan_step)
    _sol, _its, flag = try_fused_local(
        _gallery_family(), 1.0 + 0.3j, maxiter=1, tol=1e-10, relax=1.0,
        lam_tol=np.inf, v0=None, v0_adj=None, output=False, scale=1)
    assert flag == ITSOL_ISNAN

"""chip_smoke.py: its refusal to run off the GPU, and each phase at a
tiny size on the CPU backend (the same checks the GPU run makes)."""
import os
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_refuses_without_gpu(argv, capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main(argv) != 0
    assert capsys.readouterr().out == ""


def test_phase_local_with_perturbation():
    rec = chip_smoke.phase_local("A", 2, 6, "cpu", perturb=True)
    assert rec["abs_domega"] <= rec["tol"]
    assert rec["abs_dpade"] <= rec["tol_pade"]


def test_phase_local_rejects_wrong_platform():
    """The placement check fails when the solver's arrays are not on the
    platform the run claims."""
    with pytest.raises(chip_smoke.SmokeFailure, match="not on the gpu"):
        chip_smoke.phase_local("B", 2, 6, "gpu")


def test_phase_local_rejects_host_engine(monkeypatch):
    """A solve that never built the fused device solver fails the run."""
    from wavesandeigenvalues_jl_tpu.utils import config
    real = config.set_solve_backend
    monkeypatch.setattr(config, "set_solve_backend",
                        lambda b: real("host"))
    with pytest.raises(chip_smoke.SmokeFailure, match="fused device"):
        chip_smoke.phase_local("B", 2, 6, "cpu")


def test_phase_contour():
    from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
    rec = chip_smoke.phase_contour(
        "C", rijke_mesh(n_rings=2, nz_cold=6, nz_hot=6), N=32)
    hz = [f for f, _ in rec["modes_hz"]]
    assert np.allclose(hz, chip_smoke.PASSIVE_HZ, atol=10.0)


def test_phase_four_on_virtual_devices():
    rec = chip_smoke.phase_four(jax.devices()[:4], n_rings=1, nz=6, N=32)
    assert len(rec["abs_domega_vs_single"]) == 2

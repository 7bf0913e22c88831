"""Multi-process readiness (parallel/multihost.py).

These tests pin the single-process no-op contract and compile-check the
(host × shift × row) layout on the virtual CPU mesh."""
import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu.parallel.multihost import (init_multihost,
                                                           pod_mesh,
                                                           pod_spec_check)


def test_init_multihost_noop_without_config(monkeypatch):
    monkeypatch.delenv("WAE_COORDINATOR", raising=False)
    monkeypatch.delenv("WAE_MULTIHOST", raising=False)
    assert init_multihost() is False


def test_pod_mesh_axes():
    import jax
    devs = np.array(jax.devices("cpu")[:8]).reshape(2, 4)
    mesh = pod_mesh(n_shift=2, n_row=2, devices=devs)
    assert mesh.axis_names == ("host", "shift", "row")
    assert dict(mesh.shape) == {"host": 2, "shift": 2, "row": 2}
    with pytest.raises(ValueError, match="per-host"):
        pod_mesh(n_shift=3, n_row=2, devices=devs)


def test_pod_spec_check_runs():
    axes = pod_spec_check(8, n_host=2)
    assert axes == {"host": 2, "shift": 2, "row": 2}

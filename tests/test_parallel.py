"""Distributed layer tests on the 8-virtual-device CPU mesh: partitioned
halo-exchange SpMV, family application, sharded Beyn moments."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from wavesandeigenvalues_jl_tpu.nlevp import beyn, gallery
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR
from wavesandeigenvalues_jl_tpu.parallel import (batched_moments,
                                                 beyn_batched, dist_dot,
                                                 make_dist_spmv,
                                                 partition_rows,
                                                 partition_stack)


def banded_matrix(n=257, seed=0, band=9):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), complex)
    for k in range(-band // 2, band // 2 + 1):
        d = rng.standard_normal(n - abs(k)) + 1j * rng.standard_normal(n - abs(k))
        A += np.diag(d, k)
    return A


@pytest.fixture(scope="module")
def row_mesh():
    return Mesh(np.array(jax.devices()), ("row",))


def test_partition_spmv_matches_dense(row_mesh):
    A = banded_matrix(257)
    Acsr = CSR.from_dense(A)
    part = partition_rows(Acsr, row_mesh.shape["row"], reorder=True)
    spmv, shard, unshard = make_dist_spmv(part, row_mesh)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(257) + 1j * rng.standard_normal(257)
    y = unshard(spmv(shard(x)))
    assert np.allclose(y, A @ x, atol=1e-12)


def test_partition_unstructured_spmv(row_mesh):
    """Unstructured FEM-like sparsity (random pattern) still works — CMK
    reordering bounds the halo."""
    rng = np.random.default_rng(3)
    n = 190
    A = np.zeros((n, n), complex)
    for i in range(n):
        for j in rng.choice(n, 4):
            A[i, j] = rng.standard_normal() + 1j * rng.standard_normal()
        A[i, i] += 1.0
    Acsr = CSR.from_dense(A)
    part = partition_rows(Acsr, 8)
    spmv, shard, unshard = make_dist_spmv(part, row_mesh)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = unshard(spmv(shard(x)))
    assert np.allclose(y, A @ x, atol=1e-11)


def test_partition_stack_family(row_mesh):
    """Distributed family application: coeffs ⊗ stacked values + halo SpMV
    equals L(z) @ x."""
    L, grid = gallery.rijke_tube(100)
    part = partition_stack(L._stack(), 8)
    spmv, shard, unshard = make_dist_spmv(part, row_mesh)
    z = 1.1 + 0.4j
    coeffs = L.coefficients({})  # uses current params; set ω first
    L.params["ω"] = z
    coeffs = L.coefficients({})
    rng = np.random.default_rng(5)
    x = rng.standard_normal(L.size) + 1j * rng.standard_normal(L.size)
    y = unshard(spmv(shard(x), coeffs))
    y_ref = L(z) @ x
    assert np.allclose(y, y_ref, rtol=1e-10, atol=1e-10)


def test_dist_dot(row_mesh):
    n = 8 * 13
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    xs = jax.device_put(x, NamedSharding(row_mesh, P("row")))
    ys = jax.device_put(y, NamedSharding(row_mesh, P("row")))
    d = np.complex128(dist_dot(xs, ys, row_mesh))
    assert abs(d - np.vdot(x, y)) < 1e-12 * abs(np.vdot(x, y))


def test_batched_moments_match_host():
    """Device-batched moment matrices equal the host quadrature loop."""
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import \
        compute_moment_matrices
    T = gallery.qep3()
    Gamma = [-2 - 2j, 2 - 2j, 2 + 2j, -2 + 2j]
    A_host = compute_moment_matrices(T, Gamma, l=3, K=1, N=16)
    A_dev = batched_moments(T, Gamma, l=3, K=1, N=16, dtype=np.complex128)
    assert np.allclose(A_dev, A_host, rtol=1e-9, atol=1e-9)


def test_beyn_batched_sharded():
    """Shift-sharded Beyn over the 8-device mesh reproduces the QEP
    spectrum."""
    mesh = Mesh(np.array(jax.devices()), ("shift",))
    T = gallery.qep3()
    Gamma = [-2 - 2j, 2 - 2j, 2 + 2j, -2 + 2j]
    Om, P = beyn_batched(T, Gamma, l=6, N=32, mesh=mesh,
                         dtype=np.complex128)
    for target in (1 / 3, 0.5, 1.0, 1j, -1j):
        assert np.min(np.abs(Om - target)) < 1e-8, target


def test_beyn_sharded_fem_partition_invariance():
    """Partition invariance on a real FEM operator (SURVEY §4): the
    shift-sharded distributed Beyn over the 8-device mesh finds the same
    passive Rijke eigenfrequencies as the serial host solver."""
    from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu.models import discretize

    m = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    c = m.generate_field(lambda x, y, z: np.where(z < 0, 347.2, 694.4),
                         order="const")
    L = discretize(m, {"Interior": ("interior", ()),
                       "Outlet": ("admittance", ("Y", 1e15))}, c)
    Gamma = np.array([150 + 5j, 150 - 5j, 1000 - 5j, 1000 + 5j]) * 2 * np.pi
    Om_host, _ = beyn(L, Gamma, l=8, N=32, rtol=1e-12)
    mesh = Mesh(np.array(jax.devices()), ("shift",))
    Om_dist, _ = beyn_batched(L, Gamma, l=8, N=32, rtol=1e-12, mesh=mesh,
                              dtype=np.complex128)
    f_host = np.sort(Om_host.real) / 2 / np.pi
    f_dist = np.sort(Om_dist.real) / 2 / np.pi
    assert len(f_host) == len(f_dist)
    assert np.allclose(f_host, f_dist, atol=1e-6)


def test_weak_scaling_harness():
    """Weak-scaling record format (BASELINE.json scaling-efficiency axis):
    correctness-verified distributed SpMV at 1/2/4/8 virtual devices.
    CPU timings are noisy — the records and their invariants are asserted,
    not the trend (the real pod run is the same call on a bigger mesh)."""
    from wavesandeigenvalues_jl_tpu.parallel.scaling import \
        spmv_scaling_report

    recs = spmv_scaling_report(device_counts=(1, 2, 4, 8),
                               rows_per_device=512, reps=5)
    assert [r["n_devices"] for r in recs] == [1, 2, 4, 8]
    for r in recs:
        assert r["rows"] == 512 * r["n_devices"]
        assert r["nnz_per_s"] > 0
        assert 0 < r["efficiency_vs_1"]
        assert r["baseline_n_devices"] == 1
    assert recs[0]["efficiency_vs_1"] == 1.0
    # baseline not measured -> the vs-1 field must be absent, not mislabeled
    recs2 = spmv_scaling_report(device_counts=(2, 4),
                                rows_per_device=512, reps=2, verify=False)
    assert "efficiency_vs_1" not in recs2[0]
    assert recs2[0]["baseline_n_devices"] == 2
    assert recs2[0]["efficiency_vs_smallest"] == 1.0


def test_dist_gmres_scaling_report():
    """Composed row-sharded GMRES weak-scaling harness (VERDICT r2 #9):
    deterministic pinned work per device count, records in the
    BASELINE.json format.  The virtual mesh validates the harness, not
    the trend (8 virtual devices share 2 host cores)."""
    from wavesandeigenvalues_jl_tpu.parallel.scaling import \
        dist_gmres_scaling_report

    recs = dist_gmres_scaling_report(device_counts=(1, 4),
                                     rows_per_device=256, restart=5,
                                     max_restarts=1, bs=16)
    assert [r["n_devices"] for r in recs] == [1, 4]
    for r in recs:
        assert r["rows"] == 256 * r["n_devices"]
        assert r["matvec_nnz_per_s"] > 0
        assert r["baseline_n_devices"] == 1
    assert recs[0]["efficiency_vs_1"] == 1.0


def test_dist_spmm_panel(row_mesh):
    """Row-sharded multi-RHS SpMM: one halo ppermute moves the whole
    panel (SURVEY §2.9 #3 — the Beyn probe / block-Arnoldi axis)."""
    from wavesandeigenvalues_jl_tpu.parallel.dist_spmv import make_dist_spmm

    A = banded_matrix(193, seed=5, band=11)
    Acsr = CSR.from_dense(A)
    part = partition_rows(Acsr, row_mesh.shape["row"])
    spmm, shard, unshard = make_dist_spmm(part, row_mesh)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((193, 6)) + 1j * rng.standard_normal((193, 6))
    Y = unshard(spmm(shard(X)))
    assert np.allclose(Y, A @ X, atol=1e-11)


def test_dist_gmres_strong_report_shape():
    """Strong-scaling compute measurement: measured t_iter per split +
    exact comm accounting; compute efficiencies in (0, 1]."""
    import numpy as np
    from wavesandeigenvalues_jl_tpu.parallel.scaling import (
        _banded_operator, dist_gmres_strong_report)

    A = _banded_operator(2048, band=15)
    rep = dist_gmres_strong_report(A, device_counts=(1, 4), l=1,
                                   restart=8, max_restarts=1, bs=16)
    recs = rep["records"]
    assert [r["n_devices"] for r in recs] == [1, 4]
    for r in recs:
        assert 0.0 < r["compute_efficiency"] <= 1.0
        assert r["t_iter_measured_s"] > 0
        assert r["gmres_comm_accounting"]["cols"] == 1
    assert rep["halo_rows"] == 7

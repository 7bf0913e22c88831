"""Device sparse layouts and kernels (XLA paths on the CPU backend)."""
import jax
import numpy as np

from wavesandeigenvalues_jl_tpu.ops.device import (BsrOperator,
                                                   DeviceStackedOperator,
                                                   EllOperator, bsr_spmm_xla)
from wavesandeigenvalues_jl_tpu.ops.reorder import (bandwidth,
                                                    cuthill_mckee,
                                                    permute_csr)
from wavesandeigenvalues_jl_tpu.ops.sparse import CSR, StackedOperator


def random_sparse(n=300, per_row=6, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), complex)
    for i in range(n):
        for j in rng.choice(n, per_row):
            A[i, j] = rng.standard_normal() + 1j * rng.standard_normal()
    return A


def test_ell_spmv():
    A = random_sparse()
    Acsr = CSR.from_dense(A)
    ell = EllOperator.from_csr(Acsr)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    vals = ell.pack(Acsr.data)
    y = np.asarray(ell.matvec(vals, x))
    assert np.allclose(y, A @ x)
    Y = np.asarray(ell.matmat(vals, np.stack([x, 2 * x], axis=1)))
    assert np.allclose(Y[:, 1], 2 * A @ x)


def test_cuthill_mckee_reduces_bandwidth():
    A = random_sparse(400, 4, seed=2)
    A += A.T  # symmetric pattern helps CMK
    Acsr = CSR.from_dense(A)
    perm = cuthill_mckee(Acsr)
    assert sorted(perm.tolist()) == list(range(400))
    b0 = bandwidth(Acsr)
    b1 = bandwidth(permute_csr(Acsr, perm))
    assert b1 < b0


def test_bsr_roundtrip_and_xla():
    A = random_sparse(300, 6)
    Acsr = CSR.from_dense(A)
    bsr = BsrOperator.from_csr(Acsr, bs=64)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(300) + 1j * rng.standard_normal(300))
    assert np.allclose(bsr.matvec_reference(x), A @ x)
    f = bsr_spmm_xla(bsr)
    X = (rng.standard_normal((300, 8))
         + 1j * rng.standard_normal((300, 8))).astype(np.complex64)
    Y = f(X)
    rel = np.abs(Y - A @ X).max() / np.abs(A @ X).max()
    assert rel < 1e-5  # complex64 path


def test_device_stacked_operator():
    A = random_sparse(200, 5, seed=5)
    B = random_sparse(200, 5, seed=6)
    st = StackedOperator.from_csrs([CSR.from_dense(A), CSR.from_dense(B)])
    dso = DeviceStackedOperator(st, dtype=np.complex128)
    c = np.array([0.3 + 1j, -2.0], complex)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(200) + 1j * rng.standard_normal(200)
    ref = (c[0] * A + c[1] * B)
    assert np.allclose(np.asarray(dso.matvec(c, x)), ref @ x)
    assert np.allclose(np.asarray(dso.dense(c)), ref)
    # batched dense assembly
    C = np.stack([c, 2 * c])
    D = np.asarray(dso.dense(C))
    assert np.allclose(D[1], 2 * ref)

"""Coefficient-function algebra: analytic derivatives vs finite differences
and vs hand computations (reference semantics: src/NLEVP/algebra.jl)."""
import numpy as np
import pytest

from wavesandeigenvalues_jl_tpu.nlevp import algebra as alg


def fd(f, z, k, h=1e-5):
    """k-th derivative by central differences (complex-step unfriendly
    because the functions are holomorphic — plain central FD suffices)."""
    if k == 0:
        return f(z)
    return (fd(f, z + h, k - 1, h) - fd(f, z - h, k - 1, h)) / (2 * h)


def test_pow_basic():
    z = 1.7 - 0.3j
    assert alg.pow0.eval((z,), (0,)) == 1
    assert alg.pow0.eval((z,), (1,)) == 0
    assert alg.pow1.eval((z,), (0,)) == z
    assert alg.pow1.eval((z,), (1,)) == 1
    assert alg.pow1.eval((z,), (2,)) == 0
    assert alg.pow2.eval((z,), (0,)) == z ** 2
    assert alg.pow2.eval((z,), (1,)) == 2 * z
    assert alg.pow2.eval((z,), (2,)) == 2
    assert alg.pow2.eval((z,), (3,)) == 0


def test_pow_a():
    z = 0.9 + 0.2j
    p4 = alg.pow_a(4)
    for k in range(6):
        ref = fd(lambda w: w ** 4, z, k, h=1e-2)
        assert abs(p4.eval((z,), (k,)) - ref) < 1e-3 * max(1, abs(ref))
    # fractional exponent
    ph = alg.pow_a(0.5)
    assert abs(ph.eval((z,), (1,)) - 0.5 * z ** (-0.5)) < 1e-12


def test_exp_az():
    a = 0.3 - 1.1j
    f = alg.ExpAz(a)
    z = 0.4 + 0.8j
    for k in range(4):
        assert abs(f.eval((z,), (k,)) - a ** k * np.exp(a * z)) < 1e-12


@pytest.mark.parametrize("m,n", [(0, 0), (1, 0), (0, 1), (2, 1), (1, 2),
                                 (3, 2), (4, 4)])
def test_exp_delay_mixed_derivs(m, n):
    sp = pytest.importorskip("sympy")
    w, tau = 2.0 + 0.5j, 0.7 - 0.1j
    ws, ts = sp.symbols("w t")
    expr = sp.exp(-sp.I * ws * ts)
    d = sp.diff(expr, ws, m, ts, n)
    ref = complex(d.subs({ws: w, ts: tau}).evalf())
    val = alg.exp_delay.eval((w, tau), (m, n))
    assert abs(val - ref) < 1e-10 * max(1.0, abs(ref))


def test_z_times_g():
    g = alg.ExpAz(-0.5j)
    f = alg.generate_z_g_z(g)
    z = 1.3 + 0.4j
    for k in range(4):
        ref = fd(lambda w: w * np.exp(-0.5j * w), z, k, h=1e-3)
        assert abs(f.eval((z,), (k,)) - ref) < 1e-4 * max(1, abs(ref))


def test_state_space():
    A = np.array([[-1.0, 0.3], [0.0, -2.0]])
    B = np.array([1.0, 0.5])
    C = np.array([0.2, 1.0])
    D = 0.1
    f = alg.generate_stsp_z(A, B, C, D)
    z = 0.9 + 0.2j

    def g(w):
        return C @ np.linalg.solve(1j * w * np.eye(2) - A, B) + D

    for k in range(3):
        ref = fd(g, z, k, h=1e-4)
        assert abs(f.eval((z,), (k,)) - ref) < 1e-5 * max(1, abs(ref))


def test_product_and_one_minus():
    g = alg.ExpAz(0.2j)
    h = alg.pow2
    f = alg.generate_gz_hz(g, h)
    z = 0.5 - 0.3j
    for k in range(4):
        ref = fd(lambda w: np.exp(0.2j * w) * w ** 2, z, k, h=1e-3)
        assert abs(f.eval((z,), (k,)) - ref) < 1e-4 * max(1, abs(ref))
    om = alg.generate_1_gz(g)
    assert abs(om.eval((z,), (0,)) - (1 - np.exp(0.2j * z))) < 1e-12
    assert abs(om.eval((z,), (2,)) + (0.2j) ** 2 * np.exp(0.2j * z)) < 1e-12


def test_bloch_filter():
    # DFT of unit impulse/DOS: filter is 1 at integer b≡0 (mod N), ~0 else
    DOS = 12
    y = np.zeros(DOS, complex)
    y[0] = 1.0 / DOS
    y = np.fft.fft(y)
    f = alg.generate_sum_y_exp_ikx(y)
    assert abs(f.eval((0.0 + 0j,), (0,)) - 1.0) < 1e-12
    for b in range(1, DOS):
        assert abs(f.eval((complex(b),), (0,))) < 1e-12
    assert abs(f.eval((complex(DOS),), (0,)) - 1.0) < 1e-12


def test_fancy_flame():
    w, tau, a = 1.1 + 0.3j, 0.4, 0.05
    f = alg.exp_az2mzit
    ref = np.exp(a * w ** 2 - 1j * w * tau)
    assert abs(f.eval((w, tau, a), (0, 0, 0)) - ref) < 1e-12
    h = 1e-5
    d1 = (np.exp(a * (w + h) ** 2 - 1j * (w + h) * tau)
          - np.exp(a * (w - h) ** 2 - 1j * (w - h) * tau)) / (2 * h)
    assert abs(f.eval((w, tau, a), (1, 0, 0)) - d1) < 1e-6


def test_raw_reference_functions():
    """Raw reference-signature exports (algebra.jl): pow, exp_az,
    z_exp_iaz/z_exp__iaz, exp_pm, generate_exp_az, sum_n_exp_az2mzit."""
    from wavesandeigenvalues_jl_tpu.nlevp import (exp_az, exp_pm,
                                                  generate_exp_az, pow,
                                                  z_exp__iaz, z_exp_iaz)
    assert np.isclose(pow(2.0, 1, 3), 12.0)          # d/dz z^3 at 2
    assert np.isclose(pow(2.0, 0, 0.5), np.sqrt(2))
    assert np.isclose(exp_az(1.0, 3.0, 2), 9 * np.exp(3.0))
    g = generate_exp_az(2.0 + 1.0j)
    assert np.isclose(g.eval((0.5,), (1,)), (2 + 1j) * np.exp((2 + 1j) * 0.5))
    # z·exp(±iaz) values and first derivatives
    z, a = 1.3, 0.7
    assert np.isclose(z_exp_iaz(z, a), z * np.exp(1j * a * z))
    assert np.isclose(z_exp_iaz(z, a, 1, 0),
                      (1j * a * z + 1) * np.exp(1j * a * z))
    assert np.isclose(z_exp__iaz(z, a, 0, 1), -1j * z ** 2 * np.exp(-1j * a * z))
    # exp_pm(s) equals exp_delay with flipped sign convention
    f = exp_pm(-1)
    assert np.isclose(f.eval((z, a), (0, 0)), np.exp(-1j * z * a))
    h = 1e-6
    fd = (f.eval((z, a + h), (0, 0)) - f.eval((z, a - h), (0, 0))) / (2 * h)
    assert np.isclose(f.eval((z, a), (0, 1)), fd, atol=1e-6)

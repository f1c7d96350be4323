"""Tests for the TV-1D prox: device ADMM-DCT kernel vs two exact oracles
(scipy bound-constrained dual LSQ, and the host taut-string algorithm)."""

import numpy as np
import pytest
import scipy.optimize
import jax.numpy as jnp

from epsilon_tpu.ops.prox import tv1d
from oracles import check_prox_vi


def _tv_oracle_dual(v, lam):
    """Exact via the dual box-constrained least squares:
    min_z ||D^T z - v||^2, |z| <= lam; x = v - D^T z."""
    n = v.size
    D = np.zeros((n - 1, n))
    for i in range(n - 1):
        D[i, i] = -1.0
        D[i, i + 1] = 1.0
    res = scipy.optimize.lsq_linear(D.T, v, bounds=(-lam, lam), tol=1e-14,
                                    max_iter=500)
    return v - D.T @ res.x


@pytest.mark.parametrize("trial", range(4))
def test_tv1d_vs_dual_oracle(trial):
    rng = np.random.RandomState(trial)
    n = 40
    v = np.cumsum(rng.randn(n)) * 0.5  # random-walk signal
    lam = 10.0 ** rng.uniform(-1.5, 0.7)
    x = np.asarray(tv1d.prox_tv1d(jnp.asarray(v), lam, iters=400))
    x_oracle = _tv_oracle_dual(v, lam)
    np.testing.assert_allclose(x, x_oracle, atol=2e-5)
    f = lambda z: np.sum(np.abs(np.diff(z)))
    check_prox_vi(f, v, lam, x, rng=rng, tol=1e-4)


@pytest.mark.parametrize("trial", range(4))
def test_taut_string_exact(trial):
    rng = np.random.RandomState(10 + trial)
    n = 60
    v = np.cumsum(rng.randn(n))
    lam = 10.0 ** rng.uniform(-1.5, 0.7)
    x = tv1d.tv1d_exact_numpy(v, lam)
    x_oracle = _tv_oracle_dual(v, lam)
    np.testing.assert_allclose(x, x_oracle, atol=1e-9)


def test_taut_string_edge_cases():
    np.testing.assert_allclose(tv1d.tv1d_exact_numpy(np.array([3.0]), 1.0), [3.0])
    v = np.array([1.0, 1.0, 1.0])
    np.testing.assert_allclose(tv1d.tv1d_exact_numpy(v, 0.5), v)
    # large lam -> constant at mean
    v = np.array([0.0, 1.0, 2.0, 3.0])
    np.testing.assert_allclose(tv1d.tv1d_exact_numpy(v, 100.0),
                               np.full(4, 1.5), atol=1e-12)


def test_tv1d_device_matches_taut_string(rng):
    n = 128
    v = np.repeat(rng.randn(8), 16) + 0.1 * rng.randn(n)  # piecewise const
    lam = 0.5
    x_dev = np.asarray(tv1d.prox_tv1d(jnp.asarray(v), lam, iters=500))
    x_exact = tv1d.tv1d_exact_numpy(v, lam)
    np.testing.assert_allclose(x_dev, x_exact, atol=5e-5)


# ---------------------------------------------------------------------------
# PDAS (the registry kernel): finite-termination exact solver
# ---------------------------------------------------------------------------

def _pw_const(rng, n, k=None):
    k = min(k or max(4, n // 64), n)
    jumps = np.zeros(n)
    jumps[rng.choice(n, k, replace=False)] = rng.randn(k) * 3
    return np.cumsum(jumps) + 0.3 * rng.randn(n)


@pytest.mark.parametrize("n", [2, 7, 64, 511, 4096])
def test_pdas_matches_taut_string(n):
    rng = np.random.RandomState(n)
    v = _pw_const(rng, n)
    lam = 0.8
    x, gap, iters = tv1d.prox_tv1d_pdas(jnp.asarray(v), lam)
    x_exact = tv1d.tv1d_exact_numpy(v, lam)
    np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-9)
    assert float(gap) <= float(tv1d.tv_gap_tol(jnp.asarray(v),
                                               tv1d.default_tv_tol(x.dtype)))
    assert int(iters) <= 25


def test_pdas_edge_cases():
    # n=1: no differences, x = v
    x, gap, _ = tv1d.prox_tv1d_pdas(jnp.asarray([3.0]), 1.0)
    np.testing.assert_allclose(np.asarray(x), [3.0])
    assert float(gap) == 0.0
    # lam=0: identity
    v = np.random.RandomState(0).randn(33)
    x, _, _ = tv1d.prox_tv1d_pdas(jnp.asarray(v), 0.0)
    np.testing.assert_allclose(np.asarray(x), v, atol=1e-12)
    # huge lam: constant at the mean
    v = np.array([0.0, 1.0, 2.0, 3.0])
    x, _, _ = tv1d.prox_tv1d_pdas(jnp.asarray(v), 100.0)
    np.testing.assert_allclose(np.asarray(x), np.full(4, 1.5), atol=1e-10)


def test_pdas_f32():
    rng = np.random.RandomState(7)
    v = _pw_const(rng, 4096)
    x, gap, _ = tv1d.prox_tv1d_pdas(jnp.asarray(v, jnp.float32), 1.0)
    assert x.dtype == jnp.float32
    x_exact = tv1d.tv1d_exact_numpy(v, 1.0)
    assert np.max(np.abs(np.asarray(x, np.float64) - x_exact)) < 1e-4


def test_pdas_warm_start_fewer_rounds():
    rng = np.random.RandomState(1)
    v = _pw_const(rng, 2048)
    lam = 1.0
    x, _, it_cold = tv1d.prox_tv1d_pdas(jnp.asarray(v), lam)
    # warm dual from the exact solution via stationarity z = -cumsum(v - x)
    z0 = -np.cumsum(v - np.asarray(x))[:-1]
    z0 = np.clip(z0, -lam, lam)
    _, _, it_warm = tv1d.prox_tv1d_pdas(jnp.asarray(v), lam,
                                        z0=jnp.asarray(z0))
    assert int(it_warm) <= 2 < int(it_cold)


def test_inner_tol_bounds_work():
    """VERDICT r2 item 7: a loose outer tolerance must not pay for
    machine-precision inner certificates."""
    from epsilon_tpu import config
    rng = np.random.RandomState(5)
    v = jnp.asarray(_pw_const(rng, 4096))
    _, gap_hi, it_loose = tv1d.prox_tv1d_pdas(v, 1.0, tol=1e-2)
    _, gap_lo, it_tight = tv1d.prox_tv1d_pdas(v, 1.0, tol=1e-12)
    assert int(it_loose) < int(it_tight)
    assert float(gap_hi) <= float(tv1d.tv_gap_tol(v, 1e-2))
    # and the solver maps its rel_tol a decade tighter, floored sanely
    assert config.prox_inner_tol_for(1e-3) == pytest.approx(1e-4)
    assert config.prox_inner_tol_for(0.0) is None
    assert config.prox_inner_tol_for(1e-9) == pytest.approx(1e-7)


# ---------------------------------------------------------------------------
# DR/certified alternative: the matmul conv x-update path (selected at n>=512)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 2048])
def test_conv_solve_matches_fft(n):
    rng = np.random.RandomState(n)
    r = rng.randn(n)
    for rho in [0.3, 7.0, 150.0]:
        ref = np.asarray(tv1d.neumann_laplacian_solve(jnp.asarray(r), rho))
        got = np.asarray(tv1d.neumann_laplacian_solve_conv(
            jnp.asarray(r), jnp.asarray(rho)))
        np.testing.assert_allclose(got, ref, atol=1e-7)


def test_conv_solve_batched():
    rng = np.random.RandomState(2)
    R = rng.randn(3, 700)
    rho = 5.0
    got = np.asarray(tv1d.neumann_laplacian_solve_conv(
        jnp.asarray(R), jnp.asarray(rho)))
    for i in range(3):
        ref = np.asarray(tv1d.neumann_laplacian_solve(jnp.asarray(R[i]), rho))
        np.testing.assert_allclose(got[i], ref, atol=1e-7)


@pytest.mark.parametrize("n", [512, 4096])
def test_certified_conv_path_matches_taut_string(n):
    """prox_tv1d_certified switches to the truncated-Toeplitz matmul solve at
    n >= 512; it must still certify against the exact host oracle."""
    rng = np.random.RandomState(n + 1)
    v = _pw_const(rng, n)
    lam = 0.7
    x, gap, iters = tv1d.prox_tv1d_certified(jnp.asarray(v), lam, tol=1e-7)
    x_exact = tv1d.tv1d_exact_numpy(v, lam)
    err = np.max(np.abs(np.asarray(x) - x_exact))
    assert err < 1e-5, (err, float(gap), int(iters))
    # the certificate itself bounds the error:  ||x - x*||^2 <= 2*gap
    assert np.sum((np.asarray(x) - x_exact) ** 2) <= 2 * float(gap) + 1e-12


def test_multiscale_odd_n_certificate():
    """Odd-length signals: the final certified solve runs on the ORIGINAL
    signal, so ||x - x*||^2 <= 2*gap holds for the true problem (round-2
    advisor finding: the old code certified the edge-padded problem)."""
    rng = np.random.RandomState(9)
    n = 4097
    v = _pw_const(rng, n)
    lam = 1.0
    x, gap, _ = tv1d.prox_tv1d_multiscale(jnp.asarray(v), lam, tol=1e-7,
                                          coarse_n=1024)
    assert x.shape == (n,)
    x_exact = tv1d.tv1d_exact_numpy(v, lam)
    assert np.sum((np.asarray(x) - x_exact) ** 2) <= 2 * float(gap) + 1e-12


@pytest.mark.slow
def test_pdas_million_points():
    """BASELINE config[2] correctness at scale: 1M-point TV certified to
    1e-6 against the exact host taut-string."""
    rng = np.random.RandomState(0)
    v = _pw_const(rng, 1_000_000, k=2000)
    lam = 1.0
    x, gap, iters = tv1d.prox_tv1d_pdas(jnp.asarray(v), lam)
    x_exact = tv1d.tv1d_exact_numpy(v, lam)
    assert np.max(np.abs(np.asarray(x) - x_exact)) < 1e-6
    assert int(iters) <= 30


def test_neumann_solve():
    rng = np.random.RandomState(3)
    n = 17
    r = rng.randn(n)
    rho = 0.7
    L = np.zeros((n, n))
    for i in range(n - 1):
        L[i, i] += 1
        L[i + 1, i + 1] += 1
        L[i, i + 1] -= 1
        L[i + 1, i] -= 1
    expected = np.linalg.solve(np.eye(n) + rho * L, r)
    got = np.asarray(tv1d.neumann_laplacian_solve(jnp.asarray(r), rho))
    np.testing.assert_allclose(got, expected, atol=1e-10)

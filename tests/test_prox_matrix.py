"""Oracle tests for spectral matrix prox kernels."""

import numpy as np
import pytest
import jax.numpy as jnp

from epsilon_tpu.ops.prox import matrix as mx
from oracles import (check_epigraph, check_prox_scipy, check_prox_vi,
                     check_projection_vi)

N_TRIALS = 3


def _sym(A):
    return 0.5 * (A + A.T)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_semidefinite(trial):
    rng = np.random.RandomState(trial)
    n = 5
    V = _sym(rng.randn(n, n) * 2)
    X = np.asarray(mx.prox_semidefinite(jnp.asarray(V)))
    # feasibility
    assert np.min(np.linalg.eigvalsh(X)) >= -1e-9

    def sampler(rng):
        B = rng.randn(n, n)
        return (B @ B.T * 10.0 ** rng.uniform(-2, 0.5),)

    check_projection_vi(sampler, (V,), (X,), rng=rng)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_neg_log_det(trial):
    rng = np.random.RandomState(10 + trial)
    n = 4
    V = _sym(rng.randn(n, n))
    lam = 10.0 ** rng.uniform(-1.5, 0.5)
    X = np.asarray(mx.prox_neg_log_det(jnp.asarray(V), lam))
    assert np.min(np.linalg.eigvalsh(X)) > 0

    def f(Z):
        Z = _sym(Z.reshape(n, n))
        w = np.linalg.eigvalsh(Z)
        if np.any(w <= 0):
            return np.inf
        return -np.sum(np.log(w))

    def sampler(rng):
        B = rng.randn(n, n) * 10.0 ** rng.uniform(-1, 0.5)
        return (X + _sym(B)).ravel()

    check_prox_vi(f, V.ravel(), lam, X.ravel(), sampler=sampler, rng=rng)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_norm_nuclear(trial):
    rng = np.random.RandomState(20 + trial)
    m, n = 5, 4
    V = rng.randn(m, n) * 2
    lam = 10.0 ** rng.uniform(-1.5, 0.5)
    X = np.asarray(mx.prox_norm_nuclear(jnp.asarray(V), lam))

    def f(Z):
        return np.sum(np.linalg.svd(Z.reshape(m, n), compute_uv=False))

    check_prox_vi(f, V.ravel(), lam, X.ravel(), rng=rng)
    # spot check: SVT formula
    U, s, Vt = np.linalg.svd(V, full_matrices=False)
    np.testing.assert_allclose(X, (U * np.maximum(s - lam, 0)) @ Vt, atol=1e-8)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_lambda_max(trial):
    rng = np.random.RandomState(30 + trial)
    n = 5
    V = _sym(rng.randn(n, n) * 2)
    lam = 10.0 ** rng.uniform(-1.5, 0.5)
    X = np.asarray(mx.prox_lambda_max(jnp.asarray(V), lam))

    def f(Z):
        return np.max(np.linalg.eigvalsh(_sym(Z.reshape(n, n))))

    def sampler(rng):
        B = rng.randn(n, n) * 10.0 ** rng.uniform(-2, 0.5)
        return (X + _sym(B)).ravel()

    check_prox_vi(f, V.ravel(), lam, X.ravel(), sampler=sampler, rng=rng)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_epi_neg_log_det(trial):
    rng = np.random.RandomState(40 + trial)
    n = 3
    V = _sym(rng.randn(n, n))
    s = rng.randn() * 2
    X, t = mx.epi_neg_log_det(jnp.asarray(V), s)
    X, t = np.asarray(X), float(t)

    def f(Z):
        w = np.linalg.eigvalsh(_sym(Z))
        if np.any(w <= 0):
            return np.inf
        return -np.sum(np.log(w))

    assert f(X) <= t + 1e-6

    def sampler(rng):
        B = rng.randn(n, n) * 10.0 ** rng.uniform(-2, 0)
        Z = _sym(X + _sym(B))
        w = np.linalg.eigvalsh(Z)
        if np.any(w <= 1e-9):
            Z = Z + (1e-6 - min(w.min(), 0)) * np.eye(n)
        u = f(Z) + abs(rng.randn())
        return Z.ravel(), np.asarray([u])

    check_projection_vi(sampler, (V.ravel(), np.asarray([s])),
                        (X.ravel(), np.asarray([t])), rng=rng)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_epi_norm_nuclear(trial):
    rng = np.random.RandomState(50 + trial)
    m, n = 4, 3
    V = rng.randn(m, n)
    s = rng.randn() * 2
    X, t = mx.epi_norm_nuclear(jnp.asarray(V), s)
    X, t = np.asarray(X), float(t)

    def f(Z):
        return np.sum(np.linalg.svd(Z.reshape(m, n), compute_uv=False))

    assert f(X.ravel()) <= t + 1e-6

    def sampler(rng):
        Z = X + rng.randn(m, n) * 10.0 ** rng.uniform(-2, 0.3)
        u = f(Z.ravel()) + abs(rng.randn())
        return Z.ravel(), np.asarray([u])

    check_projection_vi(sampler, (V.ravel(), np.asarray([s])),
                        (X.ravel(), np.asarray([t])), rng=rng)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_epi_lambda_max(trial):
    rng = np.random.RandomState(60 + trial)
    n = 4
    V = _sym(rng.randn(n, n) * 2)
    s = rng.randn()
    X, t = mx.epi_lambda_max(jnp.asarray(V), s)
    X, t = np.asarray(X), float(t)

    def f(Z):
        return np.max(np.linalg.eigvalsh(_sym(Z)))

    assert f(X) <= t + 1e-8

    def sampler(rng):
        Z = _sym(X + rng.randn(n, n) * 10.0 ** rng.uniform(-2, 0.3))
        u = f(Z) + abs(rng.randn())
        return Z.ravel(), np.asarray([u])

    check_projection_vi(sampler, (V.ravel(), np.asarray([s])),
                        (X.ravel(), np.asarray([t])), rng=rng)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_sigma_max(trial):
    rng = np.random.RandomState(160 + trial)
    m, n = 5, 4
    V = rng.randn(m, n) * 2
    lam = 10.0 ** rng.uniform(-2, 1)
    X = np.asarray(mx.prox_sigma_max(jnp.asarray(V), lam))
    f = lambda Z: np.linalg.norm(np.asarray(Z).reshape(m, n), 2)
    check_prox_vi(lambda z: f(z), V.ravel(), lam, X.ravel(), rng=rng)
    check_prox_scipy(lambda z: f(z), V.ravel(), lam, X.ravel(), rng=rng,
                     tol=1e-5)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_epi_sigma_max(trial):
    rng = np.random.RandomState(170 + trial)
    m, n = 4, 4
    V = rng.randn(m, n) * 2
    s = rng.randn() * 2
    X, t = mx.epi_sigma_max(jnp.asarray(V), s)
    f = lambda z: np.linalg.norm(np.asarray(z).reshape(m, n), 2)
    check_epigraph(f, V.ravel(), s, np.asarray(X).ravel(), float(t), rng=rng)


@pytest.mark.parametrize("n", [5, 40])
@pytest.mark.parametrize("kernel,expect", [
    ("prox_semidefinite", lambda n, lam: np.zeros((n, n))),
    ("prox_neg_log_det", lambda n, lam: np.sqrt(lam) * np.eye(n)),
    ("prox_lambda_max", lambda n, lam: -lam / n * np.eye(n)),
])
def test_spectral_prox_at_zero(n, kernel, expect):
    """ADMM starts every prox input at zero; the spectral kernels must map
    the zero matrix (alone and in a batch beside a nonzero one) exactly."""
    lam = 0.7
    got = np.asarray(getattr(mx, kernel)(jnp.zeros((n, n)), lam))
    np.testing.assert_allclose(got, expect(n, lam), atol=1e-12)
    if kernel == "prox_lambda_max":     # vector prox_max takes one spectrum
        return
    V = np.stack([np.zeros((n, n)), 2.0 * np.eye(n)])
    batch = np.asarray(getattr(mx, kernel)(jnp.asarray(V), lam))
    np.testing.assert_allclose(batch[0], expect(n, lam), atol=1e-12)
    np.testing.assert_allclose(
        batch[1], np.asarray(getattr(mx, kernel)(jnp.asarray(V[1]), lam)),
        atol=1e-12)


def test_spectral_eval_at_zero():
    assert float(mx.eval_lambda_max(jnp.zeros((40, 40)))) == 0.0
    assert float(mx.eval_neg_log_det(jnp.zeros((40, 40)))) == np.inf

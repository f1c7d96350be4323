"""Tests that need the card (marker ``gpu``).  Elsewhere the ``gpu``
fixture skips them; ``python chip_smoke.py`` runs them on the GPU."""

import numpy as np
import pytest

import jax.numpy as jnp

from epsilon_tpu import config
from epsilon_tpu.ops import linop
from epsilon_tpu.ops.linop import DenseOp, LuFactorOp, multiply

pytestmark = pytest.mark.gpu


def test_capability_row_on_card(gpu):
    assert gpu.platform == "gpu"
    assert config.capabilities() is config.CAPABILITIES["gpu"]
    assert config.use_explicit_inverse()


def test_device_factor_algebra_on_card(gpu, rng, monkeypatch):
    monkeypatch.setattr(linop, "_DEVICE_GEMM_MIN_FLOPS", 1.0)
    n = 300
    A = rng.randn(n, n)
    M = A @ A.T + n * np.eye(n)
    dm = multiply(DenseOp(M), DenseOp(np.eye(n)))
    assert dm._dev
    inv = dm.inverse()
    assert inv._dev
    np.testing.assert_allclose(inv.as_dense() @ M, np.eye(n), atol=1e-9)


def test_factor_apply_on_card(gpu, rng):
    n = 300
    M = rng.randn(n, n) + n * np.eye(n)
    op = LuFactorOp(M)
    X = rng.randn(n, 4)
    np.testing.assert_allclose(np.asarray(op.matmat(jnp.asarray(X))),
                               np.linalg.solve(M, X), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(op.T.matvec(jnp.asarray(X[:, 0]))),
                               np.linalg.solve(M.T, X[:, 0]), rtol=1e-9,
                               atol=1e-11)


def test_consensus_on_card(gpu):
    from epsilon_tpu.parallel import consensus_lasso_solver
    rng = np.random.RandomState(0)
    A = rng.randn(8, 40, 12)
    b = rng.randn(8, 40)
    solver = consensus_lasso_solver(A, b, 1.0, rel_tol=1e-8, abs_tol=1e-12,
                                    max_iterations=20000)
    res = solver.solve()
    assert res.converged
    A2 = A.reshape(-1, 12)
    G, c = A2.T @ A2, A2.T @ b.ravel()
    # KKT of 1/2||Ax - b||^2 + ||x||_1 at the solver's answer
    z = np.asarray(res.z)
    g = G @ z - c
    on = np.abs(z) > 1e-9
    np.testing.assert_allclose(g[on], -np.sign(z[on]), atol=1e-5)
    assert np.all(np.abs(g[~on]) <= 1 + 1e-5)


@pytest.mark.parametrize("kernel", ["prox_semidefinite", "prox_neg_log_det",
                                    "prox_lambda_max", "prox_norm_nuclear",
                                    "prox_sigma_max"])
def test_spectral_prox_at_zero_on_card(gpu, kernel):
    """The card's eigh/SVD above 32x32 must not turn ADMM's all-zero first
    prox input into NaN."""
    from epsilon_tpu.ops.prox import matrix
    x = getattr(matrix, kernel)(jnp.zeros((64, 64)), 0.5)
    assert np.isfinite(np.asarray(x)).all()

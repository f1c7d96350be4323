"""Adaptive-rho (residual balancing) two-block ADMM.

The reference hard-requires rho == 1 (``prox_admm.cc:51``) and bakes
sqrt(rho) into every cached factorization (``prox_admm_two_block.cc:52-88``),
so it cannot adapt rho at all.  This build carries rho in the jitted loop
state and parameterizes the prox applies by rho:

- projections (ZERO / SOC / epigraphs) are rho-invariant,
- canonical kernels take lam -> lam/rho,
- quadratics apply through a cached eigendecomposition Q/(w+rho) Q'.

These tests validate each rho-parameterized operator against closed forms
and the full adaptive solve against the fixed-rho solver and oracle.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import epsilon_tpu as ep
from epsilon_tpu.solvers import SolverKind

from epsilon_tpu.ir import (AffineOperator, ProxFunctionSpec, ProxKind,
                            arg_key)
from epsilon_tpu.ops import linop
from epsilon_tpu.ops.block import BlockMatrix, BlockVector
from epsilon_tpu.ops.prox.operator import create_rho_prox_operator
from epsilon_tpu.solvers import ProxADMMTwoBlockSolver, SolverParams

from test_solvers import lasso_oracle, make_lasso_problem, _lasso_objective


def _identity_arg(n, var="x"):
    return AffineOperator(
        BlockMatrix({(arg_key(0), var): linop.identity(n)}), BlockVector())


@pytest.mark.parametrize("rho", [0.25, 1.0, 7.5])
def test_rho_sum_square_closed_form(rng, rho):
    m, n, alpha = 8, 5, 0.7
    H = rng.randn(m, n)
    g = rng.randn(m)
    v = rng.randn(n)
    spec = ProxFunctionSpec(kind=ProxKind.SUM_SQUARE, alpha=alpha)
    aff = AffineOperator(
        BlockMatrix({(arg_key(0), "x"): linop.dense(H)}),
        BlockVector({arg_key(0): jnp.asarray(g)}))
    op = create_rho_prox_operator(spec, aff, {"x": n})

    x = np.asarray(op.apply_rho(BlockVector({"x": jnp.asarray(v)}),
                                jnp.asarray(rho))["x"])
    # argmin alpha||Hx+g||^2 + rho/2||x-v||^2
    x_ref = np.linalg.solve(2 * alpha * H.T @ H + rho * np.eye(n),
                            rho * v - 2 * alpha * H.T @ g)
    np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("rho", [0.5, 4.0])
def test_rho_norm1_lam_scaling(rng, rho):
    n, alpha = 12, 1.3
    v = rng.randn(n)
    spec = ProxFunctionSpec(kind=ProxKind.NORM_1, alpha=alpha)
    op = create_rho_prox_operator(spec, _identity_arg(n), {"x": n})

    x = np.asarray(op.apply_rho(BlockVector({"x": jnp.asarray(v)}),
                                jnp.asarray(rho))["x"])
    t = alpha / rho
    x_ref = np.sign(v) * np.maximum(np.abs(v) - t, 0.0)
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12)


def test_rho_affine_closed_form(rng):
    n, alpha, rho = 6, 2.0, 3.0
    c = rng.randn(n)
    v = rng.randn(n)
    spec = ProxFunctionSpec(kind=ProxKind.AFFINE, alpha=alpha)
    aff = AffineOperator(
        BlockMatrix({(arg_key(0), "x"): linop.dense(c[None, :])}),
        BlockVector())
    op = create_rho_prox_operator(spec, aff, {"x": n})

    x = np.asarray(op.apply_rho(BlockVector({"x": jnp.asarray(v)}),
                                jnp.asarray(rho))["x"])
    np.testing.assert_allclose(x, v - alpha * c / rho, rtol=1e-10, atol=1e-12)


def test_rho_projection_invariance(rng):
    # ZERO prox (projection onto {x - y = 0}) ignores rho entirely
    n = 5
    spec = ProxFunctionSpec(kind=ProxKind.ZERO)
    aff = AffineOperator(
        BlockMatrix({(arg_key(0), "x"): linop.identity(n),
                     (arg_key(0), "y"): linop.scalar(-1.0, n)}),
        BlockVector())
    op = create_rho_prox_operator(spec, aff, {"x": n, "y": n})
    v = BlockVector({"x": jnp.asarray(rng.randn(n)),
                     "y": jnp.asarray(rng.randn(n))})
    x1 = op.apply_rho(v, jnp.asarray(0.1))
    x2 = op.apply_rho(v, jnp.asarray(50.0))
    avg = 0.5 * (np.asarray(v["x"]) + np.asarray(v["y"]))
    for out in (x1, x2):
        np.testing.assert_allclose(np.asarray(out["x"]), avg, atol=1e-10)
        np.testing.assert_allclose(np.asarray(out["y"]), avg, atol=1e-10)


@pytest.mark.parametrize("drive", ["device", "host"])
def test_adaptive_lasso_matches_oracle(rng, drive):
    m, n = 30, 15
    A = rng.randn(m, n)
    x_true = rng.randn(n) * (rng.rand(n) < 0.3)
    b = A @ x_true + 0.1 * rng.randn(m)
    lam = 0.5

    prob = make_lasso_problem(A, b, lam)
    params = SolverParams(rel_tol=1e-5, abs_tol=1e-7, max_iterations=5000,
                          adaptive_rho=True, drive=drive)
    solver = ProxADMMTwoBlockSolver(prob, params)
    sol = solver.solve()
    x = np.asarray(sol["x"])

    x_o = lasso_oracle(A, b, lam)
    obj_ours = _lasso_objective(A, b, lam, x)
    obj_oracle = _lasso_objective(A, b, lam, x_o)
    assert obj_ours <= obj_oracle + 1e-3 * abs(obj_oracle) + 1e-5


def test_adaptive_beats_fixed_on_badly_scaled(rng):
    """On a badly scaled problem (||A|| >> 1), fixed rho=1 needs far more
    iterations than residual balancing."""
    m, n = 40, 20
    A = 30.0 * rng.randn(m, n)  # rho=1 is far from optimal
    x_true = rng.randn(n) * (rng.rand(n) < 0.4)
    b = A @ x_true + 0.1 * rng.randn(m)
    lam = 5.0

    common = dict(rel_tol=1e-4, abs_tol=1e-7, max_iterations=20000,
                  epoch_iterations=10)
    fixed = ProxADMMTwoBlockSolver(
        make_lasso_problem(A, b, lam), SolverParams(**common))
    fixed.solve()
    adaptive = ProxADMMTwoBlockSolver(
        make_lasso_problem(A, b, lam),
        SolverParams(adaptive_rho=True, **common))
    sol = adaptive.solve()

    assert adaptive.status.num_iterations < fixed.status.num_iterations
    # and the adaptive answer is still right
    x = np.asarray(sol["x"])
    x_o = lasso_oracle(A, b, lam)
    obj_ours = _lasso_objective(A, b, lam, x)
    obj_oracle = _lasso_objective(A, b, lam, x_o)
    assert obj_ours <= obj_oracle + 1e-2 * abs(obj_oracle) + 1e-4


def test_nblock_rejects_adaptive(rng):
    from epsilon_tpu.solvers import ProxADMMSolver
    prob = make_lasso_problem(rng.randn(10, 5), rng.randn(10), 0.1)
    with pytest.raises(ValueError, match="adaptive_rho"):
        ProxADMMSolver(prob, SolverParams(adaptive_rho=True))


def test_adaptive_full_pipeline(rng):
    """Frontend -> compiler -> adaptive solver, with warm-start re-solve."""
    import epsilon_tpu as ep

    m, n = 25, 12
    A = rng.randn(m, n)
    b = rng.randn(m)
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + 0.3 * ep.norm1(x)))
    obj1 = prob.solve(rel_tol=1e-5, abs_tol=1e-7, adaptive_rho=True,
                      warm_start=True)
    obj2 = prob.solve(rel_tol=1e-5, abs_tol=1e-7, adaptive_rho=True,
                      warm_start=True)
    x_o = lasso_oracle(A, b, 0.3)
    obj_oracle = _lasso_objective(A, b, 0.3, x_o)
    for obj in (obj1, obj2):
        assert obj <= obj_oracle + 1e-3 * abs(obj_oracle) + 1e-5


class TestNBlockGeneralRho:
    """Beyond-parity: the N-block Gauss-Seidel solver accepts any fixed rho
    (the reference hard-requires rho == 1, ``prox_admm.cc:51``) by running
    the rho = 1 sweep on the sqrt(rho)-scaled constraint system."""

    def _lasso(self):
        rng = np.random.RandomState(5)
        m, n = 20, 10
        A = rng.randn(m, n)
        b = rng.randn(m)
        x = ep.Variable(n)
        prob = ep.Problem(ep.Minimize(
            0.5 * ep.sum_squares(A @ x - b) + 0.4 * ep.norm1(x)))
        from sklearn.linear_model import Lasso
        model = Lasso(alpha=0.4 / m, fit_intercept=False, tol=1e-12,
                      max_iter=100000)
        model.fit(A, b)
        oracle = (0.5 * np.sum((A @ model.coef_ - b) ** 2)
                  + 0.4 * np.abs(model.coef_).sum())
        return prob, x, model.coef_, oracle

    @pytest.mark.parametrize("rho", [0.25, 1.0, 4.0])
    def test_fixed_rho_converges(self, rho):
        prob, x, coef, oracle = self._lasso()
        obj = prob.solve(solver=SolverKind.PROX_ADMM, rho=rho,
                         rel_tol=1e-5, abs_tol=1e-7, max_iterations=8000)
        assert prob.status == "optimal"
        assert obj <= oracle + 1e-2 * abs(oracle) + 1e-4
        np.testing.assert_allclose(np.asarray(x.value).ravel(), coef,
                                   atol=2e-2)

    def test_rho_change_rebuilds_cached_solver(self):
        prob, x, coef, oracle = self._lasso()
        obj1 = prob.solve(solver=SolverKind.PROX_ADMM, rho=1.0,
                          rel_tol=1e-5, abs_tol=1e-7, max_iterations=8000)
        it1 = prob.solver_status.num_iterations
        obj2 = prob.solve(solver=SolverKind.PROX_ADMM, rho=4.0,
                          rel_tol=1e-5, abs_tol=1e-7, max_iterations=8000)
        assert prob.status == "optimal"
        assert abs(obj1 - obj2) <= 1e-2 * abs(obj1) + 1e-3

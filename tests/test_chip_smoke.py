"""``chip_smoke.py`` on the CPU: its numpy oracles, and every phase at tiny
size (the card runs the same functions at the published sizes)."""

import importlib.util
import os

import numpy as np
import pytest
import scipy.special

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def test_fista_oracle_meets_lasso_kkt(rng):
    A = rng.randn(40, 15)
    b = rng.randn(40)
    lam = 0.3 * np.abs(A.T @ b).max()
    x = cs.fista_l1_quadratic(A.T @ A, A.T @ b, lam)
    g = A.T @ (A @ x - b)
    on = x != 0
    assert on.any() and (~on).any()
    np.testing.assert_allclose(g[on], -lam * np.sign(x[on]), atol=1e-7)
    assert np.all(np.abs(g[~on]) <= lam + 1e-7)


def test_softmax_oracles(rng):
    F, y = cs.rff_instance(80, 12, 3)
    Theta = rng.randn(12, 3)
    Z = F @ Theta
    expect = (scipy.special.logsumexp(Z, axis=1) - Z[np.arange(80), y]).sum()
    assert np.isclose(cs.softmax_l1_objective(F, y, Theta, 0.1),
                      expect + 0.1 * np.abs(Theta).sum())
    # the residual vanishes at the optimum (long FISTA run) and not at 0
    L = np.linalg.norm(F, 2) ** 2 / 2
    T = Y = np.zeros((12, 3))
    t = 1.0
    for _ in range(20000):
        Tn = cs.soft_threshold(Y - cs._softmax_parts(F, y, Y)[1] / L, 0.1 / L)
        tn = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        Y, T, t = Tn + (t - 1) / tn * (Tn - T), Tn, tn
    assert max(cs.softmax_l1_residual(F, y, T, 0.1)) < 1e-6
    rel_grad, rel_start = cs.softmax_l1_residual(F, y, np.zeros((12, 3)), 0.1)
    assert rel_grad > 0.5 and rel_start == 1.0


def test_rff_instance_matches_generator():
    from epsilon_tpu.problems import mnist
    X, y = mnist._synthetic_digits(50, k=4)
    F = mnist.kitchen_sink_features(X, 16)
    F64, y64 = cs.rff_instance(50, 16, 4)
    assert np.array_equal(y, y64)
    np.testing.assert_allclose(F, F64, atol=1e-6)


@pytest.mark.parametrize("phase,kwargs", [
    ("phase_lasso", dict(m=60, n=30)),
    ("phase_mnist_rff", dict(m=1000, n=60, k=10)),
    ("phase_consensus", dict(S=4, m=40, n=10)),
    ("phase_tv_1m", dict(n=2000, reps=1)),
])
def test_phase_tiny(phase, kwargs):
    row = getattr(cs, phase)(**kwargs)
    assert row["oracle_error"] <= row["tolerance"]


@pytest.mark.parametrize("phase,kwargs", [
    ("multi_consensus", dict(S=8, m=40, n=10)),
    ("multi_terms", dict(m=60, n=30)),
    ("multi_scenarios", dict(S=8, m=20, n=6)),
])
def test_multi_device_phase_tiny(phase, kwargs):
    row = getattr(cs, phase)(4, **kwargs)
    assert row["oracle_error"] <= row["tolerance"]


def test_phase_failure_raises():
    with pytest.raises(AssertionError, match="exceeds tolerance"):
        cs._check({"phase": "x"}, 1.0, 1e-3)
    with pytest.raises(AssertionError):
        cs._check({"phase": "x"}, float("nan"), 1e-3)


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out

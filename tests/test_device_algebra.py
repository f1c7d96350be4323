"""Device-resident dense factor algebra (``ops/linop.py``).

On the GPU, compile-time operator algebra (Schur products, explicit
inverses) runs on the accelerator and its results STAY there — the host
never sees an n^2 intermediate.  These tests force that path onto the CPU
backend (``linop._FORCE_DEVICE_ALGEBRA``) and check it against the numpy
oracle.
Reference analogue: the eager Eigen products/factors of
``src/epsilon/vector/block_cholesky.cc:86-137`` and ``lapack.h:5-13``.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from epsilon_tpu.ir import AffineOperator, ProxFunctionSpec, ProxKind
from epsilon_tpu.ops import linop
from epsilon_tpu.ops.block import BlockMatrix, BlockVector
from epsilon_tpu.ops.cholesky import BlockCholesky
from epsilon_tpu.ops.linop import (DenseOp, DiagonalOp, ScalarOp, SparseOp,
                                   add, lift_apply, lift_collect, multiply)


@pytest.fixture
def device_algebra(monkeypatch):
    monkeypatch.setattr(linop, "_FORCE_DEVICE_ALGEBRA", True)
    monkeypatch.setattr(linop, "_DEVICE_GEMM_MIN_FLOPS", 1.0)
    yield


def test_product_stays_on_device(rng, device_algebra):
    A, B = rng.randn(40, 30), rng.randn(30, 20)
    P = multiply(DenseOp(A), DenseOp(B))
    assert P._dev
    assert np.allclose(P.as_dense(), A @ B)


def test_device_add_scalar_diag_dense(rng, device_algebra):
    M = rng.randn(25, 25)
    dm = multiply(DenseOp(M), DenseOp(np.eye(25)))
    assert dm._dev
    assert np.allclose(add(dm, ScalarOp(3.0, 25)).as_dense(),
                       M + 3 * np.eye(25))
    d = np.arange(25.0)
    assert np.allclose(add(dm, DiagonalOp(d)).as_dense(), M + np.diag(d))
    N = rng.randn(25, 25)
    dn = multiply(DenseOp(N), DenseOp(np.eye(25)))
    assert np.allclose(add(dm, dn).as_dense(), M + N)
    assert np.allclose(add(dm, DenseOp(N)).as_dense(), M + N)


def test_device_inverse_newton_refined(rng, device_algebra):
    M = rng.randn(30, 30)
    M = M @ M.T + 30 * np.eye(30)
    dm = multiply(DenseOp(M), DenseOp(np.eye(30)))
    inv = dm.inverse()
    assert isinstance(inv, DenseOp) and inv._dev
    assert np.allclose(inv.as_dense() @ M, np.eye(30), atol=1e-9)


def test_sparse_times_device_dense(rng, device_algebra):
    M = rng.randn(25, 25)
    dm = multiply(DenseOp(M), DenseOp(np.eye(25)))
    S = sp.random(30, 25, 0.3, random_state=1)
    assert np.allclose(multiply(SparseOp(S), dm).as_dense(),
                       S.toarray() @ M, atol=1e-10)
    S2 = sp.random(25, 15, 0.3, random_state=2)
    assert np.allclose(multiply(dm, SparseOp(S2)).as_dense(),
                       M @ S2.toarray(), atol=1e-10)


def test_device_transpose_and_scale(rng, device_algebra):
    M = rng.randn(20, 12)
    dm = multiply(DenseOp(M), DenseOp(np.eye(12)))
    assert np.allclose(dm.T.as_dense(), M.T)
    assert np.allclose(dm.scale(2.5).as_dense(), 2.5 * M)
    x = rng.randn(20)
    assert np.allclose(np.asarray(dm.T.matvec(jnp.asarray(x))), M.T @ x)


def test_transpose_shares_lifted_base(rng):
    """F and F' lift ONE buffer: the transpose applies inside the trace."""
    A = rng.randn(40, 30)
    da = DenseOp(A)
    dt = da.T
    assert dt.T is da
    with lift_collect() as lf:
        jax.eval_shape(lambda v: (da.matvec(v[:30]), dt.matvec(v[:40])),
                       jax.ShapeDtypeStruct((70,), jnp.float64))
    assert len(lf.arrays) == 1
    args = lf.device_args()
    v = rng.randn(30)
    w = rng.randn(40)
    with lift_apply(lf, args):
        y1 = da.matvec(jnp.asarray(v))
        y2 = dt.matvec(jnp.asarray(w))
    assert np.allclose(np.asarray(y1), A @ v)
    assert np.allclose(np.asarray(y2), A.T @ w)


def test_block_cholesky_with_device_blocks(rng, device_algebra):
    """KKT factor whose Schur complements are device-resident solves to the
    same answer as the host oracle (``zero.cc:8-36`` system)."""
    m, n = 8, 14
    H = rng.randn(m, n)
    M = BlockMatrix()
    M.insert("x", "c", DenseOp(H.T))
    M.insert("c", "x", DenseOp(H))
    M.insert("s", "x", ScalarOp(1.0, n))
    M.insert("x", "s", ScalarOp(1.0, n))
    M.insert("s", "s", ScalarOp(-1.0, n))
    chol = BlockCholesky(M).factor()
    b = BlockVector({"c": jnp.asarray(rng.randn(m)),
                     "s": jnp.asarray(rng.randn(n))})
    x = chol.solve(b)
    # oracle: dense KKT solve
    K = np.zeros((n + m + n, n + m + n))
    K[:n, n:n + m] = H.T
    K[n:n + m, :n] = H
    K[:n, n + m:] = np.eye(n)
    K[n + m:, :n] = np.eye(n)
    K[n + m:, n + m:] = -np.eye(n)
    rhs = np.concatenate([np.zeros(n), np.asarray(b["c"]), np.asarray(b["s"])])
    sol = np.linalg.solve(K, rhs)
    assert np.allclose(np.asarray(x["x"]), sol[:n], atol=1e-7)


def test_zero_prox_with_device_algebra(rng, device_algebra):
    """Projection onto {Hx = 0} through the device-resident factor matches
    the closed-form projector."""
    from epsilon_tpu.ops.prox.operator import create_prox_operator
    m, n = 8, 14
    H = rng.randn(m, n)
    Hb = BlockMatrix()
    Hb.insert("c0", "x", DenseOp(H))
    A = BlockMatrix({("x", "x"): ScalarOp(1.0, n)})
    op = create_prox_operator(ProxFunctionSpec(kind=ProxKind.ZERO),
                              AffineOperator(Hb, BlockVector()),
                              AffineOperator(A, BlockVector()))
    v = rng.randn(n)
    x = np.asarray(op.apply(BlockVector({"x": jnp.asarray(v)}))["x"])
    P = np.eye(n) - H.T @ np.linalg.solve(H @ H.T, H)
    assert np.allclose(x, P @ v, atol=1e-7)


@pytest.fixture
def fresh_operand_cache(monkeypatch):
    monkeypatch.setattr(linop, "_DEVICE_OPERAND_CACHE", {})
    monkeypatch.setattr(linop, "_DEVICE_OPERAND_LRU", [])


def test_device_operand_transpose_view_shares_base(rng, fresh_operand_cache):
    A = rng.randn(40, 30)
    assert np.array_equal(np.asarray(linop._device_operand(A.T)), A.T)
    # the base was uploaded once and serves both A and A.T
    assert np.array_equal(np.asarray(linop._device_operand(A)), A)
    assert sum(1 for _, nb in linop._DEVICE_OPERAND_LRU if nb) == 1


@pytest.mark.parametrize("view", ["rows", "reversed", "square_copy_view",
                                  "strided"])
def test_device_operand_non_transpose_view(rng, fresh_operand_cache, view):
    """A view that is not its base's transpose uploads its own data (it
    used to get ``base.T``: wrong data for square matrices)."""
    B = rng.randn(30, 30)
    A = {"rows": lambda: B[:20],
         "reversed": lambda: B[::-1],
         "square_copy_view": lambda: B[:],
         "strided": lambda: B[:, ::2]}[view]()
    assert A.base is B
    assert np.array_equal(np.asarray(linop._device_operand(A)), A)


def test_device_operand_view_through_device_product(rng, device_algebra,
                                                    fresh_operand_cache):
    B = rng.randn(30, 30)
    A = B[::-1]                          # a same-shape, non-transpose view
    got = linop._dense_product(A, np.eye(30))
    assert np.allclose(np.asarray(got), A)


@pytest.mark.parametrize("mode", ["inverse", "triangular"])
@pytest.mark.parametrize("kind", ["chol", "lu"])
def test_factor_apply_modes(rng, monkeypatch, mode, kind):
    """Cached-factor applies agree with the dense solve in both factor
    modes, for vectors, blocks and the transpose."""
    from epsilon_tpu import config
    from epsilon_tpu.ops.linop import CholFactorOp, LuFactorOp
    monkeypatch.setattr(config, "FACTOR_SOLVE_MODE", mode)
    n = 60
    A = rng.randn(n, n)
    M = A @ A.T + n * np.eye(n) if kind == "chol" else A + n * np.eye(n)
    op = CholFactorOp(M) if kind == "chol" else LuFactorOp(M)
    x, X = rng.randn(n), rng.randn(n, 5)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               np.linalg.solve(M, x), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(op.matmat(jnp.asarray(X))),
                               np.linalg.solve(M, X), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(op.T.matvec(jnp.asarray(x))),
                               np.linalg.solve(M.T, x), rtol=1e-8,
                               atol=1e-10)

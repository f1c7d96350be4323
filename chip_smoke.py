"""Run the solver end to end on the GPU and check every answer.

    python chip_smoke.py              # four phases on one card
    python chip_smoke.py --multi-gpu  # the sharded paths on four cards,
                                      # each against its one-card result

Every phase goes through the package's user entry points (``ep.Problem(...)
.solve(...)``, ``consensus_lasso_solver``, the TV prox kernel) at the
instance's published size, in float32 with matmul precision "highest", and
compares the answer with an oracle computed here in numpy float64.  Each
phase prints one ``phase {...}`` line; the last line of standard output is
``{"ok": true, "device": {...}}``.  There is no CPU fallback: without a GPU
the script exits non-zero and prints no result.  A failing phase raises,
which also exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# ---------------------------------------------------------------------------
# Oracles: numpy float64 on the host, sharing no code with the solver.
# ---------------------------------------------------------------------------


def soft_threshold(v, t):
    return np.sign(v) * np.maximum(np.abs(v) - t, 0.0)


def fista_l1_quadratic(G, c, lam, tol=1e-10, max_iter=1_000_000):
    """argmin_x 1/2 x'Gx - c'x + lam ||x||_1 by FISTA with adaptive restart,
    run until the prox-gradient step moves x by at most
    ``tol * max(1, ||x||)``."""
    G = np.asarray(G, np.float64)
    c = np.asarray(c, np.float64)
    L = np.linalg.eigvalsh(G)[-1]
    x = y = np.zeros_like(c)
    t = 1.0
    for _ in range(max_iter):
        x_new = soft_threshold(y - (G @ y - c) / L, lam / L)
        if np.linalg.norm(x_new - y) <= tol * max(1.0, np.linalg.norm(x_new)):
            return x_new
        if (y - x_new) @ (x_new - x) > 0:   # momentum points uphill: restart
            t = 1.0
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        y = x_new + (t - 1.0) / t_new * (x_new - x)
        x, t = x_new, t_new
    raise RuntimeError("FISTA oracle did not converge")


def lasso_objective(A, b, lam, x):
    r = np.asarray(A, np.float64) @ np.asarray(x, np.float64) - b
    return 0.5 * r @ r + lam * np.abs(x).sum()


def rff_instance(m, n, k, dim=50, seed=0, feature_seed=1):
    """Synthetic MNIST-RFF data rebuilt in float64 from the generator's
    seeds (``epsilon_tpu/problems/mnist.py``): class-conditional Gaussian
    digits and random Fourier features of the RBF kernel."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, dim) * 2
    y = rng.randint(0, k, m)
    X = centers[y] + rng.randn(m, dim)
    rng = np.random.RandomState(feature_seed)
    W = rng.randn(dim, n) / np.sqrt(dim)
    b = rng.uniform(0, 2 * np.pi, n)
    return np.sqrt(2.0 / n) * np.cos(X @ W + b), y


def _softmax_parts(F, y, Theta):
    Z = F @ Theta
    Z -= Z.max(axis=1, keepdims=True)
    lse = np.log(np.exp(Z).sum(axis=1))
    P = np.exp(Z - lse[:, None])
    P[np.arange(len(y)), y] -= 1.0
    return lse - Z[np.arange(len(y)), y], F.T @ P


def softmax_l1_objective(F, y, Theta, lam):
    """sum_i [logsumexp(F_i Theta) - F_i Theta_{y_i}] + lam ||Theta||_1."""
    loss, _ = _softmax_parts(F, y, Theta)
    return loss.sum() + lam * np.abs(Theta).sum()


def softmax_l1_residual(F, y, Theta, lam):
    """First-order optimality residual ||Theta - prox_{t lam|.|}(Theta -
    t grad f)|| / t with t = 2/||F||_2^2 (the inverse of a Lipschitz bound
    of grad f), zero exactly at the optimum.  Returns it relative to
    ||grad f(Theta)|| and relative to its own value at Theta = 0."""
    v = np.random.RandomState(0).randn(F.shape[1])
    for _ in range(50):                  # power iteration for ||F||_2^2
        v = F.T @ (F @ v)
        sigma2 = np.linalg.norm(v)
        v /= sigma2
    t = 2.0 / sigma2

    def residual(Th):
        _, grad = _softmax_parts(F, y, Th)
        step = Th - soft_threshold(Th - t * grad, t * lam)
        return np.linalg.norm(step / t), np.linalg.norm(grad)

    r, g = residual(Theta)
    r0, _ = residual(np.zeros_like(Theta))
    return r / g, r / r0


# ---------------------------------------------------------------------------
# Phases.  Sizes default to the published instances; the tests call the
# same functions at tiny sizes on the CPU.
# ---------------------------------------------------------------------------

class _CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, read from its
    monitoring events (a persistent-cache hit skips the backend compile)."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.total += duration

    def since(self, mark):
        return self.total - mark


_CLOCK = None


def _clock():
    global _CLOCK
    if _CLOCK is None:
        _CLOCK = _CompileClock()
    return _CLOCK


def _check(row, err, tol):
    row.update(oracle_error=err, tolerance=tol)
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"phase {row['phase']}: oracle error {err} "
                             f"exceeds tolerance {tol}: {row}")
    return row


def lasso_instance(m=2000, n=1000, seed=0):
    """The flagship lasso (``bench.py _workload``)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n) / np.sqrt(m)
    x0 = rng.randn(n) * (rng.rand(n) < 0.1)
    b = A @ x0 + 0.01 * rng.randn(m)
    lam = 0.1 * np.abs(A.T @ b).max()
    return A, b, lam


# Lasso: ADMM to rel_tol 1e-5 in float32.  A CPU float32 run at this size
# reaches an objective relative error of about 1e-6; the float32 envelope
# of a 2000-term objective is ~1e-6 too, so 1e-4 leaves two decades.
LASSO_REL_TOL = 1e-5
LASSO_TOL = 1e-4


def phase_lasso(m=2000, n=1000, mesh=None):
    import epsilon_tpu as ep
    clock = _clock()
    A, b, lam = lasso_instance(m, n)
    t0 = time.perf_counter()
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))
    build_s = time.perf_counter() - t0
    params = dict(rel_tol=LASSO_REL_TOL, abs_tol=1e-8, max_iterations=20000,
                  warm_start=True, mesh=mesh)
    c0, t0 = clock.total, time.perf_counter()
    prob.solve(**params)
    first_s = time.perf_counter() - t0
    st = prob.solver_status
    row = dict(phase="lasso", size=[m, n], build_s=build_s,
               construct_s=st.timing.init_usec / 1e6,
               compile_s=clock.since(c0), first_solve_s=first_s,
               iterations=st.num_iterations, status=prob.status)
    x_sol = np.asarray(x.value, np.float64).ravel()
    t0 = time.perf_counter()
    prob.solve(**params)
    row.update(warm_solve_s=time.perf_counter() - t0,
               warm_iterations=prob.solver_status.num_iterations)
    x_star = fista_l1_quadratic(A.T @ A, A.T @ b, lam)
    f_star = lasso_objective(A, b, lam, x_star)
    err = (lasso_objective(A, b, lam, x_sol) - f_star) / abs(f_star)
    row["x"] = x_sol
    return _check(row, abs(err), LASSO_TOL)


# MNIST-RFF: the reference's published instance (mnist.rst:238-243) at
# rel_tol 1e-3, where ADMM stops on its own residuals well short of
# first-order optimality.  The first-order residual relative to ||grad f||
# stays near 1 there, so the check uses it relative to its value at
# Theta = 0, the share of the initial optimality violation left.  Runs of
# this phase in float32 (CPU; H100 for the published size):
#
#   size         iters  vs ||grad||  vs Theta=0  f/f(0)  |reported-numpy|
#   1000x60        220     0.39        0.0065    0.042       5.8e-4
#   6000x400        80     0.77        0.014     0.019       5.4e-3
#   20000x1000      50     0.92        0.024     0.016       1.5e-2
#   60000x4000      30     0.976       --        0.021       3.3e-2  (H100)
#
# (f* = 175.7 at 6000x400 by f64 FISTA, against 263.8 reached.)  The
# residual share grows with size, so 0.1 leaves a factor of ~2 above the
# published size's expected value.  The objective must have fallen below 5%
# of its value at Theta = 0 (m log k).  The reported objective is evaluated
# on the solver's per-term copies, which agree with Theta only to the
# primal residual, hence 5e-2.
MNIST_RESIDUAL_TOL = 0.1
MNIST_DECREASE_TOL = 0.05
MNIST_OBJECTIVE_TOL = 5e-2


def phase_mnist_rff(m=60000, n=4000, k=10, lam=0.1):
    from epsilon_tpu.frontend import api
    from epsilon_tpu.problems import mnist
    clock = _clock()
    t0 = time.perf_counter()
    prob = mnist.create(m=m, n=n, k=k, lam=lam)
    build_s = time.perf_counter() - t0
    variables = {}
    api.expr_var_objects(prob.objective.expr, variables)
    (Theta,) = variables.values()
    params = dict(rel_tol=1e-3, abs_tol=1e-6, max_iterations=1000,
                  epoch_iterations=10, warm_start=True)
    c0, t0 = clock.total, time.perf_counter()
    obj = prob.solve(**params)
    first_s = time.perf_counter() - t0
    st = prob.solver_status
    row = dict(phase="mnist_rff", size=[m, n, k], build_s=build_s,
               construct_s=st.timing.init_usec / 1e6,
               compile_s=clock.since(c0), first_solve_s=first_s,
               iterations=st.num_iterations, status=prob.status,
               objective=obj)
    Th = np.asarray(Theta.value, np.float64)
    t0 = time.perf_counter()
    prob.solve(**params)
    row.update(warm_solve_s=time.perf_counter() - t0,
               warm_iterations=prob.solver_status.num_iterations)
    F64, y = rff_instance(m, n, k)
    obj64 = softmax_l1_objective(F64, y, Th, lam)
    row.update(objective_rel_error=abs(obj - obj64) / abs(obj64),
               objective_vs_start=obj64 / (m * np.log(k)))
    if not (row["objective_rel_error"] <= MNIST_OBJECTIVE_TOL
            and row["objective_vs_start"] <= MNIST_DECREASE_TOL):
        raise AssertionError(f"mnist_rff objective check failed: {row}")
    rel_grad, rel_start = softmax_l1_residual(F64, y, Th, lam)
    row["residual_vs_grad"] = rel_grad
    return _check(row, rel_start, MNIST_RESIDUAL_TOL)


# Consensus lasso, 1e8 nonzeros in A (bench.py row_consensus).  ADMM stops
# at rel_tol 1e-5; a CPU float32 run at S=20 reaches ||z - x*||_inf ~1e-5
# against max|x*| ~1, and the tolerance leaves a decade above it.
CONSENSUS_TOL = 1e-3


def consensus_instance(S=200, m=2500, n=200):
    from epsilon_tpu.problems.scaling_bench import make_blocks
    A, b = make_blocks(S, m, n)
    return A, b, 0.1


def consensus_oracle(A, b, lam):
    A2 = np.asarray(A, np.float64).reshape(-1, A.shape[-1])
    return fista_l1_quadratic(A2.T @ A2, A2.T @ np.asarray(b, np.float64)
                              .ravel(), lam)


def phase_consensus(S=200, m=2500, n=200, mesh=None, data=None):
    from epsilon_tpu.parallel import consensus_lasso_solver
    clock = _clock()
    A, b, lam = data or consensus_instance(S, m, n)
    t0 = time.perf_counter()
    solver = consensus_lasso_solver(A, b, lam, mesh=mesh, rel_tol=1e-5,
                                    abs_tol=1e-8, max_iterations=20000,
                                    epoch_iterations=50)
    construct_s = time.perf_counter() - t0
    c0, t0 = clock.total, time.perf_counter()
    res = solver.solve()
    first_s = time.perf_counter() - t0
    z = np.asarray(res.z, np.float64)
    t0 = time.perf_counter()
    res2 = solver.solve()
    row = dict(phase="consensus", size=[S, m, n], construct_s=construct_s,
               compile_s=clock.since(c0), first_solve_s=first_s,
               warm_solve_s=time.perf_counter() - t0,
               iterations=res.iterations,
               status="optimal" if res.converged else "max_iterations",
               warm_iterations=res2.iterations)
    if not res.converged:
        raise AssertionError(f"consensus did not converge: {row}")
    x_star = consensus_oracle(A, b, lam)
    row.update(z=z, solver=solver)
    return _check(row, float(np.abs(z - x_star).max()), CONSENSUS_TOL)


# Certified TV prox at n = 1e6 (bench.py row_tv_1m).  A CPU float32 run of
# this phase at full size differs from the exact taut string by ~2e-5 at
# most, on a signal of magnitude ~30; 1e-3 leaves over a decade.
TV_TOL = 1e-3


def tv_instance(n=1_000_000, seed=0):
    rng = np.random.RandomState(seed)
    return (np.cumsum((rng.rand(n) < 0.002) * rng.randn(n) * 3)
            + 0.3 * rng.randn(n)), 1.0


def phase_tv_1m(n=1_000_000, reps=5):
    """The registry kernel the solver calls, timed with its uncertified-gap
    warning (a host callback) on and off."""
    import os
    import jax
    import jax.numpy as jnp
    from epsilon_tpu import native
    from epsilon_tpu.ops.prox import tv1d
    from epsilon_tpu import config
    clock = _clock()
    v, lam = tv_instance(n)
    vj = jnp.asarray(v, jnp.float32)
    row = dict(phase="tv_1m", size=[n])
    saved = os.environ.get("EPSILON_TPU_TV_WARN")
    saved_tol = config.prox_inner_tol()
    # the inner tolerance is what the last solver left (tied to its
    # rel_tol); a standalone prox call takes the kernel's own default
    config.set_prox_inner_tol(None)
    try:
        for mode in ("1", "0"):
            os.environ["EPSILON_TPU_TV_WARN"] = mode
            # a fresh function per mode: the flag is read at trace time
            fn = jax.jit(lambda v, lam: tv1d.prox_tv1d_registry(v, lam))
            c0, t0 = clock.total, time.perf_counter()
            x = jax.block_until_ready(fn(vj, lam))
            first = time.perf_counter() - t0
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(vj, lam))
                ts.append(time.perf_counter() - t0)
            tag = "warn_on" if mode == "1" else "warn_off"
            row[f"{tag}_first_solve_s"] = first
            row[f"{tag}_compile_s"] = clock.since(c0)
            row[f"{tag}_warm_solve_s"] = sorted(ts)
            if mode == "1":
                x_on = np.asarray(x, np.float64)
    finally:
        config.set_prox_inner_tol(saved_tol)
        if saved is None:
            os.environ.pop("EPSILON_TPU_TV_WARN", None)
        else:
            os.environ["EPSILON_TPU_TV_WARN"] = saved
    _, gap, rounds = jax.jit(tv1d.prox_tv1d_pdas)(vj, lam)
    certified = float(gap) <= float(tv1d.tv_gap_tol(
        vj, tv1d.pdas_default_tol(vj.dtype)))
    row.update(iterations=int(rounds), duality_gap=float(gap),
               status="certified" if certified else "uncertified")
    x_exact = native.tv1d_prox(v, lam)
    return _check(row, float(np.abs(x_on - x_exact).max()), TV_TOL)


# ---------------------------------------------------------------------------
# Four cards: each sharded path against its one-card result.
# ---------------------------------------------------------------------------

def _assert_spread(arr, n_dev):
    """Each device holds its own 1/n_dev share of ``arr``."""
    devs = arr.sharding.device_set
    shard = [s.data.nbytes for s in arr.addressable_shards]
    if len(devs) != n_dev or max(shard) * n_dev != arr.nbytes:
        raise AssertionError(f"array {arr.shape} is not spread over "
                             f"{n_dev} devices: shards {shard}")


def multi_consensus(n_dev, S=200, m=2500, n=200):
    import jax
    from epsilon_tpu.parallel import block_mesh
    data = consensus_instance(S, m, n)
    one = phase_consensus(S, m, n, data=data)
    many = phase_consensus(S, m, n, mesh=block_mesh(n_dev), data=data)
    for leaf in jax.tree_util.tree_leaves(many["solver"].data):
        _assert_spread(leaf, n_dev)
    diff = float(np.abs(one["z"] - many["z"]).max())
    row = dict(phase=f"consensus_x{n_dev}", size=[S, m, n],
               one_card_s=one["warm_solve_s"], sharded_s=many["warm_solve_s"],
               iterations=[one["iterations"], many["iterations"]],
               sharded_oracle_error=many["oracle_error"])
    return _check(row, diff, CONSENSUS_TOL)


def multi_terms(n_dev, m=2000, n=1000):
    from epsilon_tpu.parallel import block_mesh
    one = phase_lasso(m, n)
    many = phase_lasso(m, n, mesh=block_mesh(n_dev, axis_name="terms"))
    row = dict(phase=f"term_sharded_lasso_x{n_dev}", size=[m, n],
               one_card_s=one["warm_solve_s"],
               sharded_first_s=many["first_solve_s"],
               iterations=[one["iterations"], many["iterations"]],
               sharded_oracle_error=many["oracle_error"])
    return _check(row, float(np.abs(one["x"] - many["x"]).max()),
                  LASSO_TOL * 10)


def scenario_problem(S, m, n, lam, seed=0):
    """min sum_i 1/2||A_i x_i - b_i||^2 + lam||z||_1  s.t.  x_i = z: the
    consensus template scenario stacking detects (``solvers/scenario.py``)."""
    from epsilon_tpu.ir import (AffineOperator, Cone, ConeConstraint,
                                ProxFunctionSpec, ProxKind, ProxProblem,
                                ProxTerm, arg_key)
    from epsilon_tpu.ops import linop
    from epsilon_tpu.ops.block import BlockMatrix, BlockVector
    from epsilon_tpu.problems.scaling_bench import make_blocks
    A, b = make_blocks(S, m, n, dtype=np.float64, seed=seed)
    terms, cons = [], []
    dims = {"z": n}
    for i in range(S):
        xi = f"x{i}"
        dims[xi] = n
        terms.append(ProxTerm(
            spec=ProxFunctionSpec(kind=ProxKind.SUM_SQUARE, alpha=0.5),
            H=AffineOperator(BlockMatrix({(arg_key(0), xi):
                                          linop.dense(A[i])}),
                             BlockVector({arg_key(0): -b[i]}))))
        cons.append(ConeConstraint(cone=Cone.ZERO, op=AffineOperator(
            BlockMatrix({(f"t{i}", xi): linop.identity(n),
                         (f"t{i}", "z"): linop.scalar(-1.0, n)}),
            BlockVector())))
    terms.append(ProxTerm(
        spec=ProxFunctionSpec(kind=ProxKind.NORM_1, alpha=lam),
        H=AffineOperator(BlockMatrix({(arg_key(0), "z"): linop.identity(n)}),
                         BlockVector())))
    prob = ProxProblem(terms=terms, constraints=cons, var_dims=dims,
                       var_shapes={k: (d, 1) for k, d in dims.items()})
    return prob, A, b


def multi_scenarios(n_dev, S=40, m=2500, n=200, lam=0.1):
    import jax
    from epsilon_tpu.parallel import block_mesh
    from epsilon_tpu.solvers import ProxADMMTwoBlockSolver, SolverParams
    prob, A, b = scenario_problem(S, m, n, lam)
    params = dict(rel_tol=1e-5, abs_tol=1e-8, max_iterations=20000)
    row = dict(phase=f"scenario_stacking_x{n_dev}", size=[S, m, n])
    z = {}
    for name, mesh in (("one_card", None),
                       ("sharded", block_mesh(n_dev, axis_name="terms"))):
        solver = ProxADMMTwoBlockSolver(prob, SolverParams(mesh=mesh,
                                                           **params))
        t0 = time.perf_counter()
        z[name] = np.asarray(solver.solve()["z"], np.float64).ravel()
        row[f"{name}_first_solve_s"] = time.perf_counter() - t0
        row[f"{name}_iterations"] = solver.status.num_iterations
    if len(solver.scn_groups) != 1 or solver.scn_groups[0].S != S:
        raise AssertionError("scenario stacking did not stack the terms")
    for arr in jax.tree_util.tree_leaves(solver._scn_args):
        _assert_spread(arr, n_dev)
    x_star = consensus_oracle(A, b, lam)
    row["sharded_oracle_error"] = float(np.abs(z["sharded"] - x_star).max())
    return _check(row, float(np.abs(z["one_card"] - z["sharded"]).max()),
                  CONSENSUS_TOL)


# ---------------------------------------------------------------------------


def run_card_tests():
    """The repository's ``gpu``-marked tests, in this process (it holds the
    card).  They run in float64, so this comes after the float32 phases."""
    import os
    import pytest
    os.environ["EPSILON_TPU_TEST_PLATFORM"] = "gpu"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_on_card.py")
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu", path])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")
    return dict(phase="card_tests", pytest_exit=int(rc),
                seconds=time.perf_counter() - t0)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()


def _print_row(row, setup):
    row = {k: v for k, v in row.items()
           if k not in ("x", "z", "solver")}
    print("phase " + json.dumps({**row, **setup}, default=float),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run the sharded paths on four cards instead")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX finds no GPU (devices: {devices})")
    n_dev = 4 if args.multi_gpu else 1
    if len(devices) < n_dev:
        sys.exit(f"chip_smoke: --multi-gpu needs {n_dev} GPUs, "
                 f"JAX finds {len(devices)}")

    from epsilon_tpu import config
    cache = config.enable_compile_cache()
    if config.default_dtype() != np.float32:
        sys.exit("chip_smoke: runs in float32; unset JAX_ENABLE_X64")
    cards = _card()
    print("card " + "; ".join(cards), flush=True)
    setup = dict(
        platform=devices[0].platform, device_kind=devices[0].device_kind,
        count=n_dev, card=cards[0] if n_dev == 1 else cards[:n_dev],
        matmul_precision=jax.config.jax_default_matmul_precision)
    print("setup " + json.dumps({**setup, "compile_cache": cache}),
          flush=True)

    if args.multi_gpu:
        phases = [lambda: multi_consensus(n_dev), lambda: multi_terms(n_dev),
                  lambda: multi_scenarios(n_dev)]
    else:
        phases = [phase_lasso, phase_mnist_rff, phase_consensus, phase_tv_1m,
                  run_card_tests]
    for phase in phases:
        _print_row(phase(), setup)

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": n_dev}}))


if __name__ == "__main__":
    main()

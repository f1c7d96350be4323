"""Worker process for the 2-process jax.distributed consensus test.

Launched by tests/test_distributed.py: each process owns 4 virtual CPU
devices; the global mesh spans 8 devices across both processes, so the
consensus psum reductions exercise the real cross-process collective path
(gloo) — the CI realization of SURVEY §2.4's multi-host design (NCCL
across GPU hosts).

Usage: python distributed_worker.py <pid> <nprocs> <port> <out.npz>
"""

import os
import sys

pid, nprocs, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from epsilon_tpu.parallel import initialize_distributed  # noqa: E402

initialize_distributed(coordinator_address=f"localhost:{port}",
                       num_processes=nprocs, process_id=pid)

import numpy as np  # noqa: E402
from epsilon_tpu.parallel import block_mesh, consensus_lasso_solver  # noqa: E402

assert len(jax.devices()) == 4 * nprocs, (
    f"expected {4 * nprocs} global devices, got {len(jax.devices())}")
assert len(jax.local_devices()) == 4

S, m, n, lam = 8, 60, 40, 0.4
rng = np.random.RandomState(0)
A = rng.randn(S, m, n) / np.sqrt(m)
x0 = rng.randn(n) * (rng.rand(n) < 0.2)
b = np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m)

mesh = block_mesh()      # all 8 global devices
solver = consensus_lasso_solver(A, b, lam, mesh=mesh, rel_tol=1e-6,
                                abs_tol=1e-9, max_iterations=2000,
                                epoch_iterations=25)
res = solver.solve()

if pid == 0:
    np.savez(out_path, z=np.asarray(res.z), iterations=res.iterations,
             r_norm=res.r_norm, converged=res.converged)
print(f"[proc {pid}] done: iters={res.iterations} r={res.r_norm:.2e}",
      flush=True)

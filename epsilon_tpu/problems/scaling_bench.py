"""Consensus-lasso scaling benchmark: iterations/s efficiency vs mesh size.

Realizes the BASELINE reporting requirement — iterations/s scaling
efficiency at 1 chip, 1 host, N >= 2 hosts — for the consensus lasso
workload (BASELINE config[4]).  On a multi-GPU host, run as-is; in CI it
runs on the virtual CPU mesh.

    python -m epsilon_tpu.problems.scaling_bench --nnz 1e8
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def make_blocks(S, m, n, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(S, m, n).astype(dtype) / np.sqrt(m)
    x0 = (rng.randn(n) * (rng.rand(n) < 0.1)).astype(dtype)
    b = np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m).astype(dtype)
    return A, b


def run_scaling(S=32, m=500, n=500, lam=0.1, iters=500,
                device_counts=None):
    """Time `iters` consensus iterations at several mesh sizes; returns
    [{devices, iters_per_sec, efficiency}]."""
    import jax
    from epsilon_tpu.parallel import block_mesh, consensus_lasso_solver

    A, b = make_blocks(S, m, n)
    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]

    results = []
    base_ips = None
    for d in device_counts:
        mesh = block_mesh(d) if d > 1 else None
        solver = consensus_lasso_solver(
            A, b, lam, mesh=mesh, rel_tol=0.0, abs_tol=0.0,
            max_iterations=iters, epoch_iterations=min(50, iters))
        solver.solve()          # compile + warm
        t0 = time.time()
        res = solver.solve()
        elapsed = time.time() - t0
        ips = res.iterations / elapsed
        if base_ips is None:
            base_ips = ips
        results.append(dict(devices=d, iters_per_sec=round(ips, 1),
                            efficiency=round(ips / base_ips, 3)))
    return results


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--S", type=int, default=32)
    parser.add_argument("--m", type=int, default=500)
    parser.add_argument("--n", type=int, default=500)
    parser.add_argument("--nnz", type=float, default=None,
                        help="target total nonzeros; overrides m (S*m*n=nnz)")
    parser.add_argument("--iters", type=int, default=500)
    parser.add_argument("--cpu-mesh", type=int, default=0, metavar="N",
                        help="force the CPU backend with N virtual devices")
    args = parser.parse_args()

    if args.cpu_mesh:
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{args.cpu_mesh}").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")

    m = args.m
    if args.nnz is not None:
        m = max(int(args.nnz / (args.S * args.n)), 8)
    results = run_scaling(S=args.S, m=m, n=args.n, iters=args.iters)
    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()

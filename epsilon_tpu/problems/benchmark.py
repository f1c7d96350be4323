"""Benchmark harness (``python/epopt/problems/benchmark.py:26-255``).

Runs the problem suite, reporting solve time / iterations / objective::

    python -m epsilon_tpu.problems.benchmark --problem=lasso
    python -m epsilon_tpu.problems.benchmark --scale   # log-spaced sweeps
    python -m epsilon_tpu.problems.benchmark --reference --isolate

The run exits non-zero if any row raised or timed out.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np


class ProblemInstance(NamedTuple):
    name: str
    create: Callable
    kwargs: Dict

    def create_problem(self):
        np.random.seed(0)
        out = self.create(**self.kwargs)
        if isinstance(out, tuple):
            return out[0]
        return out


def _p(mod):
    from . import (basis_pursuit, chebyshev, covsel, fused_lasso, group_lasso,
                   hinge_l1, hinge_l2, huber, infinite_push, lasso,
                   least_abs_dev, logreg_l1, lp, max_gaussian, max_softmax,
                   mnist, mv_lasso, oneclass_svm, portfolio, qp, quantile,
                   robust_pca, robust_svm, tv_1d, tv_denoise)
    return locals()[mod]


# Default suite sizes follow benchmark.py:26-54 (scaled down ~4x so the
# default run completes quickly on one chip; --large restores them).
PROBLEMS: List[ProblemInstance] = [
    ProblemInstance("basis_pursuit", _p("basis_pursuit").create, dict(m=300, n=1000)),
    ProblemInstance("covsel", _p("covsel").create, dict(m=30, n=60, lam=0.1)),
    ProblemInstance("fused_lasso", _p("fused_lasso").create, dict(m=250, ni=2, k=500)),
    ProblemInstance("group_lasso", _p("group_lasso").create, dict(m=375, ni=5, K=50)),
    ProblemInstance("hinge_l1", _p("hinge_l1").create, dict(m=375, n=2500)),
    ProblemInstance("hinge_l2", _p("hinge_l2").create, dict(m=1250, n=500)),
    ProblemInstance("huber", _p("huber").create, dict(m=1250, n=500)),
    ProblemInstance("lasso", _p("lasso").create, dict(m=375, n=2500)),
    ProblemInstance("least_abs_dev", _p("least_abs_dev").create, dict(m=1250, n=250)),
    ProblemInstance("logreg_l1", _p("logreg_l1").create, dict(m=375, n=2500)),
    ProblemInstance("lp", _p("lp").create, dict(m=200, n=400)),
    ProblemInstance("mnist", _p("mnist").create, dict(m=250, n=250, k=10)),
    ProblemInstance("mv_lasso", _p("mv_lasso").create, dict(m=375, n=625, k=4)),
    ProblemInstance("qp", _p("qp").create, dict(n=300)),
    ProblemInstance("quantile", _p("quantile").create, dict(m=100, n=10, k=5)),
    ProblemInstance("robust_pca", _p("robust_pca").create, dict(n=50)),
    ProblemInstance("tv_1d", _p("tv_1d").create, dict(n=25000)),
    ProblemInstance("tv_denoise", _p("tv_denoise").create, dict(n=50, lam=1.0)),
]

PROBLEMS_SMALL: List[ProblemInstance] = [
    ProblemInstance(p.name, p.create,
                    {k: (max(int(v // 10), 4) if isinstance(v, int) else v)
                     for k, v in p.kwargs.items()})
    for p in PROBLEMS
]


def PROBLEMS_REFERENCE() -> List[ProblemInstance]:
    """The reference's full 27-row suite at the reference's sizes
    (``python/epopt/problems/benchmark.py:26-54``), including the three
    sparse (`mu`) variants.  The `mnist` row substitutes the synthetic
    generator at DATA_SMALL-equivalent scale (the reference loaded real
    MNIST from disk)."""
    return [
        ProblemInstance("basis_pursuit", _p("basis_pursuit").create, dict(m=1000, n=3000)),
        ProblemInstance("chebyshev", _p("chebyshev").create, dict(m=100, n=200)),
        ProblemInstance("covsel", _p("covsel").create, dict(m=100, n=200, lam=0.1)),
        ProblemInstance("fused_lasso", _p("fused_lasso").create, dict(m=1000, ni=10, k=1000)),
        ProblemInstance("hinge_l1", _p("hinge_l1").create, dict(m=1500, n=5000, rho=0.01)),
        ProblemInstance("hinge_l1_sparse", _p("hinge_l1").create, dict(m=1500, n=50000, rho=0.01, mu=0.1)),
        ProblemInstance("hinge_l2", _p("hinge_l2").create, dict(m=5000, n=1500)),
        ProblemInstance("hinge_l2_sparse", _p("hinge_l2").create, dict(m=10000, n=1500, mu=0.1)),
        ProblemInstance("huber", _p("huber").create, dict(m=5000, n=200)),
        ProblemInstance("infinite_push", _p("infinite_push").create, dict(m=100, n=200, d=20)),
        ProblemInstance("lasso", _p("lasso").create, dict(m=1500, n=5000, rho=0.01)),
        ProblemInstance("lasso_sparse", _p("lasso").create, dict(m=1500, n=50000, rho=0.01, mu=0.1)),
        ProblemInstance("least_abs_dev", _p("least_abs_dev").create, dict(m=5000, n=200)),
        ProblemInstance("logreg_l1", _p("logreg_l1").create, dict(m=1500, n=5000, rho=0.01)),
        ProblemInstance("logreg_l1_sparse", _p("logreg_l1").create, dict(m=1500, n=50000, rho=0.01, mu=0.1)),
        ProblemInstance("lp", _p("lp").create, dict(m=800, n=1000)),
        ProblemInstance("max_gaussian", _p("max_gaussian").create, dict(m=10, n=10, k=3)),
        ProblemInstance("max_softmax", _p("max_softmax").create, dict(m=100, k=20, n=50)),
        ProblemInstance("mnist", _p("mnist").create, dict(m=10000, n=1000, k=10)),
        ProblemInstance("mv_lasso", _p("lasso").create, dict(m=1500, n=5000, k=10, rho=0.01)),
        ProblemInstance("oneclass_svm", _p("oneclass_svm").create, dict(m=5000, n=200)),
        ProblemInstance("portfolio", _p("portfolio").create, dict(m=500, n=500000)),
        ProblemInstance("qp", _p("qp").create, dict(n=1000)),
        ProblemInstance("quantile", _p("quantile").create, dict(m=400, n=10, k=100, p=1)),
        ProblemInstance("robust_pca", _p("robust_pca").create, dict(n=100)),
        ProblemInstance("robust_svm", _p("robust_svm").create, dict(m=2000, n=600)),
        ProblemInstance("tv_1d", _p("tv_1d").create, dict(n=100000)),
    ]


def _scale_problems() -> List[ProblemInstance]:
    """Log-spaced size sweeps (``benchmark.py:66-91``): the scaling curves
    behind the reference's benchmark graphs, built lazily so importing this
    module stays cheap."""
    out: List[ProblemInstance] = []
    out += [ProblemInstance(f"lasso_{int(m)}", _p("lasso").create,
                            dict(m=int(m), n=10 * int(m),
                                 rho=1 if m < 50 else 0.01))
            for m in np.logspace(1, np.log10(5000), 20)]
    out += [ProblemInstance(f"mv_lasso_{int(m)}", _p("mv_lasso").create,
                            dict(m=int(m), n=10 * int(m), k=10,
                                 rho=1 if m < 50 else 0.01))
            for m in np.logspace(1, np.log10(5000), 20)]
    out += [ProblemInstance(f"fused_lasso_{int(m)}", _p("fused_lasso").create,
                            dict(m=int(m), ni=10, k=int(m)))
            for m in np.logspace(1, 3, 20)]
    out += [ProblemInstance(f"hinge_l2_{int(n)}", _p("hinge_l2").create,
                            dict(m=10 * int(n), n=int(n)))
            for n in np.logspace(1, np.log10(5000), 20)]
    return out


def PROBLEMS_SCALE() -> List[ProblemInstance]:
    return _scale_problems()


def benchmark_epsilon(instance: ProblemInstance,
                      rel_tol: float = 1e-3,
                      max_iterations: int = 50000,
                      **params) -> Dict:
    prob = instance.create_problem()
    t0 = time.time()
    obj = prob.solve(rel_tol=rel_tol, max_iterations=max_iterations, **params)
    t_total = time.time() - t0
    st = prob.solver_status
    return dict(
        name=instance.name,
        time=t_total,
        solve_time=st.timing.solve_usec / 1e6,
        iterations=st.num_iterations,
        objective=obj,
        status=prob.status,
    )


def run_benchmarks(problems: List[ProblemInstance], **kwargs) -> List[Dict]:
    results = []
    for inst in problems:
        try:
            r = benchmark_epsilon(inst, **kwargs)
        except Exception as e:  # keep the table going; main() exits non-zero
            traceback.print_exc()
            r = dict(name=inst.name, error=f"{type(e).__name__}: {e}")
        results.append(r)
        print(format_result(r))
    return results


def run_benchmarks_isolated(problems: List[ProblemInstance],
                            suite_flags: Optional[List[str]] = None,
                            row_timeout: int = 600,
                            json_path: Optional[str] = None,
                            **kwargs) -> List[Dict]:
    """Each row in its OWN subprocess under a hard timeout, one at a time:
    per-row isolation (no device state carried between rows) and a bound
    on a row that does not converge.  This parent never touches JAX's
    backend, so each child holds the card alone."""
    import json as _json
    import subprocess
    import sys as _sys
    import tempfile

    results = []
    for inst in problems:
        with tempfile.NamedTemporaryFile("r", suffix=".json") as tf:
            cmd = ([_sys.executable, "-m", "epsilon_tpu.problems.benchmark"]
                   + list(suite_flags or [])
                   + ["--problem", inst.name, "--json", tf.name])
            if kwargs.get("rel_tol") is not None:
                cmd += ["--rel-tol", str(kwargs["rel_tol"])]
            if kwargs.get("max_iterations") is not None:
                cmd += ["--max-iterations", str(kwargs["max_iterations"])]
            try:
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=row_timeout)
            except subprocess.TimeoutExpired:
                row = dict(name=inst.name, error=f"timeout {row_timeout}s")
            else:
                if out.returncode == 0:
                    row = _json.load(tf)[0]
                else:
                    tail = (out.stderr or out.stdout or "no output")[-400:]
                    row = dict(name=inst.name,
                               error=f"exit {out.returncode}: {tail}")
        results.append(row)
        print(format_result(row), flush=True)
        if json_path:  # incremental: partial table survives a cut run
            with open(json_path, "w") as f:
                _json.dump(results, f, indent=1, default=float)
    return results


def format_result(r: Dict) -> str:
    if "error" in r:
        return f"{r['name']:16s} ERROR {r['error']}"
    return (f"{r['name']:16s} {r['time']:8.2f}s  iters={r['iterations']:6d}  "
            f"obj={r['objective']:.6e}  {r['status']}")


def format_table(results: List[Dict], fmt: str = "text") -> str:
    if fmt == "html":
        rows = "".join(
            f"<tr><td>{r['name']}</td><td>{r.get('time', float('nan')):.2f}</td>"
            f"<td>{r.get('objective', float('nan')):.4e}</td></tr>"
            for r in results)
        return f"<table><tr><th>problem</th><th>time</th><th>objective</th></tr>{rows}</table>"
    if fmt == "latex":
        rows = "\\\\\n".join(
            f"{r['name']} & {r.get('time', float('nan')):.2f} & "
            f"{r.get('objective', float('nan')):.4e}"
            for r in results)
        return ("\\begin{tabular}{lrr}\nproblem & time & objective\\\\\n"
                + rows + "\\\\\n\\end{tabular}")
    return "\n".join(format_result(r) for r in results)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--problem", default=None)
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--reference", action="store_true",
                        help="the reference's full 27-row suite at the "
                             "reference's sizes (benchmark.py:26-54)")
    parser.add_argument("--scale", action="store_true",
                        help="run the log-spaced size sweeps")
    parser.add_argument("--rel-tol", type=float, default=1e-3)
    parser.add_argument("--max-iterations", type=int, default=50000)
    parser.add_argument("--format", default="text",
                        choices=["text", "html", "latex"])
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write results as a JSON list")
    parser.add_argument("--isolate", action="store_true",
                        help="run each row in its own subprocess under "
                             "--row-timeout")
    parser.add_argument("--row-timeout", type=int, default=600)
    args = parser.parse_args()

    suite = PROBLEMS_SMALL if args.small else PROBLEMS
    if args.reference:
        suite = PROBLEMS_REFERENCE()
    if args.scale:
        suite = _scale_problems()
    if args.problem:
        suite = [p for p in suite if p.name == args.problem
                 or p.name.startswith(args.problem + "_")]
        if not suite:
            raise SystemExit(f"unknown problem {args.problem}")
    if args.isolate:
        flags = (["--reference"] if args.reference else
                 ["--small"] if args.small else
                 ["--scale"] if args.scale else [])
        results = run_benchmarks_isolated(
            suite, suite_flags=flags, row_timeout=args.row_timeout,
            json_path=args.json,
            rel_tol=args.rel_tol, max_iterations=args.max_iterations)
    else:
        from .. import config
        config.enable_compile_cache()
        results = run_benchmarks(suite, rel_tol=args.rel_tol,
                                 max_iterations=args.max_iterations)
    if args.format != "text":
        print(format_table(results, args.format))
    if args.json:
        import json as _json

        def _clean(r):
            return {k: (float(v) if isinstance(v, (np.floating,)) else v)
                    for k, v in r.items()}
        with open(args.json, "w") as f:
            _json.dump([_clean(r) for r in results], f, indent=1)
    failed = [r["name"] for r in results if "error" in r]
    if failed:
        sys.exit(f"benchmark rows failed: {failed}")


if __name__ == "__main__":
    main()

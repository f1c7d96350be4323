"""Global configuration for the epsilon_tpu framework.

The reference (Epsilon) is float64 throughout its C++/Eigen core.  The
policy here:

- Tests and oracles enable x64 and run float64, matching the reference's
  accuracy envelope.
- Accelerator runs default to float32 with float32 accumulation; ADMM is
  robust to this and reaches the 1e-3 relative tolerance targets used by
  the reference notebooks (see BASELINE.md).  Whether f64 pays for itself
  on the GPU is an open measurement (ROADMAP A).

``default_dtype()`` resolves what "real" means for the current JAX config;
``capabilities()`` says what the current backend does by default.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

# GPUs run float32 matmuls in TF32 by default, which keeps ~10 mantissa bits:
# a cached-inverse KKT apply at that precision loses enough accuracy that
# the ADMM iteration stalls or diverges.  Force full float32 products; the
# hot matvecs are bandwidth-bound, so the throughput cost is small.
if os.environ.get("EPSILON_TPU_MATMUL_PRECISION", "highest") != "default":
    jax.config.update(
        "jax_default_matmul_precision",
        os.environ.get("EPSILON_TPU_MATMUL_PRECISION", "highest"))

# Density / size thresholds at which a scipy.sparse operand is densified when
# frozen onto the device.  BCOO lowers to gather/scatter, which is usually
# slower than a dense matmul unless the matrix is both very large and very
# sparse.  The crossover has not been measured on the GPU (ROADMAP A).
SPARSE_DENSIFY_DENSITY = float(os.environ.get("EPSILON_TPU_DENSIFY_DENSITY", "0.01"))
SPARSE_DENSIFY_MAX_ELEMS = int(os.environ.get("EPSILON_TPU_DENSIFY_MAX_ELEMS", str(64 * 1024 * 1024)))


# How cached factorizations apply their solves on device:
#   "triangular" - cho/lu triangular solves
#   "inverse"    - explicit inverse computed host-side in f64, applied as a
#                  dense matmul
#   "auto"       - the backend's ``capabilities().explicit_inverse``
FACTOR_SOLVE_MODE = os.environ.get("EPSILON_TPU_FACTOR_SOLVE", "auto")


# Inner tolerance for iteratively-certified prox kernels (TV-1D PDAS):
# None -> sqrt-precision default per dtype (ops/prox/tv1d.default_tv_tol).
# The solvers tie this to their own rel_tol at trace time (a 1e-3 outer
# solve must not pay for 1e-14 inner certificates — VERDICT r2 item 7);
# the jitted-step cache is keyed by rel_tol, so the baked value is always
# consistent with the trace.
_PROX_INNER_TOL = None


def prox_inner_tol():
    return _PROX_INNER_TOL


def set_prox_inner_tol(tol):
    global _PROX_INNER_TOL
    _PROX_INNER_TOL = tol


def prox_inner_tol_for(rel_tol: float):
    """Inner certificate tolerance tied to an outer solver tolerance:
    one decade tighter than the outer rel_tol, floored at the dtype's
    *certifiable* sqrt-precision (1e-7 f64 / 3e-4 f32).  Flooring at a
    fixed 1e-7 made the f32 PDAS gap target unreachable for any
    rel_tol <= 3e-3, firing the uncertified warning spuriously (round-3
    advisor finding)."""
    if rel_tol is None or rel_tol <= 0:
        return None
    from .ops.prox.tv1d import default_tv_tol  # local: avoids import cycle
    return max(0.1 * rel_tol, default_tv_tol(default_dtype()))


def strict_lifting() -> bool:
    """When on, apply-mode ``linop._to_device`` of a host array that the
    collect pass never saw is a hard error instead of silently embedding the
    data as a jit constant (which would also serve stale data after
    ``update_problem``).  Enabled in the test suite; off in production where
    a one-off small constant embed is tolerable."""
    return os.environ.get("EPSILON_TPU_STRICT_LIFTING", "0") == "1"


def bucket_heaps_enabled() -> bool:
    """Memory-shard the heterogeneous term-bucket path: pack each bucket's
    lifted constants into per-device heap rows sharded along the term mesh
    (each device holds only its bucket's problem data at rest) instead of
    replicating every term's data on every device.  Default on; disable
    with EPSILON_TPU_BUCKET_HEAPS=0 to fall back to replicated constants."""
    return os.environ.get("EPSILON_TPU_BUCKET_HEAPS", "1") != "0"


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend does by default.  Each field of a row carries its
    reason in ``CAPABILITIES``; ROADMAP item A names the measurement that
    will confirm or overturn each GPU entry."""
    explicit_inverse: bool   # cached factors apply as inv @ x
    device_algebra: bool     # big compile-time products/inverses on device
    device_features: bool    # generators build big feature matrices on device
    debug_callbacks: bool    # host warnings via jax.debug.print


CAPABILITIES = {
    # Triangular solves are accurate and cheap on the host's LAPACK; the
    # data is already in host memory, so moving algebra or feature
    # generation to a "device" buys nothing.
    "cpu": Capabilities(explicit_inverse=False, device_algebra=False,
                        device_features=False, debug_callbacks=True),
    # A cached inverse applies as one GEMV/GEMM at HBM bandwidth, while a
    # triangular solve (trsv) is a latency-bound chain of dependent steps.
    # Schur products and inverses at solver build are large GEMMs, which
    # the GPU runs far faster than the host, and their results are applied
    # on the device anyway.  Feature matrices at reference scale (~1 GB)
    # are cheaper to generate where they are used than to upload.  Host
    # callbacks work, but cost time: see tv_warn_enabled.
    "gpu": Capabilities(explicit_inverse=True, device_algebra=True,
                        device_features=True, debug_callbacks=False),
}


def capabilities(platform: "str | None" = None) -> Capabilities:
    """The capability row of ``platform`` (default: JAX's default backend).
    This table is the only place that branches on the platform; an
    unlisted platform is an error, not a default."""
    platform = platform or jax.default_backend()
    try:
        return CAPABILITIES[platform]
    except KeyError:
        raise RuntimeError(
            f"epsilon_tpu has no capability row for platform {platform!r}; "
            f"supported platforms: {sorted(CAPABILITIES)}") from None


def tv_warn_enabled() -> bool:
    """Emit a host-side warning (jax.debug.print) when an iteratively-
    certified prox kernel exits without meeting its gap tolerance.  Follows
    ``capabilities().debug_callbacks``; override with
    EPSILON_TPU_TV_WARN=0/1.  Off on the GPU, where the conditional host
    callback costs a 1e6-point float32 TV prox call 0.53 ms when it does not
    fire (2.94 against 2.41 ms median) and 1.33 ms when it fires (6.34
    against 5.01 ms), measured on an H100 80GB HBM3 at 700 W."""
    if "EPSILON_TPU_TV_WARN" in os.environ:
        return os.environ["EPSILON_TPU_TV_WARN"] != "0"
    return capabilities().debug_callbacks


def use_explicit_inverse() -> bool:
    if FACTOR_SOLVE_MODE == "inverse":
        return True
    if FACTOR_SOLVE_MODE == "triangular":
        return False
    return capabilities().explicit_inverse


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` at the root
    of the checkout.  The path is part of the cache's key, so it is fixed."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and cache every compile.  Entry-point scripts call this once, before
    their first compile; importing the package does not."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def default_dtype() -> jnp.dtype:
    """Float dtype used for solver state and frozen constants."""
    return jnp.float64 if x64_enabled() else jnp.float32


def default_np_dtype() -> np.dtype:
    return np.float64 if x64_enabled() else np.float32

"""MNIST-style multiclass classification with random-Fourier features
(``problems/mnist.py:46-63``).  Data is synthesized (class-conditional
Gaussians) so the generator has no external data dependencies; the model
structure (kitchen-sink features + multiclass softmax + elementwise l1)
matches the reference benchmark.
"""

import numpy as np

import epsilon_tpu as ep
from epsilon_tpu import config


def _synthetic_digits(m, dim=50, k=10, seed=0):
    rng = np.random.RandomState(seed)
    dtype = config.default_np_dtype()
    centers = rng.randn(k, dim).astype(dtype) * 2
    y = rng.randint(0, k, m)
    X = centers[y] + rng.randn(m, dim).astype(dtype)
    return X, y


def kitchen_sink_features(X, n, sigma=None, seed=1, device=False):
    """Random Fourier features for the RBF kernel (``mnist.py:46-54``).

    Computed in the solver dtype: at reference scale the 60000x4000 feature
    matrix is 960 MB in f32 vs 1.92 GB in f64, and the f64 host cos/gemm
    alone costs ~45 s on a 2-core host.  With ``device=True`` the features
    are computed ON the accelerator and stay there: only the small X/W
    operands cross the host link."""
    rng = np.random.RandomState(seed)
    dtype = config.default_np_dtype()
    d = X.shape[1]
    if sigma is None:
        sigma = np.sqrt(d)
    W = (rng.randn(d, n) / sigma).astype(dtype)
    b = rng.uniform(0, 2 * np.pi, n).astype(dtype)
    scale = np.asarray(np.sqrt(2.0 / n), dtype=dtype)
    if device:
        import jax
        import jax.numpy as jnp
        Xd = jnp.asarray(np.asarray(X, dtype=dtype))
        return jax.block_until_ready(
            scale * jnp.cos(Xd @ jnp.asarray(W) + jnp.asarray(b)))
    return scale * np.cos(np.asarray(X, dtype=dtype).dot(W) + b)

def create(m=200, n=100, k=10, lam=0.1, device_features=None):
    """Build the MNIST-RFF softmax problem.  ``device_features`` defaults
    to ``config.capabilities().device_features`` for instances big enough
    that shipping F through the host link dominates (m*n >= 1e7)."""
    X, y = _synthetic_digits(m, k=k)
    if device_features is None:
        device_features = (config.capabilities().device_features
                           and m * n >= 10_000_000)
    F = kitchen_sink_features(X, n, device=device_features)
    Theta = ep.Variable(n, k)
    f = ep.softmax_loss(Theta, F, y) + lam * ep.norm1(ep.vec(Theta))
    return ep.Problem(ep.Minimize(f))

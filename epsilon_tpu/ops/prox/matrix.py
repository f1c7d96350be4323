"""Matrix (orthogonally invariant) proximal operators.

Accelerator-native re-design of ``ortho_invariant.{h,cc}``: eigendecompose the
symmetric(ized) argument — batched ``jnp.linalg.eigh`` on device — apply a
*vector* prox to the spectrum, reconstruct.  Valid by the Lewis/Davis
theorem for spectral functions f(X) = phi(eig(X)) with symmetric phi.

Kernels: ``semidefinite.cc`` (PSD cone projection), ``neg_log_det.cc``
(spectral sum_neg_log), ``norm_nuclear.cc`` (singular value thresholding),
``lambda_max.cc`` (spectral max).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import elementwise, vector

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _sym(V):
    return 0.5 * (V + jnp.swapaxes(V, -1, -2))


def _nonzero_sym(V):
    """The symmetric part of V, with each all-zero matrix replaced by the
    identity, and a mask of those matrices.  XLA:GPU's eigh returns NaN
    eigenvalues for an all-zero matrix larger than 32x32 (measured on an
    H100), and ADMM starts every prox input at zero; the identity's
    eigenvectors serve the zero matrix too."""
    S = _sym(V)
    zero = jnp.all(S == 0, axis=(-2, -1))
    eye = jnp.eye(S.shape[-1], dtype=S.dtype)
    return jnp.where(zero[..., None, None], eye, S), zero


def _eigh(V):
    S, zero = _nonzero_sym(V)
    d, U = jnp.linalg.eigh(S)
    return jnp.where(zero[..., None], 0.0, d), U


def _eigvalsh(V):
    S, zero = _nonzero_sym(V)
    return jnp.where(zero[..., None], 0.0, jnp.linalg.eigvalsh(S))


def _spectral_prox(V, prox_eigs):
    """U diag(prox(d)) U^T on the symmetric part of V
    (``ortho_invariant.cc:30-50``)."""
    d, U = _eigh(V)
    x = prox_eigs(d)
    return (U * x[..., None, :]) @ jnp.swapaxes(U, -1, -2)


def _spectral_epi(V, s, epi_eigs):
    d, U = _eigh(V)
    x, t = epi_eigs(d, s)
    return (U * x[..., None, :]) @ jnp.swapaxes(U, -1, -2), t


# ---------------------------------------------------------------------------
# semidefinite: I(X >= 0)                          (semidefinite.cc:3-8)
# ---------------------------------------------------------------------------

def prox_semidefinite(V, lam=None):
    return _spectral_prox(V, lambda d: jnp.maximum(d, 0.0))


# ---------------------------------------------------------------------------
# neg_log_det: f(X) = -log det X                   (neg_log_det.cc:4-15)
# ---------------------------------------------------------------------------

def prox_neg_log_det(V, lam):
    return _spectral_prox(V, lambda d: elementwise.prox_sum_neg_log(d, lam))


def eval_neg_log_det(X):
    d = _eigvalsh(X)
    return -jnp.sum(jnp.log(d))


def epi_neg_log_det(V, s):
    return _spectral_epi(V, s, elementwise.epi_sum_neg_log)


# ---------------------------------------------------------------------------
# lambda_max: f(X) = max eigenvalue                (lambda_max.cc:3-15)
# ---------------------------------------------------------------------------

def prox_lambda_max(V, lam):
    return _spectral_prox(V, lambda d: vector.prox_max(d, lam))


def eval_lambda_max(X):
    return jnp.max(_eigvalsh(X))


def epi_lambda_max(V, s):
    return _spectral_epi(V, s, vector.epi_max)


# ---------------------------------------------------------------------------
# norm_nuclear: f(X) = sum of singular values      (norm_nuclear.cc:2-14)
# Singular-value thresholding via SVD (the reference computes the SVD via
# eigh of Y^T Y; XLA's divide-and-conquer SVD runs on device directly).
# ---------------------------------------------------------------------------

def prox_norm_nuclear(V, lam):
    U, sv, Vt = jnp.linalg.svd(V, full_matrices=False)
    x = jnp.maximum(sv - lam, 0.0)
    return (U * x[..., None, :]) @ Vt


def eval_norm_nuclear(X):
    return jnp.sum(jnp.linalg.svd(X, compute_uv=False))


def epi_norm_nuclear(V, s):
    """Projection onto {(X, t): ||X||_* <= t} — norm-1 epigraph on the
    singular values."""
    U, sv, Vt = jnp.linalg.svd(V, full_matrices=False)
    x, t = elementwise.epi_scaled_zone(sv, s)  # norm_1 epigraph on spectrum
    # keep singular values non-negative (projection of a nonneg vector onto
    # the norm-1 epigraph stays nonneg, so this is a no-op numerically)
    return (U * x[..., None, :]) @ Vt, t


# ---------------------------------------------------------------------------
# sigma_max: f(X) = largest singular value (spectral norm)
# The reference has NO direct kernel — it falls back to an (m+n)x(m+n) SDP
# embedding (``conic.py:176-186`` transform_sigma_max), which costs a full
# eigh of the embedding per ADMM iteration plus m^2+n^2 extra variables.
# Direct kernel: sigma_max = ||sigma(X)||_inf is an absolutely symmetric
# gauge of the spectrum, so by the Lewis/von Neumann transfer theorem its
# prox is U diag(prox_norm_inf(sigma)) V^T — one SVD, no embedding.
# ---------------------------------------------------------------------------

def prox_sigma_max(V, lam):
    U, sv, Vt = jnp.linalg.svd(V, full_matrices=False)
    x = vector.prox_norm_inf(sv, lam)
    return (U * x[..., None, :]) @ Vt


def eval_sigma_max(X):
    return jnp.max(jnp.linalg.svd(X, compute_uv=False))


def epi_sigma_max(V, s):
    """Projection onto {(X, t): sigma_max(X) <= t} — norm_inf epigraph on the
    spectrum (sigma >= 0 stays in [0, t] under the clip, so the factors are
    a valid SVD of the projection)."""
    U, sv, Vt = jnp.linalg.svd(V, full_matrices=False)
    x, t = vector.epi_norm_inf(sv, s)
    return (U * x[..., None, :]) @ Vt, t

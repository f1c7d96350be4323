"""Damped-Newton epigraph projections for smooth prox kinds.

Replaces the outer-bisection epigraphs (90-110 fixed outer iterations, each
inner call itself a 30-60-iteration Newton prox) with joint Newton on the
arrowhead KKT system of the projection, the jittable re-design of
``NewtonEpigraph`` (``src/epsilon/prox/newton.cc:109-190``):

    minimize ||x - v||^2/2 + (t - s)^2/2   s.t.  f(x) <= t

Active case (f(v) > s) stationarity, with t = s + lam eliminated::

    r1(x, lam) = x - v + lam * grad f(x) = 0      (n equations)
    r2(x, lam) = f(x) - s - lam          = 0      (1 equation)

Newton step through the arrowhead Jacobian ``[[M, g], [g^T, -1]]`` with
``M = I + lam * Hess f(x)`` (diagonal for separable f; rank-1-corrected for
log-sum-exp; 2x2-block for KL) via the Schur complement::

    dlam = (r2 - g^T M^-1 r1) / (1 + g^T M^-1 g)
    dx   = -M^-1 (r1 + g * dlam)

Globalized by a *vectorized* backtracking line search: all candidate step
sizes are evaluated in one batched residual pass (no data-dependent control
flow), and the first Armijo-acceptable one is selected — jit/vmap friendly,
fixed shapes.  Quadratic convergence reaches oracle tolerance in <= 15
iterations where bisection needed ~100 x ~50 nested ones.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

__all__ = ["newton_epigraph", "implicit_newton_epigraph", "make_epigraph",
           "lse_metric_solve", "epi_log_sum_exp", "epi_sum_kl_div"]


def _domain_eps(dtype):
    return 1e-12 if dtype == jnp.float64 else 1e-6


def newton_epigraph(v, s, feval: Callable, fgrad: Callable,
                    fhess: Optional[Callable] = None,
                    proj: Optional[Callable] = None,
                    metric_solve: Optional[Callable] = None,
                    prox: Optional[Callable] = None,
                    iters: int = 13, n_alphas: int = 6):
    """Active-case epigraph projection; returns ``(x, t)``.

    ``metric_solve(x, lam, r)`` solves ``(I + lam*Hess f(x)) y = r``;
    defaults to the diagonal solve from ``fhess`` (separable f).  ``proj``
    clips iterates into the domain of f (identity if omitted).  When the
    kind's plain prox is supplied, the iteration starts at
    ``(x0, lam0) = (prox(v, 1), 1)`` — exactly on the r1 = 0 manifold, so
    the first Newton step reduces to the implicit-Newton step on lambda and
    the search never starts from a domain-clipped v.  Callers handle the
    inactive case (``f(v) <= s`` -> identity) themselves.
    """
    v = jnp.asarray(v)
    dtype = v.dtype
    s = jnp.asarray(s, dtype=dtype)
    if proj is None:
        proj = lambda x: x
    if metric_solve is None:
        if fhess is None:
            raise ValueError("need fhess or metric_solve")

        def metric_solve(x, lam, r):
            return r / (1.0 + lam * fhess(x))

    floor = jnp.asarray(_domain_eps(dtype), dtype)
    alphas = (0.5 ** jnp.arange(n_alphas)).astype(dtype)

    def res_norm(x, lam):
        r1 = x - v + lam * fgrad(x)
        r2 = feval(x) - s - lam
        return jnp.sqrt(jnp.sum(r1 * r1) + r2 * r2)

    if prox is not None:
        lam0 = jnp.asarray(1.0, dtype)
        x0 = proj(prox(v, lam0))
    else:
        x0 = proj(v)
        f0 = feval(x0)
        # t* lies in (s, f(proj(v))]; half the gap is a scale-aware guess
        lam0 = jnp.clip(0.5 * (f0 - s), floor, jnp.asarray(1e6, dtype))

    def body(_, carry):
        x, lam = carry
        g = fgrad(x)
        r1 = x - v + lam * g
        r2 = feval(x) - s - lam
        Minv_r1 = metric_solve(x, lam, r1)
        Minv_g = metric_solve(x, lam, g)
        dlam = (r2 - jnp.vdot(g, Minv_r1)) / (1.0 + jnp.vdot(g, Minv_g))
        dx = -(Minv_r1 + Minv_g * dlam)
        rn0 = jnp.sqrt(jnp.sum(r1 * r1) + r2 * r2)

        def trial(a):
            return res_norm(proj(x + a * dx), jnp.maximum(lam + a * dlam,
                                                          floor))

        rns = jax.vmap(trial)(alphas)
        rns = jnp.where(jnp.isfinite(rns), rns, jnp.inf)
        ok = rns <= (1.0 - 0.1 * alphas) * rn0
        idx = jnp.where(jnp.any(ok), jnp.argmax(ok), jnp.argmin(rns))
        a = alphas[idx]
        x_new = proj(x + a * dx)
        lam_new = jnp.maximum(lam + a * dlam, floor)
        # never move to a worse point than the incumbent (safeguard against
        # a fully-stalled search direction at the boundary)
        better = rns[idx] <= rn0
        return (jnp.where(better, x_new, x),
                jnp.where(better, lam_new, lam))

    x, lam = jax.lax.fori_loop(0, iters, body, (x0, lam0))
    return x, s + lam


def implicit_newton_epigraph(v, s, feval: Callable, fgrad: Callable,
                             prox: Callable,
                             fhess: Optional[Callable] = None,
                             proj: Optional[Callable] = None,
                             metric_solve: Optional[Callable] = None,
                             iters: int = 24):
    """Active-case epigraph projection via safeguarded Newton on the scalar
    implicit function ``h(lam) = f(prox(v, lam)) - s - lam``, which is
    strictly decreasing with the closed-form derivative

        h'(lam) = -g^T (I + lam*Hess f)^{-1} g - 1,   g = grad f(x(lam))

    (differentiate the stationarity ``x - v + lam*g(x) = 0``).  Every
    iterate stays exactly on the ``r1 = 0`` manifold (the inner prox is the
    kind's own quadratically-convergent kernel), so unlike the joint
    arrowhead Newton there is no line search to stall: a bracket
    [lo (h>0), hi (h<0)] is maintained and out-of-bracket Newton steps fall
    back to doubling/bisection — globally convergent, quadratic near the
    root.  Jittable re-design of ``ImplicitNewton``
    (``src/epsilon/prox/newton.cc:192-237``)."""
    v = jnp.asarray(v)
    dtype = v.dtype
    s = jnp.asarray(s, dtype=dtype)
    if proj is None:
        proj = lambda x: x
    if metric_solve is None:
        if fhess is None:
            raise ValueError("need fhess or metric_solve")

        def metric_solve(x, lam, r):
            return r / (1.0 + lam * fhess(x))

    floor = jnp.asarray(_domain_eps(dtype), dtype)
    big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)

    def h_and_x(lam):
        x = proj(prox(v, lam))
        return feval(x) - s - lam, x

    def body(_, carry):
        lam, lo, hi = carry
        h, x = h_and_x(lam)
        g = fgrad(x)
        hp = -jnp.vdot(g, metric_solve(x, lam, g)) - 1.0
        # shrink the bracket around the root of the decreasing h
        lo = jnp.where(h > 0, jnp.maximum(lo, lam), lo)
        hi = jnp.where(h <= 0, jnp.minimum(hi, lam), hi)
        lam_n = lam - h / hp
        # out-of-bracket -> double up while hi unknown, else bisect
        fallback = jnp.where(hi >= big, jnp.maximum(4.0 * lam, 1.0),
                             0.5 * (lo + hi))
        bad = (lam_n <= lo) | (lam_n >= hi) | ~jnp.isfinite(lam_n)
        lam_n = jnp.where(bad, fallback, lam_n)
        return lam_n, lo, hi

    lam0 = jnp.asarray(1.0, dtype)
    lam, _, _ = jax.lax.fori_loop(
        0, iters, body, (lam0, floor, big * 2))
    x = proj(prox(v, lam))
    return x, s + jnp.maximum(feval(x) - s, lam)


def make_epigraph(feval, fgrad, fhess=None, proj=None, metric_solve=None,
                  dom=None, prox=None, iters: int = 13):
    """Build a full epigraph kernel ``epi(v, s) -> (x, t)`` including the
    inactive-case passthrough.  NaN/inf from out-of-domain ``feval(v)``
    compare False and correctly route to the active solve; ``dom(v)`` guards
    kinds whose feval is finite-but-meaningless outside the domain (e.g.
    sum 1/x at negative x)."""

    def epi(v, s, **_):
        if prox is not None:
            x, t = implicit_newton_epigraph(
                v, s, feval, fgrad, prox, fhess=fhess, proj=proj,
                metric_solve=metric_solve, iters=iters + 11)
        else:
            x, t = newton_epigraph(v, s, feval, fgrad, fhess=fhess,
                                   proj=proj, metric_solve=metric_solve,
                                   prox=prox, iters=iters)
        inactive = feval(v) <= s
        if dom is not None:
            inactive = inactive & dom(v)
        return jnp.where(inactive, v, x), jnp.where(inactive, s, t)

    return epi


# -- log_sum_exp: Hessian diag(p) - p p^T, Sherman-Morrison metric solve
#    (``log_sum_exp.cc:21-78``) -----------------------------------------------

def lse_metric_solve(x, lam, r):
    p = jax.nn.softmax(x)
    d = 1.0 + lam * p
    Dinv_r = r / d
    Dinv_p = p / d
    # 1 - lam*p'D^-1 p == sum_i p_i/(1+lam p_i): always > 0, and the sum
    # form avoids the catastrophic cancellation of the difference form at
    # lam >> 1
    denom = jnp.sum(Dinv_p)
    return Dinv_r + lam * Dinv_p * jnp.vdot(p, Dinv_r) / denom


def epi_log_sum_exp(v, s):
    from .vector import eval_log_sum_exp, prox_log_sum_exp
    epi = make_epigraph(eval_log_sum_exp, jax.nn.softmax,
                        metric_solve=lse_metric_solve,
                        prox=prox_log_sum_exp)
    return epi(v, s)


# -- sum_kl_div: 2-argument f(x, y) = sum x log(x/y) - x + y with per-element
#    2x2 Hessian blocks, solved in closed form (``sum_kl_div.cc:69-120``) ----

def epi_sum_kl_div(u, w, s):
    """Project (u, w, s) onto {(x, y, t): KL(x, y) <= t}.  The two argument
    vectors are packed into one so the generic arrowhead machinery applies;
    the metric solve inverts the per-element [[1+lam/x, -lam/y],
    [-lam/y, 1+lam*x/y^2]] blocks directly."""
    from .elementwise import eval_sum_kl_div
    u = jnp.asarray(u)
    w = jnp.asarray(w, dtype=u.dtype)
    n = u.shape[-1]
    eps = _domain_eps(u.dtype)

    def unpack(z):
        return z[..., :n], z[..., n:]

    def feval(z):
        x, y = unpack(z)
        return eval_sum_kl_div(x, y)

    def fgrad(z):
        x, y = unpack(z)
        return jnp.concatenate([jnp.log(x / y), 1.0 - x / y], axis=-1)

    def proj(z):
        return jnp.maximum(z, eps)

    def metric_solve(z, lam, r):
        x, y = unpack(z)
        r1, r2 = unpack(r)
        a = 1.0 + lam / x
        b = -lam / y
        c = 1.0 + lam * x / (y * y)
        det = a * c - b * b
        return jnp.concatenate([(c * r1 - b * r2) / det,
                                (a * r2 - b * r1) / det], axis=-1)

    def prox(z, lam):
        from .elementwise import prox_sum_kl_div
        x, y = prox_sum_kl_div(*unpack(z), lam)
        return jnp.concatenate([x, y], axis=-1)

    vz = jnp.concatenate([u, w], axis=-1)
    xz, t = implicit_newton_epigraph(vz, s, feval, fgrad, prox, proj=proj,
                                     metric_solve=metric_solve)
    x, y = unpack(xz)
    fv = eval_sum_kl_div(jnp.maximum(u, eps), jnp.maximum(w, eps))
    inactive = jnp.all(u > 0) & jnp.all(w > 0) & (fv <= s)
    return (jnp.where(inactive, u, x), jnp.where(inactive, w, y),
            jnp.where(inactive, s, t))

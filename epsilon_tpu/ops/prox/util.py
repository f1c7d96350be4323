"""Numerical utilities shared by the prox kernels.

The reference implements its data-dependent scalar algorithms with pointer
loops and randomized partition searches (``scaled_zone.cc:122-280``,
``max.cc:7-87``, ``sum_largest.cc:8-85``).  None of that can be jitted.
The jittable replacements here are:

- :func:`pwl_root` — closed-form root of a monotone piecewise-linear function
  via one ``jnp.sort`` + prefix sums (replaces every pool/partition search).
- :func:`bisect` — fixed-iteration elementwise bisection (jit/vmap friendly).
- :func:`newton_safeguarded` — damped Newton with bracket clipping.
- :func:`solve_w_log_w` — solves ``w + log w = c`` (Lambert-W of ``e^c``),
  the core of the exp/entropy family proxes.
- :func:`implicit_epigraph` — generic epigraph projection via outer
  root-finding on lambda (replaces ``ImplicitNewtonEpigraph`` /
  ``BisectionEpigraph``, ``newton.cc:192-288``).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["pwl_root", "bisect", "newton_safeguarded", "solve_w_log_w",
           "implicit_epigraph"]


def pwl_root(c0, d0, keys, weights):
    """Root of ``h(t) = c0 + d0*t + sum_i w_i * max(0, k_i - t)``.

    ``h`` must be globally non-increasing with a unique root (d0 <= 0; mixed
    signs in ``w`` are allowed as long as the sum stays non-increasing, as in
    the sum-largest window function).  Everything is a fixed-shape sort +
    prefix-sum: O(n log n), fully on the VPU.

    Args: scalars ``c0, d0``; 1-D arrays ``keys, weights`` of equal length.
    Returns the scalar root.
    """
    keys = jnp.asarray(keys)
    weights = jnp.asarray(weights)
    n = keys.shape[-1]
    order = jnp.argsort(-keys, axis=-1)
    k = jnp.take_along_axis(keys, order, axis=-1)
    w = jnp.take_along_axis(weights, order, axis=-1)

    S = jnp.cumsum(w * k, axis=-1)          # S_j = sum_{i<=j} w_i k_i
    W = jnp.cumsum(w, axis=-1)              # W_j = sum_{i<=j} w_i
    zero = jnp.zeros_like(S[..., :1])
    S = jnp.concatenate([zero, S], axis=-1)  # index j = #active terms
    W = jnp.concatenate([zero, W], axis=-1)

    inf = jnp.asarray(jnp.inf, dtype=k.dtype)
    upper = jnp.concatenate([jnp.full_like(k[..., :1], jnp.inf), k], axis=-1)
    lower = jnp.concatenate([k, jnp.full_like(k[..., :1], -jnp.inf)], axis=-1)

    denom = W - d0
    cand = jnp.where(denom != 0, (c0 + S) / jnp.where(denom == 0, 1.0, denom), inf)
    valid = (cand >= lower - 1e-30) & (cand <= upper + 1e-30) & (denom != 0)
    # Multiple valid candidates (ties at shared endpoints) all equal the root;
    # take the first valid one.
    idx = jnp.argmax(valid, axis=-1)
    root = jnp.take_along_axis(cand, idx[..., None], axis=-1)[..., 0]
    # Plateau corner case: the zero set of h is a flat segment (e.g.
    # sum-largest with k = n), so no sloped segment brackets a crossing.
    # Fall back to the breakpoint minimizing |h| — the plateau boundary.
    h_at_k = c0 + d0 * k + (S[..., 1:] - W[..., 1:] * k)
    plateau = jnp.take_along_axis(
        k, jnp.argmin(jnp.abs(h_at_k), axis=-1)[..., None], axis=-1)[..., 0]
    any_valid = jnp.any(valid, axis=-1)
    return jnp.where(any_valid, root, plateau)


def bisect(g: Callable, lo, hi, iters: int = 80):
    """Elementwise bisection for a root of non-decreasing ``g`` on [lo, hi]."""
    lo = jnp.asarray(lo, dtype=jnp.result_type(lo, hi, float))
    hi = jnp.asarray(hi, dtype=lo.dtype)

    def body(_, state):
        lo, hi = state
        mid = 0.5 * (lo + hi)
        gm = g(mid)
        lo = jnp.where(gm < 0, mid, lo)
        hi = jnp.where(gm >= 0, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return 0.5 * (lo + hi)


def newton_safeguarded(g: Callable, gprime: Callable, x0, lo, hi,
                       iters: int = 30):
    """Elementwise Newton for non-decreasing ``g`` safeguarded by a
    maintained bracket [lo, hi] with *endpoint values*: when the Newton
    candidate leaves the bracket, fall back to the Illinois-damped regula
    falsi point instead of the midpoint.  The midpoint fallback degrades to
    plain bisection exactly in the common convex-g endgame (Newton from the
    left overshoots a nearly-pinned right endpoint); regula falsi uses the
    endpoint residuals and lands at the root in one step there."""
    x0 = jnp.asarray(x0)
    lo = jnp.broadcast_to(jnp.asarray(lo, dtype=x0.dtype), x0.shape)
    hi = jnp.broadcast_to(jnp.asarray(hi, dtype=x0.dtype), x0.shape)
    glo = g(lo)
    ghi = g(hi)

    def body(_, state):
        x, lo, hi, glo, ghi = state
        gx = g(x)
        neg = gx < 0
        # replace the matching endpoint; Illinois damping halves the kept
        # side's residual so one-sided stalls still converge superlinearly
        lo = jnp.where(neg, jnp.maximum(lo, x), lo)
        glo = jnp.where(neg, gx, glo)
        ghi = jnp.where(neg, 0.5 * ghi, ghi)
        hi = jnp.where(~neg, jnp.minimum(hi, x), hi)
        ghi = jnp.where(~neg, gx, ghi)
        glo = jnp.where(~neg, 0.5 * glo, glo)

        gp = gprime(x)
        step = jnp.where(gp != 0, gx / jnp.where(gp == 0, 1.0, gp), 0.0)
        xn = x - step
        denom = ghi - glo
        falsi = jnp.where(denom != 0,
                          (lo * ghi - hi * glo) / jnp.where(denom == 0, 1.0,
                                                            denom),
                          0.5 * (lo + hi))
        # non-finite endpoint residuals (e.g. overflowing g at a wide hi)
        # make the secant meaningless: fall back to the midpoint there
        falsi = jnp.where(jnp.isfinite(falsi), jnp.clip(falsi, lo, hi),
                          0.5 * (lo + hi))
        bad = (xn <= lo) | (xn >= hi) | ~jnp.isfinite(xn)
        xn = jnp.where(bad, falsi, xn)
        return xn, lo, hi, glo, ghi

    x, lo, hi, glo, ghi = jax.lax.fori_loop(0, iters, body,
                                            (x0, lo, hi, glo, ghi))
    return x


def solve_w_log_w(c):
    """Solve ``w + log(w) = c`` for w > 0 (= LambertW(e^c)), elementwise.

    Stable across the whole real line: for c >> 1 the root is ~ c - log c;
    for c << 0 it is ~ e^c.
    """
    c = jnp.asarray(c)
    w0 = jnp.where(c > 1.0, c - jnp.log(jnp.maximum(c, 1.1)), jnp.exp(jnp.minimum(c, 1.0)))
    w0 = jnp.maximum(w0, jnp.finfo(c.dtype).tiny)

    def body(_, w):
        # Newton on h(w) = w + log w - c;  h' = 1 + 1/w
        # step = (w + log w - c) * w / (w + 1)
        wn = w - (w + jnp.log(w) - c) * w / (w + 1.0)
        return jnp.maximum(wn, jnp.finfo(c.dtype).tiny)

    return jax.lax.fori_loop(0, 30, body, w0)


def implicit_epigraph(prox: Callable, feval: Callable, v, s,
                      lam_max: float = 1e12, iters: int = 100):
    """Project (v, s) onto ``{(x, t): f(x) <= t}`` via the optimality system
    ``x = prox_{lam f}(v), t = s + lam, f(x) = t`` — outer bisection on
    ``g(lam) = f(prox_lam(v)) - s - lam`` which is non-increasing in lam.

    ``prox(v, lam)`` and ``feval(x)`` operate on the full argument; this is
    the generic jittable replacement for BisectionEpigraph/ImplicitNewtonEpigraph
    (``newton.cc:192-288``).
    """
    s = jnp.asarray(s)

    def g(lam):
        return feval(prox(v, lam)) - s - lam

    lam = bisect(lambda t: -g(t), jnp.zeros_like(s), jnp.full_like(s, lam_max),
                 iters=iters)
    x = prox(v, lam)
    t = s + lam
    inactive = feval(v) <= s
    x = jnp.where(inactive, v, x) if x.shape == jnp.shape(v) else jax.tree_util.tree_map(
        lambda a, b: jnp.where(inactive, a, b), v, x)
    t = jnp.where(inactive, s, t)
    return x, t

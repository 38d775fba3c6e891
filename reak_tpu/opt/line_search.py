"""1-D line searches as straight-line batched programs.

JAX-native equivalents of the reference's line-search family
(ref: core/optimization/line_search.hpp — dichotomous, golden-section,
Fibonacci, backtracking, expand-and-zoom).  Each runs a *fixed* number of
shrink steps (compile-time constant), which on an accelerator is cheaper and more
vmap-friendly than data-dependent termination: the interval contracts
geometrically, so ``iters≈40`` already reaches f64 resolution.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_GOLD = 0.6180339887498949  # 1/phi


def golden_section(f, lo, hi, iters: int = 48):
    """Minimize unimodal ``f`` on [lo, hi] (ref: line_search.hpp golden-section).

    ``f`` must be elementwise-vectorized; lo/hi may be arrays (batched search).
    Returns the interval midpoint after ``iters`` contractions.
    """
    lo = jnp.asarray(lo, jnp.result_type(float))
    hi = jnp.asarray(hi, lo.dtype)
    x1 = hi - _GOLD * (hi - lo)
    x2 = lo + _GOLD * (hi - lo)
    f1, f2 = f(x1), f(x2)

    def body(_, c):
        lo, hi, x1, x2, f1, f2 = c
        shrink_hi = f1 < f2  # keep [lo, x2]
        nhi = jnp.where(shrink_hi, x2, hi)
        nlo = jnp.where(shrink_hi, lo, x1)
        nx1 = jnp.where(shrink_hi, nhi - _GOLD * (nhi - nlo), x2)
        nx2 = jnp.where(shrink_hi, x1, nlo + _GOLD * (nhi - nlo))
        nf = f(jnp.where(shrink_hi, nx1, nx2))
        nf1 = jnp.where(shrink_hi, nf, f2)
        nf2 = jnp.where(shrink_hi, f1, nf)
        return nlo, nhi, nx1, nx2, nf1, nf2

    lo, hi, *_ = lax.fori_loop(0, iters, body, (lo, hi, x1, x2, f1, f2))
    return 0.5 * (lo + hi)


def dichotomous_search(f, lo, hi, iters: int = 48, delta_frac: float = 1e-3):
    """Dichotomous interval shrink (ref: line_search.hpp dichotomous_search)."""
    lo = jnp.asarray(lo, jnp.result_type(float))
    hi = jnp.asarray(hi, lo.dtype)

    def body(_, c):
        lo, hi = c
        mid = 0.5 * (lo + hi)
        d = delta_frac * (hi - lo)
        keep_left = f(mid - d) < f(mid + d)
        return jnp.where(keep_left, lo, mid - d), jnp.where(keep_left, mid + d, hi)

    lo, hi = lax.fori_loop(0, iters, body, (lo, hi))
    return 0.5 * (lo + hi)


def backtracking_armijo(f, x, d, fx, gx, alpha0=1.0, rho: float = 0.5,
                        c1: float = 1e-4, iters: int = 20):
    """Armijo backtracking along direction ``d`` from ``x``
    (ref: line_search.hpp backtracking_search).

    Runs all ``iters`` shrinks as straight-line code, keeping the *first*
    step length that satisfies the Armijo condition — equivalent to the
    sequential early-exit loop but branch-free for vmap.
    Returns (alpha, f(x + alpha d)).
    """
    slope = jnp.vdot(gx, d)
    alpha0 = jnp.asarray(alpha0, jnp.result_type(float))

    def body(i, c):
        alpha_best, f_best, found = c
        a = alpha0 * rho ** i
        fa = f(x + a * d)
        ok = (fa <= fx + c1 * a * slope) & ~found
        return (jnp.where(ok, a, alpha_best), jnp.where(ok, fa, f_best),
                found | ok)

    a, fa, found = lax.fori_loop(
        0, iters, body, (jnp.zeros_like(alpha0), fx, jnp.asarray(False)))
    # if nothing satisfied Armijo, take the smallest trial step anyway
    a_min = alpha0 * rho ** (iters - 1)
    a = jnp.where(found, a, a_min)
    fa = jnp.where(found, fa, f(x + a * d))
    return a, fa


def wolfe_zoom(f_and_grad, x, d, fx, gx, alpha_max: float = 4.0,
               c1: float = 1e-4, c2: float = 0.9,
               expand_iters: int = 8, zoom_iters: int = 16):
    """Strong-Wolfe expand-then-zoom search
    (ref: line_search.hpp expand_and_zoom_search).

    ``f_and_grad(x) -> (f, g)``.  Bracket by geometric expansion, then bisect
    with Armijo/curvature selects.  Fixed budgets; returns (alpha, f_new).
    """
    slope0 = jnp.vdot(gx, d)

    def phi(a):
        fv, gv = f_and_grad(x + a * d)
        return fv, jnp.vdot(gv, d)

    # -- expansion: find [a_lo, a_hi] bracketing a Wolfe point
    def exp_body(i, c):
        a_lo, a_hi, done = c
        a = jnp.minimum(a_hi * 2.0, alpha_max)
        fa, _ = phi(a)
        viol = fa > fx + c1 * a * slope0  # passed the minimum
        na_hi = jnp.where(done, a_hi, a)
        na_lo = jnp.where(done | viol, a_lo, a)
        return na_lo, na_hi, done | viol

    a_lo, a_hi, _ = lax.fori_loop(
        0, expand_iters, exp_body,
        (jnp.asarray(0.0), jnp.asarray(alpha_max / 2.0 ** expand_iters),
         jnp.asarray(False)))

    # -- zoom: bisection keeping the Armijo-satisfying side
    def zoom_body(i, c):
        a_lo, a_hi, a_best, f_best = c
        a = 0.5 * (a_lo + a_hi)
        fa, ga = phi(a)
        armijo = fa <= fx + c1 * a * slope0
        curv = jnp.abs(ga) <= c2 * jnp.abs(slope0)
        good = armijo & curv
        a_best = jnp.where(good & (fa < f_best), a, a_best)
        f_best = jnp.where(good & (fa < f_best), fa, f_best)
        # standard zoom interval update
        hi_to_a = ~armijo | (armijo & (ga * (a_hi - a_lo) >= 0))
        na_hi = jnp.where(hi_to_a, a, a_hi)
        na_lo = jnp.where(hi_to_a, a_lo, a)
        return na_lo, na_hi, a_best, f_best

    a_lo, a_hi, a_best, f_best = lax.fori_loop(
        0, zoom_iters, zoom_body, (a_lo, a_hi, jnp.asarray(0.0), fx))
    # fall back to the final midpoint if no strict Wolfe point was kept
    a_mid = 0.5 * (a_lo + a_hi)
    f_mid, _ = phi(a_mid)
    use_mid = (a_best == 0.0) | (f_mid < f_best)
    return jnp.where(use_mid, a_mid, a_best), jnp.where(use_mid, f_mid, f_best)

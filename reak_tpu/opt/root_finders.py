"""Scalar and vector root finders, batched with static iteration budgets.

JAX-native equivalents of the reference's `core/root_finders`
(ref: bisection_method.hpp:58 bisection_method, secant_method.hpp:249
secant/Illinois/Ford-3/Brent/Ridders family, newton_raphson_method.hpp:63,
broyden_method.hpp).  Scalar finders take an elementwise-vectorized ``f`` and
array-shaped brackets, so one call solves a whole batch of root problems —
the regime the SVP/SAP interpolators need (one root per DoF per segment,
ref: ctrl/interpolation/sustained_velocity_pulse_Ndof_detail.cpp).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def bisection(f, lo, hi, iters: int = 60):
    """Bisection on a sign-changing bracket (ref: bisection_method.hpp:58)."""
    lo = jnp.asarray(lo, jnp.result_type(float))
    hi = jnp.asarray(hi, lo.dtype)
    flo = f(lo)

    def body(_, c):
        lo, hi, flo = c
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        left = jnp.sign(fm) == jnp.sign(flo)
        return (jnp.where(left, mid, lo), jnp.where(left, hi, mid),
                jnp.where(left, fm, flo))

    lo, hi, _ = lax.fori_loop(0, iters, body, (lo, hi, flo))
    return 0.5 * (lo + hi)


def secant(f, x0, x1, iters: int = 40):
    """Plain secant iteration (ref: secant_method.hpp secant_method)."""
    x0 = jnp.asarray(x0, jnp.result_type(float))
    x1 = jnp.asarray(x1, x0.dtype)
    f0, f1 = f(x0), f(x1)

    def body(_, c):
        x0, x1, f0, f1 = c
        denom = f1 - f0
        safe = jnp.where(jnp.abs(denom) > 1e-300, denom, 1.0)
        x2 = jnp.where(jnp.abs(denom) > 1e-300, x1 - f1 * (x1 - x0) / safe, x1)
        return x1, x2, f1, f(x2)

    _, x1, _, _ = lax.fori_loop(0, iters, body, (x0, x1, f0, f1))
    return x1


def illinois(f, lo, hi, iters: int = 40):
    """Illinois-weighted regula falsi on a bracket
    (ref: secant_method.hpp illinois weighting)."""
    lo = jnp.asarray(lo, jnp.result_type(float))
    hi = jnp.asarray(hi, lo.dtype)
    flo, fhi = f(lo), f(hi)

    def body(_, c):
        lo, hi, flo, fhi = c
        denom = fhi - flo
        safe = jnp.where(jnp.abs(denom) > 1e-300, denom, 1.0)
        x = hi - fhi * (hi - lo) / safe
        fx = f(x)
        same_side = jnp.sign(fx) == jnp.sign(fhi)
        # replace the endpoint on the same side; halve the stale one (Illinois)
        nlo = jnp.where(same_side, lo, hi)
        nflo = jnp.where(same_side, 0.5 * flo, fhi)
        return nlo, x, nflo, fx

    _, hi, _, _ = lax.fori_loop(0, iters, body, (lo, hi, flo, fhi))
    return hi


def ridders(f, lo, hi, iters: int = 30):
    """Ridders' exponential-fit bracketed method
    (ref: secant_method.hpp ridders_method)."""
    lo = jnp.asarray(lo, jnp.result_type(float))
    hi = jnp.asarray(hi, lo.dtype)
    flo, fhi = f(lo), f(hi)

    def body(_, c):
        lo, hi, flo, fhi = c
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        s = jnp.sqrt(jnp.maximum(fm * fm - flo * fhi, 0.0))
        safe = jnp.where(s > 1e-300, s, 1.0)
        x = mid + (mid - lo) * jnp.sign(flo - fhi) * fm / safe
        x = jnp.where(s > 1e-300, x, mid)
        fx = f(x)
        # rebuild the tightest sign-changing bracket from {lo, mid, x, hi}
        use_mx = jnp.sign(fm) != jnp.sign(fx)
        use_lx = jnp.sign(flo) != jnp.sign(fx)
        nlo = jnp.where(use_mx, jnp.minimum(mid, x),
                        jnp.where(use_lx, lo, x))
        nhi = jnp.where(use_mx, jnp.maximum(mid, x),
                        jnp.where(use_lx, x, hi))
        nflo = jnp.where(use_mx, jnp.where(mid < x, fm, fx),
                         jnp.where(use_lx, flo, fx))
        nfhi = jnp.where(use_mx, jnp.where(mid < x, fx, fm),
                         jnp.where(use_lx, fx, fhi))
        return nlo, nhi, nflo, nfhi

    lo, hi, flo, fhi = lax.fori_loop(0, iters, body, (lo, hi, flo, fhi))
    return jnp.where(jnp.abs(flo) < jnp.abs(fhi), lo, hi)


def brent(f, lo, hi, iters: int = 40):
    """Brent-style bracketed method: inverse-quadratic / secant step with a
    bisection safeguard (ref: secant_method.hpp brent_method).

    Branch-free reformulation: each iteration computes the interpolated
    candidate, rejects it for the midpoint whenever it leaves the bracket,
    then updates the sign-changing bracket — same convergence class as
    classical Brent with static control flow.
    """
    a = jnp.asarray(lo, jnp.result_type(float))
    b = jnp.asarray(hi, a.dtype)
    fa, fb = f(a), f(b)

    def body(_, c):
        a, b, fa, fb = c
        # inverse quadratic through (a, fa), (b, fb), (m, fm)
        m = 0.5 * (a + b)
        fm = f(m)
        d0, d1, d2 = fa - fb, fb - fm, fm - fa
        safe = lambda x: jnp.where(jnp.abs(x) > 1e-300, x, 1.0)
        x_iq = (a * fb * fm / safe(d0 * -d2)
                + b * fa * fm / safe(-d0 * d1)
                + m * fa * fb / safe(d2 * d1))
        inside = (x_iq > jnp.minimum(a, b)) & (x_iq < jnp.maximum(a, b))
        x = jnp.where(inside & jnp.isfinite(x_iq), x_iq, m)
        fx = f(x)
        # keep the sign-changing half among {a,m,x,b}, collapsing toward x
        lo_, hi_ = jnp.minimum(a, b), jnp.maximum(a, b)
        flo_ = jnp.where(a < b, fa, fb)
        fhi_ = jnp.where(a < b, fb, fa)
        left = jnp.sign(flo_) != jnp.sign(fx)
        na = jnp.where(left, lo_, x)
        nfa = jnp.where(left, flo_, fx)
        nb = jnp.where(left, x, hi_)
        nfb = jnp.where(left, fx, fhi_)
        return na, nb, nfa, nfb

    a, b, fa, fb = lax.fori_loop(0, iters, body, (a, b, fa, fb))
    return jnp.where(jnp.abs(fa) < jnp.abs(fb), a, b)


def newton_raphson(f, x0, iters: int = 25, df=None):
    """Newton–Raphson (ref: newton_raphson_method.hpp:63).  Derivative via
    forward-mode AD unless ``df`` is given; elementwise over batched x0."""
    x = jnp.asarray(x0, jnp.result_type(float))
    if df is None:
        def df(x):
            _, d = jax.jvp(f, (x,), (jnp.ones_like(x),))
            return d

    def body(_, x):
        fx, dfx = f(x), df(x)
        safe = jnp.where(jnp.abs(dfx) > 1e-300, dfx, 1.0)
        return x - fx / safe

    return lax.fori_loop(0, iters, body, x)


def broyden(f, x0, iters: int = 50, J0=None):
    """Broyden's good method for vector roots f: R^n → R^n
    (ref: secant_method.hpp broyden_method analog for systems).

    Maintains an approximate inverse Jacobian via Sherman–Morrison.
    """
    x = jnp.asarray(x0, jnp.result_type(float))
    n = x.shape[-1]
    fx = f(x)
    Jinv = jnp.eye(n, dtype=x.dtype) if J0 is None else jnp.linalg.inv(J0)

    def body(_, c):
        x, fx, Jinv = c
        dx = -(Jinv @ fx)
        xn = x + dx
        fn = f(xn)
        df = fn - fx
        Jdf = Jinv @ df
        denom = jnp.vdot(dx, Jdf)
        safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
        upd = jnp.outer(dx - Jdf, dx @ Jinv) / safe
        Jinv_n = jnp.where(jnp.abs(denom) > 1e-30, Jinv + upd, Jinv)
        return xn, fn, Jinv_n

    x, fx, _ = lax.fori_loop(0, iters, body, (x, fx, Jinv))
    return x

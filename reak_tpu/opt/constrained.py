"""Constrained NLP: augmented Lagrangian, equality SQP, log-barrier IP.

JAX-native equivalents of the reference's constrained solvers
(ref: core/optimization/augmented_lagrangian_methods.hpp,
sequential_qp_methods.hpp:196 Byrd–Omojokun SQP,
nl_interior_points_methods.hpp:1215 interior-point LS/TR).

Conventions: minimize f(x) subject to ce(x) = 0 and ci(x) ≥ 0.
All outer/inner loops have static budgets; inner solves reuse
:func:`reak_tpu.opt.nlp.bfgs` machinery via damped-Newton KKT steps.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from reak_tpu.math.linalg import solve_pd
from reak_tpu.opt.line_search import backtracking_armijo
from reak_tpu.opt.nlp import pd_shift


class ConstrainedResult(NamedTuple):
    x: jax.Array
    f: jax.Array
    eq_violation: jax.Array
    ineq_violation: jax.Array


def _finalize(f, ce, ci, x) -> ConstrainedResult:
    ev = jnp.linalg.norm(ce(x)) if ce is not None else jnp.asarray(0.0)
    iv = (jnp.linalg.norm(jnp.minimum(ci(x), 0.0))
          if ci is not None else jnp.asarray(0.0))
    return ConstrainedResult(x, f(x), ev, iv)


def augmented_lagrangian(f: Callable, x0, ce: Optional[Callable] = None,
                         ci: Optional[Callable] = None,
                         outer_iters: int = 12, inner_iters: int = 25,
                         mu0: float = 10.0, mu_growth: float = 4.0
                         ) -> ConstrainedResult:
    """Augmented-Lagrangian method (ref: augmented_lagrangian_methods.hpp).

    Inequalities handled via the standard clipped form:
    L = f − λᵀce + μ/2‖ce‖² + 1/(2μ) Σ (max(0, σ − μ ci)² − σ²).
    Inner minimization: damped Newton on the AL with AD derivatives.
    """
    x = jnp.asarray(x0, jnp.result_type(float))
    n_e = ce(x).shape[-1] if ce is not None else 0
    n_i = ci(x).shape[-1] if ci is not None else 0
    lam = jnp.zeros(n_e, x.dtype)
    sig = jnp.zeros(n_i, x.dtype)
    mu = jnp.asarray(mu0, x.dtype)

    def al(x, lam, sig, mu):
        v = f(x)
        if ce is not None:
            c = ce(x)
            v = v - jnp.vdot(lam, c) + 0.5 * mu * jnp.vdot(c, c)
        if ci is not None:
            g = ci(x)
            t = jnp.maximum(0.0, sig - mu * g)
            v = v + jnp.sum(t * t - sig * sig) / (2.0 * mu)
        return v

    def inner(x, lam, sig, mu):
        obj = lambda x: al(x, lam, sig, mu)
        grad = jax.grad(obj)
        hess = jax.hessian(obj)
        eye = jnp.eye(x.shape[-1], dtype=x.dtype)

        def body(_, c):
            x, fx, gx = c
            H = hess(x)
            d = -solve_pd(H + pd_shift(H) * eye, gx)
            a, fn = backtracking_armijo(obj, x, d, fx, gx, iters=20)
            xn = x + a * d
            return xn, fn, grad(xn)

        fx, gx = obj(x), grad(x)
        x, _, _ = lax.fori_loop(0, inner_iters, body, (x, fx, gx))
        return x

    def outer(_, c):
        x, lam, sig, mu = c
        x = inner(x, lam, sig, mu)
        if ce is not None:
            lam = lam - mu * ce(x)
        if ci is not None:
            sig = jnp.maximum(0.0, sig - mu * ci(x))
        return x, lam, sig, mu * mu_growth

    x, lam, sig, mu = lax.fori_loop(0, outer_iters, outer, (x, lam, sig, mu))
    return _finalize(f, ce, ci, x)


def sqp_equality(f: Callable, ce: Callable, x0, iters: int = 30,
                 reg: float = 1e-8, merit_mu: float = 10.0) -> ConstrainedResult:
    """Equality-constrained SQP via damped KKT-Newton steps with an ℓ1-merit
    backtracking search (ref: sequential_qp_methods.hpp:196 — the
    Byrd–Omojokun normal/tangential decomposition collapses to one KKT solve
    in the equality-only case)."""
    x = jnp.asarray(x0, jnp.result_type(float))
    n = x.shape[-1]
    m = ce(x).shape[-1]
    lam = jnp.zeros(m, x.dtype)

    def lagrangian(x, lam):
        return f(x) - jnp.vdot(lam, ce(x))

    grad_f = jax.grad(f)
    jac_c = jax.jacfwd(ce)
    hess_L = jax.hessian(lagrangian, argnums=0)

    def merit(x):
        return f(x) + merit_mu * jnp.sum(jnp.abs(ce(x)))

    def body(_, c):
        x, lam = c
        g = grad_f(x)
        A = jac_c(x)
        cx = ce(x)
        H = hess_L(x, lam)
        # convexify H (exact PD shift)
        H = H + pd_shift(H, reg) * jnp.eye(n, dtype=x.dtype)
        # KKT system [H Aᵀ; A 0][dx; -lam⁺] = [-g; -c]
        K = jnp.block([[H, A.T], [A, jnp.zeros((m, m), x.dtype)]])
        rhs = jnp.concatenate([-g, -cx])
        sol = jnp.linalg.solve(K + reg * jnp.eye(n + m, dtype=x.dtype), rhs)
        dx, lam_new = sol[:n], -sol[n:]
        # ℓ1-merit backtracking
        m0 = merit(x)
        a, _ = backtracking_armijo(merit, x, dx, m0,
                                   jax.grad(merit)(x), iters=20)
        return x + a * dx, lam_new

    x, lam = lax.fori_loop(0, iters, body, (x, lam))
    return _finalize(f, ce, None, x)


def log_barrier(f: Callable, ci: Callable, x0, ce: Optional[Callable] = None,
                outer_iters: int = 10, inner_iters: int = 20,
                t0: float = 1.0, t_growth: float = 4.0) -> ConstrainedResult:
    """Log-barrier interior point for ci(x) ≥ 0 (+ optional equalities via
    quadratic penalty) — the fixed-μ-schedule analog of the reference's
    nl_interior_points_methods.hpp:1215 path-following methods.

    ``x0`` must be strictly feasible (ci(x0) > 0)."""
    x = jnp.asarray(x0, jnp.result_type(float))
    eye = jnp.eye(x.shape[-1], dtype=x.dtype)

    def barrier(x, t):
        g = ci(x)
        v = t * f(x) - jnp.sum(jnp.log(jnp.maximum(g, 1e-300)))
        if ce is not None:
            c = ce(x)
            v = v + 0.5 * t * 100.0 * jnp.vdot(c, c)
        # infeasible iterates get +inf so the line search rejects them
        return jnp.where(jnp.all(g > 0), v, jnp.inf)

    def inner(x, t):
        obj = lambda x: barrier(x, t)
        grad = jax.grad(obj)
        hess = jax.hessian(obj)

        def body(_, c):
            x, fx, gx = c
            H = hess(x)
            d = -solve_pd(H + pd_shift(H) * eye, gx)
            a, fn = backtracking_armijo(obj, x, d, fx, gx, iters=25)
            xn = x + a * d
            ok = jnp.isfinite(fn)
            return (jnp.where(ok, xn, x), jnp.where(ok, fn, fx),
                    jnp.where(ok, grad(xn), gx))

        fx, gx = obj(x), grad(x)
        x, _, _ = lax.fori_loop(0, inner_iters, body, (x, fx, gx))
        return x

    def outer(_, c):
        x, t = c
        return inner(x, t), t * t_growth

    x, _ = lax.fori_loop(0, outer_iters, outer, (x, jnp.asarray(t0, x.dtype)))
    return _finalize(f, ce, ci, x)

"""Nonlinear least squares: Gauss–Newton, Levenberg–Marquardt, J-transpose.

JAX-native equivalents of the reference's NLLSQ solvers
(ref: core/optimization/gauss_newton_method.hpp gauss_newton_nllsq,
levenberg_marquardt_method.hpp:57 levenberg_marquardt_nllsq,
jacobian_transpose_method.hpp).  Jacobians come from forward-mode AD rather
than user callbacks; every solver is a fixed-iteration straight-line program
(LM accept/reject is a select, not a branch) so the whole fit ``vmap``s over
batches — e.g. batched CLIK IK across scenario goals
(ref consumer: ctrl/kte_models/manip_clik_calculator.hpp:209).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from reak_tpu.math.linalg import solve_pd


class NLLSQResult(NamedTuple):
    x: jax.Array
    residual_norm: jax.Array
    grad_norm: jax.Array


def _jac(r, x):
    return jax.jacfwd(r)(x)


def gauss_newton(r: Callable, x0, iters: int = 20, damping: float = 1e-9,
                 step_clip: float | None = None) -> NLLSQResult:
    """Damped Gauss–Newton (ref: gauss_newton_method.hpp).

    ``r(x) -> (m,)`` residual vector; minimizes ½‖r(x)‖².
    """
    x = jnp.asarray(x0, jnp.result_type(float))

    def body(_, x):
        rx = r(x)
        J = _jac(r, x)
        H = J.T @ J + damping * jnp.eye(x.shape[-1], dtype=x.dtype)
        dx = -solve_pd(H, J.T @ rx)
        if step_clip is not None:
            nrm = jnp.linalg.norm(dx)
            dx = dx * jnp.minimum(1.0, step_clip / jnp.maximum(nrm, 1e-30))
        return x + dx

    x = lax.fori_loop(0, iters, body, x)
    rx = r(x)
    J = _jac(r, x)
    return NLLSQResult(x, jnp.linalg.norm(rx), jnp.linalg.norm(J.T @ rx))


def levenberg_marquardt(r: Callable, x0, iters: int = 30, lam0: float = 1e-2,
                        lam_up: float = 4.0, lam_down: float = 0.25,
                        lam_min: float = 1e-12, lam_max: float = 1e8) -> NLLSQResult:
    """Levenberg–Marquardt with multiplicative damping adaptation
    (ref: levenberg_marquardt_method.hpp:57 — same accept/reject policy,
    expressed as selects so the iteration count is static)."""
    x = jnp.asarray(x0, jnp.result_type(float))
    n = x.shape[-1]
    eye = jnp.eye(n, dtype=x.dtype)

    def body(_, c):
        x, lam, cost = c
        rx = r(x)
        J = _jac(r, x)
        g = J.T @ rx
        H = J.T @ J
        dx = -solve_pd(H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-12)), g)
        xn = x + dx
        rn = r(xn)
        cn = 0.5 * jnp.vdot(rn, rn).real
        accept = cn < cost
        x = jnp.where(accept, xn, x)
        cost = jnp.where(accept, cn, cost)
        lam = jnp.clip(jnp.where(accept, lam * lam_down, lam * lam_up),
                       lam_min, lam_max)
        return x, lam, cost

    r0 = r(x)
    cost0 = 0.5 * jnp.vdot(r0, r0).real
    x, _, _ = lax.fori_loop(0, iters, body, (x, jnp.asarray(lam0, x.dtype), cost0))
    rx = r(x)
    J = _jac(r, x)
    return NLLSQResult(x, jnp.linalg.norm(rx), jnp.linalg.norm(J.T @ rx))


def jacobian_transpose(r: Callable, x0, iters: int = 200, rate: float | None = None
                       ) -> NLLSQResult:
    """Jacobian-transpose descent (ref: jacobian_transpose_method.hpp).
    Step size per iteration from the exact 1-D minimizer along Jᵀr."""
    x = jnp.asarray(x0, jnp.result_type(float))

    def body(_, x):
        rx = r(x)
        J = _jac(r, x)
        g = J.T @ rx
        if rate is None:
            Jg = J @ g
            alpha = jnp.vdot(g, g) / jnp.maximum(jnp.vdot(Jg, Jg), 1e-30)
        else:
            alpha = rate
        return x - alpha * g

    x = lax.fori_loop(0, iters, body, x)
    rx = r(x)
    J = _jac(r, x)
    return NLLSQResult(x, jnp.linalg.norm(rx), jnp.linalg.norm(J.T @ rx))

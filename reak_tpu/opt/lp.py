"""Linear programming: Mehrotra predictor-corrector interior point.

The reference ships two LP solvers — primal-dual simplex
(ref: core/optimization/simplex_method.hpp) and a Mehrotra interior-point
(ref: core/optimization/mehrotra_method.hpp) — and its own README flags BOTH
as broken ("the LP solvers don't work", ref: README:301-303).  This module
provides a *working* JAX-native replacement: a standard-form Mehrotra
predictor-corrector with the normal-equations solve batched as dense
Cholesky, a fixed iteration budget (XLA-friendly: `lax.scan`, no
data-dependent control flow), and the classic Mehrotra starting-point
heuristic.  Validated against scipy.optimize.linprog in tests/test_lp.py.

Standard form:  min cᵀx  s.t.  A x = b,  x ≥ 0.
``solve_lp_inequality`` converts  min cᵀx  s.t.  G x ≤ h, x free  via
slacks and a free-variable split.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.math.linalg import solve_pd


class LPResult(NamedTuple):
    x: jax.Array          # primal solution
    y: jax.Array          # equality duals
    s: jax.Array          # reduced costs (duals of x ≥ 0)
    obj: jax.Array        # cᵀx
    gap: jax.Array        # final complementarity μ
    primal_res: jax.Array
    dual_res: jax.Array


def _starting_point(A, b, c, reg):
    """Mehrotra's least-squares starting point (the standard heuristic:
    x̃ = Aᵀ(AAᵀ)⁻¹b, ỹ = (AAᵀ)⁻¹Ac, s̃ = c − Aᵀỹ, then shift positive)."""
    m = A.shape[0]
    AAt = A @ A.T + reg * jnp.eye(m, dtype=A.dtype)
    x = A.T @ solve_pd(AAt, b)
    y = solve_pd(AAt, A @ c)
    s = c - A.T @ y
    dx = jnp.maximum(-1.5 * jnp.min(x), 0.0)
    ds = jnp.maximum(-1.5 * jnp.min(s), 0.0)
    x = x + dx
    s = s + ds
    xs = jnp.dot(x, s)
    dx2 = 0.5 * xs / jnp.maximum(jnp.sum(s), 1e-30)
    ds2 = 0.5 * xs / jnp.maximum(jnp.sum(x), 1e-30)
    return x + dx2 + 1e-1, y, s + ds2 + 1e-1


def solve_lp(A, b, c, iters: int = 30, reg: float = 1e-10) -> LPResult:
    """min cᵀx  s.t.  Ax = b, x ≥ 0  (Mehrotra predictor-corrector).

    A (m, n) with m ≤ n and full row rank.  Fixed ``iters`` interior-point
    iterations (each: one normal-equations Cholesky + two back-solves).
    jit/vmap-compatible.
    """
    A = jnp.asarray(A)
    dtype = A.dtype
    b = jnp.asarray(b, dtype)
    c = jnp.asarray(c, dtype)
    m, n = A.shape
    x, y, s = _starting_point(A, b, c, reg)
    eye_m = jnp.eye(m, dtype=dtype)

    def max_step(v, dv):
        t = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, 0.995 * jnp.min(t))

    def body(carry, _):
        x, y, s = carry
        rp = b - A @ x                    # primal residual
        rd = c - A.T @ y - s              # dual residual
        mu = jnp.dot(x, s) / n
        d2 = x / jnp.maximum(s, 1e-30)    # diag(X/S)

        M = (A * d2[None, :]) @ A.T + reg * eye_m

        def solve_dirs(rc):
            # rc = XSe − target (so the Newton row reads S dx + X ds = −rc);
            # eliminating (dx, ds) gives  A D² Aᵀ dy = rp + A(D² rd + rc/s)
            rhs = rp + A @ (d2 * rd + rc / jnp.maximum(s, 1e-30))
            dy = solve_pd(M, rhs)
            ds = rd - A.T @ dy
            dx = -(rc / jnp.maximum(s, 1e-30)) - d2 * ds
            return dx, dy, ds

        # predictor (affine scaling)
        rc_aff = x * s
        dx_a, dy_a, ds_a = solve_dirs(rc_aff)
        a_p = max_step(x, dx_a)
        a_d = max_step(s, ds_a)
        mu_aff = jnp.dot(x + a_p * dx_a, s + a_d * ds_a) / n
        sigma = (mu_aff / jnp.maximum(mu, 1e-30)) ** 3

        # corrector
        rc = x * s + dx_a * ds_a - sigma * mu
        dx, dy, ds = solve_dirs(rc)
        a_p = max_step(x, dx)
        a_d = max_step(s, ds)
        x_n, y_n, s_n = x + a_p * dx, y + a_d * dy, s + a_d * ds
        # freeze once converged: running a fixed budget past optimality
        # makes diag(X/S) blow up and the normal equations go singular
        done = (mu < 1e-13) | ~(
            jnp.all(jnp.isfinite(x_n)) & jnp.all(jnp.isfinite(y_n))
            & jnp.all(jnp.isfinite(s_n)))
        keep = lambda new, old: jnp.where(done, old, new)
        return (keep(x_n, x), keep(y_n, y), keep(s_n, s)), None

    (x, y, s), _ = jax.lax.scan(body, (x, y, s), None, length=iters)
    return LPResult(
        x=x, y=y, s=s, obj=jnp.dot(c, x), gap=jnp.dot(x, s) / n,
        primal_res=jnp.linalg.norm(A @ x - b),
        dual_res=jnp.linalg.norm(A.T @ y + s - c))


def solve_lp_inequality(c, G, h, iters: int = 30,
                        reg: float = 1e-10) -> LPResult:
    """min cᵀx  s.t.  G x ≤ h  with x free — converted to standard form via
    the split x = x⁺ − x⁻ and slack variables w:  min [c, −c, 0]ᵀ[x⁺,x⁻,w]
    s.t. [G, −G, I][x⁺,x⁻,w] = h, all ≥ 0.  Returns the solution with
    ``x`` already recombined."""
    G = jnp.asarray(G)
    dtype = G.dtype
    c = jnp.asarray(c, dtype)
    h = jnp.asarray(h, dtype)
    m, n = G.shape
    A = jnp.concatenate([G, -G, jnp.eye(m, dtype=dtype)], axis=1)
    cc = jnp.concatenate([c, -c, jnp.zeros(m, dtype)])
    res = solve_lp(A, h, cc, iters=iters, reg=reg)
    x = res.x[:n] - res.x[n:2 * n]
    return LPResult(x=x, y=res.y, s=res.s, obj=jnp.dot(c, x), gap=res.gap,
                    primal_res=res.primal_res, dual_res=res.dual_res)

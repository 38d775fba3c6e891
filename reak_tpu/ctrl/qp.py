"""Batched convex QP solvers with static iteration counts.

JAX-native replacement for the reference's QP toolbox
(ref: core/optimization/quadratic_programs.hpp:77 null-space method, :313
projected CG, mehrotra_method.hpp:269 Mehrotra predictor-corrector).

Primary workhorse: a Mehrotra-style primal-dual interior-point method for
box-constrained QPs — the condensed-MPC core.  Everything is straight-line
batched linear algebra (Cholesky + triangular solves), so ``vmap`` over
thousands of scenarios becomes batched dense linear algebra.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.math.linalg import solve_pd


class QPResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    gap: jax.Array  # final complementarity gap


def solve_box_qp(H, g, lb, ub, iters: int = 15, reg: float = 1e-9) -> QPResult:
    """min ½xᵀHx + gᵀx  s.t.  lb ≤ x ≤ ub, via Mehrotra predictor-corrector PDIP
    (ref behavior: core/optimization/mehrotra_method.hpp:269).

    Static ``iters`` Newton rounds; each solves one SPD system
    (H + Σ λ/s) Δx = r via Cholesky.  f32-safe; for 1e-6+ accuracy use f64.
    """
    n = H.shape[-1]
    dtype = H.dtype
    eye = jnp.eye(n, dtype=dtype)
    Hr = H + reg * eye

    # strictly-interior start
    x = jnp.clip(jnp.zeros(n, dtype), lb + 0.1 * (ub - lb), ub - 0.1 * (ub - lb))
    sl = x - lb
    su = ub - x
    zl = jnp.ones(n, dtype)
    zu = jnp.ones(n, dtype)

    def newton_dx(d, rhs):
        return solve_pd(Hr + jnp.diag(d), rhs)

    def max_step(v, dv):
        """Largest α ≤ 1 with v + α·dv ≥ (1−0.995)·… (fraction-to-boundary)."""
        t = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, 0.995 * jnp.min(t))

    def body(carry, _):
        x, sl, su, zl, zu = carry
        r_dual = Hr @ x + g - zl + zu
        mu = (sl @ zl + su @ zu) / (2 * n)
        d = zl / sl + zu / su

        # --- affine (predictor) step: complementarity targets −zl∘sl, −zu∘su
        # rhs = −r_dual + rc_l/sl − rc_u/su = −(Hx + g)
        dx_aff = newton_dx(d, -(Hr @ x + g))
        dzl_aff = -zl - (zl / sl) * dx_aff
        dzu_aff = -zu + (zu / su) * dx_aff

        a_p = jnp.minimum(max_step(sl, dx_aff), max_step(su, -dx_aff))
        a_d = jnp.minimum(max_step(zl, dzl_aff), max_step(zu, dzu_aff))
        mu_aff = (
            (sl + a_p * dx_aff) @ (zl + a_d * dzl_aff)
            + (su - a_p * dx_aff) @ (zu + a_d * dzu_aff)
        ) / (2 * n)
        sigma = (mu_aff / jnp.maximum(mu, 1e-30)) ** 3

        # --- corrector with centering: targets σμ − ds_aff∘dz_aff − z∘s
        rc_l = sigma * mu - dx_aff * dzl_aff - zl * sl
        rc_u = sigma * mu + dx_aff * dzu_aff - zu * su
        rhs = -r_dual + rc_l / sl - rc_u / su
        dx = newton_dx(d, rhs)
        dzl = (rc_l - zl * dx) / sl
        dzu = (rc_u + zu * dx) / su

        a_p = jnp.minimum(max_step(sl, dx), max_step(su, -dx))
        a_d = jnp.minimum(max_step(zl, dzl), max_step(zu, dzu))

        x = x + a_p * dx
        sl = sl + a_p * dx
        su = su - a_p * dx
        zl = zl + a_d * dzl
        zu = zu + a_d * dzu
        return (x, sl, su, zl, zu), None

    (x, sl, su, zl, zu), _ = jax.lax.scan(body, (x, sl, su, zl, zu), None, length=iters)
    gap = (sl @ zl + su @ zu) / (2 * n)
    return QPResult(x=jnp.clip(x, lb, ub), iters=jnp.asarray(iters), gap=gap)


def solve_eq_qp(H, g, A, b, reg: float = 1e-10):
    """Equality-constrained QP  min ½xᵀHx + gᵀx  s.t. Ax = b  via the KKT/
    range-space method (ref: quadratic_programs.hpp:77 null_space_QP_method).

    Returns (x, λ)."""
    Hi_g = solve_pd(H + reg * jnp.eye(H.shape[-1], dtype=H.dtype), g)
    Hi_At = solve_pd(H + reg * jnp.eye(H.shape[-1], dtype=H.dtype), jnp.swapaxes(A, -1, -2))
    S = A @ Hi_At  # Schur complement (m × m), SPD for full-rank A
    lam = solve_pd(S, -(A @ Hi_g + b))
    x = -Hi_g - Hi_At @ lam
    return x, lam


def project_box(x, lb, ub):
    return jnp.clip(x, lb, ub)


def solve_box_qp_pg(H, g, lb, ub, iters: int = 200):
    """Projected-gradient fallback (accelerated, fixed iterations) — the
    simple/robust option mirroring projected-CG usage
    (ref: quadratic_programs.hpp:313).  Linear convergence; prefer
    :func:`solve_box_qp` for tight tolerances."""
    # Lipschitz estimate by power iteration (static count)
    v = jnp.ones_like(g)
    for _ in range(12):
        v = H @ v
        v = v / jnp.linalg.norm(v)
    L = v @ (H @ v)
    step = 1.0 / L

    def body(carry, _):
        x, y, t = carry
        x_new = project_box(y - step * (H @ y + g), lb, ub)
        t_new = 0.5 * (1 + jnp.sqrt(1 + 4 * t * t))
        y_new = x_new + (t - 1) / t_new * (x_new - x)
        return (x_new, y_new, t_new), None

    x0 = project_box(jnp.zeros_like(g), lb, ub)
    (x, _, _), _ = jax.lax.scan(body, (x0, x0, jnp.asarray(1.0, H.dtype)), None, length=iters)
    return QPResult(x=x, iters=jnp.asarray(iters), gap=jnp.asarray(jnp.nan, H.dtype))

"""Linearly-implicit (Rosenbrock) stiff integrators.

The reference ships only explicit and predictor-corrector methods
(ref: core/integrators/fixed_step_integrators.hpp, pred_corr_integrators.hpp,
variable_step_integrators.hpp) — which is why its own stiff-IVP test suite
(ref: core/integrators/unit_test_integrators.cpp:250-280) generates reference
trajectories but asserts nothing: none of its integrators can traverse
Pollution (λ ~ −1e12), the Ring Modulator (C_s = 2e-12), ROBER (t_f = 1e11)
or E5 (t_f = 1e13).  This module closes that capability gap natively in JAX:

* **Rosenbrock 2(3)** (Shampine–Reichelt, the ode23s scheme): L-stable,
  linearly implicit — ONE Jacobian (jax.jacfwd) + ONE LU factorization +
  three back-substitutions per step, no Newton iteration, no data-dependent
  inner loop — exactly the fixed-structure step body XLA wants.
* Embedded 3rd-order error estimate drives the same bounded
  ``lax.while_loop`` step controller as integrators/adaptive.py, with the
  mixed absolute/relative error norm stiff problems need (component scale
  spans 1e-290..1e4 across the suite).

Validated against the published CWI/Hairer-Wanner endpoint values in
tests/test_stiff_ivp.py (integrators/ivp_suite.py) — an assertion level the
reference's empty test shells never reach.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


_D = 1.0 / (2.0 + 2.0 ** 0.5)  # 1/(2+√2)
_E32 = 6.0 + 2.0 ** 0.5        # 6+√2


def rosenbrock23_step(f, jac, t, y, dt):
    """One Rosenbrock 2(3) attempt → (y1 2nd-order, err_vec 3rd-order est).

    Autonomous-form treatment of time dependence: ∂f/∂t enters via a
    forward-difference (the standard ode23s practice); J = ∂f/∂y at (t, y).
    """
    n = y.shape[0]
    J = jac(t, y)
    eye = jnp.eye(n, dtype=y.dtype)
    W = eye - (dt * _D) * J
    lu, piv = jax.scipy.linalg.lu_factor(W)
    solve = lambda b: jax.scipy.linalg.lu_solve((lu, piv), b)

    # df/dt by forward difference, guarded for huge t (autonomous problems
    # see an exactly zero difference)
    tdel = dt * 0.1
    F0 = f(t, y)
    dfdt = (f(t + tdel, y) - F0) / tdel
    hdT = (dt * _D) * dfdt

    k1 = solve(F0 + hdT)
    F1 = f(t + 0.5 * dt, y + 0.5 * dt * k1)
    k2 = solve(F1 - k1) + k1
    y1 = y + dt * k2
    F2 = f(t + dt, y1)
    k3 = solve(F2 - _E32 * (k2 - F1) - 2.0 * (k1 - F0) + hdT)
    err = (dt / 6.0) * (k1 - 2.0 * k2 + k3)
    return y1, err


class StiffResult(NamedTuple):
    y: jax.Array
    t: jax.Array
    dt: jax.Array
    n_steps: jax.Array   # accepted + rejected attempts
    ok: jax.Array        # reached t_end within budget & above dt_min


def integrate_rosenbrock(
    f,
    y0,
    t0,
    t_end,
    dt0,
    rtol=1e-6,
    atol=1e-9,
    dt_min=0.0,
    dt_max=None,
    max_steps=100_000,
    jac=None,
):
    """Adaptive Rosenbrock 2(3) integration over [t0, t_end].

    ``atol`` may be a scalar or per-component vector.  ``jac`` defaults to
    jax.jacfwd of ``f`` (re-evaluated every attempt).  Same bounded-budget
    failure signalling as integrators/adaptive.integrate_adaptive: ``ok``
    goes False instead of raising (ref exception surface:
    integration_exceptions.hpp:82 untolerable_integration).
    """
    dtype = jnp.result_type(float)
    y0 = jnp.asarray(y0, dtype)
    t0 = jnp.asarray(t0, dtype)
    t_end = jnp.asarray(t_end, dtype)
    atol_v = jnp.broadcast_to(jnp.asarray(atol, dtype), y0.shape)
    if jac is None:
        jac = lambda t, y: jax.jacfwd(lambda yy: f(t, yy))(y)
    dt_max_v = jnp.asarray(dt_max if dt_max is not None else (t_end - t0),
                           dtype)
    dt_min_v = jnp.asarray(dt_min, dtype)

    def err_norm(err, y, y1):
        scale = atol_v + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y1))
        return jnp.sqrt(jnp.mean((err / scale) ** 2))

    def cond(state):
        t, y, dt, n, alive = state
        return alive & (t < t_end) & (n < max_steps)

    def body(state):
        t, y, dt, n, alive = state
        dt_eff = jnp.minimum(dt, t_end - t)
        y1, err = rosenbrock23_step(f, jac, t, y, dt_eff)
        e = err_norm(err, y, y1)
        finite = jnp.all(jnp.isfinite(y1))
        accept = (e <= 1.0) & finite
        # 3rd-order error estimate → exponent 1/3
        scale = jnp.where(
            finite,
            jnp.clip(0.8 * (1.0 / jnp.maximum(e, 1e-30)) ** (1.0 / 3.0),
                     0.2, 5.0),
            jnp.asarray(0.2, dtype))
        new_dt = jnp.clip(dt_eff * scale, dt_min_v, dt_max_v)
        t_new = jnp.where(accept, t + dt_eff, t)
        y_new = jnp.where(accept, y1, y)
        died = (~accept) & (dt_eff <= dt_min_v) & (dt_min_v > 0)
        return (t_new, y_new, new_dt, n + 1, alive & ~died)

    t, y, dt, n, alive = jax.lax.while_loop(
        cond, body,
        (t0, y0, jnp.asarray(dt0, dtype), jnp.asarray(0), jnp.asarray(True)))
    return StiffResult(y=y, t=t, dt=dt, n_steps=n, ok=alive & (t >= t_end))

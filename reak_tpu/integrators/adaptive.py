"""Adaptive (embedded-pair) integrators with bounded step-rejection loops.

JAX-native re-design of the reference's variable-step integrators
(ref: core/integrators/variable_step_integrators.hpp:66 fehlberg45,
:251 dormand_prince45).  XLA needs static control flow, so:

- each attempted step returns (y5, error_estimate);
- a ``lax.while_loop`` over (t, y, dt) runs until t ≥ t_end or the step budget
  is exhausted (replacing the reference's untolerable_integration exception
  with a reported failure flag);
- step-size control is the standard PI-free rule dt ← dt·min(max(0.84·(tol/err)^¼, 0.1), 4).

For hot batched paths (MPC rollouts) prefer the fixed-step scans — adaptive
loops serialize; they exist for capability parity and stiff-problem testing.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.integrators.fixed import _lc


def rkf45_step(f, t, y, dt):
    """One Fehlberg 4(5) attempt → (y5, y4) (ref: variable_step_integrators.hpp:66)."""
    k1 = f(t, y)
    k2 = f(t + 0.25 * dt, _lc(y, (0.25 * dt, k1)))
    k3 = f(t + 0.375 * dt, _lc(y, (3 * dt / 32, k1), (9 * dt / 32, k2)))
    k4 = f(
        t + 12 / 13 * dt,
        _lc(y, (1932 * dt / 2197, k1), (-7200 * dt / 2197, k2), (7296 * dt / 2197, k3)),
    )
    k5 = f(
        t + dt,
        _lc(y, (439 * dt / 216, k1), (-8.0 * dt, k2), (3680 * dt / 513, k3), (-845 * dt / 4104, k4)),
    )
    k6 = f(
        t + 0.5 * dt,
        _lc(
            y,
            (-8 * dt / 27, k1),
            (2.0 * dt, k2),
            (-3544 * dt / 2565, k3),
            (1859 * dt / 4104, k4),
            (-11 * dt / 40, k5),
        ),
    )
    y5 = _lc(
        y,
        (16 * dt / 135, k1),
        (6656 * dt / 12825, k3),
        (28561 * dt / 56430, k4),
        (-9 * dt / 50, k5),
        (2 * dt / 55, k6),
    )
    y4 = _lc(
        y,
        (25 * dt / 216, k1),
        (1408 * dt / 2565, k3),
        (2197 * dt / 4104, k4),
        (-dt / 5, k5),
    )
    return y5, y4


def dopri45_step(f, t, y, dt):
    """One Dormand-Prince 4(5) attempt → (y5, y4)
    (ref: variable_step_integrators.hpp:251)."""
    k1 = f(t, y)
    k2 = f(t + dt / 5, _lc(y, (dt / 5, k1)))
    k3 = f(t + 3 * dt / 10, _lc(y, (3 * dt / 40, k1), (9 * dt / 40, k2)))
    k4 = f(t + 4 * dt / 5, _lc(y, (44 * dt / 45, k1), (-56 * dt / 15, k2), (32 * dt / 9, k3)))
    k5 = f(
        t + 8 * dt / 9,
        _lc(
            y,
            (19372 * dt / 6561, k1),
            (-25360 * dt / 2187, k2),
            (64448 * dt / 6561, k3),
            (-212 * dt / 729, k4),
        ),
    )
    k6 = f(
        t + dt,
        _lc(
            y,
            (9017 * dt / 3168, k1),
            (-355 * dt / 33, k2),
            (46732 * dt / 5247, k3),
            (49 * dt / 176, k4),
            (-5103 * dt / 18656, k5),
        ),
    )
    y5 = _lc(
        y,
        (35 * dt / 384, k1),
        (500 * dt / 1113, k3),
        (125 * dt / 192, k4),
        (-2187 * dt / 6784, k5),
        (11 * dt / 84, k6),
    )
    k7 = f(t + dt, y5)
    y4 = _lc(
        y,
        (5179 * dt / 57600, k1),
        (7571 * dt / 16695, k3),
        (393 * dt / 640, k4),
        (-92097 * dt / 339200, k5),
        (187 * dt / 2100, k6),
        (dt / 40, k7),
    )
    return y5, y4


class AdaptiveResult(NamedTuple):
    y: jax.Array  # final state pytree
    t: jax.Array  # reached time
    dt: jax.Array  # final step size
    n_steps: jax.Array  # accepted+rejected attempts used
    ok: jax.Array  # bool: reached t_end within budget & above dt_min


_ATTEMPTS = {"rkf45": rkf45_step, "dopri45": dopri45_step}


def integrate_adaptive(
    f,
    y0,
    t0,
    t_end,
    dt0,
    tol=1e-6,
    dt_min=1e-10,
    dt_max=None,
    max_steps=10_000,
    method="dopri45",
):
    """Adaptive integration with a bounded attempt budget.

    Failure signalling: instead of throwing ``untolerable_integration``
    (ref: integration_exceptions.hpp:82), returns ``ok=False`` when the step
    size underflows ``dt_min`` or the budget is exhausted before ``t_end``.
    """
    attempt = _ATTEMPTS[method] if isinstance(method, str) else method
    dtype = jnp.result_type(float)
    t0 = jnp.asarray(t0, dtype)
    t_end = jnp.asarray(t_end, dtype)
    dt_max_v = jnp.asarray(dt_max if dt_max is not None else (t_end - t0), dtype)

    def err_norm(y5, y4):
        leaves5 = jax.tree.leaves(y5)
        leaves4 = jax.tree.leaves(y4)
        sq = sum(jnp.sum((a - b) ** 2) for a, b in zip(leaves5, leaves4))
        return jnp.sqrt(sq)

    def cond(state):
        t, y, dt, n, alive = state
        return alive & (t < t_end) & (n < max_steps)

    def body(state):
        t, y, dt, n, alive = state
        dt_eff = jnp.minimum(dt, t_end - t)
        y5, y4 = attempt(f, t, y, dt_eff)
        err = err_norm(y5, y4)
        accept = err <= tol
        # standard 4th-order controller
        scale = jnp.clip(0.84 * (tol / jnp.maximum(err, 1e-30)) ** 0.25, 0.1, 4.0)
        new_dt = jnp.clip(dt_eff * scale, dt_min, dt_max_v)
        t_new = jnp.where(accept, t + dt_eff, t)
        y_new = jax.tree.map(lambda a, b: jnp.where(accept, a, b), y5, y)
        died = (~accept) & (dt_eff <= dt_min)
        return (t_new, y_new, new_dt, n + 1, alive & ~died)

    t, y, dt, n, alive = jax.lax.while_loop(
        cond, body, (t0, y0, jnp.asarray(dt0, dtype), jnp.asarray(0), jnp.asarray(True))
    )
    return AdaptiveResult(y=y, t=t, dt=dt, n_steps=n, ok=alive & (t >= t_end))

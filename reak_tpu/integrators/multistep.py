"""Predictor-corrector multistep integrators as scan carries.

JAX-native re-design of the reference's predictor-corrector family
(ref: core/integrators/pred_corr_integrators.hpp:64 adamsBM3, :301 adamsBM5,
:542 hamming_mod, :821 hamming_iter_mod).  The derivative history lives in the
scan carry; the first steps bootstrap with RK4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from reak_tpu.integrators.fixed import rk4_step


def _lin(*coeff_trees):
    """Σ aᵢ·treeᵢ."""
    a0, t0 = coeff_trees[0]
    out = jax.tree.map(lambda x: a0 * x, t0)
    for a, t in coeff_trees[1:]:
        out = jax.tree.map(lambda o, x: o + a * x, out, t)
    return out


def adams_bm3(f, y0, t0, dt, n_steps: int):
    """Adams-Bashforth-Moulton 3-step PC (ref: pred_corr_integrators.hpp:64)."""
    t = jnp.asarray(t0, jnp.result_type(float))
    ys = [y0]
    fs = [f(t, y0)]
    for i in range(min(2, n_steps)):
        y = rk4_step(f, t + i * dt, ys[-1], dt)
        ys.append(y)
        fs.append(f(t + (i + 1) * dt, y))
    if n_steps <= 2:
        return ys[n_steps]

    def body(carry, i):
        y, f0, f1, f2, t = carry  # f2 = newest
        tn = t + dt
        yp = _lin((1.0, y), (23 * dt / 12, f2), (-16 * dt / 12, f1), (5 * dt / 12, f0))
        fp = f(tn, yp)
        yc = _lin((1.0, y), (5 * dt / 12, fp), (8 * dt / 12, f2), (-1 * dt / 12, f1))
        fc = f(tn, yc)
        return (yc, f1, f2, fc, tn), None

    carry = (ys[2], fs[0], fs[1], fs[2], t + 2 * dt)
    (y, *_), _ = jax.lax.scan(body, carry, jnp.arange(n_steps - 2))
    return y


def adams_bm5(f, y0, t0, dt, n_steps: int):
    """Adams-Bashforth-Moulton 5-step PC (ref: pred_corr_integrators.hpp:301)."""
    t = jnp.asarray(t0, jnp.result_type(float))
    ys = [y0]
    fs = [f(t, y0)]
    for i in range(min(4, n_steps)):
        y = rk4_step(f, t + i * dt, ys[-1], dt)
        ys.append(y)
        fs.append(f(t + (i + 1) * dt, y))
    if n_steps <= 4:
        return ys[n_steps]

    def body(carry, i):
        y, f0, f1, f2, f3, f4, t = carry  # f4 newest
        tn = t + dt
        yp = _lin(
            (1.0, y),
            (1901 * dt / 720, f4),
            (-2774 * dt / 720, f3),
            (2616 * dt / 720, f2),
            (-1274 * dt / 720, f1),
            (251 * dt / 720, f0),
        )
        fp = f(tn, yp)
        yc = _lin(
            (1.0, y),
            (251 * dt / 720, fp),
            (646 * dt / 720, f4),
            (-264 * dt / 720, f3),
            (106 * dt / 720, f2),
            (-19 * dt / 720, f1),
        )
        fc = f(tn, yc)
        return (yc, f1, f2, f3, f4, fc, tn), None

    carry = (ys[4], fs[0], fs[1], fs[2], fs[3], fs[4], t + 4 * dt)
    (y, *_), _ = jax.lax.scan(body, carry, jnp.arange(n_steps - 4))
    return y


def _hamming(f, y0, t0, dt, n_steps: int, corrector_iters: int):
    t = jnp.asarray(t0, jnp.result_type(float))
    ys = [y0]
    fs = [f(t, y0)]
    for i in range(min(3, n_steps)):
        y = rk4_step(f, t + i * dt, ys[-1], dt)
        ys.append(y)
        fs.append(f(t + (i + 1) * dt, y))
    if n_steps <= 3:
        return ys[n_steps]

    zero = jax.tree.map(jnp.zeros_like, y0)

    def body(carry, i):
        y3, y2, y1, y, f1, f0, fm1, pc_err, t = carry
        # names: y = y_n, y1 = y_{n-1}, …; f0 = f_n, f1 = f_{n-1}, fm1 = f_{n-2}
        tn = t + dt
        p = _lin((1.0, y3), (8 * dt / 3, f0), (-4 * dt / 3, f1), (8 * dt / 3, fm1))
        m = jax.tree.map(lambda pp, ee: pp - 112.0 / 121.0 * ee, p, pc_err)
        fm = f(tn, m)
        c = _lin((9.0 / 8.0, y), (-1.0 / 8.0, y2), (3 * dt / 8, fm), (6 * dt / 8, f0), (-3 * dt / 8, f1))
        for _ in range(corrector_iters - 1):
            fm = f(tn, c)
            c = _lin((9.0 / 8.0, y), (-1.0 / 8.0, y2), (3 * dt / 8, fm), (6 * dt / 8, f0), (-3 * dt / 8, f1))
        err = jax.tree.map(lambda pp, cc: pp - cc, p, c)
        y_new = jax.tree.map(lambda cc, ee: cc + 9.0 / 121.0 * ee, c, err)
        f_new = f(tn, y_new)
        return (y2, y1, y, y_new, f0, f_new, f1, err, tn), None

    carry = (ys[0], ys[1], ys[2], ys[3], fs[2], fs[3], fs[1], zero, t + 3 * dt)
    (res) = jax.lax.scan(body, carry, jnp.arange(n_steps - 3))
    (_, _, _, y, *_), _ = res
    return y


def hamming_mod(f, y0, t0, dt, n_steps: int):
    """Hamming's modified PC method (ref: pred_corr_integrators.hpp:542)."""
    return _hamming(f, y0, t0, dt, n_steps, corrector_iters=1)


def hamming_iter_mod(f, y0, t0, dt, n_steps: int, iters: int = 3):
    """Hamming's iterated modified PC (ref: pred_corr_integrators.hpp:821)."""
    return _hamming(f, y0, t0, dt, n_steps, corrector_iters=iters)

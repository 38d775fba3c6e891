"""Unscented Kalman filter (ref: ctrl/ctrl_sys/unscented_kalman_filter.hpp:65).

Sigma points via Cholesky of the covariance; the whole propagation is one
vmapped evaluation of the system function — ideal for an accelerator (2n+1 parallel
rollouts per belief, further vmapped over scenario batches).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.math.linalg import solve_pd, symmetrize


def sigma_points(b: GaussianBelief, alpha=1e-1, beta=2.0, kappa=0.0):
    """Merwe scaled sigma points: returns (points (2n+1, n), wm, wc)."""
    n = b.mean.shape[-1]
    lam = alpha * alpha * (n + kappa) - n
    L = jnp.linalg.cholesky((n + lam) * b.cov)
    pts = jnp.concatenate(
        [b.mean[None, :], b.mean[None, :] + L.T, b.mean[None, :] - L.T], axis=0
    )
    wm = jnp.full((2 * n + 1,), 0.5 / (n + lam), b.mean.dtype)
    wm = wm.at[0].set(lam / (n + lam))
    wc = wm.at[0].set(lam / (n + lam) + (1 - alpha * alpha + beta))
    return pts, wm, wc


def ukf_predict(F: Callable, b, u, Q, t=0.0, alpha=1e-1, beta=2.0, kappa=0.0):
    """(ref: unscented_kalman_filter.hpp unscented_kalman_predict)"""
    pts, wm, wc = sigma_points(b, alpha, beta, kappa)
    prop = jax.vmap(lambda p: F(p, u, t))(pts)
    mean = wm @ prop
    d = prop - mean
    cov = jnp.einsum("k,ki,kj->ij", wc, d, d) + Q
    return GaussianBelief(mean, symmetrize(cov))


def ukf_update(h: Callable, b, z, R, t=0.0, alpha=1e-1, beta=2.0, kappa=0.0):
    """(ref: unscented_kalman_filter.hpp unscented_kalman_update)"""
    pts, wm, wc = sigma_points(b, alpha, beta, kappa)
    zs = jax.vmap(lambda p: h(p, t))(pts)
    z_hat = wm @ zs
    dz = zs - z_hat
    dx = pts - b.mean
    S = jnp.einsum("k,ki,kj->ij", wc, dz, dz) + R
    Pxz = jnp.einsum("k,ki,kj->ij", wc, dx, dz)
    K = solve_pd(S, Pxz.T).T
    mean = b.mean + K @ (z - z_hat)
    cov = b.cov - K @ S @ K.T
    return GaussianBelief(mean, symmetrize(cov))


def ukf_step(F, h, b, u, z, Q, R, t=0.0, **kw):
    """Predict + update (the reference's per-row UKF loop)."""
    return ukf_update(h, ukf_predict(F, b, u, Q, t, **kw), z, R, t, **kw)

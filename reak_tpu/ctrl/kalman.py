"""Kalman-family filters as pure (belief, u, z) → belief functions.

JAX-native replacement for the reference's free-function filter templates
(ref: ctrl/ctrl_sys/kalman_filter.hpp:88 kalman_predict, :144 kalman_update,
:214 kalman_filter_step, kalman_bucy_filter.hpp, hybrid_kalman_filter.hpp,
aggregate_kalman_filter.hpp:278, symplectic_kalman_filter.hpp:285).

Systems are pure functions; Jacobians come from jacfwd at the current belief
mean (the EKF linearization the reference implements per-model via
``get_state_transition_blocks``).  Filters vmap over Monte-Carlo batches.

The manifold hook: ``adjust(x, dx)`` / ``difference(z, ẑ)`` default to vector
addition/subtraction but may implement retraction on SE(3) etc. — mirroring
``state_space.adjust`` in the reference update (kalman_filter.hpp:170-179).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from reak_tpu.ctrl.belief import GaussianBelief, symmetrized
from reak_tpu.math.linalg import solve_pd, symmetrize


def _default_adjust(x, dx):
    return x + dx


def _default_diff(a, b):
    return a - b


def ekf_predict(
    F: Callable,
    b: GaussianBelief,
    u,
    Q,
    t=0.0,
    adjust=_default_adjust,
) -> GaussianBelief:
    """EKF prediction (ref: kalman_filter.hpp:88-110 kalman_predict):
    x⁺ = F(x, u),  P⁺ = A P Aᵀ + Q  with A = ∂F/∂x."""
    x = b.mean
    A = jax.jacfwd(lambda xx: F(xx, u, t))(x)
    x1 = F(x, u, t)
    P1 = A @ b.cov @ A.T + Q
    return GaussianBelief(x1, symmetrize(P1))


def ekf_update(
    h: Callable,
    b: GaussianBelief,
    z,
    R,
    t=0.0,
    adjust=_default_adjust,
    diff=_default_diff,
) -> GaussianBelief:
    """EKF measurement update (ref: kalman_filter.hpp:144-179 kalman_update):
    innovation y = z − h(x); S = C P Cᵀ + R; K = P Cᵀ S⁻¹ (via Cholesky);
    mean ← adjust(x, K y); P ← (I − KC) P."""
    x, P = b.mean, b.cov
    C = jax.jacfwd(lambda xx: h(xx, t))(x)
    y = diff(z, h(x, t))
    S = C @ P @ C.T + R
    K = solve_pd(S, C @ P).T  # P Cᵀ S⁻¹
    x1 = adjust(x, K @ y)
    n = x.shape[-1]
    IKC = jnp.eye(n, dtype=P.dtype) - K @ C
    # Joseph form for covariance (symmetric, PSD-preserving)
    P1 = IKC @ P @ IKC.T + K @ R @ K.T
    return GaussianBelief(x1, symmetrize(P1))


def ekf_step(F, h, b, u, z, Q, R, t=0.0, adjust=_default_adjust, diff=_default_diff):
    """Predict + update (ref: kalman_filter.hpp:214 kalman_filter_step)."""
    return ekf_update(h, ekf_predict(F, b, u, Q, t, adjust), z, R, t, adjust, diff)


def kalman_bucy_step(
    f: Callable,
    h: Callable,
    b: GaussianBelief,
    u,
    z,
    Q,
    R,
    dt,
    t=0.0,
) -> GaussianBelief:
    """Continuous-time Kalman-Bucy filter, one Euler step of the joint mean/
    covariance ODE (ref: ctrl/ctrl_sys/kalman_bucy_filter.hpp):
      ẋ = f(x,u) + K(z − h(x)),  Ṗ = AP + PAᵀ + Q − P Cᵀ R⁻¹ C P,  K = P Cᵀ R⁻¹.
    """
    x, P = b.mean, b.cov
    A = jax.jacfwd(lambda xx: f(xx, u, t))(x)
    C = jax.jacfwd(lambda xx: h(xx, t))(x)
    K = solve_pd(R, C @ P).T
    xdot = f(x, u, t) + K @ (z - h(x, t))
    Pdot = A @ P + P @ A.T + Q - K @ C @ P
    return GaussianBelief(x + dt * xdot, symmetrize(P + dt * Pdot))


def hybrid_ekf_step(f, h, b, u, z, Q, R, dt, t=0.0, substeps: int = 1):
    """Hybrid continuous-predict / discrete-update EKF
    (ref: ctrl/ctrl_sys/hybrid_kalman_filter.hpp): RK4 on the mean, Lyapunov
    Euler substeps on the covariance, then a discrete update."""
    x, P = b.mean, b.cov
    h_dt = dt / substeps
    for _ in range(substeps):
        A = jax.jacfwd(lambda xx: f(xx, u, t))(x)
        k1 = f(x, u, t)
        k2 = f(x + 0.5 * h_dt * k1, u, t)
        k3 = f(x + 0.5 * h_dt * k2, u, t)
        k4 = f(x + h_dt * k3, u, t)
        x = x + h_dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        P = P + h_dt * (A @ P + P @ A.T + Q)
        t = t + h_dt
    return ekf_update(h, GaussianBelief(x, symmetrize(P)), z, R, t)


def filter_trajectory(step_fn, b0: GaussianBelief, us, zs, **kw):
    """Run a filter over measurement sequences with lax.scan; returns stacked
    beliefs (the batch_KF_on_meas_vector loop of estimate_satellite3D.cpp:406)."""

    def body(b, inputs):
        u, z = inputs
        b1 = step_fn(b, u, z, **kw)
        return b1, b1

    _, bs = jax.lax.scan(body, b0, (us, zs))
    return bs

"""Augmented-state and two-stage (TSOS) Kalman filters.

JAX-native equivalents of the reference's augmented filters
(ref: ctrl/ctrl_sys/tsos_aug_kalman_filter.hpp:1-12 two-stage online-steady
augmented KF, tsos_aug_inv_kalman_filter.hpp invariant variant,
augmented_sss_concept.hpp:100, augmented_to_state_mapping.hpp,
maximum_likelihood_mapping.hpp).

An augmented system carries quasi-constant parameter states ``a`` appended to
the dynamic state ``s`` (e.g. the airship's mass-eccentricity/drag states,
near_buoyant_airship_models.hpp:342).  Two filters are provided:

* :func:`aug_iekf_step` — plain joint filtering of ``[s, a]`` on the manifold
  (what the reference calls the augmented KF), via ctrl.invariant.
* :func:`tsos_step` — the two-stage decomposition: a state filter of size
  ``n_s`` plus a parameter filter of size ``n_a`` coupled through a blending
  matrix, equivalent to the joint filter when the parameter dynamics are
  constant (Friedland's two-stage form, which is what "two-stage
  online-steady" optimizes).  Cost drops from O((n_s+n_a)³) to
  O(n_s³ + n_a³ + n_s²n_a).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.ctrl.invariant import Retraction, iekf_step
from reak_tpu.math.linalg import solve_pd, symmetrize


def aug_iekf_step(F, h, ret: Retraction, b: GaussianBelief, u, z, Q, R,
                  t=0.0, diff=None) -> GaussianBelief:
    """Joint augmented filter: just the invariant EKF over [s, a]
    (ref: tsos_aug_kalman_filter.hpp aug filter-step semantics)."""
    return iekf_step(F, h, ret, b, u, z, Q, R, t=t, diff=diff)


def augmented_to_state(b: GaussianBelief, n_state: int) -> GaussianBelief:
    """Marginalize the parameter block away
    (ref: augmented_to_state_mapping.hpp)."""
    return GaussianBelief(b.mean[..., :n_state],
                          b.cov[..., :n_state, :n_state])


def maximum_likelihood_point(b: GaussianBelief):
    """Belief → most-likely state (ref: maximum_likelihood_mapping.hpp)."""
    return b.mean


class TSOSBelief(NamedTuple):
    """Two-stage factored belief: bias-free state filter (x̄, Px), parameter
    filter (a, Pa), and the coupling matrix U with  s = x̄ + U·a,
    P_joint = [[Px + U Pa Uᵀ, U Pa], [Pa Uᵀ, Pa]]."""

    x: jax.Array      # (n_s,) bias-free state estimate
    Px: jax.Array     # (n_s, n_s)
    a: jax.Array      # (n_a,) parameter estimate
    Pa: jax.Array     # (n_a, n_a)
    U: jax.Array      # (n_s, n_a) coupling


def tsos_init(s0, P0s, a0, P0a) -> TSOSBelief:
    n_s, n_a = s0.shape[-1], a0.shape[-1]
    return TSOSBelief(s0, P0s, a0, P0a,
                      jnp.zeros((n_s, n_a), s0.dtype))


def tsos_state(b: TSOSBelief):
    """Blended full-state estimate s = x̄ + U·a."""
    return b.x + b.U @ b.a


def tsos_step(F, h, b: TSOSBelief, u, z, Q, R, t=0.0) -> TSOSBelief:
    """One predict+update of the two-stage augmented filter
    (ref: tsos_aug_kalman_filter.hpp:1-12 — the reference's TSOS filter keeps
    the parameter block at a steady gain; here both stages run exactly, with
    the two-stage U-V decoupling).

    System model:  s' = F(s, a, u, t),  a' = a (random walk, noise
    Qa = Q[n_s:, n_s:]),  z = h(s, a, t).  Jacobians come from AD around the
    blended estimate, so parameters may enter nonlinearly.

    The decomposition is the *exact* two-stage form (Keller's U-V transform):
    equal to the joint augmented KF to machine precision on linear systems
    (verified in tests/test_ss_systems.py::TestTSOS), including the
    predict-stage coupling correction U' = Ū·Pa·(Pa+Qa)⁻¹ needed when the
    parameter random-walk noise is non-zero.
    """
    n_s = b.x.shape[-1]
    n_a = b.a.shape[-1]
    s_blend = tsos_state(b)
    xa = jnp.concatenate([s_blend, b.a])

    # Jacobians of the augmented dynamics around the blended estimate
    Fj = jax.jacfwd(lambda v: F(v[:n_s], v[n_s:], u, t))(xa)
    A, Ba = Fj[:, :n_s], Fj[:, n_s:]
    s_pred_full = F(s_blend, b.a, u, t)

    # --- two-stage predict ------------------------------------------------
    Qs, Qa = Q[:n_s, :n_s], Q[n_s:, n_s:]
    a_pred = b.a
    Pa_pred = b.Pa + Qa
    Ubar = A @ b.U + Ba
    # coupling correction for Qa > 0: U' = Ū·Pa·Pa_pred⁻¹
    Up = solve_pd(Pa_pred, (Ubar @ b.Pa).T).T
    UbarPa = Ubar @ b.Pa
    Px_pred = symmetrize(A @ b.Px @ A.T + Qs
                         + UbarPa @ Ubar.T - Up @ Pa_pred @ Up.T)
    # bias-free predicted state: s_pred = x' + U'·a
    x_pred = s_pred_full - Up @ a_pred

    # --- two-stage update ---------------------------------------------------
    s_pred = s_pred_full
    hj = jax.jacfwd(lambda v: h(v[:n_s], v[n_s:], t))(
        jnp.concatenate([s_pred, a_pred]))
    C, Da = hj[:, :n_s], hj[:, n_s:]
    y = z - h(s_pred, a_pred, t)          # blended innovation

    Sx = C @ Px_pred @ C.T + R            # bias-free innovation covariance
    Kx = solve_pd(Sx, C @ Px_pred).T
    Ha = C @ Up + Da                      # bias sensitivity of the output
    Sa = Ha @ Pa_pred @ Ha.T + Sx         # = the joint filter's S
    Ka = solve_pd(Sa, Ha @ Pa_pred).T

    a_new = a_pred + Ka @ y
    Pa_new = symmetrize((jnp.eye(n_a, dtype=Pa_pred.dtype) - Ka @ Ha) @ Pa_pred)
    # bias-free filter uses its own residual  z − h(x', ·) = y + Ha·a (linear)
    x_new = x_pred + Kx @ (y + Ha @ a_pred)
    Px_new = symmetrize((jnp.eye(n_s, dtype=Px_pred.dtype) - Kx @ C) @ Px_pred)
    U_new = Up - Kx @ Ha
    return TSOSBelief(x_new, Px_new, a_new, Pa_new, U_new)


def tsos_joint_belief(b: TSOSBelief) -> GaussianBelief:
    """Reassemble the joint augmented belief from the two-stage factors."""
    Pxa = b.U @ b.Pa
    top = jnp.concatenate([b.Px + Pxa @ b.U.T, Pxa], axis=-1)
    bot = jnp.concatenate([Pxa.T, b.Pa], axis=-1)
    return GaussianBelief(jnp.concatenate([tsos_state(b), b.a]),
                          jnp.concatenate([top, bot], axis=-2))

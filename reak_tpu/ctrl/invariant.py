"""Invariant / manifold (multiplicative) EKF.

JAX-native re-design of the reference's invariant Kalman filters
(ref: ctrl/ctrl_sys/invariant_kalman_filter.hpp:278 invariant_kalman_filter_step,
invariant_system_concept.hpp:209, invariant_kalman_bucy_filter.hpp).

The reference expresses each invariant system by hand (invariant error, frame
transitions W, invariant output).  Here the manifold structure is captured by a
retraction pair and the error-state Jacobians are obtained by AD *through the
retraction*:

    A = ∂/∂e  local(F(retract(x, e), u),  F(x, u)) |_{e=0}
    C = ∂/∂e  h(retract(x, e))                     |_{e=0}

which reproduces the invariant linearization for group-affine systems without
per-model derivation.  ``SE3Retraction`` covers the satellite/airship family
(quaternion attitude states).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.math import rotations as rot
from reak_tpu.math.linalg import solve_pd, symmetrize


class Retraction(NamedTuple):
    """Manifold chart: ``retract(x, e)`` perturbs state x by tangent e;
    ``local(x1, x0)`` is its inverse: the tangent taking x0 to x1.
    ``dim``: tangent dimension (may differ from ambient state dim)."""

    retract: Callable
    local: Callable
    dim: int


def vector_retraction(n: int) -> Retraction:
    return Retraction(retract=lambda x, e: x + e, local=lambda a, b: a - b, dim=n)


def quat_state_retraction(quat_index: int, n_state: int, n_tangent: int) -> Retraction:
    """Retraction for states embedding one unit quaternion at
    ``x[quat_index:quat_index+4]``; tangent uses a 3-vector rotation error
    (right-multiplicative, body frame — the reference's invariant error frame,
    ref: satellite_invar_models.hpp:296 satellite3D_imdt_sys error state)."""
    qi = quat_index

    def retract(x, e):
        # split tangent: [pre (maps to x[:qi]), δθ (3,), post]
        pre = e[:qi]
        dth = e[qi : qi + 3]
        post = e[qi + 3 :]
        q = x[qi : qi + 4]
        q_new = rot.qmul(q, rot.q_exp(dth))
        return jnp.concatenate([x[:qi] + pre, q_new, x[qi + 4 :] + post])

    def local(x1, x0):
        q1 = x1[qi : qi + 4]
        q0 = x0[qi : qi + 4]
        dth = rot.q_log(rot.qmul(rot.qconj(q0), q1))
        return jnp.concatenate([x1[:qi] - x0[:qi], dth, x1[qi + 4 :] - x0[qi + 4 :]])

    return Retraction(retract=retract, local=local, dim=n_tangent)


def iekf_predict(F: Callable, ret: Retraction, b: GaussianBelief, u, Q, t=0.0):
    """Invariant/multiplicative EKF predict: mean by full nonlinear propagation,
    covariance in the tangent space (ref: invariant_kalman_filter.hpp predict)."""
    x1 = F(b.mean, u, t)
    zero = jnp.zeros(ret.dim, b.mean.dtype)
    A = jax.jacfwd(lambda e: ret.local(F(ret.retract(b.mean, e), u, t), x1))(zero)
    P1 = A @ b.cov @ A.T + Q
    return GaussianBelief(x1, symmetrize(P1))


def iekf_update(h: Callable, ret: Retraction, b: GaussianBelief, z, R, t=0.0,
                diff=None):
    """Invariant update with manifold mean correction
    (ref: invariant_kalman_filter.hpp:278 update; mean via state_space.adjust)."""
    zero = jnp.zeros(ret.dim, b.mean.dtype)
    z_hat = h(b.mean, t)
    if diff is None:
        C = jax.jacfwd(lambda e: h(ret.retract(b.mean, e), t))(zero)
        y = z - z_hat
    else:
        # manifold-valued outputs (e.g. quaternion pose): linearize the
        # innovation itself, y(e) = diff(z, h(retract(x, e))) ≈ y0 − C·e,
        # so C rows live in innovation space (the reference's invariant
        # output error, invariant_system_concept.hpp get_invariant_error)
        C = -jax.jacfwd(lambda e: diff(z, h(ret.retract(b.mean, e), t)))(zero)
        y = diff(z, z_hat)
    S = C @ b.cov @ C.T + R
    K = solve_pd(S, C @ b.cov).T
    x1 = ret.retract(b.mean, K @ y)
    n = ret.dim
    IKC = jnp.eye(n, dtype=b.cov.dtype) - K @ C
    P1 = IKC @ b.cov @ IKC.T + K @ R @ K.T
    return GaussianBelief(x1, symmetrize(P1))


def iekf_step(F, h, ret, b, u, z, Q, R, t=0.0, diff=None):
    """(ref: invariant_kalman_filter.hpp invariant_kalman_filter_step)"""
    return iekf_update(h, ret, iekf_predict(F, ret, b, u, Q, t), z, R, t, diff)


# ---------------------------------------------------------------------------
# Symplectic / aggregate covariance propagation
# (ref: ctrl/ctrl_sys/aggregate_kalman_filter.hpp:278,
#  symplectic_kalman_filter.hpp:285, mat_star_product.hpp)
# ---------------------------------------------------------------------------


class HamiltonianMap(NamedTuple):
    """Blocks ((T11, T12), (T21, T22)) of the symplectic covariance flow."""

    blocks: tuple


def hamiltonian_predict_map(A, Q) -> HamiltonianMap:
    """Prediction as a Hamiltonian map: P⁺ = (T21 + T22 P)(T11 + T12 P)⁻¹ with
    T = [[A⁻ᵀ, 0], [Q A⁻ᵀ, A]] (ref: aggregate_kalman_filter.hpp:278)."""
    Ait = jnp.linalg.inv(A).T
    z = jnp.zeros_like(A)
    return HamiltonianMap(((Ait, z), (Q @ Ait, A)))


def hamiltonian_update_map(C, R) -> HamiltonianMap:
    """Update as a Hamiltonian map: T = [[I, CᵀR⁻¹C], [0, I]]."""
    n = C.shape[-1]
    eye = jnp.eye(n, dtype=C.dtype)
    z = jnp.zeros_like(eye)
    CtRC = C.T @ solve_pd(R, C)
    return HamiltonianMap(((eye, CtRC), (z, eye)))


def apply_hamiltonian(T: HamiltonianMap, P):
    """Propagate covariance through a Hamiltonian map."""
    (T11, T12), (T21, T22) = T.blocks
    num = T21 + T22 @ P
    den = T11 + T12 @ P
    return symmetrize(num @ jnp.linalg.inv(den))


def compose_hamiltonian(T2: HamiltonianMap, T1: HamiltonianMap) -> HamiltonianMap:
    """Aggregate two covariance flows (T2 ∘ T1) — the reference aggregates
    these to transport covariances along whole trajectories in one map
    (ref: aggregate_kalman_filter.hpp; product of 2n×2n block matrices)."""
    (A11, A12), (A21, A22) = T2.blocks
    (B11, B12), (B21, B22) = T1.blocks
    return HamiltonianMap(
        (
            (A11 @ B11 + A12 @ B21, A11 @ B12 + A12 @ B22),
            (A21 @ B11 + A22 @ B21, A21 @ B12 + A22 @ B22),
        )
    )

"""Lanes-layout (batch-last) quaternion/rotation kernels.

Same math as reak_tpu.math.rotations (ref: core/kinetostatics/rotations_3D.hpp,
quat_alg.hpp) with the component axis at position -2 and the scenario batch on
the LAST axis — the (k, B) register layout of the batched hot paths
(kte/lanes.py, ctrl/riccati_soa.py): every op is an elementwise op over the
whole contiguous batch instead of over a 3/4-wide trailing axis.

All functions accept (..., k, B) with k ∈ {3, 4} and broadcast leading axes.
AD-safe at the identity (q_exp/q_log series guards mirror math/rotations.py).
"""
from __future__ import annotations

import jax.numpy as jnp


def cross_l(a, b):
    """Cross product over axis -2 (size 3)."""
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-2
    )


def qmul_l(a, b):
    """Hamilton product, components on axis -2: (..., 4, B)."""
    w1, x1, y1, z1 = a[..., 0, :], a[..., 1, :], a[..., 2, :], a[..., 3, :]
    w2, x2, y2, z2 = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-2,
    )


def qconj_l(q):
    return jnp.concatenate([q[..., 0:1, :], -q[..., 1:4, :]], axis=-2)


def qnormalize_l(q):
    n = jnp.sqrt(jnp.sum(q * q, axis=-2, keepdims=True))
    return q / n


def qrot_l(q, v):
    """Rotate v by q (frame → parent): t = 2 q_v × v; v + w t + q_v × t."""
    w = q[..., 0:1, :]
    qv = q[..., 1:4, :]
    t = 2.0 * cross_l(qv, v)
    return v + w * t + cross_l(qv, t)


def qrot_inv_l(q, v):
    """Rotate v by q⁻¹ (parent → frame)."""
    w = q[..., 0:1, :]
    qv = q[..., 1:4, :]
    t = 2.0 * cross_l(qv, v)
    return v - w * t + cross_l(qv, t)


def q_exp_l(v):
    """Rotation vector (..., 3, B) → quaternion (..., 4, B); AD-safe at 0."""
    n2 = jnp.sum(v * v, axis=-2, keepdims=True)
    safe = n2 > 1e-16
    angle = jnp.sqrt(jnp.where(safe, n2, 1.0))
    half = 0.5 * angle
    k = jnp.where(safe, jnp.sin(half) / angle, 0.5 - n2 / 48.0)
    w = jnp.where(safe, jnp.cos(half), 1.0 - n2 / 8.0)
    return jnp.concatenate([w, k * v], axis=-2)


def q_log_l(q):
    """Quaternion (..., 4, B) → rotation vector (..., 3, B); AD-safe at id."""
    w = q[..., 0:1, :]
    qv = q[..., 1:4, :]
    n2 = jnp.sum(qv * qv, axis=-2, keepdims=True)
    safe = n2 > 1e-16
    n = jnp.sqrt(jnp.where(safe, n2, 1.0))
    scale = jnp.where(
        safe, 2.0 * jnp.arctan2(n, w) / n, 2.0 / w * (1.0 - n2 / (3.0 * w * w))
    )
    return scale * qv


def q_to_matrix_l(q):
    """Unit quaternion (..., 4, B) → rotation matrix (..., 3, 3, B)."""
    w, x, y, z = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-2)
    row1 = jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-2)
    row2 = jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-2)
    return jnp.stack([row0, row1, row2], axis=-3)


def skew_l(v):
    """(..., 3, B) → (..., 3, 3, B) cross-product matrix [v]×."""
    zero = jnp.zeros_like(v[..., 0, :])
    vx, vy, vz = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    row0 = jnp.stack([zero, -vz, vy], axis=-2)
    row1 = jnp.stack([vz, zero, -vx], axis=-2)
    row2 = jnp.stack([-vy, vx, zero], axis=-2)
    return jnp.stack([row0, row1, row2], axis=-3)


def qdot_from_omega_l(q, w_body):
    """Q̇ = ½ Q ⊗ (0, ω_body), lanes layout: q (..., 4, B), w (..., 3, B)."""
    zw = jnp.concatenate([jnp.zeros_like(w_body[..., 0:1, :]), w_body],
                         axis=-2)
    return 0.5 * qmul_l(q, zw)

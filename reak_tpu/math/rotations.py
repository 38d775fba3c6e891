"""Rotations: 2D angles, 3D quaternions, rotation matrices, axis-angle, Euler TB.

JAX-native re-design of the reference's rotation classes
(ref: core/kinetostatics/rotations_2D.hpp, rotations_3D.hpp:73,552, quat_alg.hpp:49).
Instead of class hierarchies, rotations are plain arrays with conventions:

- 2D rotation        : scalar angle ``theta`` (radians)
- 3D quaternion      : shape ``(..., 4)`` array ``[w, x, y, z]``, unit norm
- rotation matrix    : shape ``(..., 3, 3)``, acts on column vectors (R @ v)
- axis-angle         : ``(axis (...,3), angle (...))``
- Euler angles (TB)  : Tait-Bryan body-fixed Z-Y'-X'' yaw/pitch/roll, matching the
                       reference's ``euler_angles_TB`` (rotations_3D.hpp).

All functions broadcast over arbitrary leading batch axes and preserve input dtype.
Frame composition convention: ``qmul(q_parent_to_world, q_child_to_parent)`` gives
child-to-world, matching ReaK's ``Q_end = Q_base * Q_joint``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# 2D rotations (scalar angle)
# ---------------------------------------------------------------------------


def rot2d(theta):
    """2x2 rotation matrix from angle (ref: rotations_2D.hpp rot_mat_2D)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def rot2d_apply(theta, v):
    """Rotate 2D vector(s) v by angle theta."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    x, y = v[..., 0], v[..., 1]
    return jnp.stack([c * x - s * y, s * x + c * y], axis=-1)


# ---------------------------------------------------------------------------
# Quaternions [w, x, y, z]
# ---------------------------------------------------------------------------


def qidentity(dtype=jnp.float32, batch_shape=()):
    q = jnp.zeros(batch_shape + (4,), dtype=dtype)
    return q.at[..., 0].set(1.0)


def qmul(q1, q2):
    """Hamilton product q1 ⊗ q2 (composition: parent * child, ref quat_alg.hpp)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def qconj(q):
    """Conjugate = inverse for unit quaternions (ref: rotations_3D.hpp invert)."""
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qnormalize(q, eps=0.0):
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, jnp.asarray(eps, q.dtype)) if eps else q / n


def qrot(q, v):
    """Rotate vector v from the frame of q into its parent: R(q) @ v.

    Uses the 15-multiply form t = 2 q_v × v; v' = v + w t + q_v × t.
    """
    w = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def qrot_inv(q, v):
    """Rotate v from parent coords into the frame of q: R(q)^T @ v."""
    w = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * jnp.cross(qv, v)
    return v - w * t + jnp.cross(qv, t)


def q_to_matrix(q):
    """Unit quaternion → rotation matrix (ref: rotations_3D.hpp getRotMat)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1)
    row1 = jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1)
    row2 = jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def q_from_matrix(R):
    """Rotation matrix → unit quaternion, branch-free Shepperd via max-trace select."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick numerically-best by largest pivot.
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-30)) / 2.0
    q0 = jnp.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        axis=-1,
    )
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-30)) / 2.0
    q1 = jnp.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        axis=-1,
    )
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-30)) / 2.0
    q2 = jnp.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        axis=-1,
    )
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-30)) / 2.0
    q3 = jnp.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        axis=-1,
    )
    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], axis=-1)
    idx = jnp.argmax(pivots, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4cand, 4)
    q = jnp.take_along_axis(qs, idx[..., None, None], axis=-2)[..., 0, :]
    # canonical sign: w >= 0
    return q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)


def q_from_axis_angle(axis, angle):
    """Axis-angle → quaternion (ref: rotations_3D.hpp axis_angle::getQuaternion)."""
    half = 0.5 * jnp.asarray(angle)
    s = jnp.sin(half)
    return jnp.concatenate(
        [jnp.cos(half)[..., None], s[..., None] * axis], axis=-1
    )


def q_to_axis_angle(q):
    """Quaternion → (axis, angle); axis defaults to +x for identity."""
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    qv = q[..., 1:4]
    n = jnp.linalg.norm(qv, axis=-1)
    angle = 2.0 * jnp.arctan2(n, w)
    safe = n > 1e-12
    axis = jnp.where(
        safe[..., None],
        qv / jnp.maximum(n, 1e-30)[..., None],
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], q.dtype), qv.shape),
    )
    return axis, angle


def q_exp(v):
    """Exponential map from rotation vector (..., 3) to quaternion.

    AD-safe at v = 0 (double-where guards the norm so jvp/grad are finite).
    """
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    safe = n2 > 1e-16
    angle = jnp.sqrt(jnp.where(safe, n2, 1.0))
    half = 0.5 * angle
    # sinc(half)/2: series 0.5 − n²/48 near zero
    k = jnp.where(safe, jnp.sin(half) / angle, 0.5 - n2 / 48.0)
    w = jnp.where(safe, jnp.cos(half), 1.0 - n2 / 8.0)
    return jnp.concatenate([w, k * v], axis=-1)


def q_log(q):
    """Log map: quaternion → rotation vector (..., 3).  AD-safe at identity."""
    w = q[..., 0:1]
    qv = q[..., 1:4]
    n2 = jnp.sum(qv * qv, axis=-1, keepdims=True)
    safe = n2 > 1e-16
    n = jnp.sqrt(jnp.where(safe, n2, 1.0))
    # scale = 2·atan2(n, w)/n; series for small n: 2/w·(1 − n²/(3w²))
    scale = jnp.where(
        safe, 2.0 * jnp.arctan2(n, w) / n, 2.0 / w * (1.0 - n2 / (3.0 * w * w))
    )
    return scale * qv


def qslerp(q0, q1, t):
    """Spherical linear interpolation with shortest-arc sign fix."""
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    # fall back to lerp for nearly parallel quaternions
    theta = jnp.arccos(jnp.clip(dot, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    near = sin_theta < 1e-6
    w0 = jnp.where(near, 1.0 - t, jnp.sin((1.0 - t) * theta) / jnp.where(near, 1.0, sin_theta))
    w1 = jnp.where(near, t, jnp.sin(t * theta) / jnp.where(near, 1.0, sin_theta))
    return qnormalize(w0 * q0 + w1 * q1)


def qdot_from_omega(q, omega_body):
    """Quaternion rate from body-frame angular velocity.

    Q̇ = ½ Q ⊗ (0, ω_body) — matches the reference frame_3D ``UpdateQuatDot``
    (ref: core/kinetostatics/frame_3D.hpp QuatDot member docs).
    """
    zero = jnp.zeros_like(omega_body[..., :1])
    return 0.5 * qmul(q, jnp.concatenate([zero, omega_body], axis=-1))


def omega_from_qdot(q, qdot):
    """Body angular velocity from quaternion rate: ω = 2 (Q* ⊗ Q̇)_vec."""
    return 2.0 * qmul(qconj(q), qdot)[..., 1:4]


# ---------------------------------------------------------------------------
# Euler angles, Tait-Bryan ZYX (yaw-pitch-roll), body-fixed
# ---------------------------------------------------------------------------


def q_from_euler_tb(yaw, pitch, roll):
    """Tait-Bryan Z-Y'-X'' → quaternion (ref: rotations_3D.hpp euler_angles_TB)."""
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    return jnp.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        axis=-1,
    )


def q_to_euler_tb(q):
    """Quaternion → (yaw, pitch, roll), Tait-Bryan ZYX."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    sinp = jnp.clip(2 * (w * y - z * x), -1.0, 1.0)
    pitch = jnp.arcsin(sinp)
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    return yaw, pitch, roll


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def hat(v):
    """Skew-symmetric cross-product matrix [v]× (..., 3) → (..., 3, 3)."""
    zero = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zero, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zero], axis=-1),
        ],
        axis=-2,
    )


def vee(M):
    """Inverse of hat: (..., 3, 3) skew matrix → (..., 3)."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)

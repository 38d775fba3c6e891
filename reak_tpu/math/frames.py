"""Kinematic poses and frames as pytrees, with ReaK-compatible conventions.

JAX-native re-design of the reference's chained-pointer frame classes
(ref: core/kinetostatics/pose_3D.hpp, frame_3D.hpp:50-76, gen_coord.hpp:45).
Instead of parent-pointer chains mutated by sweeps, frames are immutable pytree
values; composition is explicit (``compose``), and "global frame" resolution is
just a fold over a chain of relative frames.

Conventions (identical to the reference, frame_3D.hpp:40-48):
- ``pos``   position of the frame origin, expressed in PARENT coordinates
- ``quat``  orientation quaternion [w,x,y,z], local→parent rotation
- ``vel``   linear velocity relative-to and expressed-in PARENT coordinates
- ``omega`` angular velocity relative to parent, expressed in LOCAL (body) coords
- ``acc``   linear acceleration, PARENT coordinates
- ``alpha`` angular acceleration, LOCAL coordinates
- ``force``/``torque`` flowing through the frame, LOCAL coordinates

All fields broadcast over leading batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.math import rotations as rot


class Pose3(NamedTuple):
    """Static pose: position (PARENT coords) + quaternion (local→parent)."""

    pos: jax.Array  # (..., 3)
    quat: jax.Array  # (..., 4) [w,x,y,z]

    @staticmethod
    def identity(dtype=jnp.float32, batch_shape=()):
        return Pose3(
            pos=jnp.zeros(batch_shape + (3,), dtype),
            quat=rot.qidentity(dtype, batch_shape),
        )

    def rotate_to_parent(self, v):
        """Local vector → parent coords (ref: pose_3D.hpp:147 rotateToParent)."""
        return rot.qrot(self.quat, v)

    def rotate_from_parent(self, v):
        return rot.qrot_inv(self.quat, v)

    def transform_to_parent(self, p):
        """Local point → parent coords."""
        return self.pos + rot.qrot(self.quat, p)

    def transform_from_parent(self, p):
        return rot.qrot_inv(self.quat, p - self.pos)

    def compose(self, child: "Pose3") -> "Pose3":
        """this ∘ child: pose of ``child`` (expressed rel. to this) in this's parent.

        Matches ReaK ``pose_3D::operator*`` / ``addBefore`` (pose_3D.hpp:206).
        """
        return Pose3(
            pos=self.pos + rot.qrot(self.quat, child.pos),
            quat=rot.qmul(self.quat, child.quat),
        )

    def inverse(self) -> "Pose3":
        qi = rot.qconj(self.quat)
        return Pose3(pos=-rot.qrot(qi, self.pos), quat=qi)


class Frame3(NamedTuple):
    """Kinematic frame: pose + velocity + acceleration (ReaK frame_3D semantics)."""

    pos: jax.Array  # (..., 3) parent coords
    quat: jax.Array  # (..., 4) local→parent
    vel: jax.Array  # (..., 3) parent coords
    omega: jax.Array  # (..., 3) LOCAL coords
    acc: jax.Array  # (..., 3) parent coords
    alpha: jax.Array  # (..., 3) LOCAL coords

    @staticmethod
    def identity(dtype=jnp.float32, batch_shape=()):
        z = jnp.zeros(batch_shape + (3,), dtype)
        return Frame3(z, rot.qidentity(dtype, batch_shape), z, z, z, z)

    @property
    def pose(self) -> Pose3:
        return Pose3(self.pos, self.quat)

    def compose(self, child: "Frame3") -> "Frame3":
        """Kinematic composition: ``child`` expressed relative to this frame →
        the same frame expressed relative to this frame's parent.

        Implements the rotating-frame formulae of ReaK ``frame_3D::add_before``
        / ``getGlobalFrame`` (frame_3D.hpp:50; used by inertia.cpp:111-121):
          p   = p1 + R1 p2
          v   = v1 + R1 v2 + (R1 ω1×p2)           (ω1 local → rotate cross to parent)
          a   = a1 + R1 a2 + R1(α1×p2) + R1(ω1×(ω1×p2)) + 2 R1(ω1×v2)
          ω   = R2ᵀ ω1 + ω2
          α   = R2ᵀ α1 + R2ᵀ(ω1×?)… — angular terms compose in local coords:
          α   = R2ᵀ α1 + ω_rel-coupling + α2 with coupling R2ᵀ(ω1) × ω2
        """
        q1, q2 = self.quat, child.quat
        # Rotate child linear quantities into this frame's parent coords.
        p2_in1 = rot.qrot(q1, child.pos)
        v2_in1 = rot.qrot(q1, child.vel)
        a2_in1 = rot.qrot(q1, child.acc)
        # ω1/α1 are local to frame1; cross products with child pos are done in
        # frame1 coords then rotated out.
        w1xp2 = jnp.cross(self.omega, child.pos)
        pos = self.pos + p2_in1
        vel = self.vel + v2_in1 + rot.qrot(q1, w1xp2)
        acc = (
            self.acc
            + a2_in1
            + rot.qrot(
                q1,
                jnp.cross(self.alpha, child.pos)
                + jnp.cross(self.omega, w1xp2)
                + 2.0 * jnp.cross(self.omega, child.vel),
            )
        )
        # Angular: express in child-local coords.
        w1_in2 = rot.qrot_inv(q2, self.omega)
        omega = w1_in2 + child.omega
        alpha = rot.qrot_inv(q2, self.alpha) + jnp.cross(w1_in2, child.omega) + child.alpha
        return Frame3(pos, rot.qmul(q1, q2), vel, omega, acc, alpha)

    @property
    def quat_dot(self):
        """Quaternion time-derivative (ref: frame_3D.hpp QuatDot/UpdateQuatDot)."""
        return rot.qdot_from_omega(self.quat, self.omega)


class Frame2(NamedTuple):
    """2D kinematic frame (ReaK frame_2D semantics; ref: frame_2D.hpp)."""

    pos: jax.Array  # (..., 2) parent coords
    angle: jax.Array  # (...)
    vel: jax.Array  # (..., 2) parent coords
    omega: jax.Array  # (...)
    acc: jax.Array  # (..., 2) parent coords
    alpha: jax.Array  # (...)

    @staticmethod
    def identity(dtype=jnp.float32, batch_shape=()):
        z2 = jnp.zeros(batch_shape + (2,), dtype)
        z = jnp.zeros(batch_shape, dtype)
        return Frame2(z2, z, z2, z, z2, z)

    def compose(self, child: "Frame2") -> "Frame2":
        th = self.angle
        p2_in1 = rot.rot2d_apply(th, child.pos)
        v2_in1 = rot.rot2d_apply(th, child.vel)
        a2_in1 = rot.rot2d_apply(th, child.acc)

        def perp(v):  # ω × p in 2D: ω ẑ × (x, y) = ω(-y, x)
            return jnp.stack([-v[..., 1], v[..., 0]], axis=-1)

        w1xp2 = self.omega[..., None] * perp(child.pos)
        pos = self.pos + p2_in1
        vel = self.vel + v2_in1 + rot.rot2d_apply(th, w1xp2)
        acc = (
            self.acc
            + a2_in1
            + rot.rot2d_apply(
                th,
                self.alpha[..., None] * perp(child.pos)
                + self.omega[..., None] * perp(w1xp2)
                + 2.0 * self.omega[..., None] * perp(child.vel),
            )
        )
        return Frame2(
            pos,
            self.angle + child.angle,
            vel,
            self.omega + child.omega,
            acc,
            self.alpha + child.alpha,
        )


class GenCoord(NamedTuple):
    """Generalized coordinate {q, q_dot, q_ddot} (ref: gen_coord.hpp:45)."""

    q: jax.Array
    qd: jax.Array
    qdd: jax.Array

    @staticmethod
    def zero(dtype=jnp.float32, batch_shape=()):
        z = jnp.zeros(batch_shape, dtype)
        return GenCoord(z, z, z)

"""Task-space and virtual-model-control forces on KTE chains.

JAX-native equivalents of the reference's force-application elements
(ref: ctrl/mbd_kte/force_actuator.hpp:55 force_actuator, vmc_revolute_joint.hpp
:58 virtual-model-control joints, virtual_kte_interface.hpp:49,
line_point_mindist.hpp:51, plane_point_mindist.hpp:49 geometric constraint
elements).  In the functional design these are not chain elements but pure
functions mapping world-space forces to generalized joint forces through the
point Jacobian — add their outputs to ``tau`` before forward_dynamics.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from reak_tpu.kte.spec import ChainSpec, JointType, REVOLUTE, PRISMATIC
from reak_tpu.kte import dynamics
from reak_tpu.math import rotations as rot


def point_kinematics(spec: ChainSpec, q, body: int, point_local):
    """World position of a body-fixed point and its (3, nv) Jacobian."""
    r = dynamics.fk(spec, q)
    p = r.body_pos[body] + rot.qrot(r.body_quat[body], point_local)
    cols = []
    zeros3 = jnp.zeros(3, q.dtype)
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        reach = i <= body
        if jt == REVOLUTE:
            col = jnp.cross(r.joint_axis[i], p - r.joint_anchor[i])
        elif jt == PRISMATIC:
            col = r.joint_axis[i]
        else:
            continue
        cols.append(jnp.where(reach, col, zeros3))
    return p, jnp.stack(cols, axis=-1)


def point_velocity(spec: ChainSpec, q, qd, body: int, point_local):
    _, J = point_kinematics(spec, q, body, point_local)
    return J @ qd


def world_force_to_tau(spec: ChainSpec, q, body: int, point_local, f_world):
    """Generalized force of a world-frame force applied at a body point:
    τ = Jᵀ f  (ref: force_actuator_3D doForce accumulation)."""
    _, J = point_kinematics(spec, q, body, point_local)
    return J.T @ f_world


def virtual_spring_damper(spec: ChainSpec, q, qd, body: int, point_local,
                          target_world, k: float, d: float = 0.0):
    """Virtual-model control: spring(+damper) pulling a body point toward a
    world target (ref: vmc_revolute_joint.hpp:58, virtual_kte_interface.hpp:49
    — virtual elements acting through the real chain's Jacobian)."""
    p, J = point_kinematics(spec, q, body, point_local)
    f = k * (jnp.asarray(target_world, q.dtype) - p)
    if d:
        f = f - d * (J @ qd)
    return J.T @ f


def line_point_mindist_force(spec: ChainSpec, q, body: int, point_local,
                             line_origin, line_dir, k: float):
    """Restoring force pulling a body point onto a world line
    (ref: line_point_mindist.hpp:51,164)."""
    p, J = point_kinematics(spec, q, body, point_local)
    o = jnp.asarray(line_origin, q.dtype)
    u = jnp.asarray(line_dir, q.dtype)
    u = u / jnp.linalg.norm(u)
    w = p - o
    closest = o + jnp.dot(w, u) * u
    return J.T @ (k * (closest - p))


def plane_point_mindist_force(spec: ChainSpec, q, body: int, point_local,
                              plane_normal, plane_offset, k: float):
    """Restoring force pulling a body point onto the plane n·x = d
    (ref: plane_point_mindist.hpp:49)."""
    p, J = point_kinematics(spec, q, body, point_local)
    n = jnp.asarray(plane_normal, q.dtype)
    n = n / jnp.linalg.norm(n)
    dist = jnp.dot(p, n) - jnp.asarray(plane_offset, q.dtype)
    return J.T @ (-k * dist * n)

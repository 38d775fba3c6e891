"""Concrete vehicle state-space systems: satellite, airship, quadrotor.

JAX-native re-design of the reference's ctrl/ss_systems layer
(ref: ss_systems/satellite_basic_models.hpp:70 satellite3D_lin_dt_system,
satellite_invar_models.hpp:296,406,514 invariant mid-point + gyro/IMU variants,
near_buoyant_airship_models.hpp:72,342,617,739 augmented-parameter airships,
quadrotor_system.hpp:51, airship mixins assembled in
airship_assembled_models.hpp:56-151).

Design: each vehicle is a pytree of parameters plus *pure functions*
``f(x, u, t) → ẋ`` (continuous) and ``F(x, u, t) → x'`` (discrete-time,
invariant mid-point on SE(3)), vmappable over scenario batches and usable
directly by the EKF/IEKF/UKF stack (ctrl.kalman / ctrl.invariant) and the MPC
layer.  Mixin composition in the reference (state_space_system_tuple.hpp:1087)
becomes plain function composition over the shared rigid-body core.

State layout (matches the reference's frame conventions, frame_3D.hpp:40-45 —
linear quantities in global coords, angular quantities in body coords):

    x = [p (3, global) | q (4, unit quaternion body→global)
         | v (3, global) | w (3, body)]            (13,)

followed by any augmented parameter states (airships).  Inputs are body-frame
force + torque ``u = [f_body (3) | tau_body (3)]`` unless noted.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp

from reak_tpu.math import rotations as rot
from reak_tpu.ctrl.invariant import Retraction, quat_state_retraction

# ---------------------------------------------------------------------------
# shared rigid-body core
# ---------------------------------------------------------------------------


def split_state(x):
    """x → (p, q, v, w[, aug])."""
    p, q, v, w = x[..., 0:3], x[..., 3:7], x[..., 7:10], x[..., 10:13]
    aug = x[..., 13:]
    return p, q, v, w, aug


def join_state(p, q, v, w, aug=None):
    parts = [p, q, v, w]
    if aug is not None and aug.shape[-1]:
        parts.append(aug)
    return jnp.concatenate(parts, axis=-1)


def _rigid_rate(q, v, w, acc_global, ang_acc_body, aug_rate=None):
    """Pack ẋ given global linear acceleration and body angular acceleration."""
    qd = rot.qdot_from_omega(q, w)
    parts = [v, qd, acc_global, ang_acc_body]
    if aug_rate is not None and aug_rate.shape[-1]:
        parts.append(aug_rate)
    return jnp.concatenate(parts, axis=-1)


def sat3D_retraction(n_aug: int = 0) -> Retraction:
    """Invariant-error retraction for the 13(+n_aug)-state rigid body:
    tangent = [δp, δθ (3), δv, δw, δaug] — the reference's invariant error
    frame (ref: satellite_invar_models.hpp:296)."""
    return quat_state_retraction(3, 13 + n_aug, 12 + n_aug)


# ---------------------------------------------------------------------------
# satellite (ref: satellite_basic_models.hpp:70, satellite_invar_models.hpp)
# ---------------------------------------------------------------------------


class SatelliteParams(NamedTuple):
    mass: jnp.ndarray          # scalar
    inertia: jnp.ndarray       # (3, 3) body-frame inertia tensor


def satellite3D(mass=1.0, inertia=None) -> SatelliteParams:
    inertia = jnp.eye(3) if inertia is None else jnp.asarray(inertia, jnp.result_type(float))
    return SatelliteParams(jnp.asarray(mass, jnp.result_type(float)), inertia)


def satellite3D_cont(params: SatelliteParams) -> Callable:
    """Continuous dynamics of a free rigid body with body-frame thrusters:
    v̇ = R(q)·f/m,  J·ẇ = τ − w × Jw  (Euler's equations)."""
    J = params.inertia
    Jinv = jnp.linalg.inv(J)

    def f(x, u, t=0.0):
        _, q, v, w, _ = split_state(x)
        fb, tb = u[..., 0:3], u[..., 3:6]
        acc = rot.qrot(q, fb) / params.mass
        wd = (tb - jnp.cross(w, w @ J.T)) @ Jinv.T
        return _rigid_rate(q, v, w, acc, wd)

    return f


def satellite3D_imdt(params: SatelliteParams, dt: float) -> Callable:
    """Discrete-time invariant mid-point step on SE(3)
    (ref: satellite_invar_models.hpp:296 satellite3D_imdt_sys).

    The attitude advances along the Lie-group exponential of the mid-point
    body rate, so the quaternion stays exactly unit-norm and torque-free
    rotation preserves |Jw| — the property the reference's invariant
    mid-point discretization exists for.
    """
    J = params.inertia
    Jinv = jnp.linalg.inv(J)

    def wdot(w, tb):
        return (tb - jnp.cross(w, w @ J.T)) @ Jinv.T

    def F(x, u, t=0.0):
        p, q, v, w, _ = split_state(x)
        fb, tb = u[..., 0:3], u[..., 3:6]
        # mid-point body rate (one fixed-point sweep of the implicit rule)
        w_half = w + 0.5 * dt * wdot(w, tb)
        w_half = w + 0.5 * dt * wdot(w_half, tb)
        q_next = rot.qnormalize(rot.qmul(q, rot.q_exp(dt * w_half)))
        w_next = w + dt * wdot(w_half, tb)
        # translation: trapezoidal with the mid-point attitude
        q_half = rot.qmul(q, rot.q_exp(0.5 * dt * w_half))
        acc = rot.qrot(q_half, fb) / params.mass
        v_next = v + dt * acc
        p_next = p + dt * v + 0.5 * dt * dt * acc
        return join_state(p_next, q_next, v_next, w_next)

    return F


def h_pose(x, t=0.0):
    """Position + attitude measurement (ref: satellite3D output y = [p, q],
    satellite_basic_models.hpp:70)."""
    p, q, _, _, _ = split_state(x)
    return jnp.concatenate([p, q], axis=-1)


def h_pose_gyro(x, t=0.0):
    """Pose + body-rate gyro (ref: satellite3D_gyro_imdt_sys,
    satellite_invar_models.hpp:406)."""
    p, q, _, w, _ = split_state(x)
    return jnp.concatenate([p, q, w], axis=-1)


def make_h_pose_imu(params: SatelliteParams, f_of_xu: Callable | None = None):
    """Pose + gyro + body-frame accelerometer (specific force)
    (ref: satellite3D_IMU_imdt_sys, satellite_invar_models.hpp:514)."""
    def h(x, u=None, t=0.0):
        p, q, _, w, _ = split_state(x)
        fb = jnp.zeros(3, x.dtype) if u is None else u[..., 0:3]
        accel = fb / params.mass  # specific force sensed in body frame
        return jnp.concatenate([p, q, w, accel], axis=-1)

    return h


def make_h_sonars_in_room(room_lower, room_upper, sonar_pos, sonar_dir):
    """Sonar-grounded output model: N body-mounted sonar rays return their
    distance to the axis-aligned room box [room_lower, room_upper]
    (ref: airship_sonar_mixins.hpp:157 sonars_in_room_output_model,
    :171 get_sonar_distance_to_room — the indoor-airship grounding
    measurement of the Tryphon blimp experiments).

    JAX-native form: the reference's per-surface branch cascade becomes one
    masked minimum over the 6 slab intersections, vectorized over all N
    sonars — no data-dependent control flow, vmappable over scenario
    batches.  A ray that exits the box (no positive hit) reports 0, matching
    the reference's impossible-distance guard.

    Returns ``h(x, t=0.0) → (N,)`` distances given the rigid-body state x.
    """
    lo = jnp.asarray(room_lower, jnp.result_type(float))
    hi = jnp.asarray(room_upper, jnp.result_type(float))
    spos = jnp.asarray(sonar_pos, jnp.result_type(float))   # (N, 3) body
    sdir = jnp.asarray(sonar_dir, jnp.result_type(float))   # (N, 3) body

    def h(x, t=0.0):
        p, q, _, _, _ = split_state(x)
        pos_g = p + rot.qrot(q, spos)                       # (N, 3) world
        dir_g = rot.qrot(q, jnp.broadcast_to(sdir, spos.shape))
        safe = jnp.where(jnp.abs(dir_g) > 1e-4, dir_g, 1.0)
        t_lo = (lo - pos_g) / safe                          # (N, 3)
        t_hi = (hi - pos_g) / safe
        valid = jnp.abs(dir_g) > 1e-4
        cand = jnp.concatenate([t_lo, t_hi], axis=-1)       # (N, 6)
        ok = jnp.concatenate([valid, valid], axis=-1) & (cand > 0.0)
        dist = jnp.min(jnp.where(ok, cand, jnp.inf), axis=-1)
        return jnp.where(jnp.isfinite(dist), dist, 0.0)

    return h


def pose_innovation(z, y):
    """Measurement difference for [p, q, ...] outputs: quaternion part maps to
    a 3-vector rotation error via the log map (the reference's invariant
    output error, satellite_invar_models.hpp get_invariant_error)."""
    dp = z[..., 0:3] - y[..., 0:3]
    dq = rot.qmul(rot.qconj(y[..., 3:7]), z[..., 3:7])
    dth = rot.q_log(rot.qnormalize(dq))
    rest = z[..., 7:] - y[..., 7:]
    return jnp.concatenate([dp, dth, rest], axis=-1)


# ---------------------------------------------------------------------------
# airship (ref: near_buoyant_airship_models.hpp:72,342,617,739 + mixins)
# ---------------------------------------------------------------------------


class AirshipParams(NamedTuple):
    mass: jnp.ndarray            # scalar, body dry mass
    inertia: jnp.ndarray         # (3, 3)
    buoyancy: jnp.ndarray        # scalar net buoyant force (N, +up); ≈ m·g when neutral
    r_cm: jnp.ndarray            # (3,) CM offset from body origin (eccentricity)
    drag_lin: jnp.ndarray        # scalar linear-velocity drag coefficient
    drag_rot: jnp.ndarray        # scalar angular-velocity drag coefficient
    gravity: jnp.ndarray         # scalar, +9.81


def airship3D(mass=1.0, inertia=None, buoyancy=None, r_cm=(0.0, 0.0, 0.0),
              drag_lin=0.1, drag_rot=0.1, gravity=9.81) -> AirshipParams:
    inertia = jnp.eye(3) if inertia is None else jnp.asarray(inertia, jnp.result_type(float))
    f64 = lambda a: jnp.asarray(a, jnp.result_type(float))
    buoy = f64(mass * gravity if buoyancy is None else buoyancy)
    return AirshipParams(f64(mass), inertia, buoy, f64(r_cm), f64(drag_lin),
                         f64(drag_rot), f64(gravity))


def airship3D_cont(params: AirshipParams) -> Callable:
    """Near-buoyant airship: gravity − buoyancy imbalance, CM-eccentricity
    torque, linear/rotational drag (ref: near_buoyant_airship_models.hpp:72
    state-rate; drag and eccentricity terms per the tryphon blimp models)."""
    J = params.inertia
    Jinv = jnp.linalg.inv(J)

    def f(x, u, t=0.0):
        _, q, v, w, _ = split_state(x)
        fb, tb = u[..., 0:3], u[..., 3:6]
        up = jnp.array([0.0, 0.0, 1.0], x.dtype)
        # global forces: thrust (body), net buoyancy − weight, linear drag
        f_glob = (rot.qrot(q, fb) + (params.buoyancy - params.mass * params.gravity) * up
                  - params.drag_lin * v)
        acc = f_glob / params.mass
        # body torques: thrusters, gravity acting at CM offset, rotational drag
        g_body = rot.qrot_inv(q, -params.gravity * up) * params.mass
        tau = tb + jnp.cross(params.r_cm, g_body) - params.drag_rot * w
        wd = (tau - jnp.cross(w, w @ J.T)) @ Jinv.T
        return _rigid_rate(q, v, w, acc, wd)

    return f


N_AUG_AIRSHIP = 5  # [δm (1), r_ecc (3), log-drag (1)]


def airship3D_aug_cont(params: AirshipParams) -> Callable:
    """Airship with augmented quasi-constant parameter states
    ``aug = [δm, r_ecc (3), κ_drag]`` appended to x (estimated online by the
    TSOS/augmented filters — ref: near_buoyant_airship_models.hpp:342,617,739
    mass-eccentricity/drag augmented systems).  auġ = 0."""
    J = params.inertia
    Jinv = jnp.linalg.inv(J)

    def f(x, u, t=0.0):
        _, q, v, w, aug = split_state(x)
        dm, r_ecc, kd = aug[..., 0:1], aug[..., 1:4], aug[..., 4:5]
        m = params.mass + dm[..., 0]
        fb, tb = u[..., 0:3], u[..., 3:6]
        up = jnp.array([0.0, 0.0, 1.0], x.dtype)
        drag = params.drag_lin * jnp.exp(kd[..., 0])
        f_glob = (rot.qrot(q, fb) + (params.buoyancy - m * params.gravity) * up
                  - drag * v)
        acc = f_glob / m
        g_body = rot.qrot_inv(q, -params.gravity * up) * m
        tau = (tb + jnp.cross(params.r_cm + r_ecc, g_body) - params.drag_rot * w)
        wd = (tau - jnp.cross(w, w @ J.T)) @ Jinv.T
        return _rigid_rate(q, v, w, acc, wd, jnp.zeros_like(aug))

    return f


# ---------------------------------------------------------------------------
# quadrotor (ref: quadrotor_system.hpp:51)
# ---------------------------------------------------------------------------


class QuadrotorParams(NamedTuple):
    mass: jnp.ndarray
    inertia: jnp.ndarray        # (3, 3)
    arm: jnp.ndarray            # rotor arm length
    k_torque: jnp.ndarray       # rotor drag-torque / thrust ratio
    gravity: jnp.ndarray


def quadrotor(mass=1.0, inertia=None, arm=0.2, k_torque=0.02,
              gravity=9.81) -> QuadrotorParams:
    inertia = (jnp.diag(jnp.array([0.01, 0.01, 0.02]))
               if inertia is None else jnp.asarray(inertia, jnp.result_type(float)))
    f64 = lambda a: jnp.asarray(a, jnp.result_type(float))
    return QuadrotorParams(f64(mass), inertia, f64(arm), f64(k_torque), f64(gravity))


def quadrotor_cont(params: QuadrotorParams) -> Callable:
    """X-configuration quadrotor; input u = 4 rotor thrusts (N, ≥0).
    Thrust along body +z; rotor torques from arm geometry + drag torque
    (ref: quadrotor_system.hpp:51 get_state_derivative)."""
    J = params.inertia
    Jinv = jnp.linalg.inv(J)
    a = params.arm / jnp.sqrt(2.0)

    def f(x, u, t=0.0):
        _, q, v, w, _ = split_state(x)
        thrust = jnp.sum(u, axis=-1)
        up = jnp.array([0.0, 0.0, 1.0], x.dtype)
        acc = rot.qrot(q, thrust[..., None] * up) / params.mass - params.gravity * up
        # rotors (+x+y, +x−y, −x−y, −x+y), alternating spin for yaw balance
        tau_x = a * (u[..., 0] - u[..., 1] - u[..., 2] + u[..., 3])
        tau_y = a * (-u[..., 0] - u[..., 1] + u[..., 2] + u[..., 3])
        tau_z = params.k_torque * (u[..., 0] - u[..., 1] + u[..., 2] - u[..., 3])
        tb = jnp.stack([tau_x, tau_y, tau_z], axis=-1)
        wd = (tb - jnp.cross(w, w @ J.T)) @ Jinv.T
        return _rigid_rate(q, v, w, acc, wd)

    return f


def hover_thrust(params: QuadrotorParams):
    """Per-rotor thrust that exactly cancels gravity."""
    return params.mass * params.gravity / 4.0


# ---------------------------------------------------------------------------
# discretization helper shared by all vehicles
# ---------------------------------------------------------------------------


def rk4_quat_discrete(f: Callable, dt: float, n_aug: int = 0) -> Callable:
    """RK4 step + quaternion renormalization (the generic discretization the
    reference reaches via num_int_dtnl_system.hpp:55 wrapping)."""
    def F(x, u, t=0.0):
        k1 = f(x, u, t)
        k2 = f(x + 0.5 * dt * k1, u, t + 0.5 * dt)
        k3 = f(x + 0.5 * dt * k2, u, t + 0.5 * dt)
        k4 = f(x + dt * k3, u, t + dt)
        xn = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        q = rot.qnormalize(xn[..., 3:7])
        return jnp.concatenate([xn[..., 0:3], q, xn[..., 7:]], axis=-1)

    return F


def default_state(n_aug: int = 0, dtype=jnp.result_type(float)):
    x = jnp.zeros(13 + n_aug, dtype)
    return x.at[3].set(1.0)

"""Inverse kinematics: closed-form solvers for the named arms + CLIK.

JAX-native equivalent of the reference's IK layer
(ref: ctrl/kte_models/inverse_kinematics_model.hpp:54,73 doInverseMotion,
manip_3R3R_arm.hpp:54 closed-form decoupled IK, manip_P3R3R_arm.hpp:60,
manip_SCARA_arm.hpp:50, manip_clik_calculator.hpp:4-8,209 closed-loop IK as an
NLP with posture cost).

All solvers are pure jittable functions; branch choices are explicit arguments
(shoulder/elbow/wrist ∈ {+1, −1}) instead of the reference's run-time branch
search, so a vmap over the 8 branch combinations evaluates every solution in
one fused batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.kte.spec import ChainSpec, JointType, REVOLUTE, PRISMATIC
from reak_tpu.kte import dynamics
from reak_tpu.math import rotations as rot


def ee_pose(spec: ChainSpec, q):
    """End-effector pose: the last body frame of the chain
    (ref: direct_kinematics_model.hpp:208 doDirectMotion → dependent frame)."""
    r = dynamics.fk(spec, q)
    return r.body_pos[-1], r.body_quat[-1]


def ee_jacobian(spec: ChainSpec, q, fk_res=None):
    """Analytic geometric Jacobian of the end-effector frame, world coords:
    (6, nv) mapping q̇ → [v_ee, ω_ee]  (ref: getJacobianMatrix,
    direct_kinematics_model.hpp:216; column construction mirrors
    manip_kin_mdl_jac_calculator, manipulator_model_helper.hpp:322)."""
    if fk_res is None:
        fk_res = dynamics.fk(spec, q)
    p_ee = fk_res.body_pos[-1]
    cols = []
    zeros3 = jnp.zeros(3, q.dtype)
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt == REVOLUTE:
            a = fk_res.joint_axis[i]
            cols.append(jnp.concatenate([jnp.cross(a, p_ee - fk_res.joint_anchor[i]), a]))
        elif jt == PRISMATIC:
            cols.append(jnp.concatenate([fk_res.joint_axis[i], zeros3]))
        elif jt == JointType.FREE:
            raise NotImplementedError("CLIK on a floating base is ill-posed; "
                                      "fix the base or use task-space MPC")
        # FIXED: no column
    return jnp.stack(cols, axis=-1)


def pose_error(spec: ChainSpec, q, p_target, quat_target):
    """6-vector task error [δp, δθ] with δθ the rotation log of R_t·R(q)ᵀ."""
    p, quat = ee_pose(spec, q)
    dp = p_target - p
    dq = rot.qmul(rot.qconj(quat), quat_target)
    dth = rot.q_log(rot.qnormalize(dq))
    return jnp.concatenate([dp, rot.qrot(quat, dth)])


# ---------------------------------------------------------------------------
# closed-form: decoupled 3R3R (CRS-A465 family, ref: manip_3R3R_arm.hpp:54)
# ---------------------------------------------------------------------------


def _zoffsets(spec: ChainSpec, start: int):
    offs = np.asarray(spec.offsets_pos)
    return [float(offs[i][2]) for i in range(start, len(offs))]


def ik_3r3r(spec: ChainSpec, p_ee, quat_ee, shoulder=1.0, elbow=1.0, wrist=1.0,
            _joint0: int = 0):
    """Closed-form IK of the decoupled 3R3R arm (axes z, −y, −y, z, −y, z,
    inter-joint offsets along local +z — the geometry of models.manip_3r3r).

    Spherical wrist at the joint-5 origin; position subproblem is the planar
    2R reduction, orientation subproblem a ZYZ extraction
    (ref: manip_3R3R_arm.cpp doInverseMotion — same decoupling, re-derived).
    Branches: ``shoulder`` (+1 front / −1 back), ``elbow`` (+1/−1),
    ``wrist`` (+1/−1).  Returns q (6,).
    """
    d = _zoffsets(spec, _joint0)
    d1, d2, d3, d4, d5 = d[1], d[2], d[3], d[4], d[5]
    a = d3 + d4
    R_ee = rot.q_to_matrix(quat_ee)
    # wrist center: EE origin sits d5 along the joint-6 z-axis from the wrist
    W = p_ee - d5 * R_ee[:, 2]

    r_xy = jnp.hypot(W[0], W[1])
    q1 = jnp.arctan2(W[1], W[0]) + jnp.where(shoulder > 0, 0.0, jnp.pi)
    X = jnp.where(shoulder > 0, r_xy, -r_xy)
    Z = W[2] - d1
    # planar 2R with u = −q2, v = −q3 measured from +z
    cv = jnp.clip((X * X + Z * Z - d2 * d2 - a * a) / (2.0 * d2 * a), -1.0, 1.0)
    v = elbow * jnp.arccos(cv)
    u = jnp.arctan2(X, Z) - jnp.arctan2(a * jnp.sin(v), d2 + a * jnp.cos(v))
    q2, q3 = -u, -v

    # orientation: R36 = R03ᵀ R_ee = Rz(q4)·Ry(−q5)·Rz(q6)
    c1, s1 = jnp.cos(q1), jnp.sin(q1)
    Rz1 = jnp.array([[c1, -s1, 0.0], [s1, c1, 0.0], [0.0, 0.0, 1.0]])
    th = -(q2 + q3)  # about −y twice ⇒ Ry(−(q2+q3)) ... Ry(th)
    ct, st = jnp.cos(th), jnp.sin(th)
    Ry23 = jnp.array([[ct, 0.0, st], [0.0, 1.0, 0.0], [-st, 0.0, ct]])
    M = (Rz1 @ Ry23).T @ R_ee
    # ZYZ with middle angle β: M = Rz(q4)·Ry(β)·Rz(q6), β = −q5
    sb = jnp.hypot(M[0, 2], M[1, 2])
    beta = jnp.arctan2(wrist * sb, M[2, 2])
    q4 = jnp.arctan2(wrist * M[1, 2], wrist * M[0, 2])
    q6 = jnp.arctan2(wrist * M[2, 1], -wrist * M[2, 0])
    q5 = -beta
    return jnp.stack([q1, q2, q3, q4, q5, q6])


def ik_p3r3r(spec: ChainSpec, p_ee, quat_ee, track_pos, **branches):
    """Closed-form IK of the track+arm P3R3R (ref: manip_P3R3R_arm.hpp:60):
    the redundant track coordinate is resolved by the caller (``track_pos``),
    the remaining 6 DoF by the 3R3R solver in track coordinates."""
    track_axis = jnp.asarray(np.asarray(spec.axes)[0], p_ee.dtype)
    p_local = p_ee - track_pos * track_axis
    q_arm = ik_3r3r(spec, p_local, quat_ee, _joint0=1, **branches)
    return jnp.concatenate([jnp.atleast_1d(track_pos), q_arm])


def ik_scara(spec: ChainSpec, p_ee, yaw=None, elbow=1.0):
    """Closed-form SCARA IK (ref: manip_SCARA_arm.hpp:50): planar 2R for
    (x, y), prismatic for z.  Returns q = [q1, q2, d3]."""
    offs = np.asarray(spec.offsets_pos)
    l1, l2 = float(offs[1][0]), float(offs[2][0])
    x, y, z = p_ee[0], p_ee[1], p_ee[2]
    c2 = jnp.clip((x * x + y * y - l1 * l1 - l2 * l2) / (2 * l1 * l2), -1.0, 1.0)
    q2 = elbow * jnp.arccos(c2)
    q1 = jnp.arctan2(y, x) - jnp.arctan2(l2 * jnp.sin(q2), l1 + l2 * jnp.cos(q2))
    return jnp.stack([q1, q2, z])


# ---------------------------------------------------------------------------
# closed-form: 7-DoF symmetric arms — SSRMS/Canadarm2 & ERA
# (ref: manip_SSRMS_arm.hpp:51 / manip_SSRMS_arm.cpp:300 doInverseMotion,
#  manip_ERA_arm.hpp:50 / manip_ERA_arm.cpp doInverseMotion)
# ---------------------------------------------------------------------------
#
# Both arms are roll–yaw–(pitch,pitch,pitch)–yaw–roll chains whose three
# middle joints share one axis direction w (the PLANE NORMAL of the planar
# elbow sub-chain).  The reference resolves the 1-DoF redundancy with a
# geometric wrist-plane construction (manip_SSRMS_arm.cpp:327-415, including
# a small fixed-point iteration); here the redundancy is an EXPLICIT angle
# ``phi`` picking w on the circle of unit vectors ⊥ (wrist−shoulder), so a
# vmap over phi evaluates the whole self-motion manifold in one batch — the
# JAX-native replacement for the reference's branch search.
#
# Derivation (SSRMS axes z,x,y,y,y,x,z; offsets along local +z):
#   p1 = (0,0,L0) fixed; p5 = p_ee − L5·ẑ_ee (joint-6 is a z-roll);
#   every segment p1→p5 is ⊥ w  ⇒  w ⊥ v := p5 − p1  (the redundancy circle);
#   base pair:  w = Rz(q0)Rx(q1)·ŷ  ⇒  q0, q1;
#   wrist pair: w = c5·y5 − s5·ẑ_ee with y5 = s6·x̂_ee + c6·ŷ_ee ⇒ q5, q6;
#   middle: planar 2R (L2, L3) in the plane {u1 = R1·ẑ, u2 = w×u1} ⇒ q2, q3;
#   q4 closes the frame: angle about w from ẑ3 to ẑ4 = s5·y5 + c5·ẑ_ee.
# ERA (axes z,y,x,x,x,y,z) is the same with pitch about x̂ — mirrored dot
# products, same structure.


def _ik7_core(p_ee, quat_ee, L, phi, elbow, kind):
    R_ee = rot.q_to_matrix(quat_ee)
    x_ee, y_ee, z_ee = R_ee[:, 0], R_ee[:, 1], R_ee[:, 2]
    L0, L1, L2, L3, L4, L5 = L

    p1 = jnp.array([0.0, 0.0, L0], p_ee.dtype)
    p5 = p_ee - L5 * z_ee
    v = p5 - p1
    vn = jnp.linalg.norm(v)
    vu = v / jnp.maximum(vn, 1e-12)

    # redundancy circle basis ⊥ v (guard v ∥ ẑ with an x̂ fallback)
    zw = jnp.array([0.0, 0.0, 1.0], p_ee.dtype)
    xw = jnp.array([1.0, 0.0, 0.0], p_ee.dtype)
    ref_axis = jnp.where(jnp.abs(vu[2]) < 0.9, zw, xw)
    e1 = jnp.cross(vu, ref_axis)
    e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-12)
    e2 = jnp.cross(vu, e1)
    w = jnp.cos(phi) * e1 + jnp.sin(phi) * e2

    if kind == "ssrms":  # pitch about ŷ: w = Rz(q0)Rx(q1)·ŷ
        q0 = jnp.arctan2(-w[0], w[1])
        q1 = jnp.arctan2(w[2], jnp.hypot(w[0], w[1]))
        # wrist: w = c5·y5 − s5·ẑ_ee, y5 = s6·x̂_ee + c6·ŷ_ee
        q6 = jnp.arctan2(jnp.dot(w, x_ee), jnp.dot(w, y_ee))
        c5h = jnp.hypot(jnp.dot(w, x_ee), jnp.dot(w, y_ee))
        q5 = jnp.arctan2(-jnp.dot(w, z_ee), c5h)
        s5, c5 = jnp.sin(q5), jnp.cos(q5)
        s6, c6 = jnp.sin(q6), jnp.cos(q6)
        y5 = s6 * x_ee + c6 * y_ee
        z4 = s5 * y5 + c5 * z_ee  # R4·ẑ
    else:  # "era": pitch about x̂: w = Rz(q0)Ry(q1)·x̂
        q0 = jnp.arctan2(w[1], w[0])
        q1 = jnp.arctan2(-w[2], jnp.hypot(w[0], w[1]))
        # wrist: w = c5·x5 + s5·ẑ_ee, x5 = c6·x̂_ee − s6·ŷ_ee
        q6 = jnp.arctan2(-jnp.dot(w, y_ee), jnp.dot(w, x_ee))
        c5h = jnp.hypot(jnp.dot(w, x_ee), jnp.dot(w, y_ee))
        q5 = jnp.arctan2(jnp.dot(w, z_ee), c5h)
        s5, c5 = jnp.sin(q5), jnp.cos(q5)
        s6, c6 = jnp.sin(q6), jnp.cos(q6)
        x5 = c6 * x_ee - s6 * y_ee
        z4 = -s5 * x5 + c5 * z_ee  # R4·ẑ

    # shoulder-plane basis: u1 = R1·ẑ, u2 = w × u1
    s0, c0 = jnp.sin(q0), jnp.cos(q0)
    s1, c1 = jnp.sin(q1), jnp.cos(q1)
    if kind == "ssrms":
        u1 = jnp.stack([s0 * s1, -c0 * s1, c1])
    else:
        u1 = jnp.stack([c0 * s1, s0 * s1, c1])
    u2 = jnp.cross(w, u1)

    p2 = p1 + L1 * u1
    p4 = p5 - L4 * z4
    d = p4 - p2
    a, b = jnp.dot(d, u1), jnp.dot(d, u2)
    r2 = a * a + b * b
    c3 = jnp.clip((r2 - L2 * L2 - L3 * L3) / (2.0 * L2 * L3), -1.0, 1.0)
    q3 = elbow * jnp.arccos(c3)
    q2 = jnp.arctan2(b, a) - jnp.arctan2(L3 * jnp.sin(q3), L2 + L3 * jnp.cos(q3))

    z3 = jnp.cos(q2 + q3) * u1 + jnp.sin(q2 + q3) * u2
    q4 = jnp.arctan2(jnp.dot(jnp.cross(z3, z4), w), jnp.dot(z3, z4))
    return jnp.stack([q0, q1, q2, q3, q4, q5, q6])


def ik_ssrms(spec: ChainSpec, p_ee, quat_ee, phi=0.0, elbow=1.0):
    """Closed-form IK of the 7-DoF SSRMS/Canadarm2 arm
    (ref: manip_SSRMS_arm.cpp:300 doInverseMotion).  ``phi`` parameterizes
    the self-motion circle (the reference's wrist-plane heuristic picks one
    point of it); ``elbow`` ∈ {+1, −1} selects the elbow branch."""
    L = _zoffsets(spec, 0)[1:7]
    return _ik7_core(p_ee, rot.qnormalize(quat_ee), L,
                     jnp.asarray(phi, p_ee.dtype), elbow, "ssrms")


def ik_era(spec: ChainSpec, p_ee, quat_ee, phi=0.0, elbow=1.0):
    """Closed-form IK of the 7-DoF ERA arm
    (ref: manip_ERA_arm.cpp doInverseMotion — same family, x-pitch axes)."""
    L = _zoffsets(spec, 0)[1:7]
    return _ik7_core(p_ee, rot.qnormalize(quat_ee), L,
                     jnp.asarray(phi, p_ee.dtype), elbow, "era")


# ---------------------------------------------------------------------------
# CLIK — closed-loop numerical IK (ref: manip_clik_calculator.hpp:209)
# ---------------------------------------------------------------------------


class CLIKResult(NamedTuple):
    q: jax.Array          # (nq,) solution
    err: jax.Array        # scalar final task-error norm
    converged: jax.Array  # bool


def clik(
    spec: ChainSpec,
    p_target,
    quat_target,
    q0,
    iters: int = 50,
    damping: float = 1e-6,
    posture_weight: float = 1e-3,
    q_rest=None,
    q_min=None,
    q_max=None,
    tol: float = 1e-8,
    step_max: float = 0.5,
) -> CLIKResult:
    """Closed-loop IK as damped Gauss-Newton with posture cost and box joint
    limits — the reference solves the same NLP with a trust-region Newton SQP
    and a pluggable posture objective (manip_clik_calculator.hpp:4-8).

    Fixed iteration count (`lax.scan`) so the solver jits/vmaps; Jacobians by
    AD through the FK (replaces manip_kin_mdl_jac_calculator bookkeeping,
    manipulator_model_helper.hpp:322).
    """
    nq = q0.shape[-1]
    q_rest = q0 if q_rest is None else q_rest
    has_limits = q_min is not None and q_max is not None

    err_fn = lambda q: pose_error(spec, q, p_target, quat_target)

    def step(q, _):
        fk_res = dynamics.fk(spec, q)
        e = err_fn(q)
        J = ee_jacobian(spec, q, fk_res)  # (6, nq): q̇ → [v_ee, ω_ee], e ≈ J·dq
        # Levenberg-style damping grows with the residual so far-from-target
        # steps stay conservative (the trust-region role in the reference's
        # SQP solver, manip_clik_calculator.hpp:209)
        lam = damping + 1e-2 * jnp.sum(e * e)
        H = J.T @ J + lam * jnp.eye(nq, dtype=q.dtype)
        Hinv_Jt = jnp.linalg.solve(H, J.T)  # damped pseudo-inverse J⁺
        dq_task = Hinv_Jt @ e
        # posture as a secondary objective in the task nullspace, so it never
        # perturbs the primary fixed point (ref: clik posture cost is the
        # NLP's secondary objective, manip_clik_calculator.hpp:4-8)
        N = jnp.eye(nq, dtype=q.dtype) - Hinv_Jt @ J
        dq = dq_task + posture_weight * (N @ (q_rest - q))
        # trust-region clip on the step norm
        nrm = jnp.linalg.norm(dq)
        dq = dq * jnp.minimum(1.0, step_max / (nrm + 1e-12))
        q = q + dq
        if has_limits:
            q = jnp.clip(q, jnp.asarray(q_min, q.dtype), jnp.asarray(q_max, q.dtype))
        return q, jnp.sum(e * e)

    q, errs = jax.lax.scan(step, q0, None, length=iters)
    e_fin = jnp.linalg.norm(err_fn(q))
    return CLIKResult(q=q, err=e_fin, converged=e_fin < tol)


def clik_batched(spec: ChainSpec, p_targets, quat_targets, q0s, **kw):
    """vmapped CLIK over a target batch — the batched replacement for the
    reference's serial per-sample IK calls inside planning DK/IK maps
    (topologies/inverse_kinematics_topomap.hpp)."""
    return jax.vmap(lambda p, qt, q0: clik(spec, p, qt, q0, **kw))(
        p_targets, quat_targets, q0s)

"""Chain kinematics & dynamics as pure functions.

This is the JAX-native equivalent of the reference's doMotion/clearForce/doForce
sweeps + mass-matrix aggregation + Cholesky solve
(ref: ctrl/mbd_kte/kte_map_chain.hpp:71-89, mass_matrix_calculator.cpp:80-287,
manipulator_model.cpp:292-355 computeStateRate).

Design (SURVEY.md §7): the chain spec is a static closure constant, so the
per-joint loop below unrolls at trace time into straight-line XLA ops — no
dynamic control flow, fully fusable, vmap-able over scenario batches.

Semantics parity with the reference:
- kinematics sweep base→tip == ``fk``;
- per-joint Jacobian bookkeeping (jacobian_joint_map.hpp) == geometric Jacobian
  columns stacked into the twist-shaping matrix T (linear rows in world coords,
  angular rows in body coords — exactly the Tcm of mass_matrix_calc);
- force sweep tip→base with q̈=0 == ``bias_force`` (the f_nl of test_am.cpp:47-59),
  computed via automatic differentiation: J̇q̇ terms come from one jvp through
  the velocity map instead of hand-propagated coriolis bookkeeping;
- gravity enters as a base-frame acceleration (d'Alembert), matching
  ``base_frame->Acceleration = -g`` in the reference (test_am.cpp:106).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.math import rotations as rot
from reak_tpu.math.frames import Frame3
from reak_tpu.math.linalg import solve_pd
from reak_tpu.kte.spec import ChainSpec, JointType, REVOLUTE, PRISMATIC, FIXED, FREE


class FkResult(NamedTuple):
    """Stacked per-body global kinematics (nb = n_joints bodies)."""

    body_pos: jax.Array  # (nb, 3) joint end-frame origins, world coords
    body_quat: jax.Array  # (nb, 4) body orientation, local→world
    com_pos: jax.Array  # (nb, 3) COM positions, world coords
    joint_anchor: jax.Array  # (nb, 3) rotation anchor points, world coords
    joint_axis: jax.Array  # (nb, 3) joint axes, world coords
    pre_quat: jax.Array  # (nb, 4) orientation of the frame *before* each joint


def _spec_const(spec: ChainSpec, dtype):
    """Materialize spec metadata as jnp constants of the working dtype."""
    return dict(
        axes=jnp.asarray(np.asarray(spec.axes), dtype),
        off_pos=jnp.asarray(np.asarray(spec.offsets_pos), dtype),
        off_quat=jnp.asarray(np.asarray(spec.offsets_quat), dtype),
        com=jnp.asarray(np.asarray(spec.com_pos), dtype),
        mass=jnp.asarray(np.asarray(spec.masses), dtype),
        inertia=jnp.asarray(np.asarray(spec.inertias).reshape(-1, 3, 3), dtype),
        gravity=jnp.asarray(np.asarray(spec.gravity), dtype),
    )


def _one_dof_only(spec: ChainSpec) -> bool:
    return all(
        JointType(t) in (REVOLUTE, PRISMATIC, FIXED) for t in spec.joint_types
    )


def _fk_scan(spec: ChainSpec, q: jax.Array) -> FkResult:
    """Scan-form FK for 1-DoF/fixed chains: compile time O(1) in chain length
    (the unrolled sweep's trace grows linearly and chokes XLA on long chains,
    e.g. ≥8-segment flexible beams).  Joint-type dispatch becomes masked
    updates — the "segmented scan" strategy of SURVEY.md §7 hard-parts."""
    dtype = q.dtype
    c = _spec_const(spec, dtype)
    n = spec.n_joints
    is_rev = np.array([JointType(t) == REVOLUTE for t in spec.joint_types], np.float64)
    is_pri = np.array([JointType(t) == PRISMATIC for t in spec.joint_types], np.float64)
    qsel = np.array(
        [spec.q_index(i) if JointType(t) != FIXED else 0
         for i, t in enumerate(spec.joint_types)], np.int32)
    sel = jnp.asarray((is_rev + is_pri), dtype)
    qfull = q[jnp.asarray(qsel)] * sel  # (n,) zero at FIXED slots
    rev = jnp.asarray(is_rev, dtype)
    pri = jnp.asarray(is_pri, dtype)

    def body(carry, inp):
        p, Q = carry
        off_p, off_q, ax, com, qi, r, s = inp
        p = p + rot.qrot(Q, off_p)
        Q = rot.qmul(Q, off_q)
        pre_Q = Q
        a_g = rot.qrot(Q, ax)
        anchor = p
        half = 0.5 * qi * r  # identity quaternion when not revolute
        qj = jnp.concatenate([jnp.cos(half)[None], ax * jnp.sin(half)])
        Q = rot.qmul(Q, qj)
        p = p + (qi * s) * a_g
        com_w = p + rot.qrot(Q, com)
        out = (p, Q, com_w, anchor, a_g * (r + s), pre_Q)
        return (p, Q), out

    init = (jnp.zeros(3, dtype), rot.qidentity(dtype))
    _, (bp, bq, cw, an, ag, pq) = jax.lax.scan(
        body, init, (c["off_pos"], c["off_quat"], c["axes"], c["com"], qfull, rev, pri)
    )
    return FkResult(body_pos=bp, body_quat=bq, com_pos=cw,
                    joint_anchor=an, joint_axis=ag, pre_quat=pq)


def fk(spec: ChainSpec, q: jax.Array) -> FkResult:
    """Forward kinematics sweep base→tip (ref: kte_map_chain.hpp:71 doMotion).

    ``q``: (nq,) configuration.  Returns stacked world-frame kinematic data.
    Long 1-DoF chains route through the scan form (compile-time O(1));
    short/free-base chains through the fully unrolled sweep (fastest runtime).
    """
    if _one_dof_only(spec) and spec.n_joints >= 8:
        return _fk_scan(spec, q)
    dtype = q.dtype
    c = _spec_const(spec, dtype)
    p = jnp.zeros(3, dtype)
    Q = rot.qidentity(dtype)

    body_pos, body_quat, com_pos = [], [], []
    anchors, axes_g, pre_quats = [], [], []

    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        # fixed offset (the rigid link before the joint, ref rigid_link.hpp:50)
        p = p + rot.qrot(Q, c["off_pos"][i])
        Q = rot.qmul(Q, c["off_quat"][i])
        pre_quats.append(Q)
        qidx = spec.q_index(i)

        if jt == REVOLUTE:
            anchors.append(p)
            a_g = rot.qrot(Q, c["axes"][i])
            axes_g.append(a_g)
            Q = rot.qmul(Q, rot.q_from_axis_angle(c["axes"][i], q[qidx]))
        elif jt == PRISMATIC:
            a_g = rot.qrot(Q, c["axes"][i])
            axes_g.append(a_g)
            anchors.append(p)
            p = p + q[qidx] * a_g
        elif jt == FREE:
            # 6-DoF joint: q = [pos(3) in pre-frame coords, quat(4)]
            # (ref: free_joints.hpp:165 — end = base * coordinate frame)
            p = p + rot.qrot(Q, q[qidx : qidx + 3])
            quat = q[qidx + 3 : qidx + 7]
            quat = quat / jnp.linalg.norm(quat)
            Q = rot.qmul(Q, quat)
            anchors.append(p)
            axes_g.append(jnp.zeros(3, dtype))
        else:  # FIXED
            anchors.append(p)
            axes_g.append(jnp.zeros(3, dtype))

        body_pos.append(p)
        body_quat.append(Q)
        com_pos.append(p + rot.qrot(Q, c["com"][i]))

    return FkResult(
        body_pos=jnp.stack(body_pos),
        body_quat=jnp.stack(body_quat),
        com_pos=jnp.stack(com_pos),
        joint_anchor=jnp.stack(anchors),
        joint_axis=jnp.stack(axes_g),
        pre_quat=jnp.stack(pre_quats),
    )


def jacobians(spec: ChainSpec, q: jax.Array, fk_res: FkResult | None = None):
    """Stacked geometric Jacobians — the twist-shaping matrix Tcm
    (ref: mass_matrix_calculator.cpp:100-287 get_TMT_TdMT).

    Returns ``(Jv, Jw)`` of shapes (nb, 3, nv): for each body, the maps
    q̇ → COM linear velocity (world coords) and q̇ → angular velocity
    (BODY coords — matching the block-diag Mcm convention diag(m,m,m,I_body)).
    """
    if fk_res is None:
        fk_res = fk(spec, q)
    if _one_dof_only(spec):
        return _jacobians_1dof(spec, q, fk_res)
    dtype = q.dtype
    nb, nv = spec.n_joints, spec.nv

    cols_v = []  # list of (nb, 3) per velocity dof
    cols_w = []  # world-coords angular columns

    # static reach mask: body k is affected by joint i iff k >= i
    def mask(i):
        m = np.zeros((nb, 1), dtype=np.float64)
        m[i:] = 1.0
        return jnp.asarray(m, dtype)

    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt == REVOLUTE:
            a = fk_res.joint_axis[i]
            r = fk_res.com_pos - fk_res.joint_anchor[i]
            cols_v.append(jnp.cross(a[None, :], r) * mask(i))
            cols_w.append(jnp.broadcast_to(a, (nb, 3)) * mask(i))
        elif jt == PRISMATIC:
            a = fk_res.joint_axis[i]
            cols_v.append(jnp.broadcast_to(a, (nb, 3)) * mask(i))
            cols_w.append(jnp.zeros((nb, 3), dtype))
        elif jt == FREE:
            # linear dofs: velocity in pre-frame coords → world
            pre_R_cols = rot.q_to_matrix(fk_res.pre_quat[i])  # columns = axes
            for j in range(3):
                cols_v.append(jnp.broadcast_to(pre_R_cols[:, j], (nb, 3)) * mask(i))
                cols_w.append(jnp.zeros((nb, 3), dtype))
            # angular dofs: ω in base-body coords, anchored at joint end origin
            base_R = rot.q_to_matrix(fk_res.body_quat[i])
            r = fk_res.com_pos - fk_res.joint_anchor[i]
            for j in range(3):
                a = base_R[:, j]
                cols_v.append(jnp.cross(a[None, :], r) * mask(i))
                cols_w.append(jnp.broadcast_to(a, (nb, 3)) * mask(i))
        # FIXED: no columns

    Jv = jnp.stack(cols_v, axis=-1) if cols_v else jnp.zeros((nb, 3, 0), dtype)
    Jw_world = jnp.stack(cols_w, axis=-1) if cols_w else jnp.zeros((nb, 3, 0), dtype)
    # rotate angular rows into each body's frame
    R_body = rot.q_to_matrix(fk_res.body_quat)  # (nb, 3, 3)
    Jw = jnp.einsum("bij,bik->bjk", R_body, Jw_world)
    return Jv, Jw


def _jacobians_1dof(spec: ChainSpec, q: jax.Array, fk_res: FkResult):
    """Vectorized twist-column assembly for 1-DoF/fixed chains: replaces the
    per-column Python loop with masked batched cross products, so the trace
    stays O(1) in chain length (same Tcm semantics as the generic path)."""
    dtype = q.dtype
    nb = spec.n_joints
    idx = [i for i, t in enumerate(spec.joint_types)
           if JointType(t) in (REVOLUTE, PRISMATIC)]
    nv = len(idx)
    if nv == 0:
        z = jnp.zeros((nb, 3, 0), dtype)
        return z, z
    idx_np = np.asarray(idx)
    # static reach mask: body b moves with dof k iff b >= joint(k)
    reach = (np.arange(nb)[:, None] >= idx_np[None, :]).astype(np.float64)
    w_rev = np.array(
        [JointType(spec.joint_types[i]) == REVOLUTE for i in idx], np.float64
    )[None, :, None]  # (1, nv, 1)
    reach = jnp.asarray(reach[:, :, None], dtype)  # (nb, nv, 1)
    w_rev = jnp.asarray(w_rev, dtype)

    ax = fk_res.joint_axis[idx_np]  # (nv, 3)
    anch = fk_res.joint_anchor[idx_np]  # (nv, 3)
    rel = fk_res.com_pos[:, None, :] - anch[None, :, :]  # (nb, nv, 3)
    crossed = jnp.cross(jnp.broadcast_to(ax[None], rel.shape), rel)
    axb = jnp.broadcast_to(ax[None], rel.shape)
    Jv_cols = (w_rev * crossed + (1.0 - w_rev) * axb) * reach
    Jw_cols = (w_rev * axb) * reach
    Jv = jnp.swapaxes(Jv_cols, 1, 2)  # (nb, 3, nv)
    Jw_world = jnp.swapaxes(Jw_cols, 1, 2)
    R_body = rot.q_to_matrix(fk_res.body_quat)  # (nb, 3, 3)
    Jw = jnp.einsum("bij,bik->bjk", R_body, Jw_world)
    return Jv, Jw


def config_rate(spec: ChainSpec, q: jax.Array, v: jax.Array) -> jax.Array:
    """dq/dt from generalized velocity (quaternion rate for a free base,
    ref: manipulator_model.cpp:301-344 quaternion-rate packing)."""
    if not spec.has_free_base:
        return v
    quat = q[3:7]
    qdot = rot.qdot_from_omega(quat, v[3:6])
    return jnp.concatenate([v[0:3], qdot, v[6:]])


def velocities(spec: ChainSpec, q: jax.Array, qd: jax.Array, fk_res=None):
    """Per-body COM linear velocity (world) and angular velocity (body coords)."""
    Jv, Jw = jacobians(spec, q, fk_res)
    return Jv @ qd, Jw @ qd


def mass_matrix(spec: ChainSpec, q: jax.Array) -> jax.Array:
    """Joint-space mass matrix  M = Tᵀ Mcm T
    (ref: mass_matrix_calculator.cpp:80-98 getMassMatrix)."""
    c = _spec_const(spec, q.dtype)
    Jv, Jw = jacobians(spec, q)
    M = jnp.einsum("b,bik,bil->kl", c["mass"], Jv, Jv)
    M = M + jnp.einsum("bik,bij,bjl->kl", Jw, c["inertia"], Jw)
    return M


def mass_matrix_and_derivative(spec: ChainSpec, q: jax.Array, qd: jax.Array):
    """(M, Ṁ) — Ṁ by forward-mode AD along the configuration rate
    (ref: mass_matrix_calculator.cpp getMassMatrixAndDerivative)."""
    dq = config_rate(spec, q, qd)
    return jax.jvp(lambda qq: mass_matrix(spec, qq), (q,), (dq,))


def _passive_joint_force(spec: ChainSpec, q: jax.Array, qd: jax.Array) -> jax.Array:
    """Generalized force from joint springs/dampers/dry friction.

    (ref: spring.hpp:53, damper.hpp:51, joint_friction.cpp:43-57 microslip law)
    Free-base dofs carry no passive joint elements.
    """
    dtype = q.dtype
    nv = spec.nv
    idx = [i for i, t in enumerate(spec.joint_types)
           if JointType(t) in (REVOLUTE, PRISMATIC)]
    smooth = all(
        spec.backlash[i] == 0.0 and spec.stiction_coef[i] == 0.0
        and spec.slip_coef[i] == 0.0 for i in idx
    )
    if smooth and not spec.has_free_base and len(idx) == nv:
        # vectorized spring/damper path (no deadband/friction): one fused op
        k = jnp.asarray(np.asarray(spec.stiffness)[idx], dtype)
        d = jnp.asarray(np.asarray(spec.damping)[idx], dtype)
        rq = jnp.asarray(np.asarray(spec.rest_q)[idx], dtype)
        return -k * (q - rq) - d * qd
    f = jnp.zeros(nv, dtype)
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt not in (REVOLUTE, PRISMATIC):
            continue
        qi = q[spec.q_index(i)]
        vi = qd[spec.v_index(i)]
        k = jnp.asarray(spec.stiffness[i], dtype)
        d = jnp.asarray(spec.damping[i], dtype)
        rq = jnp.asarray(spec.rest_q[i], dtype)
        e = qi - rq
        # transmission backlash: spring engages only outside the deadband
        # (ref: joint_backlash.hpp:47 joint_backlash_gen, lumped model)
        gap = spec.backlash[i] if len(spec.backlash) > i else 0.0
        if gap != 0.0:
            half = jnp.asarray(0.5 * gap, dtype)
            e = jnp.sign(e) * jnp.maximum(jnp.abs(e) - half, 0.0)
        fi = -k * e - d * vi
        # dry microslip friction, piecewise (joint_friction.cpp:49-56)
        sc = spec.stiction_coef[i]
        if sc != 0.0 or spec.slip_coef[i] != 0.0:
            v_st = jnp.asarray(spec.stiction_vel[i], dtype)
            v_sl = jnp.asarray(spec.slip_vel[i], dtype)
            c_st = jnp.asarray(sc, dtype)
            c_sl = jnp.asarray(spec.slip_coef[i], dtype)
            speed = jnp.abs(vi)
            sgn = jnp.sign(vi)
            f_stick = vi * c_st / v_st
            f_micro = sgn * (c_st + (c_sl - c_st) * (speed - v_st) / (v_sl - v_st))
            f_slip = sgn * c_sl
            fr = jnp.where(
                speed <= v_st, f_stick, jnp.where(speed < v_sl, f_micro, f_slip)
            )
            fi = fi - fr
        f = f.at[spec.v_index(i)].add(fi)
    return f


def dynamics_terms(spec: ChainSpec, q: jax.Array, qd: jax.Array):
    """Fused (M, f_nl): one FK + one jvp produce the mass matrix AND the
    accumulated bias force — the whole doMotion/clearForce/doForce +
    mass-matrix pipeline of the reference in a single pass
    (ref: kte_map_chain.hpp:71-89 + mass_matrix_calculator.cpp:80-287).
    """
    dtype = q.dtype
    c = _spec_const(spec, dtype)

    def vel_map(qq):
        res = fk(spec, qq)
        Jv, Jw = jacobians(spec, qq, res)
        return Jv @ qd, Jw @ qd, Jv, Jw

    # one jvp: primals give velocities + Jacobians, tangents give J̇q̇ bias accels
    (v, w, Jv, Jw), (a_bias, alpha_bias, _, _) = jax.jvp(
        vel_map, (q,), (config_rate(spec, q, qd),)
    )
    M = jnp.einsum("b,bik,bil->kl", c["mass"], Jv, Jv)
    M = M + jnp.einsum("bik,bij,bjl->kl", Jw, c["inertia"], Jw)
    # d'Alembert: base acceleration = -gravity (test_am.cpp:106)
    a_total = a_bias - c["gravity"][None, :]
    # inertia elements subtract m·a and Iα + ω×Iω (inertia.cpp:111-121)
    f_lin = -c["mass"][:, None] * a_total  # (nb, 3) world coords
    Iw = jnp.einsum("bij,bj->bi", c["inertia"], w)
    f_ang = -(jnp.einsum("bij,bj->bi", c["inertia"], alpha_bias) + jnp.cross(w, Iw))
    f = jnp.einsum("bik,bi->k", Jv, f_lin) + jnp.einsum("bik,bi->k", Jw, f_ang)
    return M, f + _passive_joint_force(spec, q, qd)


def bias_force(spec: ChainSpec, q: jax.Array, qd: jax.Array) -> jax.Array:
    """Accumulated generalized force with q̈ = 0 — the reference's ``f_nl``
    from the doMotion/clearForce/doForce sweeps (test_am.cpp:47-59), including
    gravity, centrifugal/Coriolis bias, and passive joint elements.

    Forward dynamics is then  M q̈ = τ + bias_force.
    """
    return dynamics_terms(spec, q, qd)[1]


def forward_dynamics(spec: ChainSpec, q, qd, tau=None) -> jax.Array:
    """q̈ = M⁻¹(τ + f_nl) via Cholesky (ref: manipulator_model.cpp:346-354)."""
    M, f = dynamics_terms(spec, q, qd)
    if tau is not None:
        f = f + tau
    return solve_pd(M, f)


def forward_dynamics_checked(spec: ChainSpec, q, qd, tau=None):
    """Forward dynamics + device-side failure flags: ``(q̈, status)`` where
    status is a reak_tpu.errors bitmask (SINGULAR_MATRIX when the mass matrix
    is numerically singular — the reference THROWS here,
    manipulator_model.cpp:351-354 — NONFINITE when inputs/outputs blow up).
    Safe inside jit/vmap/scan; raise on host with errors.raise_on_error."""
    from reak_tpu import errors

    M, f = dynamics_terms(spec, q, qd)
    if tau is not None:
        f = f + tau
    qdd = solve_pd(M, f)
    status = (
        errors.chol_singular_flag(M)
        | errors.finite_flag(q, qd, f)
        | errors.finite_flag(qdd)
    )
    return qdd, status


def inverse_dynamics(spec: ChainSpec, q, qd, qdd) -> jax.Array:
    """Required generalized force: τ = M q̈ − f_nl
    (ref: kte_models/inverse_dynamics_model.hpp:54)."""
    M, f = dynamics_terms(spec, q, qd)
    return M @ qdd - f


def state_retraction(spec: ChainSpec):
    """Manifold chart for the packed state x = [q | q̇]: tangent dim 2·nv.

    Fixed base: plain vector chart.  Free base: the configuration embeds one
    unit quaternion at q[3:7], so the tangent uses a body-frame 3-vector
    rotation error [δp, δθ, δq_joints, δq̇] — the same 6-DoF-per-body
    parameterization the invariant filters use
    (ref: satellite_invar_models.hpp:296 invariant error state;
    ctrl/invariant.py quat_state_retraction).  This is what lifts the
    fixed-base restriction of the LTV linearization: error dynamics are
    linearized in this chart (ctrl/mpc_manifold.py), never in the
    rank-deficient ambient quaternion coordinates.
    """
    from reak_tpu.ctrl.invariant import quat_state_retraction, vector_retraction

    if spec.has_free_base:
        return quat_state_retraction(3, spec.nq + spec.nv, 2 * spec.nv)
    return vector_retraction(2 * spec.nv)


def linearize_fd(spec: ChainSpec, q, qd, tau=None):
    """Analytic-structure linearization of forward dynamics: returns
    (qdd, ∂q̈/∂e_q, ∂q̈/∂e_q̇, M⁻¹ as a solve closure), where e is the
    2·nv-dim tangent chart of ``state_retraction`` (for a fixed base that is
    just (q, q̇); for a free base the configuration block is [δp, δθ, δq_arm]).

    Key identity:  ∂(M⁻¹(f+τ)) = M⁻¹(∂f − ∂M·q̈), so AD only runs through
    ``dynamics_terms`` (2·nv tangents) and never through the Cholesky solve —
    about 4× smaller trace than jacfwd of forward_dynamics, and one factor
    of M is reused for every right-hand side.
    """
    nv = spec.nv

    if spec.has_free_base:
        ret = state_retraction(spec)
        x0 = jnp.concatenate([q, qd])

        def terms(e):
            x = ret.retract(x0, e)
            return dynamics_terms(spec, x[: spec.nq], x[spec.nq :])

        M, f = dynamics_terms(spec, q, qd)
        dM, df = jax.jacfwd(terms)(jnp.zeros(2 * nv, q.dtype))
    else:

        def terms(x):
            return dynamics_terms(spec, x[:nv], x[nv:])

        x = jnp.concatenate([q, qd])
        M, f = terms(x)
        dM, df = jax.jacfwd(terms)(x)  # dM: (nv, nv, 2nv), df: (nv, 2nv)
    rhs = f if tau is None else f + tau
    L = jnp.linalg.cholesky(M)

    def msolve(b):
        y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)

    qdd = msolve(rhs)
    # ∂q̈/∂x = M⁻¹ (df/∂x − (∂M/∂x) q̈)
    dq_rhs = df - jnp.einsum("ijx,j->ix", dM, qdd)
    dqdd = msolve(dq_rhs)  # (nv, 2nv)
    return qdd, dqdd[:, :nv], dqdd[:, nv:], msolve


# ---------------------------------------------------------------------------
# State packing — the computeStateRate surface (manipulator_model.cpp:292)
# ---------------------------------------------------------------------------


def pack_state(spec: ChainSpec, q, qd):
    return jnp.concatenate([q, qd])


def unpack_state(spec: ChainSpec, x):
    return x[: spec.nq], x[spec.nq :]


def state_rate(spec: ChainSpec, x, tau=None) -> jax.Array:
    """ẋ = [q̇ (quaternion rates for a free base) | q̈]  — the pure-function
    equivalent of manipulator_dynamics_model::computeStateRate
    (ref: manipulator_model.cpp:292-355)."""
    q, qd = unpack_state(spec, x)
    qdd = forward_dynamics(spec, q, qd, tau)
    return jnp.concatenate([config_rate(spec, q, qd), qdd])


def body_frames(spec: ChainSpec, q, qd=None) -> Frame3:
    """Stacked world-frame Frame3 for every body (pose + twist), for geometry
    anchoring and reporting (ref: kte_ext_mappings.hpp:119 frame_storage)."""
    res = fk(spec, q)
    nb = spec.n_joints
    dtype = q.dtype
    if qd is None:
        z = jnp.zeros((nb, 3), dtype)
        return Frame3(res.body_pos, res.body_quat, z, z, z, z)
    Jv, Jw = jacobians(spec, q, res)
    v = Jv @ qd
    w = Jw @ qd
    z = jnp.zeros((nb, 3), dtype)
    return Frame3(res.body_pos, res.body_quat, v, w, z, z)

"""Batch-in-lanes error-state scenario MPC — the free-base batched path.

``ctrl/mpc_manifold.py`` is the generic composition (arbitrary discrete map F +
retraction, AD linearization, batch-FIRST vmap over scenarios).  Its per-
scenario jacfwd through the discrete step and the batch-first Riccati solve
leave the reference's *flagship domain* — the free-base satellite/airship
chaser-target pipeline (ref: estimate_satellite3D.cpp, CRS_planner_dynexec.cpp)
— far off the fixed-base arm's batched path.  This module re-expresses the
SAME SQP-on-manifold composition with the scenario batch on the LAST axis of
every array:

  * the nominal rollout runs the EXACT invariant mid-point step
    (ctrl/ss_systems.satellite3D_imdt) in lanes form — quaternion registers
    (4, B), byte-identical math;
  * the tangent-space LTV comes from the ANALYTIC error-state model of the
    rigid body (right-multiplicative body-frame attitude error — the
    invariant-EKF error kinematics, ctrl/invariant.py:45) + exponential-series
    discretization, instead of per-scenario AD through the step;
  * the box-QP is ctrl/riccati_soa.solve_box_mpc_riccati_soa_fused with
    x_ref = tangent reference errors.

Error-state convention (matches ctrl/ss_systems.sat3D_retraction exactly):
tangent e = [δp (global), δθ (body, right-mult), δv (global), δω (body)],
nominal-relative; the QP decision variable is the ABSOLUTE input sequence, so
c_t = −B_t ū_t keeps the nominal (e ≡ 0 at u = ū) consistent with constant
box bounds — identical conventions to ctrl/mpc_manifold.solve_manifold,
asserted against it in tests/test_manifold_lanes.py.

(ref lineage: satellite dynamics satellite_invar_models.hpp:296
satellite3D_imdt_sys; tracking recursion mat_are_solver.hpp:1449; the
composition itself is new — the reference never builds an MPC.)
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from reak_tpu.ctrl.mpc import MPCProblem
from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused, _mm, _mv
from reak_tpu.ctrl.ss_systems import SatelliteParams
from reak_tpu.math import rot_lanes as rl


# ---------------------------------------------------------------------------
# exact invariant mid-point satellite step, lanes layout
# ---------------------------------------------------------------------------


def sat_step_lanes(params: SatelliteParams, dt: float) -> Callable:
    """``step(x (13, B), u (6, B)) → x' (13, B)`` — byte-identical math to
    ctrl/ss_systems.satellite3D_imdt (invariant mid-point on SE(3)), with the
    scenario batch as the last axis."""
    import numpy as np

    J_np = np.asarray(params.inertia)
    Jinv_np = np.linalg.inv(J_np)

    def step(x, u):
        dtype = x.dtype
        J = jnp.asarray(J_np, dtype)
        Jinv = jnp.asarray(Jinv_np, dtype)
        p, q, v, w = x[0:3], x[3:7], x[7:10], x[10:13]
        fb, tb = u[0:3], u[3:6]

        def wdot(wb):
            Jw = jnp.einsum("ij,jz->iz", J, wb)
            return jnp.einsum("ij,jz->iz", Jinv, tb - rl.cross_l(wb, Jw))

        w_half = w + 0.5 * dt * wdot(w)
        w_half = w + 0.5 * dt * wdot(w_half)
        q_next = rl.qnormalize_l(rl.qmul_l(q, rl.q_exp_l(dt * w_half)))
        w_next = w + dt * wdot(w_half)
        q_half = rl.qmul_l(q, rl.q_exp_l(0.5 * dt * w_half))
        acc = rl.qrot_l(q_half, fb) / params.mass.astype(dtype)
        v_next = v + dt * acc
        p_next = p + dt * v + (0.5 * dt * dt) * acc
        return jnp.concatenate([p_next, q_next, v_next, w_next], axis=0)

    return step


# ---------------------------------------------------------------------------
# analytic error-state LTV, lanes layout
# ---------------------------------------------------------------------------


def sat_error_ltv_lanes(params: SatelliteParams, dt: float,
                        order: int = 4) -> Callable:
    """``ltv(x (13, B), u (6, B)) → (A_d (12,12,B), B_d (12,6,B),
    c_d (12,B))`` — one step of the tangent-space LTV model about (x, u).

    Continuous error dynamics of the free rigid body in the [δp, δθ, δv, δω]
    chart (right-multiplicative attitude error, the invariant-EKF error
    kinematics — same chart as sat3D_retraction):

        δṗ = δv
        δθ̇ = −ω̄ × δθ + δω
        δv̇ = −(1/m) R̄ [f̄_b]× δθ + (1/m) R̄ δf
        δω̇ = J⁻¹([Jω̄]× − [ω̄]× J) δω + J⁻¹ δτ

    then S = Σ_{k=1..order} dtᵏ A^{k-1}/k!,  A_d = I + A S,  B_d = S B,
    c_d = −B_d ū (absolute-input decision variable; nominal error rate 0) —
    the same recipe as ctrl/systems.kte_manifold_ltv_linearizer, in lanes
    form with no AD.
    """
    import numpy as np

    J_np = np.asarray(params.inertia)
    Jinv_np = np.linalg.inv(J_np)
    inv_m = 1.0 / float(np.asarray(params.mass))

    def ltv(x, u):
        dtype = x.dtype
        batch = x.shape[1:]
        J = jnp.asarray(J_np, dtype)
        Jinv = jnp.asarray(Jinv_np, dtype)
        q, w0 = x[3:7], x[10:13]
        fb, tb = u[0:3], u[3:6]

        # freeze A about the step MIDPOINT (the same w_half/q_half the imdt
        # integrator uses): a frozen-coefficient exponential series matches
        # the time-varying error flow to 2nd order only when evaluated at
        # the midpoint (Magnus), which is what keeps the SQP fixed point
        # within ~1e-3 of the AD-linearized one at dt = 0.1
        def wdot(wb):
            Jwb = jnp.einsum("ij,jz->iz", J, wb)
            return jnp.einsum("ij,jz->iz", Jinv, tb - rl.cross_l(wb, Jwb))

        w_half = w0 + 0.5 * dt * wdot(w0)
        w_half = w0 + 0.5 * dt * wdot(w_half)
        w = w_half
        q = rl.qmul_l(q, rl.q_exp_l(0.5 * dt * w_half))

        R = rl.q_to_matrix_l(q)                      # (3, 3, B)
        wx = rl.skew_l(w)                            # (3, 3, B)
        Jw = jnp.einsum("ij,jz->iz", J, w)
        # d(−ω×Jω)/dω = [Jω̄]× − [ω̄]× J
        Aww = jnp.einsum("ij,jkz->ikz",
                         Jinv, rl.skew_l(Jw) - jnp.einsum(
                             "ijz,jk->ikz", wx, J))  # (3, 3, B)
        Avth = -inv_m * _mm(R, rl.skew_l(fb))        # (3, 3, B)

        zero3 = jnp.zeros((3, 3) + batch, dtype)
        eye3 = jnp.broadcast_to(
            jnp.eye(3, dtype=dtype)[:, :, None], (3, 3) + batch)
        # A_c rows: [δp | δθ | δv | δω]
        A_c = jnp.concatenate([
            jnp.concatenate([zero3, zero3, eye3, zero3], axis=1),
            jnp.concatenate([zero3, -wx, zero3, eye3], axis=1),
            jnp.concatenate([zero3, Avth, zero3, zero3], axis=1),
            jnp.concatenate([zero3, zero3, zero3, Aww], axis=1),
        ], axis=0)                                   # (12, 12, B)
        Rm = inv_m * R
        Jinv_b = jnp.broadcast_to(Jinv[:, :, None], (3, 3) + batch)
        B_c = jnp.concatenate([
            jnp.concatenate([zero3, zero3], axis=1),
            jnp.concatenate([zero3, zero3], axis=1),
            jnp.concatenate([Rm, zero3], axis=1),
            jnp.concatenate([zero3, Jinv_b], axis=1),
        ], axis=0)                                   # (12, 6, B)

        eye_d = jnp.eye(12, dtype=dtype)[:, :, None]
        S = eye_d * dt
        term = eye_d * dt
        for k in range(2, order + 1):
            term = (dt / k) * _mm(A_c, term)
            S = S + term
        A_d = eye_d + _mm(A_c, S)
        B_d = _mm(S, B_c)
        c_d = -_mv(B_d, u)
        return A_d, B_d, c_d

    return ltv


def quat_local_lanes(x1, x0, qi: int = 3):
    """Lanes-form ``ret.local``: tangent taking x0 to x1 for states embedding
    a unit quaternion at state rows [qi, qi+4) — (..., S, B), (..., S, B) →
    (..., S−1, B), components on axis -2.
    Matches ctrl/invariant.quat_state_retraction.local exactly."""
    dq = rl.qmul_l(rl.qconj_l(x0[..., qi:qi + 4, :]), x1[..., qi:qi + 4, :])
    dth = rl.q_log_l(dq)
    return jnp.concatenate(
        [x1[..., :qi, :] - x0[..., :qi, :], dth,
         x1[..., qi + 4:, :] - x0[..., qi + 4:, :]], axis=-2)


# ---------------------------------------------------------------------------
# the SQP-on-manifold scenario solver, lanes end to end
# ---------------------------------------------------------------------------


def make_scenario_mpc_lanes(
    step: Callable,
    ltv: Callable,
    problem: MPCProblem,
    tangent_dim: int = 12,
    quat_index: int = 3,
    qp_iters: int = 8,
    sqp_iters: int = 2,
    sqp_linesearch: bool = False,
):
    """Lanes-layout belief-scenario MPC driver.

    ``step``/``ltv``: lanes-form nominal step and tangent LTV (e.g.
    sat_step_lanes / sat_error_ltv_lanes).  Same contract as
    ctrl/mpc_manifold.make_scenario_mpc: ``solve(x0s (B, S), x_ref (S,) or
    (H, S), us_init (B, H, m)) → (us (B, H, m), xs (B, H, S))`` — wrap in
    jax.jit.  Internally everything runs batch-LAST.

    ``sqp_linesearch``: per-scenario backtracking over α ∈ {1, ½, ¼} on the
    true manifold tracking cost (one exact nominal rollout per candidate) —
    the full-step SQP globalization; off by default (the bench satellite
    config is stable without it).
    """
    Hh = problem.horizon
    m = problem.R.shape[-1]
    d = tangent_dim

    def rollout(x, us_l):
        # x (S, B), us_l (H, m, B) → xs (H, S, B), xs_prev (H, S, B)
        def body(xc, u_t):
            x1 = step(xc, u_t)
            return x1, (xc, x1)

        _, (xs_prev, xs) = jax.lax.scan(body, x, us_l)
        return xs_prev, xs

    def traj_cost(x_l, u_l, xr_l):
        """True manifold tracking cost per scenario (B,)."""
        _, xs = rollout(x_l, u_l)
        e = quat_local_lanes(jnp.broadcast_to(xr_l, xs.shape), xs,
                             qi=quat_index)
        qx = jnp.einsum("hib,ij,hjb->b", e[:-1], problem.Q, e[:-1])
        qn = jnp.einsum("ib,ij,jb->b", e[-1], problem.QN, e[-1])
        ru = jnp.einsum("hib,ij,hjb->b", u_l, problem.R, u_l)
        cost = 0.5 * (qx + qn + ru)
        return jnp.where(jnp.isfinite(cost), cost, jnp.inf)

    def solve(x0s, x_ref, us_init):
        x_l = x0s.T                                   # (S, B)
        u_l = jnp.moveaxis(us_init, 0, -1)            # (H, m, B)
        x_ref_b = jnp.broadcast_to(x_ref, (Hh,) + x_ref.shape[-1:])
        xr_l = x_ref_b[..., None]                     # (H, S, 1)
        e0 = jnp.zeros_like(x_l[:d])  # carries x_l's mesh axes (shard_map)

        xs = None
        for _ in range(sqp_iters):
            xs_prev, xs = rollout(x_l, u_l)

            def lin_body(_, inp):
                xp, ut = inp
                return None, ltv(xp, ut)

            _, (A_seq, B_seq, c_seq) = jax.lax.scan(
                lin_body, None, (xs_prev, u_l))
            # target as tangent errors about the nominal: e_ref_t =
            # local(x_ref, x̄_t) over the H tracked states x_1..x_H
            e_ref = quat_local_lanes(
                jnp.broadcast_to(xr_l, xs.shape), xs, qi=quat_index)
            u_new, _ = solve_box_mpc_riccati_soa_fused(
                A_seq, B_seq, c_seq, problem.Q, problem.QN, problem.R,
                e0, problem.u_min, problem.u_max, x_ref=e_ref,
                iters=qp_iters)
            if sqp_linesearch and sqp_iters > 1:
                best_u = u_l
                best_J = traj_cost(x_l, u_l, xr_l)
                for alpha in (1.0, 0.5, 0.25):
                    u_a = u_l + alpha * (u_new - u_l)
                    J_a = traj_cost(x_l, u_a, xr_l)
                    take = J_a < best_J
                    best_J = jnp.where(take, J_a, best_J)
                    best_u = jnp.where(take[None, None, :], u_a, best_u)
                u_l = best_u
            else:
                u_l = u_new

        _, xs = rollout(x_l, u_l)
        return jnp.moveaxis(u_l, -1, 0), jnp.moveaxis(xs, -1, 0)

    return solve


def make_sat_scenario_mpc_lanes(params: SatelliteParams, problem: MPCProblem,
                                dt: float, qp_iters: int = 8,
                                sqp_iters: int = 2):
    """The free-base satellite entry point: error-state scenario
    MPC, lanes end to end (drop-in for ctrl/mpc_manifold.make_scenario_mpc
    with F = satellite3D_imdt, ret = sat3D_retraction)."""
    return make_scenario_mpc_lanes(
        sat_step_lanes(params, dt), sat_error_ltv_lanes(params, dt),
        problem, tangent_dim=12, quat_index=3, qp_iters=qp_iters,
        sqp_iters=sqp_iters)

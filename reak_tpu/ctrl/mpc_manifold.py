"""Error-state (retraction-based) MPC on manifold state spaces.

BASELINE config 4 composition: "Free-joint floating base (satellite/airship,
quaternion frames) with EKF/UKF belief-sampled scenario MPC".  The reference
never composes an MPC at all — its ingredients are the invariant satellite
systems (ref: ss_systems/satellite_invar_models.hpp:296 satellite3D_imdt_sys),
Gaussian belief sampling (ref: ctrl_sys/gaussian_belief_state.hpp:491
sample_gaussian_point) and the belief predictor
(ref: ctrl_sys/belief_state_predictor.hpp:79).  Here they compose into one
JAX-native pipeline:

    IEKF posterior belief  →  tangent-space scenario sampling (fold_in keys)
    →  per-scenario error-state LTV linearization along a nominal rollout
    →  batched Riccati interior-point box-QP  (all vmapped under one jit)

Why error-state: a quaternion state x ∈ R^13 lives on a 12-dim manifold; a
naive LTV in ambient coordinates makes the QP rank-deficient along the
quaternion-norm direction and drifts off the unit sphere.  Instead the QP
decision stays the absolute input sequence while the *state* is the tangent
error  e_t = local(x_t, x̄_t) ∈ R^d  around the nominal rollout x̄ — the same
6-DoF-per-body tangent parameterization the IEKF uses (ctrl/invariant.py:45
quat_state_retraction).  Along its own nominal the error dynamics are exactly

    e_{t+1} = A_t e_t + B_t (u_t − ū_t),   e_0 = 0,

so with c_t = −B_t ū_t the existing LTV solver (ctrl/riccati.py) applies
unchanged, and ``sqp_iters > 1`` re-linearizes about the updated nominal
(real-time-iteration SQP on the manifold).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.ctrl.invariant import Retraction
from reak_tpu.ctrl.mpc import MPCProblem
from reak_tpu.ctrl.riccati import solve_box_mpc_riccati


class ManifoldMPCSolution(NamedTuple):
    u: jax.Array   # (H, m) absolute optimal inputs
    x: jax.Array   # (H, n_state) predicted manifold states (retracted)
    e: jax.Array   # (H, d) predicted tangent errors about the final nominal


def rollout_manifold(F: Callable, x0, u_seq):
    """Nominal rollout of the (manifold-respecting) discrete dynamics F —
    returns x_1..x_H stacked (H, n_state)."""

    def body(x, u):
        x1 = F(x, u)
        return x1, x1

    _, xs = jax.lax.scan(body, x0, u_seq)
    return xs


def linearize_ltv_manifold(F: Callable, ret: Retraction, xs_prev, us, xs_next):
    """Tangent-space LTV models along a nominal trajectory:

        A_t = ∂/∂e  local(F(retract(x̄_t, e), ū_t), x̄_{t+1}) |_{e=0}
        B_t = ∂/∂δu local(F(x̄_t, ū_t + δu),      x̄_{t+1}) |_{δu=0}

    (AD through the retraction — the same construction the IEKF uses for its
    error-state Jacobians, ctrl/invariant.py iekf_predict.)  Returns
    (A (H,d,d), B (H,d,m)).
    """
    d = ret.dim

    def lin(xp, u, xn):
        zero_e = jnp.zeros(d, xp.dtype)
        zero_u = jnp.zeros_like(u)
        A = jax.jacfwd(lambda e: ret.local(F(ret.retract(xp, e), u), xn))(zero_e)
        B = jax.jacfwd(lambda du: ret.local(F(xp, u + du), xn))(zero_u)
        return A, B

    return jax.vmap(lin)(xs_prev, us, xs_next)


def solve_manifold(
    F: Callable,
    ret: Retraction,
    problem: MPCProblem,
    x0,
    x_ref,
    u_init=None,
    u_ref=None,
    qp_iters: int = 8,
    sqp_iters: int = 2,
    linearizer=None,
) -> ManifoldMPCSolution:
    """One error-state MPC solve tracking a manifold target.

    ``problem.Q/QN`` are (d, d) tangent-space weights (d = ret.dim — e.g. 12
    for one rigid body: [δp, δθ, δv, δw]).  ``x_ref``: target state, one
    (n_state,) point or a (H, n_state) trajectory.  ``linearizer``: optional
    analytic tangent-space LTV ``(xs_prev, us) → (A, B, c)`` (e.g.
    ctrl.systems.kte_manifold_ltv_linearizer — orders of magnitude cheaper to
    compile than AD through the discrete step for free-base KTE chains).
    """
    Hh, m = problem.horizon, problem.R.shape[-1]
    dtype = x0.dtype
    u = jnp.zeros((Hh, m), dtype) if u_init is None else u_init
    x_ref_b = jnp.broadcast_to(x_ref, (Hh,) + x0.shape)

    es = None
    for _ in range(sqp_iters):
        xs = rollout_manifold(F, x0, u)                       # x_1..x_H
        xs_prev = jnp.concatenate([x0[None], xs[:-1]], axis=0)
        if linearizer is not None:
            A_seq, B_seq, c_seq = linearizer(xs_prev, u)
        else:
            A_seq, B_seq = linearize_ltv_manifold(F, ret, xs_prev, u, xs)
            # decision variable is the ABSOLUTE input: c_t = −B_t ū_t keeps
            # the nominal (e ≡ 0 at u = ū) consistent with constant box bounds
            c_seq = -jnp.einsum("tij,tj->ti", B_seq, u)
        # target expressed as tangent errors about the nominal
        e_ref = jax.vmap(ret.local)(x_ref_b, xs)              # (H, d)
        u, es = solve_box_mpc_riccati(
            A_seq, B_seq, c_seq, problem.Q, problem.QN, problem.R,
            jnp.zeros(ret.dim, dtype), problem.u_min, problem.u_max,
            x_ref=e_ref, u_ref=u_ref, iters=qp_iters,
        )

    xs = rollout_manifold(F, x0, u)
    return ManifoldMPCSolution(u=u, x=xs, e=es)


def make_scenario_mpc(
    F: Callable,
    ret: Retraction,
    problem: MPCProblem,
    qp_iters: int = 8,
    sqp_iters: int = 2,
):
    """Batched scenario solver: ``solve(x0s (B, n), x_ref, us_init (B, H, m))
    → (us (B, H, m), xs (B, H, n))``.  vmap over scenarios; wrap in jax.jit.
    This is the generic free-base scenario entry point."""

    def solve_batch(x0s, x_ref, us_init):
        def one(x0, u0):
            sol = solve_manifold(
                F, ret, problem, x0, x_ref, u_init=u0,
                qp_iters=qp_iters, sqp_iters=sqp_iters,
            )
            return sol.u, sol.x

        return jax.vmap(one)(x0s, us_init)

    return solve_batch


def make_kte_scenario_mpc(spec, problem: MPCProblem, dt: float,
                          actuated=None, qp_iters: int = 8,
                          sqp_iters: int = 2):
    """Scenario MPC for ANY KTE chain, routed to the batched fast path:

    * free-base (quaternion) chains → the lanes error-state SQP
      (kte/lanes.make_kte_manifold_lanes + ctrl/manifold_lanes — exact RK4
      nominal, analytic tangent LTV, whole-solve tracking PDIP);
    * fixed-base chains → the flagship lanes pipeline (ctrl/mpc.make_kte_mpc).

    Both return ``solve(x0s (B, n_state), x_ref, us_init (B, H, m))``.
    """
    if spec.has_free_base:
        from reak_tpu.kte.lanes import make_kte_manifold_lanes
        from reak_tpu.ctrl.manifold_lanes import make_scenario_mpc_lanes

        step, ltv = make_kte_manifold_lanes(spec, dt, actuated=actuated)
        return make_scenario_mpc_lanes(
            step, ltv, problem, tangent_dim=2 * spec.nv, quat_index=3,
            qp_iters=qp_iters, sqp_iters=sqp_iters)

    from reak_tpu.ctrl import mpc as _mpc

    solver = _mpc.make_kte_mpc(spec, problem, dt, qp_iters=qp_iters,
                               sqp_iters=sqp_iters)

    def solve(x0s, x_ref, us_init):
        return solver(x0s, us_init, x_ref=x_ref)

    return solve


def sample_belief_states(
    key, belief: GaussianBelief, n: int, ret: Optional[Retraction] = None
):
    """Draw n initial-state scenarios from a (possibly manifold) belief.

    With a retraction the covariance lives in the tangent space (the IEKF
    posterior convention) and samples are retracted onto the manifold, so
    quaternions stay unit-norm (ref: gaussian_belief_state.hpp:491 — the
    reference samples in ambient coordinates; tangent sampling is the
    manifold-correct upgrade).  Per-scenario fold_in keys keep the draw
    mesh-shape invariant (SURVEY §7 determinism).
    """
    dim = ret.dim if ret is not None else belief.mean.shape[-1]
    L = jnp.linalg.cholesky(
        belief.cov + 1e-12 * jnp.eye(dim, dtype=belief.cov.dtype))

    def one(i):
        k = jax.random.fold_in(key, i)
        e = L @ jax.random.normal(k, (dim,), belief.mean.dtype)
        if ret is None:
            return belief.mean + e
        return ret.retract(belief.mean, e)

    return jax.vmap(one)(jnp.arange(n))


def belief_scenario_mpc(
    key,
    F: Callable,
    ret: Retraction,
    problem: MPCProblem,
    belief: GaussianBelief,
    n_scenarios: int,
    x_ref,
    qp_iters: int = 8,
    sqp_iters: int = 2,
):
    """The full config-4 composition in one call: sample ``n_scenarios``
    initial states from the belief, solve the error-state MPC for each, and
    return (x0s, us, xs).  Jit-compatible (static n)."""
    x0s = sample_belief_states(key, belief, n_scenarios, ret)
    m = problem.R.shape[-1]
    us0 = jnp.zeros((n_scenarios, problem.horizon, m), belief.mean.dtype)
    solver = make_scenario_mpc(F, ret, problem, qp_iters, sqp_iters)
    us, xs = solver(x0s, x_ref, us0)
    return x0s, us, xs

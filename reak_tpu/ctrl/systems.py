"""State-space systems: linearization, discretization, generic LTI/LTV types.

JAX-native replacement for the reference's concept-driven system templates
(ref: ctrl/ctrl_sys/state_space_sys_concept.hpp:112, discrete_sss_concept.hpp,
linear_ss_system_concept.hpp:189, lti_ss_system.hpp:54, lti_discrete_sys.hpp,
discretized_lti_sys.hpp:64, num_int_dtnl_system.hpp:55).

A "system" here is just a pair of pure functions; the concept checks collapse
into function signatures:

- continuous: ``f(x, u, t) → ẋ``
- discrete:   ``F(x, u, t) → x⁺``

Helpers produce linearizations (A, B) by forward-mode AD — replacing the
hand-written ``get_state_transition_blocks`` of each reference model — and
exact LTI discretization via the matrix exponential (the reference's
``discretized_lti_sys``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.math.linalg import expm_pade


class LinearModel(NamedTuple):
    """x⁺ ≈ A x + B u + c  (or ẋ for continuous)."""

    A: jax.Array
    B: jax.Array
    c: jax.Array


def linearize(f: Callable, x, u, t=0.0) -> LinearModel:
    """Jacobian linearization of ``f(x, u, t)`` about (x, u) via jacfwd
    (replaces per-model hand Jacobians, e.g. satellite_basic_models.hpp
    get_state_transition_blocks)."""
    A = jax.jacfwd(lambda xx: f(xx, u, t))(x)
    B = jax.jacfwd(lambda uu: f(x, uu, t))(u)
    c = f(x, u, t) - A @ x - B @ u
    return LinearModel(A=A, B=B, c=c)


def discretize_lti(A, B, dt):
    """Exact zero-order-hold discretization via the augmented matrix exponential
    (ref: ctrl/ctrl_sys/discretized_lti_sys.hpp:64)."""
    n, m = A.shape[-1], B.shape[-1]
    dtype = A.dtype
    Z = jnp.zeros(A.shape[:-2] + (m, n + m), dtype)
    M = jnp.concatenate([jnp.concatenate([A, B], axis=-1), Z], axis=-2) * dt
    E = expm_pade(M)
    return E[..., :n, :n], E[..., :n, n:]


def discretize_series(A, B, f0, x, u, dt, order: int = 4) -> LinearModel:
    """Series discretization of a continuous linear model (A, B, affine rate
    f0 = f(x, u)) about the nominal (x, u):

        S   = Σ_{k=1..order} dtᵏ A^{k-1} / k!
        A_d = I + A·S,   B_d = S·B,   c_d = x + S·f0 − A_d x − B_d u

    order=4 reproduces RK4-on-LTI exactly, so pairing this with an RK4
    nominal rollout keeps the condensed MPC model consistent to O(dt⁵).
    """
    n = x.shape[-1]
    eye = jnp.eye(n, dtype=x.dtype)
    S = eye * dt
    term = eye * dt
    for k in range(2, order + 1):
        term = (dt / k) * (A @ term)
        S = S + term
    Ad = eye + A @ S
    Bd = S @ B
    cd = x + S @ f0 - Ad @ x - Bd @ u
    return LinearModel(A=Ad, B=Bd, c=cd)


def linearize_discrete_series(f: Callable, x, u, dt, order: int = 4, t=0.0) -> LinearModel:
    """Discrete linearization of the flow of ẋ = f(x, u) over one step from ONE
    continuous jacfwd + the exponential series — the compile-cheap replacement
    for AD through all four RK stages."""
    A = jax.jacfwd(lambda xx: f(xx, u, t))(x)
    B = jax.jacfwd(lambda uu: f(x, uu, t))(u)
    f0 = f(x, u, t)
    return discretize_series(A, B, f0, x, u, dt, order)


def kte_ltv_linearizer(spec, dt: float, actuated=None, order: int = 4) -> Callable:
    """Compile-cheap LTV linearizer for fixed-base KTE chains, for MPC:
    ``linearizer(xs, us) → (A_d, B_d, c_d)`` stacked per horizon step.

    Uses the analytic forward-dynamics derivative (kte.dynamics.linearize_fd —
    AD stops at (M, f); ∂q̈/∂u = M⁻¹S analytically) + exponential-series
    discretization.  Much cheaper to trace/compile than jacfwd through RK4.
    """
    from reak_tpu.kte.dynamics import linearize_fd

    def lin_one(x, u):
        nvs = x.shape[-1] // 2
        q, qd = x[:nvs], x[nvs:]
        tau = u if actuated is None else actuated @ u
        qdd, dq, dqd, msolve = linearize_fd(spec, q, qd, tau)
        zero = jnp.zeros((nvs, nvs), x.dtype)
        eye = jnp.eye(nvs, dtype=x.dtype)
        A = jnp.block([[zero, eye], [dq, dqd]])
        Minv_S = msolve(eye if actuated is None else actuated)
        B = jnp.concatenate([jnp.zeros_like(Minv_S), Minv_S], axis=0)
        f0 = jnp.concatenate([qd, qdd])
        m = discretize_series(A, B, f0, x, u, dt, order)
        return m.A, m.B, m.c

    def linearizer(xs, us):
        # scan over the horizon (not vmap): under an outer scenario-vmap this
        # becomes scan-of-batched-steps, keeping live jacfwd intermediates
        # bounded by ONE step instead of H× (H× materialization runs out of
        # memory at large scenario batches)
        def body(_, xu):
            return None, lin_one(*xu)

        _, (A, B, c) = jax.lax.scan(body, None, (xs, us))
        return A, B, c

    return linearizer


def kte_manifold_ltv_linearizer(spec, dt: float, actuated=None,
                                order: int = 4) -> Callable:
    """Compile-cheap error-state LTV linearizer for FREE-BASE KTE chains.

    Works in the tangent chart of ``kte.dynamics.state_retraction``:
    e = [δp, δθ, δq_arm | δv].  Continuous error dynamics around the nominal:

        δṗ = δv_base_lin            (base position rate is v[0:3] exactly)
        δθ̇ = δω − ω̄ × δθ          (right-multiplicative quaternion error,
                                     body-frame rates — the invariant-EKF
                                     error kinematics)
        δq̇_arm = δv_arm
        δv̇  = (∂q̈/∂e_c) δc + (∂q̈/∂e_v) δv + M⁻¹ S_u δu

    with the bottom row from the analytic ``linearize_fd`` (AD stops at the
    dynamics terms) and exponential-series discretization — the same recipe as
    ``kte_ltv_linearizer`` but manifold-correct, so AD never traces through
    RK4 stages (whose jacfwd on a 25-state free-base chain takes minutes of
    XLA compile).  Decision variable is the ABSOLUTE input: c_d = −B_d ū.

    Returns ``linearizer(xs (H, nq+nv), us (H, nu)) → (A (H,2nv,2nv),
    B (H,2nv,nu), c (H,2nv))`` for ctrl.mpc_manifold.solve_manifold.
    """
    from reak_tpu.kte.dynamics import linearize_fd
    import reak_tpu.math.rotations as rot_mod  # noqa: F401  (chart docs)

    nv = spec.nv
    nq = spec.nq

    def lin_one(x, u):
        q, qd = x[:nq], x[nq:]
        tau = u if actuated is None else actuated @ u
        qdd, dq, dqd, msolve = linearize_fd(spec, q, qd, tau)
        dtype = x.dtype
        eye = jnp.eye(nv, dtype=dtype)
        S = jnp.zeros((nv, nv), dtype)
        if spec.has_free_base:
            w = qd[3:6]  # nominal body angular rate
            wx = jnp.array([[0.0, -w[2], w[1]],
                            [w[2], 0.0, -w[0]],
                            [-w[1], w[0], 0.0]], dtype)
            S = S.at[3:6, 3:6].set(-wx)
        A = jnp.block([[S, eye], [dq, dqd]])
        nu = u.shape[-1]
        Minv_S = msolve(eye if actuated is None else actuated)
        B = jnp.concatenate(
            [jnp.zeros((nv, nu), dtype), Minv_S[:, :nu]], axis=0)
        # series discretization of the error flow; affine term −B_d ū keeps
        # the nominal consistent with absolute-input decision variables
        zero = jnp.zeros(2 * nv, dtype)
        md = discretize_series(A, B, zero, zero, u, dt, order)
        return md.A, md.B, md.c  # md.c = −B_d ū exactly (nominal error rate 0)

    def linearizer(xs, us):
        def body(_, xu):
            return None, lin_one(*xu)

        _, (A, B, c) = jax.lax.scan(body, None, (xs, us))
        return A, B, c

    return linearizer


def rk4_discrete(f: Callable, dt: float) -> Callable:
    """Wrap a continuous system into a one-step discrete map with RK4
    (ref: ctrl/ctrl_sys/num_int_dtnl_system.hpp:55 num_int_dtnl_sys)."""

    def F(x, u, t=0.0):
        k1 = f(x, u, t)
        k2 = f(x + 0.5 * dt * k1, u, t + 0.5 * dt)
        k3 = f(x + 0.5 * dt * k2, u, t + 0.5 * dt)
        k4 = f(x + dt * k3, u, t + dt)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    return F


def euler_discrete(f: Callable, dt: float) -> Callable:
    def F(x, u, t=0.0):
        return x + dt * f(x, u, t)

    return F


def semi_implicit_kte(spec, dt: float, actuated=None) -> Callable:
    """Linearly-implicit (IMEX) one-step map for STIFF KTE chains —
    flexible beams and other high-stiffness joint-spring chains
    (ref: flexible_beam.hpp:52 element; stepping strategy is new, JAX-native:
    unconditional stability for the linear spring/damper part at any dt,
    explicit treatment of the slow nonlinear terms).

        (M + dt·D + dt²·K) v⁺ = M v + dt(f_ex + τ − K(q_e − q_rest))
        q⁺ = q ⊕ dt·v⁺

    with K = diag(joint stiffness), D = diag(joint damping) handled backward-
    Euler, and f_ex the remaining (gravity/Coriolis/friction) forces explicit.
    One PD solve per step — same cost class as one RK4 stage.

    Free-base chains (floating flexible structures — a free-flying platform
    with stiff appendages, the Canadarm/SSRMS regime) are supported: the
    free dofs carry no passive elements (zero K/D rows) and the
    configuration advance ⊕ integrates the base quaternion by its rate and
    renormalizes (kte.dynamics.config_rate semantics).
    """
    from reak_tpu.kte.dynamics import config_rate, dynamics_terms
    from reak_tpu.kte.spec import JointType, REVOLUTE, PRISMATIC, FREE
    from reak_tpu.math.linalg import solve_pd
    import numpy as np

    nv = spec.nv
    nq = spec.nq
    # per-velocity-dof passive constants (zeros on FREE dofs) + the config
    # row holding each 1-dof joint's coordinate
    k_np = np.zeros(nv)
    d_np = np.zeros(nv)
    rq_np = np.zeros(nv)
    qsel_np = np.zeros(nv, np.int32)
    ci = vi = 0
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt == FREE:
            ci += 7
            vi += 6
            continue
        if jt in (REVOLUTE, PRISMATIC):
            k_np[vi] = spec.stiffness[i]
            d_np[vi] = spec.damping[i]
            rq_np[vi] = spec.rest_q[i]
            qsel_np[vi] = ci
            ci += 1
            vi += 1

    def F(x, u, t=0.0):
        dtype = x.dtype
        k = jnp.asarray(k_np, dtype)
        d = jnp.asarray(d_np, dtype)
        rq = jnp.asarray(rq_np, dtype)
        q, v = x[:nq], x[nq:]
        e = q[jnp.asarray(qsel_np)] - rq      # joint coordinate errors
        M, f = dynamics_terms(spec, q, v)     # f includes −K e − D v
        f_ex = f + k * e + d * v
        tau = u if actuated is None else actuated @ u
        A = M + dt * jnp.diag(d) + dt * dt * jnp.diag(k)
        rhs = M @ v + dt * (f_ex + tau - k * e)
        v1 = solve_pd(A, rhs)
        q1 = q + dt * config_rate(spec, q, v1)
        if spec.has_free_base:
            quat = q1[3:7]
            q1 = q1.at[3:7].set(quat / jnp.linalg.norm(quat))
        return jnp.concatenate([q1, v1])

    return F


def lti_continuous(A, B) -> Callable:
    """ẋ = A x + B u (ref: lti_ss_system.hpp:54)."""

    def f(x, u, t=0.0):
        return A @ x + B @ u

    return f


def lti_discrete(A, B) -> Callable:
    """x⁺ = A x + B u (ref: lti_discrete_sys.hpp)."""

    def F(x, u, t=0.0):
        return A @ x + B @ u

    return F


def kte_discrete(spec, dt: float, actuated=None) -> Callable:
    """One-step RK4 map for a KTE chain that respects the configuration
    manifold: for a free-base chain the base quaternion q[3:7] is renormalized
    after the step (the reference keeps quaternions unit via its frame algebra,
    frame_3D.hpp; under RK4 in ambient coordinates the norm drifts O(dt⁵)).
    Pair with ``kte.dynamics.state_retraction`` for error-state MPC
    (ctrl/mpc_manifold.py) on floating-base chains."""
    F = rk4_discrete(kte_continuous(spec, actuated), dt)
    if not spec.has_free_base:
        return F

    def F_renorm(x, u, t=0.0):
        x1 = F(x, u, t)
        q = x1[..., 3:7]
        q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
        return jnp.concatenate([x1[..., 0:3], q, x1[..., 7:]], axis=-1)

    return F_renorm


def kte_continuous(spec, actuated=None) -> Callable:
    """Continuous system from a KTE chain: x = [q, qd], u = joint torques
    (ref: ctrl/ctrl_sys/kte_nl_system.hpp:67 kte_nl_system).

    ``actuated``: optional (nv, nu) selection matrix mapping inputs to
    generalized forces (defaults to identity — fully actuated).
    """
    from reak_tpu import kte as _kte

    def f(x, u, t=0.0):
        tau = u if actuated is None else actuated @ u
        return _kte.state_rate(spec, x, tau)

    return f

"""QP and MPC correctness (parity model: ref core/optimization test_qp.cpp and
the BASELINE north-star MPC configs)."""
import pytest
import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.ctrl import qp, mpc, systems
from reak_tpu.math import are


def rand_qp(rng, n):
    A = rng.standard_normal((n, n))
    H = A @ A.T + n * np.eye(n)
    g = rng.standard_normal(n)
    return jnp.asarray(H), jnp.asarray(g)


def _box_qp_ref(H, g, lb, ub, iters=3000):
    """Projected gradient reference solution (slow, convergent)."""
    H, g, lb, ub = map(np.asarray, (H, g, lb, ub))
    L = np.linalg.eigvalsh(H).max()
    x = np.clip(np.zeros_like(g), lb, ub)
    y, t = x.copy(), 1.0
    for _ in range(iters):
        x_new = np.clip(y - (H @ y + g) / L, lb, ub)
        t_new = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        y = x_new + (t - 1) / t_new * (x_new - x)
        x, t = x_new, t_new
    return x


def test_box_qp_unconstrained_interior(rng):
    H, g = rand_qp(rng, 8)
    x_star = -np.linalg.solve(np.asarray(H), np.asarray(g))
    big = np.max(np.abs(x_star)) * 10
    lb, ub = jnp.full(8, -big), jnp.full(8, big)
    res = qp.solve_box_qp(H, g, lb, ub, iters=20)
    np.testing.assert_allclose(res.x, x_star, atol=1e-7)


def test_box_qp_active_constraints(rng):
    for trial in range(5):
        H, g = rand_qp(rng, 10)
        lb = jnp.full(10, -0.1)
        ub = jnp.full(10, 0.1)
        res = qp.solve_box_qp(H, g, lb, ub, iters=25)
        x_ref = _box_qp_ref(H, g, lb, ub)
        np.testing.assert_allclose(res.x, x_ref, atol=1e-6)


def test_box_qp_vmapped(rng):
    n, batch = 6, 16
    Hs, gs = [], []
    for _ in range(batch):
        H, g = rand_qp(rng, n)
        Hs.append(H)
        gs.append(g)
    Hs, gs = jnp.stack(Hs), jnp.stack(gs)
    lb, ub = jnp.full(n, -0.5), jnp.full(n, 0.5)
    sol = jax.jit(jax.vmap(lambda H, g: qp.solve_box_qp(H, g, lb, ub, iters=25).x))(Hs, gs)
    for i in range(0, batch, 5):
        np.testing.assert_allclose(sol[i], _box_qp_ref(Hs[i], gs[i], lb, ub), atol=1e-6)


def test_eq_qp(rng):
    n, m = 8, 3
    H, g = rand_qp(rng, n)
    A = jnp.asarray(rng.standard_normal((m, n)))
    b = jnp.asarray(rng.standard_normal(m))
    x, lam = qp.solve_eq_qp(H, g, A, b)
    np.testing.assert_allclose(A @ x, b, atol=1e-8)
    # KKT stationarity
    np.testing.assert_allclose(H @ x + g + A.T @ lam, 0.0, atol=1e-6)


def test_projected_gradient_qp(rng):
    H, g = rand_qp(rng, 6)
    lb, ub = jnp.full(6, -0.2), jnp.full(6, 0.2)
    res = qp.solve_box_qp_pg(H, g, lb, ub, iters=500)
    x_ref = _box_qp_ref(H, g, lb, ub)
    np.testing.assert_allclose(res.x, x_ref, atol=1e-4)


# ---------------------------------------------------------------------------
# MPC
# ---------------------------------------------------------------------------


def _double_integrator(dt=0.1):
    A = jnp.array([[1.0, dt], [0.0, 1.0]])
    B = jnp.array([[0.5 * dt * dt], [dt]])
    return A, B


def test_mpc_matches_lqr_unconstrained():
    """Long-horizon unconstrained MPC first input ≈ infinite-horizon LQR."""
    A, B = _double_integrator()
    F = systems.lti_discrete(A, B)
    Q = jnp.eye(2)
    R = jnp.eye(1) * 0.1
    K, P = are.dlqr(A, B, Q, R)
    prob = mpc.MPCProblem(
        Q=Q, R=R, QN=P, u_min=jnp.array([-1e6]), u_max=jnp.array([1e6]), horizon=20
    )
    x0 = jnp.array([1.0, -0.5])
    sol = mpc.solve(F, prob, x0, constrained=False)
    u_lqr = -(K @ x0)
    np.testing.assert_allclose(sol.u[0], u_lqr, atol=1e-8)


def test_mpc_condensation_consistency():
    """Predicted states from condensation must match rolling the linear model."""
    A, B = _double_integrator()
    F = systems.lti_discrete(A, B)
    H = 15
    rng = np.random.default_rng(1)
    us = jnp.asarray(rng.standard_normal((H, 1)))
    x0 = jnp.array([0.3, 0.1])
    xs = mpc.rollout_nominal(F, x0, us)
    A_seq, B_seq, c_seq = mpc.linearize_ltv(
        F, jnp.concatenate([x0[None], xs[:-1]]), us
    )
    Sx, Su, d = mpc.condense(A_seq, B_seq, c_seq, x0)
    X = (Sx @ x0 + Su @ us.ravel() + d).reshape(H, 2)
    np.testing.assert_allclose(X, xs, atol=1e-10)


def test_mpc_respects_bounds():
    A, B = _double_integrator()
    F = systems.lti_discrete(A, B)
    Q = jnp.eye(2)
    R = jnp.eye(1) * 0.01
    prob = mpc.MPCProblem(
        Q=Q, R=R, QN=Q, u_min=jnp.array([-0.3]), u_max=jnp.array([0.3]), horizon=25
    )
    sol = mpc.solve(F, prob, jnp.array([2.0, 0.0]), qp_iters=20)
    assert float(jnp.max(jnp.abs(sol.u))) <= 0.3 + 1e-9
    # saturation expected at the start for this far initial state
    assert float(jnp.abs(sol.u[0, 0])) > 0.29


def test_mpc_receding_horizon_stabilizes():
    A, B = _double_integrator()
    F = systems.lti_discrete(A, B)
    prob = mpc.MPCProblem(
        Q=jnp.eye(2),
        R=jnp.eye(1) * 0.1,
        QN=jnp.eye(2) * 10,
        u_min=jnp.array([-2.0]),
        u_max=jnp.array([2.0]),
        horizon=15,
    )
    xs, us = mpc.receding_horizon(F, prob, jnp.array([1.5, 0.0]), 80, qp_iters=12)
    assert float(jnp.linalg.norm(xs[-1])) < 1e-2


@pytest.mark.slow
def test_mpc_nonlinear_pendulum_swingdown():
    """Nonlinear KTE pendulum + SQP MPC drives to hanging equilibrium."""
    from reak_tpu.kte import models

    spec = models.pendulum(length=0.5, mass=1.0, motor_inertia=0.1, gravity=9.81)
    f = systems.kte_continuous(spec)
    F = systems.rk4_discrete(f, 0.05)
    # state [q, qd]; target hanging equilibrium q=-pi/2
    x_tgt = jnp.array([-np.pi / 2, 0.0])
    Fs = lambda x, u, t=0.0: F(x + 0.0, u, t)
    prob = mpc.MPCProblem(
        Q=jnp.diag(jnp.array([10.0, 1.0])),
        R=jnp.eye(1) * 0.05,
        QN=jnp.diag(jnp.array([50.0, 5.0])),
        u_min=jnp.array([-4.0]),
        u_max=jnp.array([4.0]),
        horizon=25,
    )
    H = prob.horizon
    x_ref = jnp.tile(x_tgt, (H, 1))

    def step(carry, _):
        x, u_warm = carry
        sol = mpc.solve(F, prob, x, u_init=u_warm, x_ref=x_ref, sqp_iters=2, qp_iters=12)
        x1 = F(x, sol.u[0])
        warm = jnp.concatenate([sol.u[1:], sol.u[-1:]])
        return (x1, warm), x1

    x0 = jnp.array([0.4, 0.0])
    (xf, _), traj = jax.lax.scan(step, (x0, jnp.zeros((H, 1))), None, length=30)
    err = np.abs(np.asarray(xf) - np.asarray(x_tgt))
    assert err[0] < 2e-2 and err[1] < 5e-2, (xf, x_tgt)


# ---------------------------------------------------------------------------
# BASELINE config 4: free-base belief-sampled scenario MPC
# (ref: satellite_invar_models.hpp:296 + gaussian_belief_state.hpp:491 +
#  belief_state_predictor.hpp:79 — composed natively in JAX in ctrl/mpc_manifold)
# ---------------------------------------------------------------------------


def _sat_setup(H=20, dt=0.1):
    from reak_tpu.ctrl import ss_systems as sss

    params = sss.satellite3D(mass=10.0, inertia=jnp.diag(jnp.array([4.0, 5.0, 6.0])))
    F = sss.satellite3D_imdt(params, dt)
    ret = sss.sat3D_retraction()
    w = jnp.concatenate([jnp.full(6, 10.0), jnp.full(6, 1.0)])
    prob = mpc.MPCProblem(
        Q=jnp.diag(w), R=jnp.eye(6) * 0.05, QN=jnp.diag(10.0 * w),
        u_min=jnp.full(6, -20.0), u_max=jnp.full(6, 20.0), horizon=H,
    )
    return sss, params, F, ret, prob


def test_manifold_mpc_satellite_tracks_pose():
    """Error-state MPC on the quaternion free body reaches a pose target and
    keeps the quaternion exactly unit-norm (the ambient-coordinate LTV would
    drift off the sphere)."""
    from reak_tpu.ctrl import mpc_manifold as mm
    from reak_tpu.math import rotations as rot

    sss, _, F, ret, prob = _sat_setup()
    Fu = lambda x, u: F(x, u)
    x0 = sss.default_state()
    x_ref = sss.default_state().at[0:3].set(jnp.array([1.0, 0.5, -0.3]))
    x_ref = x_ref.at[3:7].set(
        rot.q_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), jnp.asarray(0.6)))

    sol = mm.solve_manifold(Fu, ret, prob, x0, x_ref, qp_iters=8, sqp_iters=2)
    xH = sol.x[-1]
    np.testing.assert_allclose(float(jnp.linalg.norm(xH[3:7])), 1.0, atol=1e-9)
    assert float(jnp.linalg.norm(xH[0:3] - x_ref[0:3])) < 0.1
    dth = rot.q_log(rot.qmul(rot.qconj(x_ref[3:7]), xH[3:7]))
    assert float(jnp.linalg.norm(dth)) < 0.1
    # bounds respected
    assert float(jnp.max(sol.u)) <= float(prob.u_max[0]) + 1e-8
    assert float(jnp.min(sol.u)) >= float(prob.u_min[0]) - 1e-8


def test_scenario_mpc_from_iekf_belief():
    """The full config-4 pipeline: simulate the satellite with noisy pose
    measurements, IEKF the posterior, sample scenario initial states in the
    tangent space, solve the batched error-state MPC — every scenario must
    reach the pose target within tolerance."""
    from reak_tpu.ctrl import mpc_manifold as mm, invariant as inv
    from reak_tpu.ctrl.belief import GaussianBelief
    from reak_tpu.math import rotations as rot

    sss, params, F, ret, prob = _sat_setup()
    Fu = lambda x, u, t=0.0: F(x, u, t)
    rng = np.random.default_rng(7)

    # --- IEKF over a short measured arc (simulation as oracle, SURVEY §4) --
    Q = 1e-6 * jnp.eye(12)
    R = jnp.diag(jnp.concatenate([jnp.full(3, 1e-4), jnp.full(3, 1e-5)]))
    x_true = sss.default_state().at[10:13].set(jnp.array([0.02, -0.01, 0.03]))
    b = GaussianBelief(sss.default_state(), 0.1 * jnp.eye(12))
    u_zero = jnp.zeros(6)
    for _ in range(12):
        x_true = F(x_true, u_zero)
        z = sss.h_pose(x_true)
        z = z.at[0:3].add(jnp.asarray(rng.normal(0, 1e-2, 3)))
        b = inv.iekf_step(Fu, sss.h_pose, ret, b, u_zero, z, Q, R,
                          diff=sss.pose_innovation)

    # posterior concentrates near truth (tangent-space error)
    e_post = ret.local(x_true, b.mean)
    assert float(jnp.linalg.norm(e_post[0:6])) < 0.05

    # --- belief-sampled scenario MPC to a pose target ----------------------
    x_ref = sss.default_state().at[0:3].set(jnp.array([0.5, -0.2, 0.3]))
    key = jax.random.PRNGKey(3)
    x0s, us, xs = mm.belief_scenario_mpc(
        key, Fu, ret, prob, b, 6, x_ref, qp_iters=8, sqp_iters=2)
    assert us.shape == (6, prob.horizon, 6)
    # all sampled quaternions stay unit
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(x0s[:, 3:7]), axis=-1), 1.0, atol=1e-9)
    # every scenario's plan reaches the target pose
    perr = jnp.linalg.norm(xs[:, -1, 0:3] - x_ref[0:3], axis=-1)
    assert float(jnp.max(perr)) < 0.2, perr
    # scenario sampling is invariant to where fold_in keys are evaluated
    x0s_again = mm.sample_belief_states(key, b, 6, ret)
    np.testing.assert_allclose(np.asarray(x0s), np.asarray(x0s_again))

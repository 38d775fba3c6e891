"""Condensed linear(ized) MPC — the north-star workload (BASELINE.md).

There is no MPC in the reference; this engine is the JAX-native composition of
its ingredients (SURVEY.md §7.5): KTE forward dynamics (3.1 call stack) →
jacfwd linearization (replacing hand Jacobians) → condensed QP over the horizon
(mat_are/quadratic_programs recipes) → batched interior-point solve.

Pipeline per scenario (all fused under one jit, vmapped over scenarios):
  1. nominal rollout of the discrete dynamics F(x, u) over horizon H
  2. LTV linearization A_t, B_t along the nominal (one ``vmap``-ed jacfwd)
  3. condensation  x = Sx x0 + Su u + d   (prediction-matrix scan)
  4. QP:  min ½uᵀ(SuᵀQ̄Su + R̄)u + gᵀu  s.t. box bounds  (dense GEMMs)
  5. optional receding-horizon execution via lax.scan
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from reak_tpu.ctrl.qp import solve_box_qp, QPResult
from reak_tpu.math.linalg import solve_pd


class MPCProblem(NamedTuple):
    """Static MPC definition (weights broadcast over the horizon)."""

    Q: jax.Array  # (n, n) state stage cost
    R: jax.Array  # (m, m) input stage cost
    QN: jax.Array  # (n, n) terminal cost
    u_min: jax.Array  # (m,)
    u_max: jax.Array  # (m,)
    horizon: int


class MPCSolution(NamedTuple):
    u: jax.Array  # (H, m) optimal input sequence
    x: jax.Array  # (H, n) predicted states under u (linear model)
    qp: QPResult


def solution_status(sol: MPCSolution, gap_tol: float = 1e-6):
    """Device-side failure flags for an MPC solution (reak_tpu.errors
    bitmask): NONFINITE when the plan blew up, NOT_CONVERGED when the PDIP
    complementarity gap is above tolerance.  The systematic error surface the
    reference provides via exceptions (SURVEY §5.3)."""
    from reak_tpu import errors

    return errors.finite_flag(sol.u, sol.x) | errors.convergence_flag(
        sol.qp.gap, gap_tol
    )


def rollout_nominal(F: Callable, x0, u_seq):
    """Roll the discrete dynamics under a nominal input sequence → (H, n)."""

    def body(x, u):
        x1 = F(x, u)
        return x1, x1

    _, xs = jax.lax.scan(body, x0, u_seq)
    return xs


def linearize_ltv(F: Callable, xs, us):
    """Per-step Jacobians along a trajectory: A_t, B_t, c_t with
    x_{t+1} = A_t x_t + B_t u_t + c_t  (vmapped jacfwd)."""

    def lin(x, u):
        A = jax.jacfwd(lambda xx: F(xx, u))(x)
        B = jax.jacfwd(lambda uu: F(x, uu))(u)
        c = F(x, u) - A @ x - B @ u
        return A, B, c

    return jax.vmap(lin)(xs, us)


def linearize_ltv_series(f_cont: Callable, dt: float, xs, us, order: int = 4):
    """Per-step discrete linearization from the CONTINUOUS dynamics via
    truncated exponential series (one jacfwd per step instead of AD through
    all RK stages — ~4× smaller trace, XLA-CPU-compile friendly).  See
    systems.linearize_discrete_series."""
    from reak_tpu.ctrl.systems import linearize_discrete_series

    def lin(x, u):
        m = linearize_discrete_series(f_cont, x, u, dt, order)
        return m.A, m.B, m.c

    return jax.vmap(lin)(xs, us)


def condense(A_seq, B_seq, c_seq, x0):
    """Prediction matrices:  X = Sx·x0 + Su·U + d.

    X stacks x_1..x_H (H·n), U stacks u_0..u_{H-1} (H·m).
    Built with a scan over the horizon; each step is one (n×n)·(n×Hm) GEMM,
    batched over scenarios via vmap.
    """
    H, n, m = B_seq.shape[0], A_seq.shape[-1], B_seq.shape[-1]
    dtype = A_seq.dtype

    def body(carry, inp):
        phi, dprev = carry  # phi: (n, H·m) accumulated input map, d: (n,)
        A, B, c, t = inp
        # x_{t+1} = A x_t + B u_t + c;  x_t = phi·U + (Sx row)·x0 + d
        phi_new = A @ phi
        phi_new = jax.lax.dynamic_update_slice(phi_new, B, (0, t * m))
        d_new = A @ dprev + c
        return (phi_new, d_new), (phi_new, d_new)

    phi0 = jnp.zeros((n, H * m), dtype)
    d0 = jnp.zeros((n,), dtype)
    ts = jnp.arange(H)
    (_, _), (phis, ds) = jax.lax.scan(body, (phi0, d0), (A_seq, B_seq, c_seq, ts))

    # state-transition products for Sx: Phi_t = A_{t-1}···A_0
    def body2(P, A):
        P1 = A @ P
        return P1, P1

    _, Phis = jax.lax.scan(body2, jnp.eye(n, dtype=dtype), A_seq)

    Su = phis.reshape(H * n, H * m)
    Sx = Phis.reshape(H * n, n)
    d = ds.reshape(H * n)
    return Sx, Su, d


def build_qp(problem: MPCProblem, Sx, Su, d, x0, x_ref=None, u_ref=None):
    """Condensed QP data:  min ½UᵀH_qp U + gᵀU  with box bounds.

    H_qp = SuᵀQ̄Su + R̄,  g = SuᵀQ̄(Sx x0 + d − Xref) − R̄·Uref.
    """
    H, n, m = problem.horizon, problem.Q.shape[-1], problem.R.shape[-1]
    dtype = Su.dtype
    # Q̄ = blockdiag(Q, …, Q, QN): apply as reshape-matmul (no big block matrix)
    free = Sx @ x0 + d  # (H·n,) free response
    if x_ref is not None:
        free = free - x_ref.reshape(H * n)

    def apply_Qbar(X_flat):
        Xs = X_flat.reshape(H, n)
        QX = Xs @ problem.Q.T
        QX = QX.at[-1].set(Xs[-1] @ problem.QN.T)
        return QX.reshape(H * n)

    QSu = jax.vmap(apply_Qbar, in_axes=1, out_axes=1)(Su)  # (H·n, H·m)
    H_qp = Su.T @ QSu
    # add R̄ on the block diagonal
    Rbar = jnp.kron(jnp.eye(H, dtype=dtype), problem.R)
    H_qp = H_qp + Rbar
    g = Su.T @ apply_Qbar(free)
    if u_ref is not None:
        g = g - Rbar @ u_ref.reshape(H * m)
    return H_qp, g


def solve(
    F: Callable,
    problem: MPCProblem,
    x0,
    u_init=None,
    x_ref=None,
    u_ref=None,
    qp_iters: int = 15,
    sqp_iters: int = 1,
    constrained: bool = True,
    f_cont: Optional[Callable] = None,
    dt: Optional[float] = None,
    linearizer: Optional[Callable] = None,
    method: str = "riccati",
) -> MPCSolution:
    """One MPC solve: linearize about a nominal, condense, QP.

    ``sqp_iters > 1`` re-linearizes about the previous solution (real-time
    iteration / SQP refinement) — needed for strongly nonlinear plants.

    If ``f_cont``/``dt`` are given, the LTV models come from the continuous
    dynamics via the exponential-series discretization (much cheaper to
    compile and trace than AD through the discrete RK map; exact for LTI).

    ``method``:
      - "riccati" (default): block-sparse interior point — KKT systems solved
        by Riccati recursion, O(H·(n+m)³).  The fast path.
      - "condensed": dense condensed QP (prediction matrices + PDIP with
        (H·m)³ Cholesky).  Matmul-heavy; useful as cross-check and for short
        horizons.
    """
    Hh, m = problem.horizon, problem.R.shape[-1]
    n = problem.Q.shape[-1]
    dtype = x0.dtype
    u = jnp.zeros((Hh, m), dtype) if u_init is None else u_init
    lb = jnp.tile(problem.u_min, Hh)
    ub = jnp.tile(problem.u_max, Hh)

    qp_res = None
    for _ in range(sqp_iters):
        xs = rollout_nominal(F, x0, u)
        xs_prev = jnp.concatenate([x0[None], xs[:-1]], axis=0)
        if linearizer is not None:
            A_seq, B_seq, c_seq = linearizer(xs_prev, u)
        elif f_cont is not None:
            A_seq, B_seq, c_seq = linearize_ltv_series(f_cont, dt, xs_prev, u)
        else:
            A_seq, B_seq, c_seq = linearize_ltv(F, xs_prev, u)

        if method == "riccati" and constrained:
            from reak_tpu.ctrl.riccati import solve_box_mpc_riccati

            u, xs_pred = solve_box_mpc_riccati(
                A_seq, B_seq, c_seq, problem.Q, problem.QN, problem.R,
                x0, problem.u_min, problem.u_max,
                x_ref=x_ref, u_ref=u_ref, iters=qp_iters,
            )
            qp_res = QPResult(
                x=u.reshape(-1), iters=jnp.asarray(qp_iters), gap=jnp.asarray(0.0, dtype)
            )
        else:
            Sx, Su, d = condense(A_seq, B_seq, c_seq, x0)
            H_qp, g = build_qp(problem, Sx, Su, d, x0, x_ref, u_ref)
            if constrained:
                qp_res = solve_box_qp(H_qp, g, lb, ub, iters=qp_iters)
                U = qp_res.x
            else:
                U = -solve_pd(H_qp, g)
                qp_res = QPResult(x=U, iters=jnp.asarray(0), gap=jnp.asarray(0.0, dtype))
            u = U.reshape(Hh, m)
            xs_pred = (Sx @ x0 + Su @ qp_res.x + d).reshape(Hh, n)

    return MPCSolution(u=u, x=xs_pred, qp=qp_res)


def make_kte_mpc(spec, problem: MPCProblem, dt: float, qp_iters: int = 8,
                 sqp_iters: int = 1, qp_layout: str = "lanes",
                 rollout: str = "lanes", sqp_linesearch: bool = True):
    """Fused batched MPC solver for a fixed-base KTE chain — the batched
    fast path.

    Composes the batch-in-lanes rollout+linearization with the Riccati
    interior-point QP; returns ``solve(x0s (B, 2nv), us_init (B, H, m))
    → (us (B, H, m), xs (B, H, 2nv))``.  Wrap in jax.jit.

    ``rollout``:
      - "lanes" (default): dense-lanes rollout (kte/lanes.py) — identical
        math to the register form but a ~100× smaller HLO graph (seconds
        instead of minutes of XLA compile) and lanes-native output, so the
        LTV models feed the PDIP with zero transposes.
      - "register": the register-form SoA rollout (kte/soa.py); kept as a
        cross-check and for measuring the layout trade-off.

    ``qp_layout``:
      - "lanes" (default): the whole PDIP runs batch-in-lanes
        (ctrl/riccati_soa.py) — every tiny-matrix product is an elementwise
        operation over the scenario batch, with no layout round-trips.
      - "vmap": per-scenario solver under jax.vmap (ctrl/riccati.py) —
        batch-first layout; cross-check path.

    ``sqp_linesearch`` (active only when sqp_iters > 1): per-scenario
    backtracking over α ∈ {1, ½, ¼} on the TRUE nonlinear trajectory cost
    (priced by a cheap RK4 lanes rollout) — the globalization that keeps
    multi-pass SQP from diverging when a QP solution leaves the LTV model's
    validity region (full-step SQP at coarse dt can re-linearize about an
    unstable rollout and NaN).  Costs 3 nominal rollouts per SQP pass;
    the flagship sqp_iters=1 path is unaffected.

    Guarantee and semantics: the accepted sequence's TRUE (RK4) cost is
    never worse than the previous iterate's.  On open-loop-sensitive
    systems at coarse dt, the series-map model's optimum can be genuinely
    WORSE than zero input on the true dynamics — the safeguard then
    (correctly) keeps the conservative iterate; refine dt, or use the
    solver in receding horizon where only u[0] is applied and feedback
    absorbs model drift.  When the line search is active the returned
    trajectory is the true RK4 rollout of the accepted sequence, not the
    QP model's prediction.
    """
    from reak_tpu.kte import lanes, soa
    from reak_tpu.ctrl.riccati import solve_box_mpc_riccati
    from reak_tpu.ctrl.riccati_soa import (solve_box_mpc_riccati_soa,
                                           solve_box_mpc_riccati_soa_fused)

    H = problem.horizon

    if rollout == "lanes" and qp_layout == "lanes":
        roll_l = lanes.make_rollout_ltv_lanes(spec, dt, H)

        def to_lanes(ref, width):
            """(width,) | (H, width) | (B, H, width) reference → lanes."""
            if ref is None:
                return None
            ref = jnp.asarray(ref)
            if ref.ndim == 1:
                return jnp.broadcast_to(ref[None, :, None], (H, width, 1))
            if ref.ndim == 2:
                return ref[..., None]                      # (H, w, 1)
            return jnp.moveaxis(ref, 0, -1)                # (H, w, B)

        roll_nom = (lanes.make_rollout_lanes(spec, dt)
                    if sqp_linesearch and sqp_iters > 1 else None)

        def traj_cost(x0s, ul, xr_l, ur_l):
            """True nonlinear trajectory cost per scenario (B,) — RK4
            rollout + the problem's quadratic stage costs."""
            xs = roll_nom(x0s, ul)                       # (H, n, B)
            dx = xs if xr_l is None else xs - xr_l
            du = ul if ur_l is None else ul - ur_l
            qx = jnp.einsum("hib,ij,hjb->b", dx[:-1], problem.Q, dx[:-1])
            qn = jnp.einsum("ib,ij,jb->b", dx[-1], problem.QN, dx[-1])
            ru = jnp.einsum("hib,ij,hjb->b", du, problem.R, du)
            cost = 0.5 * (qx + qn + ru)
            return jnp.where(jnp.isfinite(cost), cost, jnp.inf)

        def solve_batch_lanes(x0s, us_init, x_ref=None, u_ref=None):
            # tracking MPC (x_ref/u_ref) rides the SAME scan-fused PDIP as
            # the regulator path (ref tracking recursion
            # mat_are_solver.hpp:1449 + lqr_controllers.hpp:58)
            xr_l = to_lanes(x_ref, 2 * spec.nv)
            ur_l = to_lanes(u_ref, problem.R.shape[-1])
            us = us_init  # (B, H, m)
            for _ in range(sqp_iters):
                A_l, B_l, c_l, _ = roll_l(x0s, us)
                ul, xl = solve_box_mpc_riccati_soa_fused(
                    A_l, B_l, c_l, problem.Q, problem.QN, problem.R,
                    x0s.T, problem.u_min, problem.u_max, iters=qp_iters,
                    x_ref=xr_l, u_ref=ur_l,
                )
                if roll_nom is not None:
                    # SQP globalization: full-step SQP can diverge when a
                    # QP solution swings the nominal outside the LTV
                    # model's validity (re-linearizing about an unstable
                    # rollout → NaN).  Per-scenario backtracking on the
                    # TRUE nonlinear cost over α ∈ {1, ½, ¼} keeps every
                    # accepted nominal finite and non-increasing.
                    u_prev = jnp.moveaxis(us, 0, -1)     # (H, m, B)
                    best_u = u_prev
                    best_J = traj_cost(x0s, u_prev, xr_l, ur_l)
                    for alpha in (1.0, 0.5, 0.25):
                        u_a = u_prev + alpha * (ul - u_prev)
                        J_a = traj_cost(x0s, u_a, xr_l, ur_l)
                        take = J_a < best_J
                        best_J = jnp.where(take, J_a, best_J)
                        best_u = jnp.where(take[None, None, :], u_a, best_u)
                    ul = best_u
                    xl = roll_nom(x0s, ul)   # true trajectory of chosen u
                us = jnp.moveaxis(ul, -1, 0)
            return us, jnp.moveaxis(xl, -1, 0)

        return solve_batch_lanes

    roll = (lanes.make_rollout_ltv_batchfirst(spec, dt, H)
            if rollout == "lanes" else soa.make_rollout_ltv_soa(spec, dt, H))

    def solve_batch(x0s, us_init):
        us = us_init
        for _ in range(sqp_iters):
            A_seq, B_seq, c_seq, _ = roll(x0s, us)
            if qp_layout == "lanes":
                ul, xl = solve_box_mpc_riccati_soa(
                    jnp.moveaxis(A_seq, 0, -1), jnp.moveaxis(B_seq, 0, -1),
                    jnp.moveaxis(c_seq, 0, -1), problem.Q, problem.QN,
                    problem.R, x0s.T, problem.u_min, problem.u_max,
                    iters=qp_iters,
                )
                us, xs = jnp.moveaxis(ul, -1, 0), jnp.moveaxis(xl, -1, 0)
            else:
                us, xs = jax.vmap(
                    lambda A, B, c, x0: solve_box_mpc_riccati(
                        A, B, c, problem.Q, problem.QN, problem.R, x0,
                        problem.u_min, problem.u_max, iters=qp_iters,
                    )
                )(A_seq, B_seq, c_seq, x0s)
        return us, xs

    return solve_batch


def receding_horizon(F, problem, x0, n_steps, **kw):
    """Closed-loop MPC execution: apply first input, advance plant, repeat.
    Returns (states (n_steps, n), inputs (n_steps, m))."""

    def body(carry, _):
        x, u_warm = carry
        sol = solve(F, problem, x, u_init=u_warm, **kw)
        u0 = sol.u[0]
        x1 = F(x, u0)
        u_next = jnp.concatenate([sol.u[1:], sol.u[-1:]], axis=0)  # shift warm start
        return (x1, u_next), (x1, u0)

    m = problem.R.shape[-1]
    u_warm = jnp.zeros((problem.horizon, m), x0.dtype)
    _, (xs, us) = jax.lax.scan(body, (x0, u_warm), None, length=n_steps)
    return xs, us

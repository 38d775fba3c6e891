"""Dense-lanes KTE rollout + LTV linearization — the compact-graph XLA path.

The register-form SoA module (kte/soa.py) emits one HLO op per scalar
multiply-add; its flagship scan body is ~10k ops, which XLA takes minutes to
optimize.  This module computes the SAME math in the same batch-LAST
("lanes") layout, but with the small structural dims (body, dof, xyz)
stacked into array axes so every assembly step is one einsum /
broadcast-multiply-reduce: the scan body drops to a few hundred HLO ops while
every contraction still reduces only tiny leading axes and keeps the
scenario batch as the contiguous last axis.

Chain topology constants (axes, offsets, masks, inertias) fold into the trace
at closure time, exactly like kte/soa.py.  Fixed-base revolute/prismatic
chains take the fast path; free-base chains route through the generic
per-joint block assembly.

The nv x nv mass-matrix solves are unrolled Cholesky recurrences
(ctrl/riccati_soa._chol_solve_lanes).

Equivalence with kte/soa.py (same sweeps as the reference's
kte_map_chain.hpp:71-89 / mass_matrix_calculator.cpp:80-287 /
manipulator_model.cpp:292-355) is asserted in tests/test_lanes_rollout.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.kte.spec import ChainSpec, JointType, REVOLUTE, PRISMATIC, \
    FIXED, FREE
from reak_tpu.kte.soa import _fk_soa
from reak_tpu.math import rot_lanes as rl


# ---------------------------------------------------------------------------
# lanes-layout vector helpers: component axis at -2, batch axis last
# ---------------------------------------------------------------------------


def _cross_l(a, b):
    """Cross product over axis -2 (size 3); a, b (..., 3, B) broadcastable."""
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-2
    )


def _qrot_inv_l(q, v):
    """Rotate v by q⁻¹: q (..., 4, B), v (..., 3, B) → (..., 3, B)."""
    w = q[..., 0:1, :]
    qv = -q[..., 1:4, :]  # conjugate
    t = 2.0 * _cross_l(qv, v)
    return v + w * t + _cross_l(qv, t)


def _bcast_stack(items, batch_shape, dtype):
    """Stack a list of tuples of ((B,) array | float) → (len, k, *batch)."""
    rows = []
    for it in items:
        comps = [
            jnp.broadcast_to(jnp.asarray(c, dtype), batch_shape) for c in it
        ]
        rows.append(jnp.stack(comps, axis=0))
    return jnp.stack(rows, axis=0)


# ---------------------------------------------------------------------------
# mass matrix + bias force in dense lanes form
# ---------------------------------------------------------------------------


def make_terms_lanes(spec: ChainSpec):
    """terms(q, qd) → (M (nv, nv, B), f (nv, B)); q, qd (nv, B).

    Same quantities as kte/soa.make_terms_soa (M = JᵀMcmJ twist-shaped mass,
    f = applied-minus-bias generalized force; ref
    mass_matrix_calculator.cpp:80-287, inertia.cpp:111-121), assembled as
    einsums over stacked (body, dof, xyz) axes.  Free-base (quaternion)
    chains route through the generic per-joint block assembly; q is then
    (nq, B) with the [p(3), quat(4)] packing of the FREE joint.
    """
    if spec.has_free_base:
        return _make_terms_lanes_generic(spec)
    nb = spec.n_joints
    nv = spec.nv

    # static structure, folded at trace time
    jidx = [i for i, t in enumerate(spec.joint_types) if JointType(t) != FIXED]
    assert len(jidx) == nv
    mask_np = np.array(
        [[1.0 if jidx[k] <= b else 0.0 for k in range(nv)] for b in range(nb)]
    )
    is_pri_np = np.array(
        [1.0 if JointType(spec.joint_types[i]) == PRISMATIC else 0.0 for i in jidx]
    )
    masses_np = np.asarray(spec.masses)
    I_np = np.asarray(spec.inertias).reshape(nb, 3, 3)
    grav_np = np.asarray(spec.gravity)
    stiff_np = np.array([spec.stiffness[i] for i in jidx])
    rest_np = np.array([spec.rest_q[i] for i in jidx])
    damp_np = np.array([spec.damping[i] for i in jidx])

    def jac_map(q):
        """q (nv, B) → Jv (nb, nv, 3, B) world, Jw (nb, nv, 3, B) body."""
        dtype = q.dtype
        batch = q.shape[1:]
        fkr = _fk_soa(spec, tuple(q[i] for i in range(nv)))
        coms = _bcast_stack(fkr.com, batch, dtype)  # (nb, 3, B)
        quats = _bcast_stack(fkr.quat, batch, dtype)  # (nb, 4, B)
        anchors = _bcast_stack([fkr.anchors[i] for i in jidx], batch, dtype)
        axes_g = _bcast_stack([fkr.axes_g[i] for i in jidx], batch, dtype)

        mask = jnp.asarray(mask_np, dtype)[:, :, None, None]
        is_pri = jnp.asarray(is_pri_np, dtype)[None, :, None, None]

        r = coms[:, None] - anchors[None]  # (nb, nv, 3, B)
        Jv_rev = _cross_l(axes_g[None], r)
        Jv = (is_pri * axes_g[None] + (1.0 - is_pri) * Jv_rev) * mask
        ax_rev = axes_g * (1.0 - jnp.asarray(is_pri_np, dtype)[:, None, None])
        Jw = _qrot_inv_l(quats[:, None], ax_rev[None]) * mask
        return Jv, Jw

    def vel_map(q, qd):
        Jv, Jw = jac_map(q)
        v = jnp.einsum("bkcz,kz->bcz", Jv, qd)
        w = jnp.einsum("bkcz,kz->bcz", Jw, qd)
        return v, w, Jv, Jw

    def terms(q, qd):
        dtype = q.dtype
        masses = jnp.asarray(masses_np, dtype)
        I_all = jnp.asarray(I_np, dtype)
        # one jvp gives J̇q̇ bias accelerations (kte/dynamics.py trick)
        (v, w, Jv, Jw), (a_b, al_b, _, _) = jax.jvp(
            lambda qq: vel_map(qq, qd), (q,), (qd,)
        )
        M = jnp.einsum("b,bkcz,blcz->klz", masses, Jv, Jv) + jnp.einsum(
            "bkrz,brc,blcz->klz", Jw, I_all, Jw
        )
        a_tot = a_b - jnp.asarray(grav_np, dtype)[None, :, None]
        f_lin = -masses[:, None, None] * a_tot
        Iw = jnp.einsum("brc,bcz->brz", I_all, w)
        Ial = jnp.einsum("brc,bcz->brz", I_all, al_b)
        f_ang = -(Ial + _cross_l(w, Iw))
        f = jnp.einsum("bkcz,bcz->kz", Jv, f_lin) + jnp.einsum(
            "bkcz,bcz->kz", Jw, f_ang
        )
        # passive joint springs/dampers (smooth part, hot path)
        f = (
            f
            - jnp.asarray(stiff_np, dtype)[:, None]
            * (q - jnp.asarray(rest_np, dtype)[:, None])
            - jnp.asarray(damp_np, dtype)[:, None] * qd
        )
        return M, f

    return terms


def _make_terms_lanes_generic(spec: ChainSpec):
    """Free-base-capable lanes terms: per-joint Jacobian column blocks
    (FREE joints contribute 6 columns — 3 pre-frame linear + 3 base-body
    angular, matching kte/dynamics.jacobians) concatenated on the dof axis,
    then the same einsum mass/bias assembly as the fixed-base fast path."""
    nb = spec.n_joints
    nv = spec.nv
    nq = spec.nq

    masses_np = np.asarray(spec.masses)
    I_np = np.asarray(spec.inertias).reshape(nb, 3, 3)
    grav_np = np.asarray(spec.gravity)
    # per-dof passive-element constants (zeros on FREE dofs) + config index
    stiff_np = np.zeros(nv)
    damp_np = np.zeros(nv)
    rest_np = np.zeros(nv)
    qsel_np = np.zeros(nv, np.int32)
    ci = vi = 0
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt == FIXED:
            continue
        if jt == FREE:
            ci += 7
            vi += 6
            continue
        stiff_np[vi] = spec.stiffness[i]
        damp_np[vi] = spec.damping[i]
        rest_np[vi] = spec.rest_q[i]
        qsel_np[vi] = ci
        ci += 1
        vi += 1

    def jac_map(q):
        """q (nq, B) → Jv (nb, nv, 3, B) world, Jw (nb, nv, 3, B) body."""
        dtype = q.dtype
        batch = q.shape[1:]
        fkr = _fk_soa(spec, tuple(q[i] for i in range(nq)))
        coms = _bcast_stack(fkr.com, batch, dtype)      # (nb, 3, B)
        quats = _bcast_stack(fkr.quat, batch, dtype)    # (nb, 4, B)
        basis = jnp.broadcast_to(
            jnp.eye(3, dtype=dtype)[:, :, None], (3, 3) + batch)
        blocks_v, blocks_w = [], []
        for i, jt in enumerate(spec.joint_types):
            jt = JointType(jt)
            if jt == FIXED:
                continue
            mask = jnp.asarray(
                (np.arange(nb) >= i).astype(np.float64), dtype
            )[:, None, None, None]
            anch = _bcast_stack([fkr.anchors[i]], batch, dtype)   # (1, 3, B)
            r = coms[:, None] - anch[None]                        # (nb,1,3,B)
            if jt == REVOLUTE:
                a = _bcast_stack([fkr.axes_g[i]], batch, dtype)[None]
                Jv_blk = _cross_l(a, r) * mask
                Jw_blk = _qrot_inv_l(
                    quats[:, None], jnp.broadcast_to(a, r.shape)) * mask
            elif jt == PRISMATIC:
                a = _bcast_stack([fkr.axes_g[i]], batch, dtype)[None]
                Jv_blk = jnp.broadcast_to(a, r.shape) * mask
                Jw_blk = jnp.zeros_like(Jv_blk)
            else:  # FREE: 3 pre-frame linear + 3 base-body angular columns
                preq = _bcast_stack([fkr.pre_quat[i]], batch, dtype)
                bq = _bcast_stack([fkr.quat[i]], batch, dtype)
                lin_axes = rl.qrot_l(preq, basis)       # (3, 3, B)
                ang_axes = rl.qrot_l(bq, basis)         # (3, 3, B)
                full = (nb, 3, 3) + batch
                Jv_lin = jnp.broadcast_to(lin_axes[None], full) * mask
                Jw_lin = jnp.zeros(full, dtype)
                ang_b = jnp.broadcast_to(ang_axes[None], full)
                Jv_ang = _cross_l(ang_b, jnp.broadcast_to(r, full)) * mask
                Jw_ang = _qrot_inv_l(quats[:, None], ang_b) * mask
                Jv_blk = jnp.concatenate([Jv_lin, Jv_ang], axis=1)
                Jw_blk = jnp.concatenate([Jw_lin, Jw_ang], axis=1)
            blocks_v.append(Jv_blk)
            blocks_w.append(Jw_blk)
        Jv = jnp.concatenate(blocks_v, axis=1)
        Jw = jnp.concatenate(blocks_w, axis=1)
        return Jv, Jw

    def config_rate_l(q, qd):
        """(nq, B) tangent of the configuration along qd (lanes form of
        kte/dynamics.config_rate — quaternion rate ½ q⊗(0, ω_body))."""
        if not spec.has_free_base:
            return qd
        qdot = rl.qdot_from_omega_l(q[3:7], qd[3:6])
        return jnp.concatenate([qd[0:3], qdot, q[7:] * 0.0 + qd[6:]], axis=0)

    def vel_map(q, qd):
        Jv, Jw = jac_map(q)
        v = jnp.einsum("bkcz,kz->bcz", Jv, qd)
        w = jnp.einsum("bkcz,kz->bcz", Jw, qd)
        return v, w, Jv, Jw

    def terms(q, qd):
        dtype = q.dtype
        masses = jnp.asarray(masses_np, dtype)
        I_all = jnp.asarray(I_np, dtype)
        dq = config_rate_l(q, qd)
        (v, w, Jv, Jw), (a_b, al_b, _, _) = jax.jvp(
            lambda qq: vel_map(qq, qd), (q,), (dq,)
        )
        M = jnp.einsum("b,bkcz,blcz->klz", masses, Jv, Jv) + jnp.einsum(
            "bkrz,brc,blcz->klz", Jw, I_all, Jw
        )
        a_tot = a_b - jnp.asarray(grav_np, dtype)[None, :, None]
        f_lin = -masses[:, None, None] * a_tot
        Iw = jnp.einsum("brc,bcz->brz", I_all, w)
        Ial = jnp.einsum("brc,bcz->brz", I_all, al_b)
        f_ang = -(Ial + _cross_l(w, Iw))
        f = jnp.einsum("bkcz,bcz->kz", Jv, f_lin) + jnp.einsum(
            "bkcz,bcz->kz", Jw, f_ang
        )
        f = (
            f
            - jnp.asarray(stiff_np, dtype)[:, None]
            * (q[jnp.asarray(qsel_np)] - jnp.asarray(rest_np, dtype)[:, None])
            - jnp.asarray(damp_np, dtype)[:, None] * qd
        )
        return M, f

    return terms


# ---------------------------------------------------------------------------
# fused rollout + LTV linearization
# ---------------------------------------------------------------------------


def make_rollout_ltv_lanes(spec: ChainSpec, dt: float, horizon: int,
                           order: int = 4):
    """Fused nominal rollout + LTV linearization, lanes-native I/O.

    Returns ``fn(x0 (B, 2nv), us (B, H, m)) → (A_seq (H, n, n, B),
    B_seq (H, n, m, B), c_seq (H, n, B), xs (H, n, B))`` with n = 2nv — i.e.
    directly in the layout ctrl/riccati_soa consumes, no transposes between
    rollout and PDIP.  Same step map as kte/soa.make_rollout_ltv_soa: one
    ``jax.linearize`` of the (M, f) assembly, n unit-tangent pulls batched by
    vmap, ∂q̈ = M⁻¹(∂f − ∂M q̈), exponential-series discretization of the
    frozen linearization (exact RK4-on-LTI).
    """
    from reak_tpu.ctrl.riccati_soa import _chol_solve_lanes, _mm, _mv

    nv = spec.nv
    n = 2 * nv
    terms = make_terms_lanes(spec)

    def step(x, u):
        """x (n, B), u (nv, B) → Ad (n, n, B), Bd (n, m, B), cd, x_new."""
        dtype = x.dtype

        def terms_flat(xx):
            return terms(xx[:nv], xx[nv:])

        (M, f), lin_fn = jax.linearize(terms_flat, x)
        qd = x[nv:]
        f_tau = f + u
        qdd = _chol_solve_lanes(M, f_tau[:, None, :])[:, 0]  # (nv, B)

        # all n unit-tangent pulls in one vmapped pass over the linear map
        # (+0·x ties the basis to the primal's varying axes under shard_map)
        basis = jnp.eye(n, dtype=dtype)[:, :, None] + 0.0 * x[None]
        dM, df = jax.vmap(lin_fn)(basis)  # (n, nv, nv, B), (n, nv, B)
        rhs = df - jnp.einsum("dklz,lz->dkz", dM, qdd)  # (n, nv, B)
        rhs_t = jnp.moveaxis(rhs, 0, 1)  # (nv, n, B)
        eye_nv = jnp.broadcast_to(
            jnp.eye(nv, dtype=dtype)[:, :, None], (nv, nv) + x.shape[1:]
        )
        sol = _chol_solve_lanes(M, jnp.concatenate([rhs_t, eye_nv], axis=1))
        dqdd = sol[:, :n]  # (nv, n, B): ∂q̈_k/∂x_d
        Minv = sol[:, n:]  # (nv, nv, B)

        # continuous A = [[0, I], [∂q̈/∂q, ∂q̈/∂q̇]], B = [[0], [M⁻¹]]
        top = jnp.concatenate(
            [jnp.zeros((nv, nv), dtype), jnp.eye(nv, dtype=dtype)], axis=1
        )[:, :, None]
        A_c = jnp.concatenate([jnp.broadcast_to(top, (nv, n) + x.shape[1:]),
                               dqdd], axis=0)  # (n, n, B)
        B_c = jnp.concatenate(
            [jnp.zeros((nv, nv) + x.shape[1:], dtype), Minv], axis=0
        )  # (n, nv, B)
        f0 = jnp.concatenate([qd, qdd], axis=0)  # (n, B)

        # S = Σ_{k=1..order} dt^k A^{k-1}/k!;  Ad = I + A S;  Bd = S B
        eye_n = jnp.eye(n, dtype=dtype)[:, :, None]
        S = eye_n * dt
        term = eye_n * dt
        for k in range(2, order + 1):
            term = (dt / k) * _mm(A_c, term)
            S = S + term
        Ad = eye_n + _mm(A_c, S)
        Bd = _mm(S, B_c)
        x_new = x + _mv(S, f0)
        cd = x_new - _mv(Ad, x) - _mv(Bd, u)
        return Ad, Bd, cd, x_new

    def rollout(x0, us):
        x = x0.T  # (n, B)
        us_t = jnp.moveaxis(us, 0, -1)  # (H, m, B)

        def body(x, u_t):
            Ad, Bd, cd, x_new = step(x, u_t)
            return x_new, (Ad, Bd, cd, x_new)

        _, seqs = jax.lax.scan(body, x, us_t)
        return seqs  # (H, n, n, B), (H, n, m, B), (H, n, B), (H, n, B)

    return rollout


def make_rollout_lanes(spec: ChainSpec, dt: float):
    """Nominal-only lanes rollout (RK4): prices candidate input sequences
    for the SQP line-search at ~4 terms-evaluations per step — far cheaper
    than the fused rollout's 2nv+1 tangent pulls.  The O(dt⁵) difference vs
    the solver's exponential-series step map cannot change a cost RANKING
    between line-search candidates.  ``fn(x0 (B, n), us (B, H, m) or
    (H, m, B)) → xs (H, n, B)`` (lanes layout, x_1..x_H)."""
    from reak_tpu.ctrl.riccati_soa import _chol_solve_lanes

    assert not spec.has_free_base
    nv = spec.nv
    terms = make_terms_lanes(spec)

    def rate(x, u):
        qd = x[nv:]
        M, f = terms(x[:nv], qd)
        qdd = _chol_solve_lanes(M, (f + u)[:, None, :])[:, 0]
        return jnp.concatenate([qd, qdd], axis=0)

    def step(x, u):
        k1 = rate(x, u)
        k2 = rate(x + 0.5 * dt * k1, u)
        k3 = rate(x + 0.5 * dt * k2, u)
        k4 = rate(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def rollout(x0, us_l):
        # x0 (B, n) batch-first; us_l (H, m, B) lanes
        def body(x, u_t):
            x1 = step(x, u_t)
            return x1, x1

        _, xs = jax.lax.scan(body, x0.T, us_l)
        return xs

    return rollout


def make_kte_manifold_lanes(spec: ChainSpec, dt: float, actuated=None,
                            order: int = 4):
    """Free-base KTE chain on the lanes fast path: returns ``(step, ltv)``
    for ctrl/manifold_lanes.make_scenario_mpc_lanes.

    * ``step(x (nq+nv, B), u (nu, B)) → x'`` — RK4 + base-quaternion
      renormalization, byte-identical math to ctrl/systems.kte_discrete
      (ref: manipulator_model.cpp:292-355 computeStateRate + the quaternion
      packing of :301-344), scenario batch as the last axis;
    * ``ltv(x, u) → (A_d (2nv,2nv,B), B_d (2nv,nu,B), c_d (2nv,B))`` — the
      error-state series LTV of ctrl/systems.kte_manifold_ltv_linearizer
      (tangent chart e = [δp, δθ, δq_arm | δq̇] of kte.dynamics
      state_retraction) in lanes form: ONE jax.linearize of the (M, f)
      assembly in the retraction chart, 2nv unit-tangent pulls, analytic
      ∂q̈ = M⁻¹(∂f − ∂M q̈), exponential-series discretization with the
      −[ω̄]× attitude-error transport block; c_d = −B_d ū (absolute-input
      decision variable).

    The satellite/airship/floating-arm domain thus runs the same lanes +
    whole-PDIP pipeline as the fixed-base flagship.
    """
    from reak_tpu.ctrl.riccati_soa import _chol_solve_lanes, _mm, _mv

    assert spec.has_free_base, "fixed-base chains use make_rollout_ltv_lanes"
    nq = spec.nq
    nv = spec.nv
    d = 2 * nv
    terms = make_terms_lanes(spec)
    act_np = None if actuated is None else np.asarray(actuated)
    nu = nv if act_np is None else act_np.shape[1]

    def tau_of(u, dtype):
        if act_np is None:
            return u
        return jnp.einsum("vu,uz->vz", jnp.asarray(act_np, dtype), u)

    def config_rate_l(q, qd):
        qdot = rl.qdot_from_omega_l(q[3:7], qd[3:6])
        return jnp.concatenate([qd[0:3], qdot, qd[6:]], axis=0)

    def state_rate(x, tau):
        q, qd = x[:nq], x[nq:]
        M, f = terms(q, qd)
        qdd = _chol_solve_lanes(M, (f + tau)[:, None, :])[:, 0]
        return jnp.concatenate([config_rate_l(q, qd), qdd], axis=0)

    def step(x, u):
        tau = tau_of(u, x.dtype)
        k1 = state_rate(x, tau)
        k2 = state_rate(x + 0.5 * dt * k1, tau)
        k3 = state_rate(x + 0.5 * dt * k2, tau)
        k4 = state_rate(x + dt * k3, tau)
        xn = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        quat = xn[3:7]
        quat = quat / jnp.sqrt(jnp.sum(quat * quat, axis=0, keepdims=True))
        return jnp.concatenate([xn[0:3], quat, xn[7:]], axis=0)

    def retract(x, e):
        """Lanes form of kte.dynamics.state_retraction.retract."""
        p = x[0:3] + e[0:3]
        quat = rl.qmul_l(x[3:7], rl.q_exp_l(e[3:6]))
        arm = x[7:nq] + e[6:nv]
        qd = x[nq:] + e[nv:]
        return jnp.concatenate([p, quat, arm, qd], axis=0)

    def ltv(x, u):
        dtype = x.dtype
        batch = x.shape[1:]
        qd = x[nq:]
        tau = tau_of(u, dtype)

        def terms_e(e):
            xe = retract(x, e)
            return terms(xe[:nq], xe[nq:])

        e0 = jnp.zeros((d,) + batch, dtype)
        (M, f), lin_fn = jax.linearize(terms_e, e0)
        qdd = _chol_solve_lanes(M, (f + tau)[:, None, :])[:, 0]

        basis = jnp.eye(d, dtype=dtype)[:, :, None] + 0.0 * e0[None]
        dM, df = jax.vmap(lin_fn)(basis)        # (d, nv, nv, B), (d, nv, B)
        rhs = df - jnp.einsum("dklz,lz->dkz", dM, qdd)
        rhs_t = jnp.moveaxis(rhs, 0, 1)         # (nv, d, B)
        S_u = (jnp.broadcast_to(jnp.eye(nv, dtype=dtype)[:, :, None],
                                (nv, nv) + batch) if act_np is None else
               jnp.broadcast_to(jnp.asarray(act_np, dtype)[:, :, None],
                                (nv, nu) + batch))
        sol = _chol_solve_lanes(M, jnp.concatenate([rhs_t, S_u], axis=1))
        dqdd = sol[:, :d]                       # (nv, d, B)
        Minv_S = sol[:, d:]                     # (nv, nu, B)

        # attitude-error transport: δθ̇ = −ω̄×δθ + δω (invariant-EKF error
        # kinematics; ctrl/systems.kte_manifold_ltv_linearizer)
        w = qd[3:6]
        Sblk = jnp.zeros((nv, nv) + batch, dtype)
        Sblk = Sblk.at[3:6, 3:6].set(-rl.skew_l(w))
        eye_v = jnp.broadcast_to(jnp.eye(nv, dtype=dtype)[:, :, None],
                                 (nv, nv) + batch)
        A_c = jnp.concatenate([
            jnp.concatenate([Sblk, eye_v], axis=1),
            dqdd,
        ], axis=0)                              # (d, d, B)
        B_c = jnp.concatenate(
            [jnp.zeros((nv, nu) + batch, dtype), Minv_S], axis=0)

        eye_d = jnp.eye(d, dtype=dtype)[:, :, None]
        S = eye_d * dt
        term = eye_d * dt
        for k in range(2, order + 1):
            term = (dt / k) * _mm(A_c, term)
            S = S + term
        A_d = eye_d + _mm(A_c, S)
        B_d = _mm(S, B_c)
        c_d = -_mv(B_d, u)
        return A_d, B_d, c_d

    return step, ltv


def make_rollout_ltv_batchfirst(spec: ChainSpec, dt: float, horizon: int,
                                order: int = 4):
    """Batch-first wrapper with the kte/soa.make_rollout_ltv_soa signature:
    ``fn(x0 (B, n), us (B, H, m)) → (A (B,H,n,n), B, c, xs (B,H,n))`` —
    used by equivalence tests and drop-in callers."""
    roll = make_rollout_ltv_lanes(spec, dt, horizon, order)

    def fn(x0, us):
        A_l, B_l, c_l, xs_l = roll(x0, us)
        # (H, ..., B) → (B, H, ...)
        perm = lambda a: jnp.moveaxis(a, -1, 0)
        return perm(A_l), perm(B_l), perm(c_l), perm(xs_l)

    return fn

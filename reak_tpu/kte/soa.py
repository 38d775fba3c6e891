"""Structure-of-arrays (batch-in-lanes) KTE dynamics — the register form.

The generic chain code (kte/dynamics.py) keeps vector/matrix components in
trailing array axes, so every operation works on tiny (3, 4, 12)-wide
trailing dims across the batch.  This
module re-expresses the SAME math with the scenario batch as the LAST axis of
every array and all small components as Python-level tuples ("registers"):
each operation is a full-lane elementwise op, XLA fuses the chains, and chain
constants (axes, offsets, inertias) fold into the trace as literals.

Semantics are identical to kte.dynamics (validated against it in tests); only
fixed-base revolute/prismatic chains are specialized here — exactly the MPC
benchmark regime.  Free-base flows stay on the generic path.

(ref lineage: same sweeps as ctrl/mbd_kte — kte_map_chain.hpp:71-89,
mass_matrix_calculator.cpp:80-287, manipulator_model.cpp:292-355.)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.kte.spec import (ChainSpec, JointType, REVOLUTE, PRISMATIC,
                               FIXED, FREE)


# ---------------------------------------------------------------------------
# register-style math: vectors = 3-tuples, quaternions = 4-tuples of arrays
# ---------------------------------------------------------------------------


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _qrot(q, v):
    """Rotate v by q: v + 2 w (qv×v) + 2 qv×(qv×v)."""
    w = q[0]
    qv = (q[1], q[2], q[3])
    t = _cross(qv, v)
    t = (2.0 * t[0], 2.0 * t[1], 2.0 * t[2])
    u = _cross(qv, t)
    return (v[0] + w * t[0] + u[0], v[1] + w * t[1] + u[1], v[2] + w * t[2] + u[2])


def _qrot_inv(q, v):
    return _qrot((q[0], -q[1], -q[2], -q[3]), v)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _scale(s, a):
    return tuple(s * x for x in a)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _const_vec(v):
    return (float(v[0]), float(v[1]), float(v[2]))


# ---------------------------------------------------------------------------
# chain geometry in register form
# ---------------------------------------------------------------------------


class _SoaFk(NamedTuple):
    com: tuple  # per body: vec3 (world COM)
    quat: tuple  # per body: quat (body→world)
    anchors: tuple  # per joint: vec3
    axes_g: tuple  # per 1-dof joint: vec3 (world axis)
    types: tuple
    pre_quat: tuple  # per joint: quat of the frame BEFORE the joint


def _fk_soa(spec: ChainSpec, q):
    """q: tuple of nq arrays (batch-last; nq = nv for fixed-base chains,
    nv + 1 with a free base: [p(3), quat(4)] per FREE joint, ref
    free_joints.hpp:165 packing).  Static constants fold at trace."""
    p = (0.0, 0.0, 0.0)
    Q = (1.0, 0.0, 0.0, 0.0)
    coms, quats, anchors, axes_g, types, pre_quats = [], [], [], [], [], []
    ci = 0
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        off = _const_vec(spec.offsets_pos[i])
        oq = tuple(float(x) for x in spec.offsets_quat[i])
        if off != (0.0, 0.0, 0.0):
            p = _add(p, _qrot(Q, off))
        if oq != (1.0, 0.0, 0.0, 0.0):
            Q = _qmul(Q, oq)
        pre_quats.append(Q)
        ax = _const_vec(spec.axes[i])
        if jt == REVOLUTE:
            qi = q[ci]
            ci += 1
            a_g = _qrot(Q, ax)
            anchors.append(p)
            axes_g.append(a_g)
            types.append(REVOLUTE)
            half = 0.5 * qi
            c, s = jnp.cos(half), jnp.sin(half)
            qj = (c, ax[0] * s, ax[1] * s, ax[2] * s)
            Q = _qmul(Q, qj)
        elif jt == PRISMATIC:
            qi = q[ci]
            ci += 1
            a_g = _qrot(Q, ax)
            anchors.append(p)
            axes_g.append(a_g)
            types.append(PRISMATIC)
            p = _add(p, _scale(qi, a_g))
        elif jt == FREE:
            # 6-DoF joint: q = [pos(3) in pre-frame coords, quat(4)]
            # (ref: free_joints.hpp:165 — end = base * coordinate frame)
            dp = (q[ci], q[ci + 1], q[ci + 2])
            p = _add(p, _qrot(Q, dp))
            qf = (q[ci + 3], q[ci + 4], q[ci + 5], q[ci + 6])
            inv_n = jax.lax.rsqrt(qf[0] * qf[0] + qf[1] * qf[1]
                                  + qf[2] * qf[2] + qf[3] * qf[3])
            qf = tuple(x * inv_n for x in qf)
            Q = _qmul(Q, qf)
            ci += 7
            anchors.append(p)
            axes_g.append((0.0, 0.0, 0.0))
            types.append(FREE)
        elif jt == FIXED:
            anchors.append(p)
            axes_g.append((0.0, 0.0, 0.0))
            types.append(FIXED)
        else:
            raise NotImplementedError(f"soa path: joint type {jt}")
        com = _const_vec(spec.com_pos[i])
        pc = _add(p, _qrot(Q, com)) if com != (0.0, 0.0, 0.0) else p
        coms.append(pc)
        quats.append(Q)
    return _SoaFk(tuple(coms), tuple(quats), tuple(anchors), tuple(axes_g),
                  tuple(types), tuple(pre_quats))


def _jacobians_soa(spec: ChainSpec, fkr: _SoaFk):
    """Per body b, per dof k: (Jv[b][k] vec3 world, Jw[b][k] vec3 BODY).

    FREE joints contribute 6 columns (matching kte/dynamics.jacobians): 3
    linear dofs along the pre-frame axes (world coords), 3 angular dofs along
    the base-BODY frame axes anchored at the joint origin."""
    nb = spec.n_joints
    Jv = [[None] * spec.nv for _ in range(nb)]
    Jw = [[None] * spec.nv for _ in range(nb)]
    zero3 = (0.0, 0.0, 0.0)
    basis = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    col = 0
    for i, jt in enumerate(fkr.types):
        if jt == FIXED:
            continue
        if jt == FREE:
            lin_axes = [_qrot(fkr.pre_quat[i], e) for e in basis]
            ang_axes = [_qrot(fkr.quat[i], e) for e in basis]
            for b in range(nb):
                for j in range(3):
                    if b < i:
                        Jv[b][col + j] = zero3
                        Jw[b][col + j] = zero3
                        Jv[b][col + 3 + j] = zero3
                        Jw[b][col + 3 + j] = zero3
                        continue
                    Jv[b][col + j] = lin_axes[j]
                    Jw[b][col + j] = zero3
                    r = tuple(fkr.com[b][k] - fkr.anchors[i][k]
                              for k in range(3))
                    Jv[b][col + 3 + j] = _cross(ang_axes[j], r)
                    Jw[b][col + 3 + j] = _qrot_inv(fkr.quat[b], ang_axes[j])
            col += 6
            continue
        for b in range(nb):
            if b < i:
                Jv[b][col] = zero3
                Jw[b][col] = zero3
                continue
            if jt == REVOLUTE:
                r = tuple(fkr.com[b][k] - fkr.anchors[i][k] for k in range(3))
                Jv[b][col] = _cross(fkr.axes_g[i], r)
                Jw[b][col] = _qrot_inv(fkr.quat[b], fkr.axes_g[i])
            else:  # prismatic
                Jv[b][col] = fkr.axes_g[i]
                Jw[b][col] = (0.0, 0.0, 0.0)
        col += 1
    return Jv, Jw


def _config_rate_soa(spec: ChainSpec, q, qd):
    """Register-form config_rate: tangent of the configuration tuple along
    the generalized velocity (quaternion rate ½ q⊗(0, ω_body) for FREE
    joints — ref: manipulator_model.cpp:301-344 quaternion-rate packing).
    Mirrors kte/dynamics.config_rate exactly (raw, un-normalized quat)."""
    out = []
    ci = vi = 0
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt in (REVOLUTE, PRISMATIC):
            out.append(qd[vi])
            ci += 1
            vi += 1
        elif jt == FREE:
            out.extend(qd[vi:vi + 3])
            quat = (q[ci + 3], q[ci + 4], q[ci + 5], q[ci + 6])
            w = (qd[vi + 3], qd[vi + 4], qd[vi + 5])
            qdot = _qmul(quat, (jnp.zeros_like(w[0]),) + w)
            out.extend(0.5 * x for x in qdot)
            ci += 7
            vi += 6
    return tuple(out)


def make_terms_soa(spec: ChainSpec):
    """Build terms(q, qd) → (M upper-tri dict, f tuple) in register form.

    q: tuple of nq arrays, qd: tuple of nv arrays (any broadcastable shape,
    batch-last by convention).  Returns M as a full nested tuple (nv × nv)
    and f (nv,).  Free-base (quaternion) chains supported: the configuration
    tuple carries [p(3), quat(4)] for each FREE joint and the jvp tangent is
    the register-form config rate.
    """
    nv = spec.nv
    nb = spec.n_joints
    masses = [float(m) for m in spec.masses]
    inertias = [np.asarray(I).reshape(3, 3) for I in spec.inertias]
    gravity = _const_vec(spec.gravity)

    def vel_map(q, qd):
        fkr = _fk_soa(spec, q)
        Jv, Jw = _jacobians_soa(spec, fkr)
        v = []
        w = []
        for b in range(nb):
            vb = (0.0, 0.0, 0.0)
            wb = (0.0, 0.0, 0.0)
            for k in range(nv):
                vb = _add(vb, _scale(qd[k], Jv[b][k]))
                wb = _add(wb, _scale(qd[k], Jw[b][k]))
            v.append(vb)
            w.append(wb)
        return tuple(v), tuple(w), Jv, Jw

    def terms(q, qd):
        # one jvp gives J̇q̇ bias accelerations (same trick as dynamics.py);
        # the tangent is the config rate (== qd for fixed-base chains)
        dq = _config_rate_soa(spec, q, qd) if spec.has_free_base else qd
        (v, w, Jv, Jw), (a_bias, al_bias, _, _) = jax.jvp(
            lambda qq: vel_map(qq, qd), (q,), (dq,)
        )
        # mass matrix
        M = [[0.0] * nv for _ in range(nv)]
        for b in range(nb):
            m_b = masses[b]
            I_b = inertias[b]
            for k in range(nv):
                for l in range(k, nv):
                    term = 0.0
                    if m_b != 0.0:
                        term = term + m_b * _dot(Jv[b][k], Jv[b][l])
                    # Jwᵀ I Jw (I static; exploit zeros)
                    for r in range(3):
                        for c in range(3):
                            Irc = float(I_b[r, c])
                            if Irc != 0.0:
                                term = term + Irc * Jw[b][k][r] * Jw[b][l][c]
                    M[k][l] = M[k][l] + term
        for k in range(nv):
            for l in range(k):
                M[k][l] = M[l][k]

        # bias force f (q̈=0 accumulated force)
        f = [0.0] * nv
        for b in range(nb):
            m_b = masses[b]
            I_b = inertias[b]
            a_tot = tuple(a_bias[b][k] - gravity[k] for k in range(3))
            f_lin = _scale(-m_b, a_tot) if m_b != 0.0 else (0.0, 0.0, 0.0)
            # I α + ω × Iω
            Iw = tuple(
                sum(float(I_b[r, c]) * w[b][c] for c in range(3) if I_b[r, c] != 0.0)
                for r in range(3)
            )
            Ial = tuple(
                sum(float(I_b[r, c]) * al_bias[b][c] for c in range(3) if I_b[r, c] != 0.0)
                for r in range(3)
            )
            wxIw = _cross(w[b], Iw)
            f_ang = tuple(-(Ial[k] + wxIw[k]) for k in range(3))
            for k in range(nv):
                f[k] = f[k] + _dot(Jv[b][k], f_lin) + _dot(Jw[b][k], f_ang)

        # passive joint elements (springs/dampers; smooth part only on hot
        # path; FREE dofs carry no passive elements)
        ci = col = 0
        for i, jt in enumerate(spec.joint_types):
            jt = JointType(jt)
            if jt == FIXED:
                continue
            if jt == FREE:
                ci += 7
                col += 6
                continue
            kstf = float(spec.stiffness[i])
            dmp = float(spec.damping[i])
            if kstf != 0.0:
                f[col] = f[col] - kstf * (q[ci] - float(spec.rest_q[i]))
            if dmp != 0.0:
                f[col] = f[col] - dmp * qd[col]
            ci += 1
            col += 1
        if spec.has_free_base:
            # the free base's lin-lin mass block is CONSTANT (total mass ×
            # identity) and folds to Python floats; materialize every entry
            # as an array of the batch shape so callers can stack/linearize
            batch = jnp.shape(q[0])
            dtype = jnp.result_type(q[0])
            bc = lambda x: jnp.broadcast_to(jnp.asarray(x, dtype), batch)
            M = [[bc(M[k][l]) for l in range(nv)] for k in range(nv)]
            f = [bc(x) for x in f]
        return tuple(tuple(row) for row in M), tuple(f)

    return terms


def _chol_solve_reg(M, rhs_list):
    """Unrolled Cholesky solve in register form.  M: nv×nv nested tuple of
    arrays; rhs_list: list of nv-tuples (multiple right-hand sides).
    Returns list of solution tuples."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(s)
        for i in range(j + 1, n):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    outs = []
    for rhs in rhs_list:
        y = [None] * n
        for i in range(n):
            s = rhs[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        outs.append(tuple(x))
    return outs


def forward_dynamics_soa(spec: ChainSpec, terms, q, qd, tau=None):
    """q̈ in register form; q/qd/tau tuples of nv arrays."""
    M, f = terms(q, qd)
    if tau is not None:
        f = tuple(fi + ti for fi, ti in zip(f, tau))
    (qdd,) = _chol_solve_reg(M, [f])
    return qdd


def make_rollout_ltv_soa(spec: ChainSpec, dt: float, horizon: int, order: int = 4):
    """Fused nominal rollout + LTV linearization, batch-in-lanes.

    Returns ``fn(x0 (B, 2nv), us (B, H, m)) → (A_seq (B,H,n,n), B_seq, c_seq,
    xs (B,H,n))`` with n = 2nv.  Per step: ONE register-form primal +
    ``jax.linearize`` + nv·2 unit-tangent pulls give (M, f) and their state
    derivatives; q̈ derivatives follow from ∂q̈ = M⁻¹(∂f − ∂M q̈); the step
    itself is the exponential-series map of the frozen linearization (exact
    RK4-on-LTI), so the emitted LTV model is self-consistent with the rollout.
    Fixed-base chains (free-base chains use the manifold rollout in
    kte/lanes.make_manifold_rollout_ltv_lanes).
    """
    assert not spec.has_free_base, \
        "use kte/lanes.make_manifold_rollout_ltv_lanes for free-base chains"
    nv = spec.nv
    n = 2 * nv
    terms = make_terms_soa(spec)
    dtype_eye = np.eye(n)

    def step(x_tup, u_cols):
        # x_tup: tuple of n arrays (B,); u_cols: tuple of nv arrays (B,)
        q = x_tup[:nv]
        qd = x_tup[nv:]

        def terms_flat(xt):
            M, f = terms(xt[:nv], xt[nv:])
            return M, f

        (M, f), lin_fn = jax.linearize(terms_flat, x_tup)
        f_tau = tuple(fi + ui for fi, ui in zip(f, u_cols))

        # all n unit-tangent pulls in ONE vmapped pass over the linear map:
        # tangent leaf i is (n, B) with ones in row i
        batch_shape = x_tup[0].shape
        # + 0·primal ties the tangent basis to the primal's varying-manual-
        # axes so the linearized pullback type-checks under shard_map
        vary0 = jnp.zeros(batch_shape, x_tup[0].dtype) * x_tup[0]
        tangents = tuple(
            jnp.zeros((n,) + batch_shape, x_tup[0].dtype).at[i].set(1.0) + vary0
            for i in range(n)
        )
        Mt, ft = jax.vmap(lin_fn)(tangents)
        # Mt[i][j]: (n, B) — derivative of M_ij along each direction;
        # ft[i]: (n, B)

        # qdd and its state derivatives via one factorization; the direction
        # axis rides THROUGH the register-form solve by broadcasting ((n, B)
        # rhs entries against (B,) factors) — one substitution pass for all
        # n directions instead of n unrolled solves (graph size n× smaller)
        (qdd,) = _chol_solve_reg(M, [f_tau])
        dd_rhs = tuple(
            ft[i] - sum(Mt[i][j] * qdd[j] for j in range(nv)) for i in range(nv)
        )  # entries (n, B)
        eye_cols = np.eye(nv)
        eye_rhs = tuple(
            jnp.asarray(eye_cols[i][:, None], x_tup[0].dtype) for i in range(nv)
        )  # entries (nv, 1)
        (dd_sol, minv_sol) = _chol_solve_reg(M, [dd_rhs, eye_rhs])
        # dd_sol[i]: (n, B) = ∂q̈_i/∂x_d over directions d
        # minv_sol[i]: (nv, B) = row i of M⁻¹ (columns of the input map)
        dqdd = [
            tuple(dd_sol[i][d] for i in range(nv)) for d in range(n)
        ]  # per direction: tuple of nv (B,)
        minv_cols = [
            tuple(minv_sol[i][j] for i in range(nv)) for j in range(nv)
        ]

        # continuous A (n×n), B (n×nv), f0 (n) as (B,)-entry nested lists
        # A = [[0, I], [dq̈/dq, dq̈/dq̇]]
        zero = jnp.zeros_like(x_tup[0])

        def Ac(i, j):
            if i < nv:
                return 1.0 if j == i + nv else 0.0
            return dqdd[j][i - nv]

        # series: S = Σ dt^k A^{k-1}/k!; done in dense (B, n, n) form (few
        # 12×12 batched matmuls — cheap relative to the chain math)
        A_rows = []
        for i in range(n):
            row = []
            for j in range(n):
                a = Ac(i, j)
                row.append(jnp.broadcast_to(jnp.asarray(a, x_tup[0].dtype), x_tup[0].shape) if isinstance(a, float) else a)
            A_rows.append(jnp.stack(row, axis=0))
        A_c = jnp.stack(A_rows, axis=0)  # (n, n, B)
        A_cb = jnp.moveaxis(A_c, -1, 0)  # (B, n, n)

        B_rows = []
        for i in range(n):
            row = []
            for j in range(nv):
                row.append(zero if i < nv else minv_cols[j][i - nv])
            B_rows.append(jnp.stack(row, axis=0))
        B_c = jnp.moveaxis(jnp.stack(B_rows, axis=0), -1, 0)  # (B, n, nv)

        f0 = jnp.moveaxis(jnp.stack(list(qd) + list(qdd), axis=0), -1, 0)  # (B, n)
        xb = jnp.moveaxis(jnp.stack(x_tup, axis=0), -1, 0)  # (B, n)
        ub = jnp.moveaxis(jnp.stack(u_cols, axis=0), -1, 0)  # (B, nv)

        eye = jnp.asarray(dtype_eye, x_tup[0].dtype)
        S = eye * dt
        term = eye * dt
        for k in range(2, order + 1):
            term = (dt / k) * (A_cb @ term)
            S = S + term
        Ad = eye + A_cb @ S
        Bd = S @ B_c
        x_new = xb + jnp.einsum("bij,bj->bi", S, f0)
        cd = x_new - jnp.einsum("bij,bj->bi", Ad, xb) - jnp.einsum("bij,bj->bi", Bd, ub)
        return Ad, Bd, cd, x_new

    def rollout(x0, us):
        # x0: (B, n); us: (B, H, m)
        x_tup = tuple(x0[:, i] for i in range(n))

        def body(carry, u_t):
            x_tup = carry
            u_cols = tuple(u_t[:, i] for i in range(nv))
            Ad, Bd, cd, x_new = step(x_tup, u_cols)
            x_tup_new = tuple(x_new[:, i] for i in range(n))
            return x_tup_new, (Ad, Bd, cd, x_new)

        us_t = jnp.moveaxis(us, 1, 0)  # (H, B, m)
        _, (A_seq, B_seq, c_seq, xs) = jax.lax.scan(body, x_tup, us_t)
        # (H, B, ...) → (B, H, ...)
        return (
            jnp.moveaxis(A_seq, 0, 1),
            jnp.moveaxis(B_seq, 0, 1),
            jnp.moveaxis(c_seq, 0, 1),
            jnp.moveaxis(xs, 0, 1),
        )

    return rollout

"""Batch-in-lanes (SoA) Riccati interior-point MPC — the batched speed path.

`ctrl/riccati.py` solves each scenario's KKT systems with batch-FIRST arrays
((B, n, n) via vmap): every tiny 12×12/6×6 product becomes a batched matmul
of tiny tiles.  This module re-expresses the SAME interior-point recursion
with the scenario batch as the LAST axis of every array ((H, n, n, B)) and
every small contraction as an explicit broadcast-multiply-reduce over the
tiny dims, so each term is a full-width elementwise operation over the
batch that XLA fuses, and the m×m Schur solves are unrolled Cholesky
recurrences in the same layout.

Numerics are identical to ctrl/riccati.py (same Mehrotra predictor-corrector,
validated against it in tests/test_riccati_soa.py).

(Reference lineage: finite-horizon DARE recursion of mat_are_solver.hpp +
Mehrotra barrier handling of core/optimization/mehrotra_method.hpp:269.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# lanes-last small-matrix algebra: operands (i, k, B), batch B last
# ---------------------------------------------------------------------------


def _mm(X, Y):
    """(i, k, B) @ (k, j, B) → (i, j, B), elementwise over the batch."""
    return jnp.sum(X[:, :, None, :] * Y[None, :, :, :], axis=1)


def _mTm(X, Y):
    """Xᵀ Y: (k, i, B), (k, j, B) → (i, j, B)."""
    return jnp.sum(X[:, :, None, :] * Y[:, None, :, :], axis=0)


def _mv(X, v):
    """(i, k, B) @ (k, B) → (i, B)."""
    return jnp.sum(X * v[None, :, :], axis=1)


def _mTv(X, v):
    """Xᵀ v: (k, i, B), (k, B) → (i, B)."""
    return jnp.sum(X * v[:, None, :], axis=0)


def _chol_solve_lanes(G, rhs):
    """SPD solve in lanes layout: G (n, n, B), rhs (n, k, B) → (n, k, B),
    as a trace-time unrolled Cholesky recurrence of elementwise ops."""
    n = G.shape[0]
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        s = G[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jax.lax.rsqrt(s)
        inv_d[j] = d
        L[j][j] = s * d
        for i in range(j + 1, n):
            t = G[i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * d
    ys = [None] * n
    for i in range(n):
        t = rhs[i]
        for k in range(i):
            t = t - L[i][k][None] * ys[k]
        ys[i] = t * inv_d[i][None]
    xs = [None] * n
    for i in reversed(range(n)):
        t = ys[i]
        for k in range(i + 1, n):
            t = t - L[k][i][None] * xs[k]
        xs[i] = t * inv_d[i][None]
    return jnp.stack(xs, axis=0)


# ---------------------------------------------------------------------------
# Riccati passes, lanes layout
# ---------------------------------------------------------------------------


def lqr_backward_soa(A_seq, B_seq, Q, QN, R_seq):
    """Matrix backward pass.  A_seq (H, n, n, B), B_seq (H, n, m, B),
    Q/QN (n, n), R_seq (H, m, m, B) → (Ks (H, m, n, B), Gs (H, m, m, B))."""
    Qb = Q[..., None]

    def body(V, inp):
        At, Bt, Rt = inp
        VB = _mm(V, Bt)                      # (n, m, B)
        G = Rt + _mTm(Bt, VB)                # (m, m, B)
        F = _mTm(VB, At)                     # (m, n, B)
        K = _chol_solve_lanes(G, F)          # (m, n, B)
        Vn = Qb + _mTm(At, _mm(V, At)) - _mTm(F, K)
        Vn = 0.5 * (Vn + jnp.swapaxes(Vn, 0, 1))
        return Vn, (K, G)

    V0 = QN[..., None] + jnp.zeros_like(A_seq[0])
    _, (Ks, Gs) = jax.lax.scan(body, V0, (A_seq[::-1], B_seq[::-1], R_seq[::-1]))
    return Ks[::-1], Gs[::-1]


def lqr_solve_rhs_soa(Ks, Gs, A_seq, B_seq, r_seq, x0):
    """Vector pass reusing the cached gains.  r_seq (H, m, B), x0 (n, B)
    → δu (H, m, B)."""
    n = A_seq.shape[1]

    def backward(v, inp):
        At, Bt, rt, K, G = inp
        w = rt + _mTv(Bt, v)                           # (m, B)
        k = _chol_solve_lanes(G, w[:, None, :])[:, 0]  # (m, B)
        vn = _mTv(At, v) - _mTv(K, w)
        return vn, k

    v0 = jnp.zeros_like(x0, shape=(n,) + x0.shape[1:])
    _, ks_rev = jax.lax.scan(
        backward, v0,
        (A_seq[::-1], B_seq[::-1], r_seq[::-1], Ks[::-1], Gs[::-1]))
    ks = ks_rev[::-1]

    def forward(dx, inp):
        At, Bt, K, k = inp
        du = -_mv(K, dx) - k
        dx1 = _mv(At, dx) + _mv(Bt, du)
        return dx1, du

    _, dus = jax.lax.scan(forward, x0, (A_seq, B_seq, Ks, ks))
    return dus


def rollout_affine_soa(A_seq, B_seq, c_seq, x0, us):
    def body(x, inp):
        At, Bt, ct, ut = inp
        x1 = _mv(At, x) + _mv(Bt, ut) + ct
        return x1, x1

    _, xs = jax.lax.scan(body, x0, (A_seq, B_seq, c_seq, us))
    return xs


def qp_gradient_soa(A_seq, B_seq, c_seq, Q, QN, R, x0, us, x_ref=None,
                    u_ref=None):
    """∇J(U): one rollout + one adjoint pass, lanes layout.  us (H, m, B)."""
    xs = rollout_affine_soa(A_seq, B_seq, c_seq, x0, us)  # (H, n, B)
    dx = xs if x_ref is None else xs - x_ref
    qs = jnp.einsum("ij,hjb->hib", Q, dx)
    qs = qs.at[-1].set(jnp.einsum("ij,jb->ib", QN, dx[-1]))
    Rb = R[..., None]

    def adjoint(lam, inp):
        At, Bt, qt, ut = inp
        lam_full = qt + lam
        grad_u = jnp.sum(Rb * ut[None], axis=1) + _mTv(Bt, lam_full)
        return _mTv(At, lam_full), grad_u

    lam0 = jnp.zeros_like(xs[0])
    _, grads_rev = jax.lax.scan(
        adjoint, lam0, (A_seq[::-1], B_seq[::-1], qs[::-1], us[::-1]))
    grad = grads_rev[::-1]
    if u_ref is not None:
        grad = grad - jnp.einsum("ij,hjb->hib", R, u_ref)
    return grad, xs


def solve_box_mpc_riccati_soa_fused(A_seq, B_seq, c_seq, Q, QN, R, x0, lb,
                                    ub, x_ref=None, u_ref=None,
                                    iters: int = 8):
    """Scan-fused Mehrotra PDIP — same math as solve_box_mpc_riccati_soa,
    4 sequential scans per iteration instead of 7:

      * the nominal trajectory xs is AFFINE in u for fixed LTV data, so it
        updates incrementally (xs += a_p·dxs from the corrector forward
        pass) instead of re-rolling out every iteration;
      * the cost-gradient adjoint, the Riccati matrix backward pass, and the
        affine-step vector backward pass all run at the same reverse time
        index with compatible data flow — one fused reverse scan computes
        (grad_t, K_t, G_t, k_aff_t) together.

    With tiny per-step operands and 50-step chains the number of dependent
    scan stages is the cost model; this cuts the PDIP critical path by ~43%.
    Numerics identical to the unfused solver (asserted at f64 in
    tests/test_riccati_soa.py)."""
    H = A_seq.shape[0]
    m = B_seq.shape[2]
    dtype = A_seq.dtype
    LB = jnp.broadcast_to(lb.astype(dtype)[None, :, None],
                          (H, m) + A_seq.shape[3:])
    UB = jnp.broadcast_to(ub.astype(dtype)[None, :, None],
                          (H, m) + A_seq.shape[3:])
    N = H * m
    Rb = R[..., None]
    eye_m = jnp.eye(m, dtype=dtype)[..., None]

    vary0 = jnp.zeros((), dtype) * jnp.sum(x0)
    u = 0.5 * (LB + UB) + vary0
    sl = u - LB
    su = UB - u
    zl = jnp.ones_like(u) + vary0
    zu = jnp.ones_like(u) + vary0

    def max_step(v, dv):
        t = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, 0.995 * jnp.min(t, axis=(0, 1)))

    def stage_q(xs):
        dx = xs if x_ref is None else xs - x_ref
        qs = jnp.einsum("ij,hjb->hib", Q, dx)
        return qs.at[-1].set(jnp.einsum("ij,jb->ib", QN, dx[-1]))

    xs0 = rollout_affine_soa(A_seq, B_seq, c_seq, x0, u)

    def body(carry, _):
        u, sl, su, zl, zu, xs = carry
        qs = stage_q(xs)  # pointwise stage costs from the tracked trajectory
        D = zl / sl + zu / su

        # ---- ONE fused reverse scan: adjoint + Riccati backward + affine
        # vector backward.  grad_t needs (q_t, lam); the affine rhs needs
        # grad_t − zl + zu at the same index; K/G close over V.
        def bwd(carry_b, inp):
            lam, V, v = carry_b
            At, Bt, qt, ut, Dt = inp
            # ut arrives pre-shifted by u_ref, so grad_t = R(u−u_ref) + Bᵀλ
            lam_full = qt + lam
            grad_t = jnp.sum(Rb * ut[None], axis=1) + _mTv(Bt, lam_full)
            # predictor rhs is the PLAIN gradient (δu solves (H̄+D)δ = −grad,
            # same as riccati.py:194); r_dual enters only the corrector
            r_t = grad_t
            VB = _mm(V, Bt)
            G = (R[..., None] + eye_m * Dt[:, None, :]) + _mTm(Bt, VB)
            F = _mTm(VB, At)
            K = _chol_solve_lanes(G, F)
            w = r_t + _mTv(Bt, v)
            k = _chol_solve_lanes(G, w[:, None, :])[:, 0]
            Vn = Q[..., None] + _mTm(At, _mm(V, At)) - _mTm(F, K)
            Vn = 0.5 * (Vn + jnp.swapaxes(Vn, 0, 1))
            vn = _mTv(At, v) - _mTv(K, w)
            lam_n = _mTv(At, lam_full)
            return (lam_n, Vn, vn), (grad_t, K, G, k)

        u_eff = u if u_ref is None else u - u_ref
        v0 = jnp.zeros_like(xs[0])
        lam0 = jnp.zeros_like(xs[0])
        V0 = QN[..., None] + jnp.zeros_like(A_seq[0])
        _, (grad_r, Ks_r, Gs_r, kaff_r) = jax.lax.scan(
            bwd, (lam0, V0, v0),
            (A_seq[::-1], B_seq[::-1], qs[::-1], u_eff[::-1], D[::-1]))
        grad = grad_r[::-1]
        Ks, Gs, ks_aff = Ks_r[::-1], Gs_r[::-1], kaff_r[::-1]
        r_dual = grad - zl + zu

        mu = (jnp.sum(sl * zl, axis=(0, 1)) + jnp.sum(su * zu, axis=(0, 1))) \
            / (2 * N)

        # ---- forward affine step
        def fwd(dx, inp):
            At, Bt, K, k = inp
            du = -_mv(K, dx) - k
            dx1 = _mv(At, dx) + _mv(Bt, du)
            return dx1, du

        dx0 = jnp.zeros_like(x0)
        _, du_aff = jax.lax.scan(fwd, dx0, (A_seq, B_seq, Ks, ks_aff))
        dzl_aff = -zl - (zl / sl) * du_aff
        dzu_aff = -zu + (zu / su) * du_aff

        a_p = jnp.minimum(max_step(sl, du_aff), max_step(su, -du_aff))
        a_d = jnp.minimum(max_step(zl, dzl_aff), max_step(zu, dzu_aff))
        mu_aff = (
            jnp.sum((sl + a_p * du_aff) * (zl + a_d * dzl_aff), axis=(0, 1))
            + jnp.sum((su - a_p * du_aff) * (zu + a_d * dzu_aff), axis=(0, 1))
        ) / (2 * N)
        sigma = (mu_aff / jnp.maximum(mu, 1e-30)) ** 3

        rc_l = sigma * mu - du_aff * dzl_aff - zl * sl
        rc_u = sigma * mu + du_aff * dzu_aff - zu * su
        rhs = r_dual - rc_l / sl + rc_u / su

        # ---- corrector vector backward (reuses cached K, G)
        def bwd2(v, inp):
            At, Bt, rt, K, G = inp
            w = rt + _mTv(Bt, v)
            k = _chol_solve_lanes(G, w[:, None, :])[:, 0]
            vn = _mTv(At, v) - _mTv(K, w)
            return vn, k

        _, ks2_r = jax.lax.scan(
            bwd2, v0, (A_seq[::-1], B_seq[::-1], rhs[::-1], Ks[::-1],
                       Gs[::-1]))
        ks2 = ks2_r[::-1]

        # ---- corrector forward: du AND the trajectory delta dxs
        def fwd2(dx, inp):
            At, Bt, K, k = inp
            du = -_mv(K, dx) - k
            dx1 = _mv(At, dx) + _mv(Bt, du)
            return dx1, (du, dx1)

        _, (du, dxs) = jax.lax.scan(fwd2, dx0, (A_seq, B_seq, Ks, ks2))
        dzl = (rc_l - zl * du) / sl
        dzu = (rc_u + zu * du) / su

        a_p = jnp.minimum(max_step(sl, du), max_step(su, -du))
        a_d = jnp.minimum(max_step(zl, dzl), max_step(zu, dzu))

        u = u + a_p * du
        xs = xs + a_p * dxs  # trajectory is affine in u: no re-rollout
        sl = sl + a_p * du
        su = su - a_p * du
        zl = zl + a_d * dzl
        zu = zu + a_d * dzu
        return (u, sl, su, zl, zu, xs), None

    (u, sl, su, zl, zu, xs), _ = jax.lax.scan(
        body, (u, sl, su, zl, zu, xs0), None, length=iters)
    u = jnp.clip(u, LB, UB)
    xs = rollout_affine_soa(A_seq, B_seq, c_seq, x0, u)
    return u, xs


def solve_box_mpc_riccati_soa(A_seq, B_seq, c_seq, Q, QN, R, x0, lb, ub,
                              x_ref=None, u_ref=None, iters: int = 8):
    """Box-constrained LTV-MPC, lanes layout: A_seq (H, n, n, B),
    B_seq (H, n, m, B), c_seq (H, n, B), x0 (n, B), lb/ub (m,)
    → (us (H, m, B), xs (H, n, B)).  Same Mehrotra PDIP as
    riccati.solve_box_mpc_riccati."""
    H = A_seq.shape[0]
    m = B_seq.shape[2]
    B = A_seq.shape[-1]
    dtype = A_seq.dtype
    LB = jnp.broadcast_to(lb.astype(dtype)[None, :, None], (H, m, B))
    UB = jnp.broadcast_to(ub.astype(dtype)[None, :, None], (H, m, B))
    N = H * m

    vary0 = jnp.zeros((), dtype) * jnp.sum(x0)
    u = 0.5 * (LB + UB) + vary0
    sl = u - LB
    su = UB - u
    zl = jnp.ones((H, m, B), dtype) + vary0
    zu = jnp.ones((H, m, B), dtype) + vary0

    def max_step(v, dv):
        t = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, 0.995 * jnp.min(t, axis=(0, 1)))  # (B,)

    eye_m = jnp.eye(m, dtype=dtype)[..., None]

    def body(carry, _):
        u, sl, su, zl, zu = carry
        grad, _ = qp_gradient_soa(A_seq, B_seq, c_seq, Q, QN, R, x0, u,
                                  x_ref, u_ref)
        r_dual = grad - zl + zu
        mu = (jnp.sum(sl * zl, axis=(0, 1)) + jnp.sum(su * zu, axis=(0, 1))) \
            / (2 * N)  # (B,)
        D = zl / sl + zu / su  # (H, m, B)

        R_seq = R[None, :, :, None] + eye_m[None] * D[:, :, None, :]
        Ks, Gs = lqr_backward_soa(A_seq, B_seq, Q, QN, R_seq)
        dx0 = jnp.zeros_like(x0)

        du_aff = lqr_solve_rhs_soa(Ks, Gs, A_seq, B_seq, grad, dx0)
        dzl_aff = -zl - (zl / sl) * du_aff
        dzu_aff = -zu + (zu / su) * du_aff

        a_p = jnp.minimum(max_step(sl, du_aff), max_step(su, -du_aff))
        a_d = jnp.minimum(max_step(zl, dzl_aff), max_step(zu, dzu_aff))
        mu_aff = (
            jnp.sum((sl + a_p * du_aff) * (zl + a_d * dzl_aff), axis=(0, 1))
            + jnp.sum((su - a_p * du_aff) * (zu + a_d * dzu_aff), axis=(0, 1))
        ) / (2 * N)
        sigma = (mu_aff / jnp.maximum(mu, 1e-30)) ** 3

        rc_l = sigma * mu - du_aff * dzl_aff - zl * sl
        rc_u = sigma * mu + du_aff * dzu_aff - zu * su
        rhs = r_dual - rc_l / sl + rc_u / su
        du = lqr_solve_rhs_soa(Ks, Gs, A_seq, B_seq, rhs, dx0)
        dzl = (rc_l - zl * du) / sl
        dzu = (rc_u + zu * du) / su

        a_p = jnp.minimum(max_step(sl, du), max_step(su, -du))
        a_d = jnp.minimum(max_step(zl, dzl), max_step(zu, dzu))

        u = u + a_p * du
        sl = sl + a_p * du
        su = su - a_p * du
        zl = zl + a_d * dzl
        zu = zu + a_d * dzu
        return (u, sl, su, zl, zu), None

    (u, sl, su, zl, zu), _ = jax.lax.scan(body, (u, sl, su, zl, zu), None,
                                          length=iters)
    u = jnp.clip(u, LB, UB)
    xs = rollout_affine_soa(A_seq, B_seq, c_seq, x0, u)
    return u, xs

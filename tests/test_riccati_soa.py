"""Batch-in-lanes Riccati PDIP (ctrl/riccati_soa.py) — numerical equivalence
with the per-scenario vmapped solver (ctrl/riccati.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reak_tpu.ctrl import riccati, riccati_soa


def _random_ltv(rng, H=12, n=4, m=2, B=5):
    # stable-ish random LTV systems
    A = jnp.asarray(0.95 * np.stack(
        [np.eye(n) + 0.05 * rng.standard_normal((H, n, n))[h] for h in range(H)]
    ))[None].repeat(B, 0) + 0.01 * jnp.asarray(rng.standard_normal((B, H, n, n)))
    Bm = jnp.asarray(0.1 * rng.standard_normal((B, H, n, m)))
    c = jnp.asarray(0.01 * rng.standard_normal((B, H, n)))
    x0 = jnp.asarray(rng.standard_normal((B, n)))
    return A, Bm, c, x0


def test_soa_matches_vmapped_solver(rng):
    H, n, m, B = 12, 4, 2, 5
    A, Bm, c, x0 = _random_ltv(rng, H, n, m, B)
    Q = jnp.eye(n) * 2.0
    QN = jnp.eye(n) * 5.0
    R = jnp.eye(m) * 0.1
    lb = jnp.full(m, -0.7)
    ub = jnp.full(m, 0.7)

    u_ref, x_ref = jax.vmap(
        lambda a, b, cc, x: riccati.solve_box_mpc_riccati(
            a, b, cc, Q, QN, R, x, lb, ub, iters=12)
    )(A, Bm, c, x0)

    ul, xl = riccati_soa.solve_box_mpc_riccati_soa(
        jnp.moveaxis(A, 0, -1), jnp.moveaxis(Bm, 0, -1),
        jnp.moveaxis(c, 0, -1), Q, QN, R, x0.T, lb, ub, iters=12)
    u_soa = jnp.moveaxis(ul, -1, 0)
    x_soa = jnp.moveaxis(xl, -1, 0)

    np.testing.assert_allclose(np.asarray(u_soa), np.asarray(u_ref),
                               atol=1e-8, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(x_soa), np.asarray(x_ref),
                               atol=1e-8, rtol=1e-6)
    # some constraints active, none violated
    assert bool(jnp.any(jnp.abs(u_soa) > 0.69))
    assert bool(jnp.all(jnp.abs(u_soa) <= 0.7 + 1e-9))


def test_backward_pass_matches(rng):
    H, n, m, B = 8, 4, 2, 3
    A, Bm, _, _ = _random_ltv(rng, H, n, m, B)
    Q = jnp.eye(n)
    QN = jnp.eye(n) * 3.0
    Rs = jnp.asarray(rng.uniform(0.5, 2.0, (B, H, m))[:, :, :, None]
                     * np.eye(m)) + jnp.eye(m) * 0.1

    bw = jax.vmap(lambda a, b, r: riccati.lqr_backward(a, b, Q, QN, r))(
        A, Bm, Rs)
    Ks, Gs = riccati_soa.lqr_backward_soa(
        jnp.moveaxis(A, 0, -1), jnp.moveaxis(Bm, 0, -1), Q, QN,
        jnp.moveaxis(Rs, 0, -1))
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(Ks, -1, 0)),
                               np.asarray(bw.Ks), atol=1e-9)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(Gs, -1, 0)),
                               np.asarray(bw.Gs), atol=1e-9)


def test_make_kte_mpc_layouts_agree(rng):
    from reak_tpu.kte import models
    from reak_tpu.ctrl import mpc

    spec = models.planar_2link()
    prob = mpc.MPCProblem(
        Q=jnp.diag(jnp.array([10.0, 10.0, 1.0, 1.0])),
        R=jnp.eye(2) * 0.05,
        QN=jnp.diag(jnp.array([50.0, 50.0, 5.0, 5.0])),
        u_min=jnp.full(2, -3.0), u_max=jnp.full(2, 3.0), horizon=8)
    x0s = jnp.asarray(rng.uniform(-0.3, 0.3, (4, 4)))
    us0 = jnp.zeros((4, 8, 2))
    u_l, x_l = jax.jit(mpc.make_kte_mpc(spec, prob, 0.02, qp_iters=6,
                                        qp_layout="lanes"))(x0s, us0)
    u_v, x_v = jax.jit(mpc.make_kte_mpc(spec, prob, 0.02, qp_iters=6,
                                        qp_layout="vmap"))(x0s, us0)
    np.testing.assert_allclose(np.asarray(u_l), np.asarray(u_v),
                               atol=1e-8, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(x_l), np.asarray(x_v),
                               atol=1e-8, rtol=1e-6)


def test_fused_pdip_matches_unfused_f64(rng):
    """Scan-fused Mehrotra PDIP (4 scans/iter) is numerically identical to
    the 7-scan version, including x_ref/u_ref tracking."""
    from reak_tpu.ctrl.riccati_soa import (solve_box_mpc_riccati_soa,
                                           solve_box_mpc_riccati_soa_fused)

    H, n, m, B = 12, 4, 2, 5
    A = jnp.asarray(rng.standard_normal((H, n, n, B)) * 0.1
                    + np.eye(n)[None, :, :, None])
    Bm = jnp.asarray(rng.standard_normal((H, n, m, B)) * 0.2)
    c = jnp.asarray(rng.standard_normal((H, n, B)) * 0.05)
    x0 = jnp.asarray(rng.standard_normal((n, B)))
    Q = jnp.eye(n)
    QN = jnp.eye(n) * 5.0
    R = jnp.eye(m) * 0.1
    lb, ub = jnp.full(m, -1.5), jnp.full(m, 1.5)
    xr = jnp.asarray(rng.standard_normal((H, n, B)) * 0.1)
    ur = jnp.asarray(rng.standard_normal((H, m, B)) * 0.1)
    for kw in ({}, dict(x_ref=xr, u_ref=ur)):
        u1, x1 = solve_box_mpc_riccati_soa(A, Bm, c, Q, QN, R, x0, lb, ub,
                                           iters=12, **kw)
        u2, x2 = solve_box_mpc_riccati_soa_fused(A, Bm, c, Q, QN, R, x0, lb,
                                                 ub, iters=12, **kw)
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u2),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2),
                                   rtol=1e-10, atol=1e-12)


def _pdip_problem(rng, H=6, n=4, m=2, B=4):
    A = jnp.asarray(rng.standard_normal((H, n, n, B)) * 0.1
                    + np.eye(n)[None, :, :, None])
    Bm = jnp.asarray(rng.standard_normal((H, n, m, B)) * 0.2)
    c = jnp.asarray(rng.standard_normal((H, n, B)) * 0.05)
    x0 = jnp.asarray(rng.standard_normal((n, B)))
    Q, QN, R = jnp.eye(n), jnp.eye(n) * 5.0, jnp.eye(m) * 0.1
    lb, ub = jnp.full(m, -1.5), jnp.full(m, 1.5)
    xr = jnp.asarray(rng.standard_normal((H, n, B)) * 0.1)
    ur = jnp.asarray(rng.standard_normal((H, m, B)) * 0.1)
    return (A, Bm, c, Q, QN, R, x0, lb, ub), xr, ur


@pytest.mark.parametrize("refs", ["regulator", "x_ref", "x_ref+u_ref"])
def test_fused_pdip_matches_per_scenario_solver(rng, refs):
    """The batched scan-fused PDIP (the path every MPC cell runs) against the
    independent per-scenario solver (ctrl/riccati.py under vmap), for the
    regulator and both tracking variants (the tracking PDIP is what the
    error-state manifold MPC rides)."""
    from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused

    (A, Bm, c, Q, QN, R, x0, lb, ub), xr, ur = _pdip_problem(rng, B=5)
    kw = {"regulator": {}, "x_ref": dict(x_ref=xr),
          "x_ref+u_ref": dict(x_ref=xr, u_ref=ur)}[refs]
    u1, x1 = solve_box_mpc_riccati_soa_fused(A, Bm, c, Q, QN, R, x0, lb, ub,
                                             iters=10, **kw)
    bf = lambda a: jnp.moveaxis(a, -1, 0)
    u2, x2 = jax.vmap(lambda a, b, cc, x, *r: riccati.solve_box_mpc_riccati(
        a, b, cc, Q, QN, R, x, lb, ub,
        **dict(zip(kw, r)), iters=10))(bf(A), bf(Bm), bf(c), bf(x0),
                                       *[bf(v) for v in kw.values()])
    np.testing.assert_allclose(np.asarray(bf(u1)), np.asarray(u2),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(bf(x1)), np.asarray(x2),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n", [3, 6, 12])
def test_chol_solve_lanes_matches_dense_solve(rng, n):
    """The unrolled lanes Cholesky of every Riccati stage against LAPACK,
    several right-hand sides at once."""
    A = rng.standard_normal((64, n, n))
    G = A @ np.swapaxes(A, -1, -2) + 3 * np.eye(n)
    rhs = rng.standard_normal((64, n, 5))
    x = riccati_soa._chol_solve_lanes(jnp.moveaxis(jnp.asarray(G), 0, -1),
                                      jnp.moveaxis(jnp.asarray(rhs), 0, -1))
    np.testing.assert_allclose(np.moveaxis(np.asarray(x), -1, 0),
                               np.linalg.solve(G, rhs), rtol=1e-10,
                               atol=1e-12)


def test_small_chol_solve_under_vmap(rng):
    """math.linalg.small_chol_solve, the per-scenario solver's Schur solve,
    batched by vmap with vector and matrix right-hand sides."""
    from reak_tpu.math.linalg import small_chol_solve

    A = rng.standard_normal((32, 6, 6))
    G = A @ np.swapaxes(A, -1, -2) + 3 * np.eye(6)
    rhs = rng.standard_normal((32, 6, 4))
    Gj, rj = jnp.asarray(G), jnp.asarray(rhs)
    ref = np.linalg.solve(G, rhs)
    np.testing.assert_allclose(np.asarray(jax.vmap(small_chol_solve)(Gj, rj)),
                               ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(jax.vmap(small_chol_solve)(Gj, rj[..., 0])), ref[..., 0],
        rtol=1e-10, atol=1e-12)

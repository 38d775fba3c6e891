"""Control-sequence parity vs the independent C++ oracle (BASELINE.md:
≤1e-4 max error vs a reference C++ solve, same horizon, same model).

Both sides solve the SAME convex box-QP (identical LTV linearization exported
to the oracle), so the unique optimum must agree to solver tolerance; the C++
side shares no code with the JAX path (native/mpc_oracle.cpp).
"""
import os
import struct
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "native",
                                   "mpc_oracle.cpp"))
ORACLE = None  # path of the binary built by the ``oracle`` fixture


@pytest.fixture(scope="session", autouse=True)
def oracle(tmp_path_factory):
    """Builds the oracle from native/mpc_oracle.cpp once per test process,
    into that process's own temporary directory; skips without g++."""
    global ORACLE
    out = tmp_path_factory.mktemp("oracle") / "mpc_oracle"
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", SRC, "-o", str(out)],
                       check=True, capture_output=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        pytest.skip(f"cannot build the C++ oracle: {e}")
    ORACLE = str(out)
    return ORACLE


def _export(path, A, B, c, x0, Q, QN, R, lb, ub):
    H, n, m = B.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<qqq", H, n, m))
        for arr in (A, B, c, x0, Q, QN, R, lb, ub):
            f.write(np.ascontiguousarray(arr, np.float64).tobytes())


def _solve_oracle(tmp_path, A, B, c, x0, Q, QN, R, lb, ub):
    fin = str(tmp_path / "qp.bin")
    fout = str(tmp_path / "u.bin")
    _export(fin, A, B, c, x0, Q, QN, R, lb, ub)
    subprocess.run([ORACLE, fin, fout], check=True, timeout=120)
    H, _, m = B.shape
    return np.fromfile(fout, np.float64).reshape(H, m)


def _ltv_problem(H=12):
    """One SQP iteration's LTV data for the planar 2-link arm, exactly what
    the framework's own solver consumes."""
    from reak_tpu.kte import models, soa

    spec = models.planar_2link()
    n, m, dt = 4, 2, 0.02
    roll = soa.make_rollout_ltv_soa(spec, dt, H)
    x0 = jnp.array([[0.4, -0.2, 0.1, 0.05]])
    us = jnp.zeros((1, H, m))
    A_seq, B_seq, c_seq, _ = roll(x0, us)
    Q = np.eye(n)
    QN = np.eye(n) * 5.0
    R = np.eye(m) * 0.1
    lb = np.full(m, -3.0)
    ub = np.full(m, 3.0)
    return (np.asarray(A_seq[0], np.float64), np.asarray(B_seq[0], np.float64),
            np.asarray(c_seq[0], np.float64), np.asarray(x0[0], np.float64),
            Q, QN, R, lb, ub)


def test_riccati_pdip_matches_cpp_oracle(tmp_path):
    from reak_tpu.ctrl.riccati import solve_box_mpc_riccati

    A, B, c, x0, Q, QN, R, lb, ub = _ltv_problem()
    u_cpp = _solve_oracle(tmp_path, A, B, c, x0, Q, QN, R, lb, ub)

    u_jax, _ = solve_box_mpc_riccati(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
        jnp.asarray(Q), jnp.asarray(QN), jnp.asarray(R), jnp.asarray(x0),
        jnp.asarray(lb), jnp.asarray(ub), iters=30)
    err = float(np.abs(np.asarray(u_jax) - u_cpp).max())
    assert err <= 1e-4, f"control parity {err:.2e} > 1e-4"
    # some inputs must actually be at the bounds for the check to be meaningful
    active = np.sum((np.abs(u_cpp - lb[None, :]) < 1e-6)
                    | (np.abs(u_cpp - ub[None, :]) < 1e-6))
    assert active > 0, "no active box constraints — weak test instance"


def test_condensed_pdip_matches_cpp_oracle(tmp_path):
    """The condensed-QP path (ctrl.mpc.solve internals) hits the same optimum."""
    from reak_tpu.ctrl import mpc
    from reak_tpu.ctrl.qp import solve_box_qp

    A, B, c, x0, Q, QN, R, lb, ub = _ltv_problem(H=8)
    u_cpp = _solve_oracle(tmp_path, A, B, c, x0, Q, QN, R, lb, ub)

    Sx, Su, d = mpc.condense(jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
                             jnp.asarray(x0))
    prob = mpc.MPCProblem(Q=jnp.asarray(Q), R=jnp.asarray(R),
                          QN=jnp.asarray(QN), u_min=jnp.asarray(lb),
                          u_max=jnp.asarray(ub), horizon=8)
    Hq, g = mpc.build_qp(prob, Sx, Su, d, jnp.asarray(x0))
    LB = jnp.tile(jnp.asarray(lb), 8)
    UB = jnp.tile(jnp.asarray(ub), 8)
    res = solve_box_qp(Hq, g, LB, UB, iters=30)
    u_jax = np.asarray(res.x).reshape(8, 2)
    err = float(np.abs(u_jax - u_cpp).max())
    assert err <= 1e-4, f"condensed parity {err:.2e} > 1e-4"


import functools


@functools.lru_cache(maxsize=1)
def _flagship_ltv_batch():
    """One SQP iteration's LTV data for the FLAGSHIP config: 6-DoF 3R3R arm,
    H=50, dt=0.01, on a batch of 8 x0 drawn from the bench.py distribution
    (rng seed 0).  Cached: the SoA rollout compile is minutes on CPU and is
    shared by the parity and bench-accuracy tests."""
    from reak_tpu.kte import models, soa

    spec = models.manip_3r3r()
    roll = soa.make_rollout_ltv_soa(spec, 0.01, 50)
    rng = np.random.default_rng(0)
    x0 = np.concatenate(
        [rng.uniform(-0.5, 0.5, (8, 6)), rng.uniform(-0.2, 0.2, (8, 6))], axis=1)
    us = jnp.zeros((8, 50, 6))
    A, B, c, _ = roll(jnp.asarray(x0), us)
    return np.asarray(A), np.asarray(B), np.asarray(c), x0


FLAGSHIP_Q = np.diag(np.concatenate([np.full(6, 10.0), np.full(6, 1.0)]))
FLAGSHIP_QN = np.diag(np.concatenate([np.full(6, 50.0), np.full(6, 5.0)]))
FLAGSHIP_R = np.eye(6) * 0.05


@pytest.mark.slow
def test_flagship_6dof_h50_parity_vs_cpp_oracle(tmp_path):
    """BASELINE.md headline parity: 6-DoF KTE arm, H=50, <=1e-4 max control
    error vs the independent C++ solve, with ACTIVE box constraints."""
    from reak_tpu.ctrl.riccati import solve_box_mpc_riccati

    A_b, B_b, c_b, x0_b = _flagship_ltv_batch()
    A, B, c, x0 = A_b[0], B_b[0], c_b[0], x0_b[0]
    lb = np.full(6, -6.0)   # ~55% of the unconstrained |u|max:
    ub = np.full(6, 6.0)    # 24 actively-constrained entries on this instance
    u_cpp = _solve_oracle(tmp_path, A, B, c, x0,
                          FLAGSHIP_Q, FLAGSHIP_QN, FLAGSHIP_R, lb, ub)
    assert np.all(np.isfinite(u_cpp))

    u_jax, _ = solve_box_mpc_riccati(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
        jnp.asarray(FLAGSHIP_Q), jnp.asarray(FLAGSHIP_QN),
        jnp.asarray(FLAGSHIP_R), jnp.asarray(x0),
        jnp.asarray(lb), jnp.asarray(ub), iters=30)
    err = float(np.abs(np.asarray(u_jax) - u_cpp).max())
    assert err <= 1e-4, f"flagship control parity {err:.2e} > 1e-4"
    active = np.sum((np.abs(u_cpp - lb[None, :]) < 1e-6)
                    | (np.abs(u_cpp - ub[None, :]) < 1e-6))
    assert active > 0, "no active box constraints — weak test instance"


def _export_kte(path, spec, H, dt, x0, Q, QN, R, lb, ub):
    """Serialize (chain parameters, x0, weights) for the oracle's --kte mode:
    the C++ side builds its OWN forward dynamics + FD linearization
    (VERDICT r2 item 5; ref manipulator_model.cpp:292-355)."""
    from reak_tpu.kte.spec import JointType, FIXED, FREE

    nj = spec.n_joints
    assert all(JointType(t) not in (FIXED, FREE) for t in spec.joint_types)
    with open(path, "wb") as f:
        f.write(struct.pack("<qq", H, nj))
        f.write(np.float64(dt).tobytes())
        for i in range(nj):
            f.write(struct.pack("<q", int(spec.joint_types[i] == 1)))
            for arr in (spec.axes[i], spec.offsets_pos[i], spec.offsets_quat[i],
                        spec.com_pos[i], (spec.masses[i],), spec.inertias[i],
                        (spec.stiffness[i],), (spec.rest_q[i],),
                        (spec.damping[i],)):
                f.write(np.asarray(arr, np.float64).tobytes())
        for arr in (spec.gravity, x0, Q, QN, R, lb, ub):
            f.write(np.ascontiguousarray(arr, np.float64).tobytes())


def _solve_oracle_kte(tmp_path, spec, H, dt, x0, Q, QN, R, lb, ub):
    fin = str(tmp_path / "kte.bin")
    fout = str(tmp_path / "u_kte.bin")
    _export_kte(fin, spec, H, dt, x0, Q, QN, R, lb, ub)
    subprocess.run([ORACLE, "--kte", fin, fout], check=True, timeout=300)
    m = spec.nv
    return np.fromfile(fout, np.float64).reshape(H, m)


@pytest.mark.slow
def test_flagship_kte_end_to_end_parity_vs_cpp_oracle(tmp_path):
    """END-TO-END flagship parity (VERDICT r2 item 5): the oracle receives
    ONLY (chain parameters, x0, weights) — no JAX-derived matrices — builds
    its own scalar forward dynamics (Lagrangian/Christoffel + FD derivatives)
    and LTV model, and the control sequences still agree to the BASELINE.md
    bar (measured 2.4e-6 on this instance, 26 active constraints — the
    oracle's FD-linearization noise floor is ~1e-6 per LTV entry).
    """
    from reak_tpu.kte import models, lanes
    from reak_tpu.ctrl.riccati import solve_box_mpc_riccati

    spec = models.manip_3r3r()
    H, dt = 50, 0.01
    rng = np.random.default_rng(0)
    x0 = np.concatenate([rng.uniform(-0.5, 0.5, 6), rng.uniform(-0.2, 0.2, 6)])
    lb = np.full(6, -6.0)
    ub = np.full(6, 6.0)
    u_cpp = _solve_oracle_kte(tmp_path, spec, H, dt, x0, FLAGSHIP_Q,
                              FLAGSHIP_QN, FLAGSHIP_R, lb, ub)
    assert np.all(np.isfinite(u_cpp))

    roll = lanes.make_rollout_ltv_batchfirst(spec, dt, H)
    A, B, c, _ = roll(jnp.asarray(x0)[None], jnp.zeros((1, H, 6)))
    u_jax, _ = solve_box_mpc_riccati(
        A[0], B[0], c[0], jnp.asarray(FLAGSHIP_Q), jnp.asarray(FLAGSHIP_QN),
        jnp.asarray(FLAGSHIP_R), jnp.asarray(x0), jnp.asarray(lb),
        jnp.asarray(ub), iters=30)
    err = float(np.abs(np.asarray(u_jax) - u_cpp).max())
    assert err <= 1e-4, f"end-to-end flagship parity {err:.2e} > 1e-4"
    active = np.sum((np.abs(u_cpp - lb[None, :]) < 1e-6)
                    | (np.abs(u_cpp - ub[None, :]) < 1e-6))
    assert active > 0, "no active box constraints — weak test instance"


def test_flagship_kte_e2e_parity_reduced_default(tmp_path):
    """DEFAULT-SET flagship e2e parity (VERDICT r3 item 6): same 6-DoF 3R3R
    chain and --kte oracle protocol as the full H=50 slow test, reduced to
    H=8 so the rollout compiles in seconds — every default run re-proves the
    central correctness claim (oracle builds its OWN dynamics + FD
    linearization from raw chain parameters)."""
    from reak_tpu.kte import models, lanes
    from reak_tpu.ctrl.riccati import solve_box_mpc_riccati

    spec = models.manip_3r3r()
    H, dt = 8, 0.01
    rng = np.random.default_rng(0)
    x0 = np.concatenate([rng.uniform(-0.5, 0.5, 6), rng.uniform(-0.2, 0.2, 6)])
    lb = np.full(6, -1.0)
    ub = np.full(6, 1.0)
    u_cpp = _solve_oracle_kte(tmp_path, spec, H, dt, x0, FLAGSHIP_Q,
                              FLAGSHIP_QN, FLAGSHIP_R, lb, ub)
    assert np.all(np.isfinite(u_cpp))

    roll = lanes.make_rollout_ltv_batchfirst(spec, dt, H)
    A, B, c, _ = roll(jnp.asarray(x0)[None], jnp.zeros((1, H, 6)))
    u_jax, _ = solve_box_mpc_riccati(
        A[0], B[0], c[0], jnp.asarray(FLAGSHIP_Q), jnp.asarray(FLAGSHIP_QN),
        jnp.asarray(FLAGSHIP_R), jnp.asarray(x0), jnp.asarray(lb),
        jnp.asarray(ub), iters=30)
    err = float(np.abs(np.asarray(u_jax) - u_cpp).max())
    assert err <= 1e-4, f"reduced e2e flagship parity {err:.2e} > 1e-4"
    active = np.sum((np.abs(u_cpp - lb[None, :]) < 1e-6)
                    | (np.abs(u_cpp - ub[None, :]) < 1e-6))
    assert active > 0, "no active box constraints — weak test instance"


def _export_refs(path, A, B, c, x0, Q, QN, R, lb, ub, xr, ur):
    H, n, m = B.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<qqq", H, n, m))
        for arr in (A, B, c, x0, Q, QN, R, lb, ub, xr, ur):
            f.write(np.ascontiguousarray(arr, np.float64).tobytes())


def test_tracking_pdip_matches_cpp_oracle(tmp_path):
    """The round-5 TRACKING path (x_ref/u_ref — what the error-state
    free-base scenario MPC rides) against the independent C++ oracle on the
    SAME LTV data: the satellite error-state model about a tumbling nominal.
    Unique convex optimum ⇒ the two independent solvers must agree ≤1e-4."""
    from reak_tpu.ctrl import manifold_lanes as ml, ss_systems as ss
    from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused

    H, n, m = 14, 12, 6
    params = ss.satellite3D(mass=10.0,
                            inertia=jnp.diag(jnp.asarray([4.0, 5.0, 6.0])))
    dt = 0.1
    step = ml.sat_step_lanes(params, dt)
    ltv = ml.sat_error_ltv_lanes(params, dt)
    rng = np.random.default_rng(3)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    x = jnp.asarray(np.concatenate(
        [0.3 * rng.standard_normal(3), q, 0.2 * rng.standard_normal(3),
         0.4 * rng.standard_normal(3)]))[:, None]   # (13, 1) lanes
    u_nom = jnp.asarray(0.5 * rng.standard_normal((H, 6, 1)))
    # nominal rollout + per-step LTV — exactly the scenario solver's data
    xs = [x]
    A_l, B_l, c_l = [], [], []
    for t in range(H):
        Ad, Bd, cd = ltv(xs[-1], u_nom[t])
        A_l.append(Ad)
        B_l.append(Bd)
        c_l.append(cd)
        xs.append(step(xs[-1], u_nom[t]))
    A = np.stack([np.asarray(a[..., 0]) for a in A_l])     # (H, 12, 12)
    B = np.stack([np.asarray(b[..., 0]) for b in B_l])
    c = np.stack([np.asarray(cc[..., 0]) for cc in c_l])
    # tangent reference errors about the nominal (target = origin pose)
    x_ref = jnp.zeros(13).at[3].set(1.0).at[0:3].set(
        jnp.asarray([0.6, -0.4, 0.2]))
    e_ref = np.stack([
        np.asarray(ml.quat_local_lanes(x_ref[:, None], xs[t + 1])[:, 0])
        for t in range(H)])                                 # (H, 12)
    u_ref = 0.1 * rng.standard_normal((H, m))
    Q = np.diag(np.concatenate([np.full(6, 10.0), np.full(6, 1.0)]))
    QN = 10.0 * Q
    R = np.eye(m) * 0.05
    lb, ub = np.full(m, -8.0), np.full(m, 8.0)
    x0 = np.zeros(n)   # error state starts at the nominal

    fin = str(tmp_path / "track.bin")
    fout = str(tmp_path / "track_u.bin")
    _export_refs(fin, A, B, c, x0, Q, QN, R, lb, ub, e_ref, u_ref)
    subprocess.run([ORACLE, fin, fout], check=True, timeout=240)
    u_cpp = np.fromfile(fout, np.float64).reshape(H, m)

    u_jax, _ = solve_box_mpc_riccati_soa_fused(
        jnp.moveaxis(jnp.asarray(A)[None], 0, -1),
        jnp.moveaxis(jnp.asarray(B)[None], 0, -1),
        jnp.moveaxis(jnp.asarray(c)[None], 0, -1),
        jnp.asarray(Q), jnp.asarray(QN), jnp.asarray(R),
        jnp.asarray(x0)[:, None], jnp.asarray(lb), jnp.asarray(ub),
        x_ref=jnp.moveaxis(jnp.asarray(e_ref)[None], 0, -1),
        u_ref=jnp.moveaxis(jnp.asarray(u_ref)[None], 0, -1),
        iters=30)
    u_jax = np.asarray(u_jax[..., 0])
    err = float(np.abs(u_jax - u_cpp).max())
    assert err <= 1e-4, f"tracking parity {err:.2e} > 1e-4"
    active = np.sum((np.abs(u_cpp - lb[None]) < 1e-6)
                    | (np.abs(u_cpp - ub[None]) < 1e-6))
    assert active > 0, "no active box constraints — weak test instance"

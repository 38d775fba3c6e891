#!/usr/bin/env python
"""Free-base belief-sampled scenario MPC CLI — BASELINE config 4.

The composite the reference's estimation stack exists to feed but never
composes (no MPC exists in the reference): an invariant-EKF posterior on the
quaternion-state satellite (ref: ss_systems/satellite_invar_models.hpp:296),
tangent-space scenario sampling (ref: ctrl_sys/gaussian_belief_state.hpp:491
sample_gaussian_point; belief_state_predictor.hpp:79), and a batched
error-state MPC to a pose target (ctrl/mpc_manifold.py) — all on device,
vmapped over scenarios.

Usage:
  python examples/satellite_mpc.py --scenarios=32 --horizon=20
  python examples/satellite_mpc.py --est-steps=20 --target="1,0.5,-0.3" \\
      --output=plans.csv
"""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.io.config import config_from_args
from reak_tpu.ctrl import mpc, mpc_manifold as mm, ss_systems as ss
from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.ctrl.invariant import iekf_step
from reak_tpu.math import rotations as rot

import reak_tpu

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu.enable_full_precision()
reak_tpu.enable_compile_cache()


DEFAULTS = dict(
    dt=0.1, horizon=20, scenarios=16, est_steps=15,
    mass=10.0, inertia=(4.0, 5.0, 6.0),
    meas_noise=1e-2, proc_noise=1e-6, seed=0,
    u_max=20.0, qp_iters=8, sqp_iters=2,
    target="1.0,0.5,-0.3",   # pose-target position
    target_yaw=0.6,          # pose-target rotation about +z
    output="",               # recorder URI for per-scenario plans
)


def main(argv=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           DEFAULTS)
    params = ss.satellite3D(
        mass=cfg["mass"], inertia=jnp.diag(jnp.asarray(cfg["inertia"])))
    F = ss.satellite3D_imdt(params, cfg["dt"])
    Fu = lambda x, u, t=0.0: F(x, u, t)
    ret = ss.sat3D_retraction()
    rng = np.random.default_rng(cfg["seed"])

    # ---- estimate: IEKF over a simulated measured arc ---------------------
    Q = jnp.eye(12) * cfg["proc_noise"]
    R = jnp.diag(jnp.concatenate([jnp.full(3, cfg["meas_noise"] ** 2),
                                  jnp.full(3, 1e-5)]))
    x_true = ss.default_state().at[10:13].set(jnp.array([0.02, -0.01, 0.03]))
    b = GaussianBelief(ss.default_state(), 0.1 * jnp.eye(12))
    u0 = jnp.zeros(6)
    for _ in range(int(cfg["est_steps"])):
        x_true = F(x_true, u0)
        z = ss.h_pose(x_true)
        z = z.at[0:3].add(jnp.asarray(rng.normal(0, cfg["meas_noise"], 3)))
        b = iekf_step(Fu, ss.h_pose, ret, b, u0, z, Q, R,
                      diff=ss.pose_innovation)
    e_post = ret.local(x_true, b.mean)
    print(f"posterior tangent error |δp,δθ| = "
          f"{float(jnp.linalg.norm(e_post[0:6])):.4f}")

    # ---- plan: belief-sampled scenario MPC to the pose target -------------
    w = jnp.concatenate([jnp.full(6, 10.0), jnp.full(6, 1.0)])
    prob = mpc.MPCProblem(
        Q=jnp.diag(w), R=jnp.eye(6) * 0.05, QN=jnp.diag(10.0 * w),
        u_min=jnp.full(6, -cfg["u_max"]), u_max=jnp.full(6, cfg["u_max"]),
        horizon=int(cfg["horizon"]),
    )
    tgt = jnp.asarray([float(s) for s in str(cfg["target"]).split(",")])
    x_ref = ss.default_state().at[0:3].set(tgt)
    x_ref = x_ref.at[3:7].set(rot.q_from_axis_angle(
        jnp.array([0.0, 0.0, 1.0]), jnp.asarray(cfg["target_yaw"])))

    key = jax.random.PRNGKey(cfg["seed"])
    n = int(cfg["scenarios"])
    # the lanes fast path: exact imdt step + analytic error-state LTV +
    # whole-solve tracking PDIP (ctrl/manifold_lanes)
    from reak_tpu.ctrl import manifold_lanes as ml

    solver = ml.make_sat_scenario_mpc_lanes(
        params, prob, cfg["dt"], qp_iters=int(cfg["qp_iters"]),
        sqp_iters=int(cfg["sqp_iters"]))

    def plan(k):
        x0s = mm.sample_belief_states(k, b, n, ret=ret)
        us, xs = solver(x0s, x_ref, jnp.zeros((n, prob.horizon, 6)))
        return x0s, us, xs

    x0s, us, xs = jax.jit(plan)(key)

    perr = jnp.linalg.norm(xs[:, -1, 0:3] - x_ref[0:3], axis=-1)
    dth = jax.vmap(lambda q: jnp.linalg.norm(
        rot.q_log(rot.qmul(rot.qconj(x_ref[3:7]), q))))(xs[:, -1, 3:7])
    print(f"scenarios={n} horizon={prob.horizon} "
          f"terminal pos err mean={float(jnp.mean(perr)):.4f} "
          f"max={float(jnp.max(perr)):.4f} "
          f"rot err max={float(jnp.max(dth)):.4f}")

    if cfg["output"]:
        from reak_tpu.io.recorder import open_recorder

        cols = ["scenario", "t"] + [f"u{i}" for i in range(6)]
        rec = open_recorder(cfg["output"], cols)
        for i in range(n):
            for t in range(prob.horizon):
                rec.write_row(np.concatenate(
                    [[i, t * cfg["dt"]], np.asarray(us[i, t])]))
        rec.close()
        print(f"wrote plans to {cfg['output']}")

    return float(jnp.max(perr))


if __name__ == "__main__":
    main()

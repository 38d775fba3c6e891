#!/usr/bin/env python
"""Satellite target prediction CLI — estimate online, then predict forward.

JAX-native equivalent of the reference's predict_satellite3D app
(ref: examples/robot_airship/predict_satellite3D.cpp:414 main;
ctrl_sys/belief_state_predictor.hpp:79): run the invariant filter over a
measurement stream, then roll the belief forward over a horizon and emit the
maximum-likelihood predicted trajectory + covariance traces.

Usage:
  python examples/predict_satellite3d.py --steps=100 --horizon=50 \\
      --output=pred.csv
"""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.io.config import config_from_args
from reak_tpu.ctrl import ss_systems as ss
from reak_tpu.ctrl import predictor
from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.ctrl.invariant import iekf_step

from estimate_satellite3d import (DEFAULTS as EST_DEFAULTS, make_system,
                                  truth_rollout, noisy_measurements)

import reak_tpu

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu.enable_full_precision()
reak_tpu.enable_compile_cache()

DEFAULTS = dict(EST_DEFAULTS, horizon=50, n_scenarios=0, output="")


def main(argv=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           defaults=DEFAULTS)
    params, F = make_system(cfg)
    key = jax.random.PRNGKey(cfg["seed"])
    xs = truth_rollout(F, cfg["steps"], key)
    zs = noisy_measurements(xs, cfg["meas_noise"], key)

    ret = ss.sat3D_retraction()
    Qd = jnp.eye(12) * cfg["proc_noise"]
    R = jnp.eye(9) * cfg["meas_noise"] ** 2 * 10 + jnp.eye(9) * 1e-8
    u = jnp.zeros(6)
    b = GaussianBelief(ss.default_state(), jnp.eye(12) * 0.5)
    for z in zs:
        b = iekf_step(F, ss.h_pose_gyro, ret, b, u, z, Qd, R,
                      diff=ss.pose_innovation)

    H = cfg["horizon"]
    traj = predictor.predict_belief_trajectory(
        F, ret, b, jnp.zeros((H, 6)), Qd, cfg["dt"],
        t0=cfg["steps"] * cfg["dt"])
    # report prediction quality vs continued truth
    x_true = xs[-1]
    for _ in range(H):
        x_true = F(x_true, u)
    err = float(jnp.linalg.norm(traj.means[-1, 0:3] - x_true[0:3]))
    print(f"predicted {H} steps; final position error vs truth: {err:.3e}")
    print(f"cov trace growth: {float(jnp.trace(traj.covs[-1]) / jnp.trace(traj.covs[0])):.2f}x")

    if cfg["n_scenarios"] > 0:
        scen = predictor.sample_scenarios(key, traj, cfg["n_scenarios"],
                                          ret=ret)
        print(f"sampled scenarios: {scen.shape} (feed to scenario-MPC batch)")

    if cfg["output"]:
        from reak_tpu.io.recorder import open_recorder
        cols = (["t"] + [f"x{i}" for i in range(13)] + ["cov_trace"])
        rec = open_recorder(cfg["output"], cols)
        for t, m, P in zip(np.asarray(traj.times), np.asarray(traj.means),
                           np.asarray(traj.covs)):
            rec.record([t, *m, float(np.trace(P))])
        rec.close()
        print(f"wrote predicted trajectory to {cfg['output']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python
"""Online composite pipeline: estimate → predict → intercept-plan → record.

JAX-native equivalent of the reference's dynamic-execution composition
(ref: examples/robot_airship/CRS_planner_dynexec.cpp:75
CRS_execute_dynamic_planner_impl + predict_satellite3D.cpp:414 streaming;
ctrl_sys/belief_state_predictor.hpp:79; interpolation/transformed_trajectory.hpp
DK∘IK mapping; path_planning/intercept_query.hpp:75):

  1. a satellite target drifts through the chaser arm's workspace; its noisy
     pose+gyro measurements stream over a LOOPBACK TCP ROW CHANNEL (the
     reference's --online-run measurement plane, network_recorder.cpp:28);
  2. an invariant EKF consumes rows as they arrive (online estimation);
  3. the final belief rolls forward through the belief predictor → the
     maximum-likelihood predicted target trajectory;
  4. the predicted SE(3) poses map through closed-form 3R3R IK into the
     chaser's joint space (the transformed_trajectory composition);
  5. the time-augmented intercept planner plans over the REAL collision
     stack (ChainWorkspace → proxy_query) to meet the target in time;
  6. the executed plan streams out through a recorder sink.

Usage:
  python examples/crs_dynexec.py --steps=40 --horizon=30 --output=plan.csv
"""
import sys
import os
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.io.config import config_from_args
from reak_tpu.io.recorder import TcpRecorder, NetworkServer, open_recorder
from reak_tpu.ctrl import ss_systems as ss
from reak_tpu.ctrl import predictor
from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.ctrl.invariant import iekf_step
from reak_tpu.kte import models, ik
from reak_tpu.math import rotations as rot
from reak_tpu.geom.shapes import Sphere, Plane
from reak_tpu.geom.proximity import ProxyModel
import reak_tpu.planning as pl
import reak_tpu.spaces.vector as sp

from run_crs_planner import chain_capsules

import reak_tpu

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu.enable_full_precision()
reak_tpu.enable_compile_cache()

DEFAULTS = dict(
    steps=40,            # measurement rows streamed online
    horizon=30,          # prediction steps
    dt=0.05,
    meas_noise=2e-3,
    proc_noise=1e-6,
    seed=0,
    port=48612,
    max_iters=120,
    output="",
)


def target_truth(cfg):
    """Satellite drifting through the arm workspace (reachable grapple)."""
    params = ss.satellite3D(mass=120.0, inertia=jnp.eye(3) * 8.0)
    F = ss.satellite3D_imdt(params, cfg["dt"])
    x = ss.default_state()
    x = x.at[0:3].set(jnp.array([0.62, -0.28, 0.40]))   # in-workspace start
    x = x.at[7:10].set(jnp.array([-0.035, 0.06, 0.01]))  # slow drift
    x = x.at[10:13].set(jnp.array([0.02, -0.01, 0.03]))  # slow tumble
    xs = [x]
    u = jnp.zeros(6)
    for _ in range(cfg["steps"] + cfg["horizon"]):
        xs.append(F(xs[-1], u))
    return F, jnp.stack(xs)


def stream_measurements(cfg, zs):
    """Loopback TCP row stream: a producer thread plays the measurement rows
    through TcpRecorder; the main thread consumes them row-by-row through
    NetworkServer — the reference's online measurement feed
    (estimate_satellite3D.cpp --online-run; network_recorder.cpp handshake)."""
    cols = [f"z{i}" for i in range(zs.shape[1])]
    server = NetworkServer(cfg["port"])

    def producer():
        recorder = TcpRecorder("127.0.0.1", cfg["port"], cols, buffered=False)
        for z in np.asarray(zs):
            recorder.record(z)
        recorder.close()

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    server.accept()
    while True:
        row = server.read_row()
        if row is None:
            break
        yield jnp.asarray(row)
    server.close()
    th.join(timeout=5.0)


def main(argv=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           defaults=DEFAULTS)
    key = jax.random.PRNGKey(cfg["seed"])

    # ---- truth + measurements ------------------------------------------
    F, xs = target_truth(cfg)
    zs = jax.vmap(ss.h_pose_gyro)(xs[1 : cfg["steps"] + 1])
    k1, k2 = jax.random.split(key)
    zs = zs.at[:, 0:3].add(cfg["meas_noise"] * jax.random.normal(k1, (cfg["steps"], 3)))

    # ---- 1+2: online estimation over the TCP row plane ------------------
    ret = ss.sat3D_retraction()
    Qd = jnp.eye(12) * cfg["proc_noise"]
    R = jnp.eye(9) * cfg["meas_noise"] ** 2 * 10 + jnp.eye(9) * 1e-8
    u = jnp.zeros(6)
    b = GaussianBelief(
        ss.default_state().at[0:3].set(jnp.array([0.6, -0.3, 0.4])),
        jnp.eye(12) * 0.25,
    )
    n_rows = 0
    for z in stream_measurements(cfg, zs):
        b = iekf_step(F, ss.h_pose_gyro, ret, b, u, z, Qd, R,
                      diff=ss.pose_innovation)
        n_rows += 1
    est_err = float(jnp.linalg.norm(b.mean[0:3] - xs[cfg["steps"], 0:3]))
    print(f"online estimate: {n_rows} rows streamed, pos err {est_err:.2e} m")

    # ---- 3: belief prediction -------------------------------------------
    H = cfg["horizon"]
    t0 = cfg["steps"] * cfg["dt"]
    traj = predictor.predict_belief_trajectory(
        F, ret, b, jnp.zeros((H, 6)), Qd, cfg["dt"], t0=t0)
    pred_err = float(jnp.linalg.norm(traj.means[-1, 0:3] - xs[-1, 0:3]))
    print(f"predicted {H} steps ahead; final pos err vs truth {pred_err:.2e} m")

    # ---- 4: map the predicted pose trajectory into joint space ----------
    # the reference's transformed_trajectory composition (target pose traj
    # ∘ chaser IK, CRS_planner_dynexec.cpp:180-195) as ONE batched device
    # IK over the tabulated belief means — the intercept planner consumes
    # the resulting interp.Trajectory natively (no per-sample host IK)
    spec = models.manip_3r3r()

    q_tab = jax.vmap(lambda mm: ik.ik_3r3r(
        spec, mm[0:3], rot.qnormalize(mm[3:7]), wrist=-1.0))(
        traj.means[: H + 1])
    from reak_tpu.interp.trajectory import Trajectory
    target_joint = Trajectory(
        times=jnp.arange(H + 1, dtype=jnp.float32) * cfg["dt"],
        points=q_tab)

    # ---- 5: intercept planning over the real collision stack, with the
    # TARGET BODY AS A MOVING OBSTACLE posed along its predicted trajectory
    # until grapple (the reference's proxy_traj_applicator composition,
    # manip_free_dynamic_workspace.hpp:60 + proxy_traj_applicator.hpp) -----
    space = sp.NdofSpace(jnp.full(6, -2.8), jnp.full(6, 2.8))
    env = ProxyModel(
        spheres=Sphere(jnp.array([[0.30, 0.25, 0.55]]), jnp.array([0.12])),
        planes=Plane(jnp.array([[0.0, 0.0, 1.0]]), jnp.array([-0.12])),
    )
    from reak_tpu.geom.shapes import ShapeSet
    from reak_tpu.planning.workspace import (TemporalChainWorkspace,
                                             rigid_traj_tabulated)

    tgrid = np.arange(H + 1) * cfg["dt"]  # planner-relative times
    target_body = ShapeSet(
        spheres=Sphere(jnp.zeros((1, 3)), jnp.array([0.08])),
        sphere_body=jnp.array([0]),
    )
    # the grapple fixture sits on the satellite's NEAR face: the body sphere
    # is offset radially outward from the predicted grapple point, so the
    # goal pose clears it while any sweep THROUGH the body is rejected
    p_pred = traj.means[: H + 1, 0:3]
    p_body = p_pred * (1.0 + 0.18 / jnp.linalg.norm(p_pred, axis=-1,
                                                    keepdims=True))
    target_rigid = rigid_traj_tabulated(
        jnp.asarray(tgrid), p_body,
        jax.vmap(rot.qnormalize)(traj.means[: H + 1, 3:7]),
    )
    ws = TemporalChainWorkspace(space, spec, chain_capsules(spec), env,
                                moving=[(target_body, target_rigid)],
                                margin=0.005, n_checks=8)
    iq = pl.InterceptQuery(start=jnp.zeros(6), target_traj=target_joint,
                           t_budget=H * cfg["dt"], v_max=4.0, goal_tol=0.35)
    res = pl.intercept_plan(ws, iq, max_iters=cfg["max_iters"], batch=32,
                            seed=cfg["seed"])
    if not res.success:
        print("no interception within the prediction horizon")
        return 1
    path = np.asarray(res.path)
    t_free = np.asarray(ws.is_free_txq_batch(jnp.asarray(path[:, 0]),
                                             jnp.asarray(path[:, 1:])))
    print(f"intercept planned: t={res.cost:.2f}s, "
          f"{res.path.shape[0]} waypoints "
          f"(all clear of the moving target body: {bool(t_free.all())}), "
          f"wall {res.wall_time_s:.2f}s")

    # ---- 6: record the executed plan ------------------------------------
    if cfg["output"]:
        rec = open_recorder(cfg["output"],
                            ["t"] + [f"q{i}" for i in range(6)])
        for row in np.asarray(res.path):
            rec.record(row)
        rec.close()
        print(f"wrote plan to {cfg['output']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

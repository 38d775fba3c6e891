#!/usr/bin/env python
"""Satellite state estimation CLI — EKF / invariant EKF / UKF, Monte-Carlo.

JAX-native equivalent of the reference's estimate_satellite3D app
(ref: examples/robot_airship/estimate_satellite3D.cpp:1482 main,
:1493-1496 --generate-meas, :1502-1505 --mc-runs, :1507 --online-run).

Key design difference: Monte-Carlo runs are ONE vmapped batch on device
(the reference loops them serially); measurement streams use the recorder
data plane (file / tcp:// / udp:// URIs, native C++ backend when available).

Usage:
  python examples/estimate_satellite3d.py --generate-meas=meas.bin --steps=200
  python examples/estimate_satellite3d.py --input=meas.bin --filter=iekf \\
      --output=est.csv
  python examples/estimate_satellite3d.py --mc-runs=256 --filter=iekf
"""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.io.config import config_from_args
from reak_tpu.ctrl import ss_systems as ss
from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.ctrl.invariant import iekf_step
from reak_tpu.ctrl.kalman import ekf_step
from reak_tpu.ctrl.ukf import ukf_step
from reak_tpu.math import rotations as rot

import reak_tpu

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu.enable_full_precision()
reak_tpu.enable_compile_cache()


DEFAULTS = dict(
    steps=150, dt=0.05, mass=1.0, inertia=(0.9, 1.1, 1.0),
    meas_noise=1e-3, proc_noise=1e-6, seed=0,
    filter="iekf",          # ekf | iekf | ukf
    mc_runs=0,              # >0: vmapped Monte-Carlo statistics
    generate_meas="",       # write a measurement stream and exit
    input="",               # read measurements from a recorded stream
    output="",              # recorder URI for estimates (csv/bin/tcp/udp)
    options="",             # serialized EstimatorOptions scene file: the
                            # whole model/noise/measurement config comes from
                            # the archive (ref: satellite_modeling_options)
)


def run_from_options(path: str, seed: int = 0):
    """Drive a full estimation run from a serialized EstimatorOptions scene
    (ref: satellite_modeling_options.hpp:73,537 + the --init/--system files
    of estimate_satellite3D.cpp): model kind, noise, measurement config
    (incl. sonar grounding) and the TSOS-vs-joint filter choice all come
    from the archive.  Returns (opts, final joint belief, truth state)."""
    from reak_tpu.io.serialization import load_scene
    from reak_tpu.ctrl import aug_kalman as ak
    from reak_tpu.ctrl.invariant import iekf_step as _iekf

    opts = load_scene(path)
    F = opts.discrete()
    h = opts.output()
    key = jax.random.PRNGKey(seed)
    n_aug = opts.n_aug
    n_s = 13

    # truth rollout with gentle thruster excitation (observability)
    b0 = opts.initial_belief()
    x = b0.mean
    ts = jnp.arange(opts.steps) * opts.time_step
    us = 0.5 * jnp.stack([jnp.sin(ts), jnp.cos(1.3 * ts),
                          jnp.sin(0.7 * ts), 0.2 * jnp.sin(2.1 * ts),
                          0.2 * jnp.cos(1.7 * ts),
                          0.2 * jnp.sin(0.9 * ts)], axis=-1)
    xs = [x]
    for t in range(opts.steps):
        xs.append(F(xs[-1], us[t]))
    xs = jnp.stack(xs)
    z_clean = jax.vmap(lambda xx: h(xx))(xs[1:])
    # measurement noise in INNOVATION space: [δp(3), δθ(3), rest]; the
    # attitude block perturbs the quaternion multiplicatively
    R = opts.measurement_cov()
    sd = jnp.sqrt(jnp.diag(R))
    n = z_clean.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    zs = z_clean.at[:, 0:3].add(sd[0:3] * jax.random.normal(k1, (n, 3)))
    dq = jax.vmap(rot.q_exp)(sd[3:6] * jax.random.normal(k2, (n, 3)))
    zs = zs.at[:, 3:7].set(jax.vmap(rot.qnormalize)(
        jax.vmap(rot.qmul)(z_clean[:, 3:7], dq)))
    if zs.shape[-1] > 7:
        zs = zs.at[:, 7:].add(
            sd[6:] * jax.random.normal(k3, (n, zs.shape[-1] - 7)))

    if opts.tsos and n_aug:
        Fsa = lambda s, a, u, t=0.0: F(jnp.concatenate([s, a]), u, t)[:n_s]
        hsa = lambda s, a, t=0.0: h(jnp.concatenate([s, a]), t)
        P0 = b0.cov
        # TSOS runs in ambient coordinates: 13-dim state block
        Ps = jnp.eye(n_s, dtype=P0.dtype) * 1e-2
        b = ak.tsos_init(b0.mean[:n_s], Ps, b0.mean[n_s:],
                         P0[12:12 + n_aug, 12:12 + n_aug])
        Qj = jax.scipy.linalg.block_diag(
            jnp.eye(n_s, dtype=P0.dtype) * 1e-6,
            jnp.eye(n_aug, dtype=P0.dtype) * 1e-8)
        # TSOS innovation is ambient (z − h): expand R's attitude rows to
        # the 4 quaternion components
        Ramb = jax.scipy.linalg.block_diag(
            R[0:3, 0:3], jnp.eye(4, dtype=R.dtype) * R[3, 3], R[6:, 6:])

        def scan_step(b, zu):
            z, u = zu
            b1 = ak.tsos_step(Fsa, hsa, b, u, z, Qj, Ramb)
            return b1, ak.tsos_state(b1)

        b, means = jax.lax.scan(scan_step, b, (zs, us))
        belief = ak.tsos_joint_belief(b)
    else:
        ret = opts.retraction()
        Qt = jnp.eye(12 + n_aug) * 1e-6

        def scan_step(b, zu):
            z, u = zu
            b1 = _iekf(F, lambda xx, t=0.0: h(xx), ret, b, u, z, Qt, R,
                       diff=opts.innovation())
            return b1, b1.mean

        b, means = jax.lax.scan(scan_step, b0, (zs, us))
        belief = b
    return opts, belief, xs[-1]


def make_system(cfg):
    J = jnp.diag(jnp.asarray(cfg["inertia"], jnp.float64))
    params = ss.satellite3D(mass=cfg["mass"], inertia=J)
    F = ss.satellite3D_imdt(params, cfg["dt"])
    return params, F


def truth_rollout(F, steps, key):
    x = ss.default_state().at[10:13].set(jnp.array([0.3, -0.8, 0.5]))
    u = jnp.zeros(6)
    xs = [x]
    for _ in range(steps):
        xs.append(F(xs[-1], u))
    return jnp.stack(xs)


def noisy_measurements(xs, noise, key):
    zs = jax.vmap(ss.h_pose_gyro)(xs[1:])
    k1, k2, k3 = jax.random.split(key, 3)
    n = zs.shape[0]
    zs = zs.at[:, 0:3].add(noise * jax.random.normal(k1, (n, 3)))
    zs = zs.at[:, 7:10].add(noise * jax.random.normal(k2, (n, 3)))
    dq = jax.vmap(rot.q_exp)(noise * jax.random.normal(k3, (n, 3)))
    q = jax.vmap(rot.qmul)(zs[:, 3:7], dq)
    return zs.at[:, 3:7].set(jax.vmap(rot.qnormalize)(q))


def run_filter(cfg, F, zs):
    """One filtered trajectory; returns stacked means."""
    dt = cfg["dt"]
    Qd = jnp.eye(12) * cfg["proc_noise"]
    R = jnp.eye(9) * cfg["meas_noise"] ** 2 * 10 + jnp.eye(9) * 1e-8
    u = jnp.zeros(6)
    ret = ss.sat3D_retraction()
    b0 = GaussianBelief(ss.default_state(), jnp.eye(12) * 0.5)

    kind = cfg["filter"]
    if kind == "iekf":
        step = lambda b, z: iekf_step(F, ss.h_pose_gyro, ret, b, u, z, Qd, R,
                                      diff=ss.pose_innovation)
    elif kind == "ekf":
        # EKF in ambient coordinates with quaternion renormalization
        def adjust(x, dx):
            # dx is 12-dim tangent; reuse the retraction for fairness
            return ret.retract(x, dx)
        step = lambda b, z: iekf_step(F, ss.h_pose_gyro, ret, b, u, z, Qd, R)
    elif kind == "ukf":
        step = lambda b, z: ukf_step(F, lambda x, t=0.0: ss.h_pose_gyro(x),
                                     b, u, z,
                                     jnp.eye(13) * cfg["proc_noise"],
                                     R)
        b0 = GaussianBelief(ss.default_state(), jnp.eye(13) * 0.5)
    else:
        raise SystemExit(f"unknown --filter={kind}")

    def scan_step(b, z):
        b1 = step(b, z)
        return b1, b1.mean

    _, means = jax.lax.scan(scan_step, b0, zs)
    return means


def main(argv=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           defaults=DEFAULTS)
    if cfg["options"]:
        opts, belief, x_true = run_from_options(cfg["options"], cfg["seed"])
        err_p = float(jnp.linalg.norm(belief.mean[0:3] - x_true[0:3]))
        print(f"options={cfg['options']} kind={opts.system_kind} "
              f"meas={opts.measurements} tsos={opts.tsos}")
        print(f"final position error: {err_p:.3e}")
        if opts.n_aug:
            print("estimated aug params:",
                  np.asarray(belief.mean[13:13 + opts.n_aug]))
        return 0
    params, F = make_system(cfg)
    key = jax.random.PRNGKey(cfg["seed"])

    if cfg["generate_meas"]:
        xs = truth_rollout(F, cfg["steps"], key)
        zs = noisy_measurements(xs, cfg["meas_noise"], key)
        from reak_tpu.io.recorder import open_recorder
        cols = ([f"p{i}" for i in range(3)] + [f"q{i}" for i in range(4)]
                + [f"w{i}" for i in range(3)])
        rec = open_recorder(cfg["generate_meas"], cols)
        for z in np.asarray(zs):
            rec.record(z)
        rec.close()
        print(f"wrote {zs.shape[0]} measurements to {cfg['generate_meas']}")
        return 0

    if cfg["input"]:
        from reak_tpu.io.recorder import open_extractor
        _, rows = open_extractor(cfg["input"])
        zs = jnp.asarray(rows)
        xs = None
    else:
        xs = truth_rollout(F, cfg["steps"], key)
        zs = noisy_measurements(xs, cfg["meas_noise"], key)

    if cfg["mc_runs"] > 0:
        # vmapped Monte-Carlo over measurement noise (replaces the serial
        # --mc-runs loop, estimate_satellite3D.cpp:1502)
        assert xs is not None, "--mc-runs needs simulated truth"
        keys = jax.random.split(key, cfg["mc_runs"])
        zs_mc = jax.vmap(lambda k: noisy_measurements(xs, cfg["meas_noise"], k)
                         )(keys)
        means = jax.vmap(lambda z: run_filter(cfg, F, z))(zs_mc)
        err_p = jnp.linalg.norm(means[:, -1, 0:3] - xs[-1, 0:3], axis=-1)
        err_w = jnp.linalg.norm(means[:, -1, 10:13] - xs[-1, 10:13], axis=-1)
        print(f"MC runs: {cfg['mc_runs']}   filter: {cfg['filter']}")
        print(f"final pos err: mean={float(err_p.mean()):.3e} "
              f"max={float(err_p.max()):.3e}")
        print(f"final rate err: mean={float(err_w.mean()):.3e} "
              f"max={float(err_w.max()):.3e}")
        return 0

    means = run_filter(cfg, F, zs)
    if xs is not None:
        err = float(jnp.linalg.norm(means[-1, 0:3] - xs[-1, 0:3]))
        print(f"filter={cfg['filter']}  final position error: {err:.3e}")
    if cfg["output"]:
        from reak_tpu.io.recorder import open_recorder
        cols = [f"x{i}" for i in range(means.shape[1])]
        rec = open_recorder(cfg["output"], cols)
        for m in np.asarray(means):
            rec.record(m)
        rec.close()
        print(f"wrote estimates to {cfg['output']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python
"""X8 quadrotor kinodynamic planning over a MEAQR control topology.

JAX-native equivalent of the reference's X8 planner app
(ref: examples/misc/X8_run_planner.cpp + quadrotor_scene.cpp: quadrotor
system + MEAQR topology + RRT*/SBA* planner, composed into one workload;
topology machinery misc/MEAQR_topology.hpp:316, planners
misc/MEAQR_rrtstar_planner.hpp:78 / MEAQR_sbastar_planner.hpp:85).

Pipeline:
  1. ctrl.ss_systems.quadrotor — the full nonlinear X-configuration model
     (quadrotor_system.hpp:51).
  2. Hover linearization on the 12-d error state (p, θ, v, ω) via jacfwd
     through the quaternion retraction — the LTI (A, B) the MEAQR topology
     needs.
  3. ctrl.aqr_space.MEAQRSpace — distance = minimum-energy cost-to-go,
     interpolation = the min-energy system trajectory.
  4. meaqr_rrt_star_plan / meaqr_sbastar_plan through a slalom of pillar
     obstacles (position-space collision gate).

Usage:
  python examples/x8_planner.py --planner=rrt_star --max-iters=40
  python examples/x8_planner.py --planner=sbastar
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.io.config import config_from_args
from reak_tpu.ctrl import ss_systems as ss
from reak_tpu.ctrl.aqr_space import (MEAQRSpace, meaqr_rrt_star_plan,
                                     meaqr_sbastar_plan)
from reak_tpu.math import rotations as rot
from reak_tpu.planning.queries import PlanningQuery

import reak_tpu

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu.enable_full_precision()
reak_tpu.enable_compile_cache()

DEFAULTS = dict(planner="rrt_star", max_iters=30, seed=0, step_size=2.0,
                n_grid=48, capacity=4096, output="")


def hover_lti(params):
    """LTI (A (12,12), B (12,4)) of the quadrotor about hover on the error
    state (p, θ, v, ω); θ the body rotation vector (quaternion retraction).
    At hover f(x0, u0) = 0 exactly, so the MEAQR drift term c vanishes."""
    f = ss.quadrotor_cont(params)
    u0 = jnp.full(4, ss.hover_thrust(params))

    def f_err(xe, du):
        p, th, v, w = xe[0:3], xe[3:6], xe[6:9], xe[9:12]
        q = rot.q_exp(th)  # unit quaternion from rotation vector
        x = jnp.concatenate([p, q, v, w])
        dx = f(x, u0 + du)
        # small-angle attitude rate: θ̇ = 2·vec(q̄⊗q̇) → at identity, 2·q̇_vec
        return jnp.concatenate([dx[0:3], 2.0 * dx[4:7], dx[7:10], dx[10:13]])

    z = jnp.zeros(12)
    du0 = jnp.zeros(4)
    A = jax.jacfwd(lambda xe: f_err(xe, du0))(z)
    B = jax.jacfwd(lambda du: f_err(z, du))(du0)
    return A, B


def pillar_scene():
    """Two pillars forcing a slalom in the x-y plane (quadrotor_scene.cpp)."""
    pillars = np.array([[3.0, 0.6], [6.0, -0.6]])
    radius = 0.9

    def is_free(pts):
        # pts: (K, 12) error states; gate on position (x, y)
        xy = pts[:, 0:2]
        d = jnp.stack([jnp.linalg.norm(xy - jnp.asarray(p)[None], axis=-1)
                       for p in pillars])
        return jnp.all(d > radius, axis=0)

    return is_free


def main(argv=None):
    cfg = config_from_args(sys.argv[1:] if argv is None else argv, DEFAULTS)
    params = ss.quadrotor()
    A, B = hover_lti(params)

    lower = jnp.array([-1.0, -3.0, -1.0, *[-0.6] * 3, *[-2.0] * 3, *[-2.0] * 3])
    upper = jnp.array([10.0, 3.0, 3.0, *[0.6] * 3, *[2.0] * 3, *[2.0] * 3])
    space = MEAQRSpace(A, B, lower, upper, R=jnp.eye(4) * 0.5,
                       t_max=3.0, n_grid=int(cfg.n_grid), time_weight=1.0)
    is_free = pillar_scene()

    start = np.zeros(12)
    goal = np.zeros(12)
    goal[0] = 9.0  # 9 m ahead, ending at rest (kinodynamic rendezvous)
    query = PlanningQuery(start, goal, goal_tolerance=1.2)

    t0 = time.perf_counter()
    planner = (meaqr_rrt_star_plan if cfg.planner == "rrt_star"
               else meaqr_sbastar_plan)
    res = planner(space, is_free, query, max_iters=int(cfg.max_iters),
                  step_size=float(cfg.step_size), seed=int(cfg.seed),
                  capacity=int(cfg.capacity))
    out = dict(
        planner=cfg.planner, success=bool(res.success),
        cost=float(res.cost), n_vertices=int(res.n_vertices),
        wall_s=round(time.perf_counter() - t0, 2),
    )
    print(json.dumps(out))
    if res.success and cfg.output:
        np.savetxt(cfg.output, np.asarray(res.path), delimiter=",")
    return 0 if res.success else 1


if __name__ == "__main__":
    raise SystemExit(main())

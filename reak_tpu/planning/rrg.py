"""RRG — Rapidly-exploring Random Graph.

(ref: ctrl/graph_alg/rr_graph.hpp:254 generate_rrg)

RRT-style steering toward uniform samples, but every new vertex also connects
to *all* collision-free neighbors inside the shrinking RRT* ball, producing a
graph (not a tree) whose shortest paths converge to optimal.  Device split: the
sample→nearest→steer→neighbor→edge-check pipeline runs as device batches; the
final shortest path is host A* (planning.graph_search.astar).
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.planning.graph_search import astar
from reak_tpu.planning.queries import PlanningQuery, PlanResult


def rrg_plan(workspace, query: PlanningQuery, max_iters: int = 300,
             batch: int = 16, step_size: float = 0.5, gamma: float = 2.0,
             goal_bias: float = 0.1, goal_tol: float = 0.3,
             seed: int = 0) -> PlanResult:
    space = workspace.space
    start = np.asarray(query.start, np.float64)
    goal = np.asarray(query.goal, np.float64)
    n = start.shape[-1]
    t0 = time.perf_counter()
    key = jax.random.PRNGKey(seed)

    verts = [start]
    edges, costs = [], []

    @jax.jit
    def wave(V, cnt, k):
        """One batched expansion wave: sample `batch` targets, steer from the
        nearest existing vertex, return candidate new points."""
        k1, k2 = jax.random.split(k)
        samp = space.sample(k1, (batch,))
        use_goal = jax.random.uniform(k2, (batch,)) < goal_bias
        samp = jnp.where(use_goal[:, None], jnp.asarray(goal)[None, :], samp)
        mask = jnp.arange(V.shape[0]) < cnt
        d = jax.vmap(lambda s: jnp.where(mask, space.distance(s, V), jnp.inf))(samp)
        ni = jnp.argmin(d, axis=1)
        near = V[ni]
        dd = jnp.maximum(d[jnp.arange(batch), ni], 1e-12)
        t = jnp.minimum(1.0, step_size / dd)
        new = space.clamp(near + t[:, None] * (samp - near))
        ok = workspace.edge_free_batch(near, new)
        return new, ni, ok

    cap = max_iters * batch + 1
    V = np.zeros((cap, n))
    V[0] = start
    cnt = 1
    goal_idx = -1

    for it in range(max_iters):
        key, k = jax.random.split(key)
        new, ni, ok = wave(jnp.asarray(V), jnp.asarray(cnt), k)
        new, ni, ok = np.asarray(new), np.asarray(ni), np.asarray(ok)
        # RRT* ball radius shrinks with graph size
        r = min(gamma * (np.log(cnt + 1) / (cnt + 1)) ** (1.0 / n), step_size * 2)
        for b in range(batch):
            if not ok[b]:
                continue
            vi = cnt
            V[vi] = new[b]
            cnt += 1
            # neighbor set within ball (batched distance on device)
            d = np.asarray(space.distance(jnp.asarray(new[b]),
                                          jnp.asarray(V[:vi])))
            nbrs = np.nonzero(d <= max(r, float(d[ni[b]]) + 1e-12))[0]
            if nbrs.size:
                A = jnp.asarray(np.repeat(new[b][None, :], nbrs.size, 0))
                B = jnp.asarray(V[nbrs])
                free = np.asarray(workspace.edge_free_batch(A, B))
                for u, okk in zip(nbrs, free):
                    if okk:
                        edges.append((int(u), vi))
                        costs.append(float(d[u]))
            if np.asarray(space.distance(jnp.asarray(new[b]),
                                         jnp.asarray(goal))) < goal_tol:
                goal_idx = vi
        if goal_idx >= 0 and it > max_iters // 4:
            break

    if goal_idx < 0:
        return PlanResult(success=False, path=None, cost=float("inf"),
                          n_vertices=cnt, n_iterations=max_iters,
                          wall_time_s=time.perf_counter() - t0)
    hgoal = np.asarray(jax.vmap(
        lambda p: space.distance(p, jnp.asarray(goal)))(jnp.asarray(V[:cnt])))
    path_idx, cost = astar(cnt, np.asarray(edges, np.int64),
                           np.asarray(costs), 0, goal_idx,
                           heuristic=lambda v: float(hgoal[v]))
    if path_idx is None:
        return PlanResult(success=False, path=None, cost=float("inf"),
                          n_vertices=cnt, n_iterations=max_iters,
                          wall_time_s=time.perf_counter() - t0)
    return PlanResult(success=True, path=jnp.asarray(V[path_idx]), cost=cost, n_vertices=cnt, n_iterations=max_iters, wall_time_s=time.perf_counter() - t0)

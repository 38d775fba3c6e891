"""SBA*-RRT* hybrid — anytime optimizing planner.

(ref: ctrl/graph_alg/sbastar_rrtstar.hpp generate_sbarrtstar — the reference's
flagship anytime planner: SBA* best-key density-guided expansion interleaved
with RRT* random exploration, all connections through the optimal
choose-parent + rewire machinery.)

JAX-native composition: every iteration draws ONE mixed K-sample wave —
half uniform/goal-biased (the RRT* exploration share), half Gaussian around
the current best-key SBA* front (key = (g + h)·(1 + α·density), density as a
batched KDE over the vertex set) — and pushes the whole wave through the
batched RRT* choose-parent/rewire step (planning/rrt_star._make_star_step),
so every accepted vertex is asymptotically-optimally wired regardless of
which strategy proposed it.  The SBA* share anneals toward exploration as
the solution improves (the reference's relaxation/temperature decay,
anytime_sbastar.hpp:485).

Returns an anytime cost history so callers (and tests) can check that the
hybrid's cost curve dominates both plain SBA* and plain RRT*.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.planning.queries import PlanningQuery, PlanResult, path_cost
from reak_tpu.planning.rrt_star import _StarState, _make_star_step


def sbastar_rrtstar_plan(
    workspace,
    query: PlanningQuery,
    max_iters: int = 150,
    step_size: float = 0.5,
    gamma: float = 3.0,
    goal_bias: float = 0.05,
    front_size: int = 8,
    density_bw: float = 0.4,
    sba_share: float = 0.5,
    capacity: int = 4096,
    seed: int = 0,
    K: int = 32,
    return_history: bool = False,
):
    """Anytime hybrid plan.  With ``return_history=True`` also returns the
    per-iteration best goal-connected cost (inf before the first solution)."""
    space = workspace.space
    start = jnp.asarray(query.start)
    goal = jnp.asarray(query.goal)
    n = start.shape[-1]
    n_sba = max(1, int(K * sba_share))

    def sba_sampler(state: _StarState, goal_, k):
        """Mixed wave: [SBA* local samples | uniform | goal bias]."""
        cap = state.verts.shape[0]
        k1, k2, k3 = jax.random.split(k, 3)
        vmask = jnp.arange(cap) < state.count
        h = space.distance(state.verts, jnp.broadcast_to(goal_, state.verts.shape))
        # batched KDE density over the current graph (the SBA* constriction
        # term, density_calculators.hpp)
        d2 = jnp.sum(
            (state.verts[:, None, :] - state.verts[None, :, :]) ** 2, axis=-1
        )
        dens = jnp.sum(
            jnp.where(vmask[None, :], jnp.exp(-d2 / (2 * density_bw**2)), 0.0),
            axis=-1,
        )
        keys_ = jnp.where(
            vmask & jnp.isfinite(state.costs),
            (state.costs + h) * (1.0 + 0.25 * dens),
            jnp.inf,
        )
        front = jnp.argsort(keys_)[:front_size]
        pick = jax.random.randint(k1, (n_sba,), 0, front_size)
        centers = state.verts[front[pick]]
        local = space.clamp(
            centers + step_size * jax.random.normal(k2, (n_sba, n))
        )
        uni = space.sample(k3, (K - n_sba,))
        n_goal = max(1, int(K * goal_bias))
        uni = uni.at[:n_goal].set(goal_)
        return jnp.concatenate([local, uni], axis=0)

    state = _StarState(
        verts=jnp.zeros((capacity, n), start.dtype).at[0].set(start),
        parents=jnp.full((capacity,), -1, jnp.int32),
        costs=jnp.full((capacity,), jnp.inf).at[0].set(0.0),
        count=jnp.asarray(1, jnp.int32),
    )
    step = jax.jit(_make_star_step(space, workspace, step_size, gamma,
                                   goal_bias, K=K, sampler=sba_sampler))

    @jax.jit
    def best_goal_cost(st: _StarState):
        vmask = jnp.arange(capacity) < st.count
        dg = space.distance(st.verts, jnp.broadcast_to(goal, st.verts.shape))
        ok = vmask & (dg <= query.goal_tolerance) & jnp.isfinite(st.costs)
        return jnp.min(jnp.where(ok, st.costs + dg, jnp.inf))

    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    history = np.full(max_iters, np.inf)
    for it in range(max_iters):
        key, sub = jax.random.split(key)
        state = step(state, goal, sub)
        history[it] = float(best_goal_cost(state))

    verts = np.asarray(state.verts)
    costs = np.asarray(state.costs)
    parents = np.asarray(state.parents)
    cnt = int(state.count)
    d_goal = np.asarray(space.distance(jnp.asarray(verts[:cnt]),
                                       jnp.broadcast_to(goal, (cnt, n))))
    near_goal = (d_goal <= query.goal_tolerance) & np.isfinite(costs[:cnt])
    wall = time.perf_counter() - t0
    if not near_goal.any():
        res = PlanResult(False, None, float("inf"), cnt, max_iters, wall)
        return (res, history) if return_history else res
    cand = np.where(near_goal)[0]
    gi = cand[np.argmin(costs[cand] + d_goal[cand])]
    path = [np.asarray(goal)]
    i = gi
    while i >= 0:
        path.append(verts[i])
        i = parents[i]
    path = np.stack(path[::-1])
    res = PlanResult(True, path, path_cost(space, path), cnt, max_iters, wall)
    return (res, history) if return_history else res

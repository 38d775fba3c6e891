"""RRT / bidirectional RRT with device-batched expansion waves.

(ref: ctrl/graph_alg/rr_tree.hpp:179 generate_rrt, :256 generate_bidirectional_rrt;
planner façade rrt_path_planner.hpp:64)

Per iteration, K samples expand simultaneously: one masked NN matrix, one
steer batch, one edge-collision batch (the reference draws ONE sample per
iteration, rr_tree.hpp:194-198).  Tree arrays live on device at fixed
capacity; the host loop only orchestrates and extracts the final path.
"""
from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.planning.queries import PlanningQuery, PlanResult, path_cost


class _TreeState(NamedTuple):
    verts: jax.Array  # (cap, n)
    parents: jax.Array  # (cap,) int32
    count: jax.Array  # () int32
    goal_idx: jax.Array  # () int32, -1 until connected


def _masked_nn(verts, count, queries, dist_fn):
    """Nearest existing vertex for each query (K,): masked brute-force argmin —
    exact NN, replaces the DVP-tree (metric_space_search.hpp:172) with one
    device-wide distance matrix."""
    cap = verts.shape[0]
    d = jax.vmap(lambda q: dist_fn(jnp.broadcast_to(q, verts.shape), verts))(queries)
    mask = jnp.arange(cap)[None, :] < count
    d = jnp.where(mask, d, jnp.inf)
    return jnp.argmin(d, axis=-1)


def _make_expand_step(space, workspace, step_size, goal_bias, goal_tol,
                      wave: int = 64):
    dist_fn = space.distance

    def expand(state: _TreeState, goal, key):
        cap, n = state.verts.shape
        k1, k2 = jax.random.split(key)
        K = wave  # expansion wave width
        samples = space.sample(k1, (K,))
        # goal bias: replace a slice of samples with the goal
        n_bias = max(1, int(K * goal_bias))
        samples = samples.at[:n_bias].set(goal)

        near_idx = _masked_nn(state.verts, state.count, samples, dist_fn)
        near = state.verts[near_idx]
        d = dist_fn(near, samples)
        t = jnp.minimum(1.0, step_size / jnp.maximum(d, 1e-12))
        new_pts = space.interpolate(near, samples, t)
        ok = workspace.edge_free_batch(near, new_pts)
        ok = ok & (d > 1e-9)

        # compact accepted points into tree slots
        offs = jnp.cumsum(ok.astype(jnp.int32)) - 1
        slots = jnp.where(ok, state.count + offs, cap - 1)  # rejected → scratch slot
        n_acc = jnp.sum(ok.astype(jnp.int32))
        # guard capacity
        fits = slots < (cap - 1)
        write = ok & fits
        verts = state.verts.at[slots].set(jnp.where(write[:, None], new_pts, state.verts[slots]))
        parents = state.parents.at[slots].set(
            jnp.where(write, near_idx.astype(jnp.int32), state.parents[slots])
        )
        count = jnp.minimum(state.count + n_acc, cap - 1).astype(jnp.int32)

        # goal connection test for accepted points
        gd = dist_fn(new_pts, jnp.broadcast_to(goal, new_pts.shape))
        hit = write & (gd <= goal_tol)
        hit_slot = jnp.where(jnp.any(hit), slots[jnp.argmax(hit)],
                             -1).astype(jnp.int32)
        goal_idx = jnp.where(state.goal_idx >= 0, state.goal_idx, hit_slot)
        return _TreeState(verts, parents, count, goal_idx)

    return expand


def rrt_plan(
    workspace,
    query: PlanningQuery,
    max_iters: int = 200,
    step_size: float = 0.5,
    goal_bias: float = 0.05,
    capacity: int = 8192,
    seed: int = 0,
    reporter=None,
) -> PlanResult:
    """Unidirectional RRT (ref: rr_tree.hpp:179 + rrt_path_planner.tpp:66)."""
    space = workspace.space
    start = jnp.asarray(query.start)
    goal = jnp.asarray(query.goal)
    n = start.shape[-1]

    verts = jnp.zeros((capacity, n), start.dtype).at[0].set(start)
    state = _TreeState(
        verts=verts,
        parents=jnp.full((capacity,), -1, jnp.int32),
        count=jnp.asarray(1, jnp.int32),
        goal_idx=jnp.asarray(-1, jnp.int32),
    )
    expand = jax.jit(_make_expand_step(space, workspace, step_size, goal_bias,
                                       query.goal_tolerance))
    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    it = 0
    for it in range(max_iters):
        key, sub = jax.random.split(key)
        state = expand(state, goal, sub)
        if reporter is not None:
            reporter(it, state)
        if int(state.goal_idx) >= 0:
            break

    gi = int(state.goal_idx)
    wall = time.perf_counter() - t0
    cnt = int(state.count)
    # motion-graph dump for the vlist/differ engines (ref:
    # vlist_sbmp_report, planner_exec_engines.hpp:214)
    graph = {"verts": np.asarray(state.verts[:cnt]),
             "parents": np.asarray(state.parents[:cnt])}
    if gi < 0:
        return PlanResult(False, None, float("inf"), cnt, it + 1, wall,
                          stats=graph)
    parents = np.asarray(state.parents)
    verts_np = np.asarray(state.verts)
    path = [np.asarray(goal)]
    i = gi
    while i >= 0:
        path.append(verts_np[i])
        i = parents[i]
    path = np.stack(path[::-1])
    return PlanResult(True, path, path_cost(space, path), cnt, it + 1, wall,
                      stats=graph)


def rrt_plan_batch(
    workspace,
    query: PlanningQuery,
    n_runs: int = 8,
    max_iters: int = 200,
    step_size: float = 0.5,
    goal_bias: float = 0.05,
    capacity: int = 4096,
    seed: int = 0,
    wave: int = 64,
):
    """Batched Monte-Carlo RRT: ALL ``n_runs`` randomized runs advance as
    ONE device program — a ``lax.while_loop`` over expansion waves, vmapped
    across runs — instead of the reference's serial repetition loop
    (ref: planner_exec_engines.hpp:125-160, the loop this replaces).

    The single-run planner dispatches max_iters tiny device calls per run
    (bound by per-call latency); here the host sees exactly one call for the whole MC batch
    and the per-run wall-clock amortizes to wall/n_runs.

    Returns ``(results, wall_s_total)`` with one PlanResult per run
    (``wall_time_s`` already amortized).
    """
    space = workspace.space
    start = jnp.asarray(query.start)
    goal = jnp.asarray(query.goal)
    n = start.shape[-1]
    expand = _make_expand_step(space, workspace, step_size, goal_bias,
                               query.goal_tolerance, wave=wave)

    def init_one(_):
        return _TreeState(
            verts=jnp.zeros((capacity, n), start.dtype).at[0].set(start),
            parents=jnp.full((capacity,), -1, jnp.int32),
            count=jnp.asarray(1, jnp.int32),
            goal_idx=jnp.asarray(-1, jnp.int32),
        )

    @jax.jit
    def solve_all(key):
        states = jax.vmap(init_one)(jnp.arange(n_runs))

        def cond(c):
            it, states, _ = c
            return (it < max_iters) & jnp.any(states.goal_idx < 0)

        def body(c):
            it, states, key = c
            key, sub = jax.random.split(key)
            subs = jax.random.split(sub, n_runs)
            states = jax.vmap(expand, in_axes=(0, None, 0))(states, goal,
                                                            subs)
            return it + 1, states, key

        it, states, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(0), states, key))
        return it, states

    t0 = time.perf_counter()
    iters, states = solve_all(jax.random.PRNGKey(seed))
    jax.block_until_ready(states.verts)
    wall = time.perf_counter() - t0
    iters = int(iters)

    results = []
    verts_np = np.asarray(states.verts)
    parents_np = np.asarray(states.parents)
    for r in range(n_runs):
        gi = int(states.goal_idx[r])
        cnt = int(states.count[r])
        graph = {"verts": verts_np[r, :cnt], "parents": parents_np[r, :cnt]}
        if gi < 0:
            results.append(PlanResult(False, None, float("inf"), cnt, iters,
                                      wall / n_runs, stats=graph))
            continue
        path = [np.asarray(goal)]
        i = gi
        while i >= 0:
            path.append(verts_np[r, i])
            i = parents_np[r, i]
        path = np.stack(path[::-1])
        results.append(PlanResult(True, path, path_cost(space, path), cnt,
                                  iters, wall / n_runs, stats=graph))
    return results, wall


class _Tree(NamedTuple):
    verts: jax.Array  # (cap, n)
    parents: jax.Array  # (cap,) int32
    count: jax.Array  # () int32


def _make_birrt_round(space, workspace, step_size, connect_tol):
    """One alternating bi-RRT round, fully batched (ref: rr_tree.hpp:256):
    grow tree A toward K random samples, then grow tree B toward A's newly
    accepted vertices (the connect heuristic), and report any (a, b) vertex
    pair that came within ``connect_tol``."""
    dist_fn = space.distance

    def grow(tree: _Tree, targets, src_required=None):
        """Batched extension of ``tree`` toward ``targets`` (K, n).
        Returns (tree', slots, new_pts, accepted)."""
        cap = tree.verts.shape[0]
        near_idx = _masked_nn(tree.verts, tree.count, targets, dist_fn)
        near = tree.verts[near_idx]
        d = dist_fn(near, targets)
        t = jnp.minimum(1.0, step_size / jnp.maximum(d, 1e-12))
        new_pts = space.interpolate(near, targets, t)
        ok = workspace.edge_free_batch(near, new_pts) & (d > 1e-9)
        if src_required is not None:
            ok = ok & src_required
        offs = jnp.cumsum(ok.astype(jnp.int32)) - 1
        slots = jnp.where(ok, tree.count + offs, cap - 1)
        fits = slots < (cap - 1)
        write = ok & fits
        verts = tree.verts.at[slots].set(
            jnp.where(write[:, None], new_pts, tree.verts[slots])
        )
        parents = tree.parents.at[slots].set(
            jnp.where(write, near_idx.astype(jnp.int32), tree.parents[slots])
        )
        count = jnp.minimum(tree.count + jnp.sum(ok.astype(jnp.int32)), cap - 1)
        return _Tree(verts, parents, count), slots, new_pts, write

    def round_step(tree_a: _Tree, tree_b: _Tree, key):
        K = 64
        samples = space.sample(key, (K,))
        tree_a, slots_a, new_a, acc_a = grow(tree_a, samples)
        # connect wave: B extends toward A's accepted new vertices
        tree_b, slots_b, new_b, acc_b = grow(tree_b, new_a, src_required=acc_a)
        gap = dist_fn(new_b, new_a)
        hit = acc_a & acc_b & (gap <= connect_tol)
        first = jnp.argmax(hit)
        bridge = jnp.where(
            jnp.any(hit),
            jnp.stack([slots_a[first], slots_b[first]]).astype(jnp.int32),
            jnp.array([-1, -1], jnp.int32),
        )
        return tree_a, tree_b, bridge

    return jax.jit(round_step)


def _trace_to_root(verts, parents, idx):
    path = []
    i = idx
    while i >= 0:
        path.append(verts[i])
        i = parents[i]
    return path  # leaf → root


def birrt_plan(
    workspace,
    query: PlanningQuery,
    max_iters: int = 200,
    step_size: float = 0.5,
    capacity: int = 8192,
    seed: int = 0,
) -> PlanResult:
    """TRUE bidirectional RRT (ref: rr_tree.hpp:256 generate_bidirectional_rrt):
    two trees rooted at start and goal; each round one tree extends toward a
    batch of random samples and the OTHER tree extends toward the accepted
    new vertices (batched connect test); roles alternate every round; the
    path is spliced at the first vertex pair within ``goal_tolerance``."""
    space = workspace.space
    start = jnp.asarray(query.start)
    goal = jnp.asarray(query.goal)
    n = start.shape[-1]

    def new_tree(root):
        return _Tree(
            verts=jnp.zeros((capacity, n), start.dtype).at[0].set(root),
            parents=jnp.full((capacity,), -1, jnp.int32),
            count=jnp.asarray(1, jnp.int32),
        )

    tree_s, tree_g = new_tree(start), new_tree(goal)
    round_step = _make_birrt_round(space, workspace, step_size,
                                   query.goal_tolerance)
    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    bridge_sg = None  # (start_tree_idx, goal_tree_idx)
    it = 0
    for it in range(max_iters):
        key, sub = jax.random.split(key)
        if it % 2 == 0:  # start tree explores, goal tree connects
            tree_s, tree_g, bridge = round_step(tree_s, tree_g, sub)
            if int(bridge[0]) >= 0:
                bridge_sg = (int(bridge[0]), int(bridge[1]))
                break
        else:  # alternate roles (the reference's alternation)
            tree_g, tree_s, bridge = round_step(tree_g, tree_s, sub)
            if int(bridge[0]) >= 0:
                bridge_sg = (int(bridge[1]), int(bridge[0]))
                break

    wall = time.perf_counter() - t0
    n_verts = int(tree_s.count) + int(tree_g.count)
    if bridge_sg is None:
        return PlanResult(False, None, float("inf"), n_verts, it + 1, wall)
    sv, sp_ = np.asarray(tree_s.verts), np.asarray(tree_s.parents)
    gv, gp = np.asarray(tree_g.verts), np.asarray(tree_g.parents)
    half_s = _trace_to_root(sv, sp_, bridge_sg[0])[::-1]  # start → bridge
    half_g = _trace_to_root(gv, gp, bridge_sg[1])  # bridge → goal
    path = np.stack(half_s + half_g)
    return PlanResult(True, path, path_cost(space, path), n_verts, it + 1, wall)

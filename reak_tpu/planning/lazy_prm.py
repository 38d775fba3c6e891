"""Lazy / pruned / branch-and-bound connection strategies.

(ref: ctrl/graph_alg/lazy_connector.hpp, pruned_connector.hpp,
branch_and_bound_connector.hpp, lazy_sbastar.hpp — the reference's family of
edge-evaluation-deferring and incumbent-pruning connectors.)

JAX-native composition:

* ``lazy_prm_plan`` — Lazy-PRM: build the roadmap with OPTIMISTIC edges
  (no collision checks), A* on host, then batch-validate ONLY the edges on
  the candidate path in one device call; invalid edges are dropped and the
  search repeats.  Collision checking — the expensive device work — is spent
  exclusively on edges a shortest path actually wants to use (the
  lazy_connector idea, with the per-edge device round-trips of the reference
  replaced by one batched validation per repair round).

* ``bnb_prune`` — branch-and-bound vertex pruning: given an incumbent
  solution cost, discard every vertex whose g + h exceeds it (the
  branch_and_bound_connector rule) in one masked device pass; used by the
  anytime planners between improvement rounds.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.planning.queries import PlanningQuery, PlanResult
from reak_tpu.planning.graph_search import astar


def lazy_prm_plan(
    workspace,
    query: PlanningQuery,
    n_samples: int = 512,
    k_neighbors: int = 8,
    max_repair_rounds: int = 30,
    seed: int = 0,
) -> PlanResult:
    """Lazy-PRM: optimistic roadmap + on-demand batched edge validation."""
    space = workspace.space
    t0 = time.perf_counter()
    key = jax.random.PRNGKey(seed)

    pts = space.sample(key, (2 * n_samples,))
    free = np.asarray(workspace.is_free_batch(pts))
    pts = np.asarray(pts)[free][:n_samples]
    V = np.concatenate([np.asarray(query.start)[None],
                        np.asarray(query.goal)[None], pts], axis=0)
    n_v = V.shape[0]
    Vj = jnp.asarray(V)

    dmat = np.array(
        jax.vmap(lambda p: space.distance(jnp.broadcast_to(p, Vj.shape), Vj))(Vj)
    )
    np.fill_diagonal(dmat, np.inf)
    nbr = np.argsort(dmat, axis=1)[:, :k_neighbors]
    ii = np.repeat(np.arange(n_v), k_neighbors)
    jj = nbr.ravel()
    keep = ii < jj
    ii, jj = ii[keep], jj[keep]
    costs = dmat[ii, jj]

    # edge status: 0 = unknown (assumed valid), 1 = known-invalid
    known_invalid = np.zeros(len(ii), bool)
    edge_index = {(int(a), int(b)): e for e, (a, b) in enumerate(zip(ii, jj))}

    h = lambda v: float(space.distance(Vj[v], Vj[1]))
    n_checked = 0
    rounds = 0
    for rounds in range(1, max_repair_rounds + 1):
        live = ~known_invalid
        edges = np.stack([ii[live], jj[live]], axis=1)
        path_ids, cost = astar(n_v, edges, costs[live], 0, 1, heuristic=h)
        if path_ids is None:
            return PlanResult(False, None, float("inf"), n_v, rounds,
                              time.perf_counter() - t0,
                              stats={"edges_checked": n_checked,
                                     "edges_total": len(ii)})
        # validate ONLY the candidate path's edges, one device batch
        pairs = [(min(a, b), max(a, b))
                 for a, b in zip(path_ids[:-1], path_ids[1:])]
        eidx = np.array([edge_index[p] for p in pairs])
        unchecked = eidx  # unknown edges on the path (invalid ones are gone)
        ok = np.asarray(workspace.edge_free_batch(
            Vj[ii[unchecked]], Vj[jj[unchecked]]))
        n_checked += len(unchecked)
        if ok.all():
            return PlanResult(True, V[path_ids], cost, n_v, rounds,
                              time.perf_counter() - t0,
                              stats={"edges_checked": n_checked,
                                     "edges_total": len(ii)})
        known_invalid[unchecked[~ok]] = True
    return PlanResult(False, None, float("inf"), n_v, rounds,
                      time.perf_counter() - t0,
                      stats={"edges_checked": n_checked,
                             "edges_total": len(ii)})


def bnb_prune(verts, costs, goal, incumbent_cost, space, count):
    """Branch-and-bound vertex mask: keep v iff g(v) + h(v) ≤ incumbent
    (ref: branch_and_bound_connector.hpp).  Returns a bool keep-mask; the
    caller compacts or masks its arrays (one fused device pass)."""
    cap = verts.shape[0]
    h = space.distance(verts, jnp.broadcast_to(goal, verts.shape))
    alive = jnp.arange(cap) < count
    return alive & (costs + h <= incumbent_cost)

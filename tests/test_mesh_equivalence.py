"""Mesh-shape equivalence: the sharded flagship solver and the fold_in-keyed
scenario sampling must produce IDENTICAL results on a 1-device and an 8-device
mesh (SURVEY §7 "multi-host determinism"): a replicated-vs-sharded mix-up
anywhere in the fused solver path would make the 8-device result differ
from the 1-device result here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P


def _flagship_pieces():
    from reak_tpu.kte import models
    from reak_tpu.ctrl import mpc

    spec = models.manip_3r3r()
    m = 6
    prob = mpc.MPCProblem(
        Q=jnp.diag(jnp.concatenate([jnp.full(6, 10.0), jnp.full(6, 1.0)])).astype(jnp.float32),
        R=(jnp.eye(m) * 0.05).astype(jnp.float32),
        QN=jnp.diag(jnp.concatenate([jnp.full(6, 50.0), jnp.full(6, 5.0)])).astype(jnp.float32),
        u_min=jnp.full(m, -40.0, jnp.float32),
        u_max=jnp.full(m, 40.0, jnp.float32),
        horizon=50,
    )
    solver = mpc.make_kte_mpc(spec, prob, 0.01, qp_iters=8, sqp_iters=1)
    return prob, solver


def _run_on_mesh(solver, n_devices, x0, u0):
    devs = jax.devices()[:n_devices]
    mesh = Mesh(np.array(devs), ("scenarios",))

    def local_step(x0s, u0s):
        us, xs = solver(x0s, u0s)
        mean_cost = jax.lax.pmean(jnp.mean(us**2), "scenarios")
        return us, mean_cost

    step = jax.jit(
        jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(P("scenarios"), P("scenarios")),
            out_specs=(P("scenarios"), P()),
        )
    )
    us, mc = step(x0, u0)
    return np.asarray(us), float(mc)


def test_flagship_solver_mesh_shape_invariant():
    """Same us (f32, tol 2e-6) and psum summary on mesh=1 vs mesh=8."""
    assert len(jax.devices()) >= 8, "conftest provides 8 virtual CPU devices"
    prob, solver = _flagship_pieces()
    H, m, n = prob.horizon, 6, 12
    batch = 8
    x0 = jnp.zeros((batch, n), jnp.float32).at[:, 0].add(
        jnp.linspace(0.1, 0.4, batch, dtype=jnp.float32))
    u0 = jnp.zeros((batch, H, m), jnp.float32)

    us1, mc1 = _run_on_mesh(solver, 1, x0, u0)
    us8, mc8 = _run_on_mesh(solver, 8, x0, u0)
    assert np.all(np.isfinite(us1))
    np.testing.assert_allclose(us1, us8, atol=2e-6, rtol=0)
    np.testing.assert_allclose(mc1, mc8, rtol=1e-6)


def test_fold_in_sampling_mesh_shape_invariant():
    """Scenario draws keyed by GLOBAL index via fold_in are identical whether
    the index range is computed on 1 device or sharded over 8 (SURVEY §7:
    seeded per-scenario PRNG reproducible across mesh shapes)."""
    from reak_tpu.ctrl.mpc_manifold import sample_belief_states
    from reak_tpu.ctrl import ss_systems as sss
    from reak_tpu.ctrl.belief import GaussianBelief

    ret = sss.sat3D_retraction()
    b = GaussianBelief(sss.default_state(), 0.05 * jnp.eye(12))
    key = jax.random.PRNGKey(11)
    n = 16

    ref = np.asarray(sample_belief_states(key, b, n, ret))

    # sharded evaluation: each device draws its own global-index slice
    mesh = Mesh(np.array(jax.devices()[:8]), ("scenarios",))
    L = jnp.linalg.cholesky(b.cov + 1e-12 * jnp.eye(12, dtype=b.cov.dtype))

    def local_draw(idx_shard):
        def one(i):
            k = jax.random.fold_in(key, i)
            e = L @ jax.random.normal(k, (12,), b.mean.dtype)
            return ret.retract(b.mean, e)

        return jax.vmap(one)(idx_shard)

    draw = jax.jit(jax.shard_map(
        local_draw, mesh=mesh, in_specs=P("scenarios"),
        out_specs=P("scenarios")))
    sharded = np.asarray(draw(jnp.arange(n)))
    np.testing.assert_allclose(ref, sharded, atol=0, rtol=0)

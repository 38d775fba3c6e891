"""Belief-state prediction over a horizon.

JAX-native equivalent of the reference's predicted-trajectory machinery
(ref: ctrl/ctrl_sys/belief_state_predictor.hpp:79 belief_predicted_trajectory,
discrete_ss_predicted_traj.hpp, maximum_likelihood_mapping.hpp), which grows a
lazy waypoint list of predicted beliefs one step at a time.  Here the whole
horizon is one `lax.scan` (fixed unroll — SURVEY.md §5.7), producing stacked
mean/covariance arrays that interpolate in O(1) and feed the MPC scenario
sampler directly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from reak_tpu.ctrl.belief import GaussianBelief
from reak_tpu.ctrl.invariant import Retraction, iekf_predict


class PredictedBeliefTrajectory(NamedTuple):
    times: jax.Array        # (H+1,)
    means: jax.Array        # (H+1, n)
    covs: jax.Array         # (H+1, n, n)

    def at_time(self, t):
        """Belief at query time (zero-order hold on cov, linear mean —
        matches the reference's waypoint bisection + interpolation,
        belief_state_predictor.hpp get_point_at_time)."""
        i = jnp.clip(jnp.searchsorted(self.times, t, side="right") - 1,
                     0, self.times.shape[0] - 2)
        t0, t1 = self.times[i], self.times[i + 1]
        s = jnp.where(t1 > t0, (t - t0) / (t1 - t0), 0.0)
        s = jnp.clip(s, 0.0, 1.0)
        mean = (1 - s) * self.means[i] + s * self.means[i + 1]
        return GaussianBelief(mean, self.covs[i])

    def ml_trajectory(self):
        """Maximum-likelihood state trajectory (ref:
        maximum_likelihood_mapping.hpp)."""
        return self.times, self.means


def predict_belief_trajectory(
    F: Callable,
    ret: Retraction,
    b0: GaussianBelief,
    us: jax.Array,
    Q: jax.Array,
    dt: float,
    t0: float = 0.0,
) -> PredictedBeliefTrajectory:
    """Open-loop belief rollout: H invariant-EKF predict steps
    (ref: belief_state_predictor.hpp:79; the predict step is
    kalman_filter.hpp:88 with no updates)."""
    def step(carry, inp):
        b, t = carry
        u = inp
        b1 = iekf_predict(F, ret, b, u, Q, t)
        return (b1, t + dt), (b1.mean, b1.cov)

    (_, _), (means, covs) = jax.lax.scan(step, (b0, t0), us)
    H = us.shape[0]
    times = t0 + dt * jnp.arange(H + 1, dtype=b0.mean.dtype)
    means = jnp.concatenate([b0.mean[None], means], axis=0)
    covs = jnp.concatenate([b0.cov[None], covs], axis=0)
    return PredictedBeliefTrajectory(times, means, covs)


def sample_scenarios(key, traj: PredictedBeliefTrajectory, n: int,
                     ret: Optional[Retraction] = None):
    """Draw n state-trajectory scenarios from a predicted belief trajectory
    (feeds the scenario-MPC batch; replaces the reference's serial Monte-Carlo
    noise draws, gaussian_belief_state.hpp:491 sample_gaussian_point).

    Tangent-space sampling when a retraction is given (quaternion states stay
    on the manifold); per-scenario keys via fold_in for mesh-shape-independent
    reproducibility (SURVEY.md §7 determinism note).
    """
    Hp1, nstate = traj.means.shape
    dim = ret.dim if ret is not None else nstate

    def one(i):
        k = jax.random.fold_in(key, i)
        eps = jax.random.normal(k, (Hp1, dim), traj.means.dtype)
        # covs are PSD; use eigh-free scaled-cholesky with jitter
        L = jnp.linalg.cholesky(
            traj.covs + 1e-12 * jnp.eye(dim, dtype=traj.covs.dtype))
        d = jnp.einsum("hij,hj->hi", L, eps)
        if ret is None:
            return traj.means + d
        return jax.vmap(ret.retract)(traj.means, d)

    return jax.vmap(one)(jnp.arange(n))

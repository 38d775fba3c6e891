"""Gaussian belief-space topology — beliefs as a metric space for planners.

(ref: ctrl/ctrl_sys/gaussian_belief_space.hpp:64 gaussian_belief_space — a
 product of a mean-point topology and a covariance topology
 (covar_topology.hpp), with the symmetrized-KL belief distance; consumed by
 the topology-generic planning machinery.)

JAX-native design: a belief point is a FLAT array ``[mean (n) | vech(S)
(n(n+1)/2)]`` where S is the lower-triangular square-root factor of the
covariance (P = S Sᵀ) — the reference's decomposed covariance storage
(decomp_covariance_matrix.hpp) chosen here because linear interpolation of
square-root factors stays positive-semidefinite, so the array-backed planners
(planning/rrt.py fixed-capacity vertex tables) can treat beliefs exactly like
joint vectors.  Distance is the symmetrized KL divergence of ctrl.belief.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from reak_tpu.ctrl.belief import GaussianBelief, belief_distance


def _tril_indices(n):
    # static (host) indices: these index fixed positions of the packed layout
    return np.tril_indices(n)


class GaussianBeliefSpace:
    """Metric space over Gaussian beliefs on an n-dim mean box.

    ``sigma_range = (s_min, s_max)``: sampled beliefs carry diagonal
    square-root factors with per-axis scales in this interval (the covariance
    "topology" of covar_topology.hpp — a bounded PSD cone chart).
    """

    order = 0

    def __init__(self, mean_lower, mean_upper, sigma_range=(0.05, 1.0),
                 mean_weight: float = 1.0):
        self.mean_lower = jnp.atleast_1d(jnp.asarray(mean_lower))
        self.mean_upper = jnp.atleast_1d(jnp.asarray(mean_upper))
        self.n = self.mean_lower.shape[-1]
        self.s_min, self.s_max = float(sigma_range[0]), float(sigma_range[1])
        self.mean_weight = float(mean_weight)
        self.n_tril = self.n * (self.n + 1) // 2

    # ---- packing ---------------------------------------------------------
    @property
    def dim(self):
        return self.n + self.n_tril

    def pack(self, b: GaussianBelief):
        """GaussianBelief → flat point (works on batches)."""
        S = jnp.linalg.cholesky(
            b.cov + 1e-12 * jnp.eye(self.n, dtype=b.cov.dtype))
        i, j = _tril_indices(self.n)
        return jnp.concatenate([b.mean, S[..., i, j]], axis=-1)

    def unpack(self, x) -> GaussianBelief:
        """Flat point → GaussianBelief (works on batches)."""
        mean = x[..., : self.n]
        v = x[..., self.n:]
        i, j = _tril_indices(self.n)
        S = jnp.zeros(x.shape[:-1] + (self.n, self.n), x.dtype)
        S = S.at[..., i, j].set(v)
        # keep the diagonal positive under interpolation/packing noise
        d = jnp.abs(jnp.diagonal(S, axis1=-2, axis2=-1)) + 1e-9
        ii = jnp.arange(self.n)
        S = S.at[..., ii, ii].set(d)
        cov = S @ jnp.swapaxes(S, -1, -2)
        return GaussianBelief(mean, cov)

    # ---- Space interface (planners) --------------------------------------
    def sample(self, key, batch=()):
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, tuple(batch) + (self.n,),
                               dtype=self.mean_lower.dtype)
        mean = self.mean_lower + u * (self.mean_upper - self.mean_lower)
        sig = jax.random.uniform(
            k2, tuple(batch) + (self.n,), minval=self.s_min,
            maxval=self.s_max, dtype=mean.dtype)
        i, j = _tril_indices(self.n)
        diag_pos = np.where(i == j)[0]  # static positions of diagonal entries
        v = jnp.zeros(tuple(batch) + (self.n_tril,), mean.dtype)
        v = v.at[..., diag_pos].set(sig)
        return jnp.concatenate([mean, v], axis=-1)

    def distance(self, a, b):
        """Symmetrized KL (ref: gaussian_belief_space.hpp:64 — the belief
        metric), with the mean part optionally re-weighted."""
        ba, bb = self.unpack(a), self.unpack(b)
        d = belief_distance(ba, bb)
        if self.mean_weight != 1.0:
            dm = jnp.sum((ba.mean - bb.mean) ** 2, axis=-1)
            d = d + (self.mean_weight - 1.0) * dm
        return jnp.sqrt(jnp.maximum(d, 0.0))

    def interpolate(self, a, b, t):
        """Linear on (mean, sqrt-factor): the PSD-cone geodesic chart the
        square-root storage makes linear."""
        tt = jnp.asarray(t)
        tb = tt[..., None] if jnp.ndim(tt) else tt
        return a + (b - a) * tb

    def difference(self, a, b):
        return a - b

    def clamp(self, x):
        mean = jnp.clip(x[..., : self.n], self.mean_lower, self.mean_upper)
        return jnp.concatenate([mean, x[..., self.n:]], axis=-1)

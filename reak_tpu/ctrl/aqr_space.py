"""AQR control topologies: IHAQR and MEAQR metric spaces for kinodynamic
planning.

JAX-native re-design of the reference's AQR planning topologies
(ref: examples/misc/IHAQR_topology.hpp:183 IHAQR_topology,
misc/MEAQR_topology.hpp:316,895 MEAQR_topology, planners over them
misc/MEAQR_rrtstar_planner.hpp:78, misc/MEAQR_sbastar_planner.hpp:85).

Both spaces wrap an affine LTI system  ẋ = A·x + B·u + c  and expose the
Space protocol (sample/distance/interpolate/clamp), so every planner in
reak_tpu.planning runs over them unchanged — steering happens along *system
trajectories*, not straight lines:

* :class:`IHAQRSpace` — distance is the infinite-horizon LQR cost-to-go
  quadratic form (CARE solution P); interpolation flows the closed-loop
  dynamics ẋ = (A−BK)(x−b) toward the target.
* :class:`MEAQRSpace` — distance is the minimum-energy cost
  min_T [ρ·T + eᵀG(T)⁻¹e], e = b − Φ(T)a − d(T), with G the weighted
  controllability Gramian; interpolation follows the exact minimum-energy
  trajectory x(s) = Φ(s)a + d(s) + G(s)Φ(T−s)ᵀG(T)⁻¹e.

All Gramians/transition matrices are tabulated on a fixed time grid at
construction (one `lax.scan`), so distance/interpolate are pure table
lookups + small matmuls — fully batched and jit-safe.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from reak_tpu.math.are import solve_care
from reak_tpu.math.linalg import solve_pd


def _tabulate(A, B, c, Rinv, t_max: float, n_grid: int):
    """Scan the matrix ODEs  Φ̇ = AΦ,  ḋ = A d + c,  Ġ = Φ B R⁻¹ Bᵀ Φᵀ
    with RK4 on the grid; returns stacked (Φ, d, G) at s_k = k·Δ."""
    n = A.shape[0]
    dt = t_max / n_grid
    BRB = B @ Rinv @ B.T

    def deriv(state):
        Phi, d, G = state
        return (A @ Phi, A @ d + c, Phi @ BRB @ Phi.T)

    def rk4(state, _):
        k1 = deriv(state)
        s2 = tuple(x + 0.5 * dt * k for x, k in zip(state, k1))
        k2 = deriv(s2)
        s3 = tuple(x + 0.5 * dt * k for x, k in zip(state, k2))
        k3 = deriv(s3)
        s4 = tuple(x + dt * k for x, k in zip(state, k3))
        k4 = deriv(s4)
        new = tuple(x + (dt / 6.0) * (a + 2 * b_ + 2 * c_ + d_)
                    for x, a, b_, c_, d_ in zip(state, k1, k2, k3, k4))
        return new, new

    init = (jnp.eye(n, dtype=A.dtype), jnp.zeros(n, A.dtype),
            jnp.zeros((n, n), A.dtype))
    _, (Phis, ds, Gs) = jax.lax.scan(rk4, init, None, length=n_grid)
    Phis = jnp.concatenate([init[0][None], Phis])
    ds = jnp.concatenate([init[1][None], ds])
    Gs = jnp.concatenate([init[2][None], Gs])
    times = dt * jnp.arange(n_grid + 1, dtype=A.dtype)
    return times, Phis, ds, Gs


class MEAQRSpace:
    """Minimum-Energy AQR topology (ref: MEAQR_topology.hpp:316)."""

    def __init__(self, A, B, lower, upper, c=None, R=None,
                 t_max: float = 2.0, n_grid: int = 64,
                 time_weight: float = 1.0):
        A = jnp.asarray(A, jnp.result_type(float))
        B = jnp.asarray(B, A.dtype)
        n, m = B.shape
        self.A, self.B = A, B
        self.c = jnp.zeros(n, A.dtype) if c is None else jnp.asarray(c, A.dtype)
        R = jnp.eye(m, dtype=A.dtype) if R is None else jnp.asarray(R, A.dtype)
        Rinv = jnp.linalg.inv(R)
        self.lower = jnp.asarray(lower, A.dtype)
        self.upper = jnp.asarray(upper, A.dtype)
        self.time_weight = time_weight
        self.times, self.Phis, self.ds, self.Gs = _tabulate(
            A, B, self.c, Rinv, t_max, n_grid)
        # regularize the Gramian at tiny T (G(0) = 0 is singular)
        eye = jnp.eye(n, dtype=A.dtype)
        self.Gs_reg = self.Gs + 1e-9 * eye

    @property
    def dim(self):
        return self.lower.shape[-1]

    def sample(self, key, batch=()):
        u = jax.random.uniform(key, tuple(batch) + (self.dim,),
                               dtype=self.lower.dtype)
        return self.lower + u * (self.upper - self.lower)

    def clamp(self, p):
        return jnp.clip(p, self.lower, self.upper)

    def contains(self, p):
        return jnp.all((p >= self.lower) & (p <= self.upper), axis=-1)

    # -- MEAQR cost --------------------------------------------------------
    def _costs_over_grid(self, a, b):
        """(n_grid+1,) cost for every horizon T on the grid (index 0 = ∞)."""
        xbar = jnp.einsum("tij,...j->t...i", self.Phis, a) + jnp.reshape(
            self.ds, (self.ds.shape[0],) + (1,) * (a.ndim - 1) + (-1,))
        e = b[None] - xbar                      # (T, ..., n)
        Ge = jnp.linalg.solve(self.Gs_reg, e[..., None])[..., 0] \
            if e.ndim == 2 else jax.vmap(
                lambda ee, G: jnp.linalg.solve(G, ee.T).T,
                in_axes=(0, 0))(e, self.Gs_reg)
        energy = jnp.einsum("t...i,t...i->t...", e, Ge)
        tshape = (self.times.shape[0],) + (1,) * (a.ndim - 1)
        cost = energy + self.time_weight * jnp.reshape(self.times, tshape)
        return cost.at[0].set(jnp.inf)          # T = 0 unusable

    def distance(self, a, b):
        """min-energy quasi-metric, broadcast over leading axes of a/b."""
        a, b = jnp.broadcast_arrays(jnp.asarray(a), jnp.asarray(b))
        costs = self._costs_over_grid(a, b)
        return jnp.sqrt(jnp.min(costs, axis=0))

    def interpolate(self, a, b, t):
        """Point a fraction ``t`` along the optimal min-energy trajectory
        a → b (ref: MEAQR steering, MEAQR_topology.hpp move_position_toward)."""
        a, b = jnp.broadcast_arrays(jnp.asarray(a), jnp.asarray(b))
        single = a.ndim == 1
        if single:
            a, b = a[None], b[None]
        t = jnp.broadcast_to(jnp.asarray(t, a.dtype), a.shape[:1])

        costs = self._costs_over_grid(a, b)     # (T, K)
        jT = jnp.argmin(costs, axis=0)          # optimal horizon index per pair
        js = jnp.clip((t * jT).astype(jnp.int32), 0, self.times.shape[0] - 1)
        jr = jnp.clip(jT - js, 0, self.times.shape[0] - 1)  # T − s index

        def one(ai, bi, jTi, jsi, jri):
            PhiT, dT, GT = self.Phis[jTi], self.ds[jTi], self.Gs_reg[jTi]
            Phis_, ds_, Gs_ = self.Phis[jsi], self.ds[jsi], self.Gs[jsi]
            Phir = self.Phis[jri]
            e = bi - PhiT @ ai - dT
            lam = jnp.linalg.solve(GT, e)
            return Phis_ @ ai + ds_ + Gs_ @ (Phir.T @ lam)

        out = jax.vmap(one)(a, b, jT, js, jr)
        out = self.clamp(out)
        return out[0] if single else out

    def difference(self, a, b):
        return a - b


class IHAQRSpace:
    """Infinite-horizon AQR topology (ref: IHAQR_topology.hpp:183): the
    metric is the LQR cost-to-go quadratic form; steering flows the
    closed-loop dynamics toward the target point."""

    def __init__(self, A, B, lower, upper, Q=None, R=None,
                 t_horizon: float = 2.0, n_grid: int = 64):
        A = jnp.asarray(A, jnp.result_type(float))
        B = jnp.asarray(B, A.dtype)
        n, m = B.shape
        Q = jnp.eye(n, dtype=A.dtype) if Q is None else jnp.asarray(Q, A.dtype)
        R = jnp.eye(m, dtype=A.dtype) if R is None else jnp.asarray(R, A.dtype)
        self.P = solve_care(A, B, Q, R)
        self.K = jnp.linalg.solve(R, B.T @ self.P)
        Acl = A - B @ self.K
        self.lower = jnp.asarray(lower, A.dtype)
        self.upper = jnp.asarray(upper, A.dtype)
        # tabulate the closed-loop flow e^{Acl s} on the grid
        dt = t_horizon / n_grid
        E = jax.scipy.linalg.expm(Acl * dt)

        def step(M, _):
            M2 = E @ M
            return M2, M2

        I = jnp.eye(n, dtype=A.dtype)
        _, Ms = jax.lax.scan(step, I, None, length=n_grid)
        self.flows = jnp.concatenate([I[None], Ms])  # (n_grid+1, n, n)

    @property
    def dim(self):
        return self.lower.shape[-1]

    def sample(self, key, batch=()):
        u = jax.random.uniform(key, tuple(batch) + (self.dim,),
                               dtype=self.lower.dtype)
        return self.lower + u * (self.upper - self.lower)

    def clamp(self, p):
        return jnp.clip(p, self.lower, self.upper)

    def contains(self, p):
        return jnp.all((p >= self.lower) & (p <= self.upper), axis=-1)

    def distance(self, a, b):
        d = jnp.asarray(b) - jnp.asarray(a)
        return jnp.sqrt(jnp.einsum("...i,ij,...j->...", d, self.P, d))

    def interpolate(self, a, b, t):
        """Flow the closed-loop system from a toward b for fraction t of the
        tabulated horizon: x = b + e^{Acl·t·T}(a − b)."""
        a = jnp.asarray(a)
        b = jnp.asarray(b)
        t = jnp.asarray(t)
        j = jnp.clip((t * (self.flows.shape[0] - 1)).astype(jnp.int32),
                     0, self.flows.shape[0] - 1)
        M = self.flows[j]                        # (..., n, n)
        return self.clamp(b + jnp.einsum("...ij,...j->...i", M, a - b))

    def difference(self, a, b):
        return a - b


class AQRWorkspace:
    """Workspace whose edges follow the space's *system trajectories* rather
    than straight lines (needed by AQR spaces; cf. planning.workspace
    Workspace.edge_free_batch's linear interpolation)."""

    def __init__(self, space, is_free_fn, n_checks: int = 16):
        self.space = space
        self._is_free = is_free_fn
        self.n_checks = n_checks

    def is_free_batch(self, pts):
        return self._is_free(pts)

    def edge_free_batch(self, a, b):
        ts = jnp.linspace(0.0, 1.0, self.n_checks)

        def at(t):
            return self.space.interpolate(a, b, jnp.full(a.shape[0], t))

        pts = jnp.stack([at(t) for t in ts], axis=1)  # (K, C, n)
        flat = pts.reshape(-1, pts.shape[-1])
        free = self._is_free(flat).reshape(a.shape[0], self.n_checks)
        return jnp.all(free, axis=-1)


def meaqr_rrt_star_plan(space: MEAQRSpace, is_free_fn, query, **kw):
    """RRT* over a MEAQR topology (ref: MEAQR_rrtstar_planner.hpp:78)."""
    from reak_tpu.planning.rrt_star import rrt_star_plan
    ws = AQRWorkspace(space, is_free_fn)
    return rrt_star_plan(ws, query, **kw)


def meaqr_sbastar_plan(space: MEAQRSpace, is_free_fn, query, **kw):
    """SBA* over a MEAQR topology (ref: MEAQR_sbastar_planner.hpp:85)."""
    from reak_tpu.planning.sbastar import sbastar_plan
    ws = AQRWorkspace(space, is_free_fn)
    return sbastar_plan(ws, query, **kw)

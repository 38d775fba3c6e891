"""Exact convex-pair distances for the "hard" shape pairs.

JAX-native replacement for the reference's NLP support-function fallback
(ref: geometry/proximity/prox_fundamentals_3D.hpp:57-264
findProximityByGJKEPA / NLP proximity, used for box-box, cylinder-cylinder,
box-cylinder — the pairs with no closed form).

Method: alternating closed-form projections between the two convex sets
(POCS).  Each shape has an exact Euclidean projection operator; iterating
  p ← proj_A(q),  q ← proj_B(p)
converges linearly to a closest-point pair for separated convex sets and to
a common point (distance 0) for intersecting ones.  Fixed iteration count →
jit/vmap-friendly; every step is a handful of fused elementwise ops.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from reak_tpu.geom.shapes import Box, Capsule, Cylinder, Sphere
from reak_tpu.math import rotations as rot


# ---------------------------------------------------------------------------
# exact point projections (world coords)
# ---------------------------------------------------------------------------


def project_sphere(p, s: Sphere):
    d = p - s.center
    n = jnp.linalg.norm(d, axis=-1, keepdims=True)
    inside = n[..., 0] <= s.radius
    on_surf = s.center + d / jnp.maximum(n, 1e-12) * s.radius[..., None]
    return jnp.where(inside[..., None], p, on_surf)


def project_box(p, b: Box):
    """Clamp in the box frame (ref: prox box support math, re-derived)."""
    local = rot.qrot_inv(b.quat, p - b.center)
    clamped = jnp.clip(local, -b.half_extents, b.half_extents)
    return b.center + rot.qrot(b.quat, clamped)


def project_capsule(p, c: Capsule):
    ab = c.b - c.a
    t = jnp.sum((p - c.a) * ab, axis=-1) / jnp.maximum(
        jnp.sum(ab * ab, axis=-1), 1e-12)
    t = jnp.clip(t, 0.0, 1.0)
    q = c.a + t[..., None] * ab
    d = p - q
    n = jnp.linalg.norm(d, axis=-1, keepdims=True)
    inside = n[..., 0] <= c.radius
    on_surf = q + d / jnp.maximum(n, 1e-12) * c.radius[..., None]
    return jnp.where(inside[..., None], p, on_surf)


def project_cylinder(p, c: Cylinder):
    """Exact flat-capped cylinder projection (the pair the reference can only
    handle via its NLP fallback)."""
    axis = c.b - c.a
    L = jnp.linalg.norm(axis, axis=-1)
    u = axis / jnp.maximum(L, 1e-12)[..., None]
    w = p - c.a
    t = jnp.sum(w * u, axis=-1)                 # axial coordinate ∈ [0, L]
    radial = w - t[..., None] * u
    r = jnp.linalg.norm(radial, axis=-1)
    rdir = radial / jnp.maximum(r, 1e-12)[..., None]

    t_cl = jnp.clip(t, 0.0, L)
    r_cl = jnp.minimum(r, c.radius)
    inside = (t >= 0.0) & (t <= L) & (r <= c.radius)
    # nearest boundary for interior points: side wall vs nearer cap
    d_side = c.radius - r
    d_cap = jnp.minimum(t, L - t)
    side_pt = c.a + t_cl[..., None] * u + rdir * c.radius[..., None]
    cap_t = jnp.where(t < L - t, 0.0, L)
    cap_pt = c.a + cap_t[..., None] * u + rdir * r_cl[..., None]
    interior_proj = jnp.where((d_side < d_cap)[..., None], side_pt, cap_pt)
    exterior_proj = c.a + t_cl[..., None] * u + rdir * r_cl[..., None]
    # NOTE: for *set* projection (closest point of the solid), interior
    # points project to themselves
    return jnp.where(inside[..., None], p, exterior_proj), interior_proj


def _proj_fn(shape) -> Callable:
    if isinstance(shape, Sphere):
        return lambda p: project_sphere(p, shape)
    if isinstance(shape, Box):
        return lambda p: project_box(p, shape)
    if isinstance(shape, Capsule):
        return lambda p: project_capsule(p, shape)
    if isinstance(shape, Cylinder):
        return lambda p: project_cylinder(p, shape)[0]
    raise TypeError(f"no projection for {type(shape).__name__}")


def _center(shape):
    if isinstance(shape, Sphere):
        return shape.center
    if isinstance(shape, Box):
        return shape.center
    if isinstance(shape, (Capsule, Cylinder)):
        return 0.5 * (shape.a + shape.b)
    raise TypeError


class PairResult(NamedTuple):
    """(ref: proximity record proximity_record_3D, proximity_finder_3D.hpp:49)"""

    distance: jax.Array   # ≥ 0; 0 when intersecting
    point_a: jax.Array    # closest point on A
    point_b: jax.Array    # closest point on B


def convex_pair(shape_a, shape_b, iters: int = 60) -> PairResult:
    """Closest points between two convex shapes by alternating projection.

    Works for any combination of Sphere/Capsule/Cylinder/Box (the reference
    needs per-pair analytic kernels plus an NLP fallback; one batched
    fixed-point loop covers them all here).  Shapes broadcast over leading
    axes.  Distance is exact at convergence; with the default 60 iterations
    the residual is far below collision-margin scales for separated pairs.
    """
    pa = _proj_fn(shape_a)
    pb = _proj_fn(shape_b)
    q0 = _center(shape_b)

    def step(carry, _):
        p, q = carry
        p1 = pa(q)
        q1 = pb(p1)
        return (p1, q1), None

    p0 = pa(q0)
    (p, q), _ = jax.lax.scan(step, (p0, pb(p0)), None, length=iters)
    return PairResult(distance=jnp.linalg.norm(p - q, axis=-1),
                      point_a=p, point_b=q)


# ---------------------------------------------------------------------------
# signed distance via support-function minimization (penetration depth)
# ---------------------------------------------------------------------------
#
# For convex A, B with Minkowski difference C = A ⊖ B, the signed distance is
#   sd(A, B) = −min_{|d|=1} h_C(d),   h_C(d) = h_A(d) + h_B(−d),
# where h_S is the support function: positive min ⇒ overlap with penetration
# depth = min (the minimal translation distance), negative min ⇒ separation
# with gap = −min.  This replaces the reference's GJK/EPA fallback
# (prox_fundamentals_3D.hpp:57-264 findProximityByGJKEPA), which returns
# closest/deepest points even in contact — but as one fixed-shape batched
# minimization over the direction sphere instead of an expanding polytope:
# SAT-complete candidate directions (face normals, axes, box edge-crosses)
# seed the search, projected subgradient refines, and the witness support
# points give the deepest-point pair.  jit/vmap-friendly throughout.


def support(shape, d):
    """Support h_S(d) = max_{x∈S} d·x and its witness point.

    ``d`` may carry extra leading axes (e.g. a candidate-direction axis)
    relative to the shape's batch axes.  Returns (h, witness)."""
    if isinstance(shape, Sphere):
        h = jnp.sum(d * shape.center, axis=-1) + shape.radius
        w = shape.center + shape.radius[..., None] * d
        return h, w
    if isinstance(shape, Capsule):
        ha = jnp.sum(d * shape.a, axis=-1)
        hb = jnp.sum(d * shape.b, axis=-1)
        end = jnp.where((ha >= hb)[..., None], shape.a + 0.0 * d, shape.b + 0.0 * d)
        h = jnp.maximum(ha, hb) + shape.radius
        return h, end + shape.radius[..., None] * d
    if isinstance(shape, Box):
        local = rot.qrot_inv(shape.quat, d)  # box-frame direction
        corner = jnp.sign(local) * shape.half_extents
        h = jnp.sum(d * shape.center, axis=-1) + jnp.sum(
            jnp.abs(local) * shape.half_extents, axis=-1
        )
        return h, shape.center + rot.qrot(shape.quat, corner)
    if isinstance(shape, Cylinder):
        axis = shape.b - shape.a
        L = jnp.linalg.norm(axis, axis=-1)
        u = axis / jnp.maximum(L, 1e-12)[..., None]
        mid = 0.5 * (shape.a + shape.b)
        ax_c = jnp.sum(d * u, axis=-1)
        d_perp = d - ax_c[..., None] * u
        np_ = jnp.linalg.norm(d_perp, axis=-1)
        rdir = d_perp / jnp.maximum(np_, 1e-12)[..., None]
        h = (
            jnp.sum(d * mid, axis=-1)
            + 0.5 * L * jnp.abs(ax_c)
            + shape.radius * np_
        )
        w = (
            mid
            + (0.5 * L * jnp.sign(ax_c))[..., None] * u
            + shape.radius[..., None] * rdir
        )
        return h, w
    raise TypeError(f"no support function for {type(shape).__name__}")


def _face_dirs(shape):
    """SAT-style candidate normals of a shape (list of (..., 3) arrays)."""
    if isinstance(shape, Box):
        R_cols = [rot.qrot(shape.quat, jnp.asarray(e, shape.center.dtype))
                  for e in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))]
        return R_cols
    if isinstance(shape, (Cylinder, Capsule)):
        axis = shape.b - shape.a
        L = jnp.linalg.norm(axis, axis=-1, keepdims=True)
        return [axis / jnp.maximum(L, 1e-12)]
    return []


def _fibonacci_dirs(k: int, dtype):
    """k roughly-uniform unit directions (static constants)."""
    import numpy as np

    i = np.arange(k) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / k)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    dirs = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    )
    return jnp.asarray(dirs, dtype)


def signed_pair(shape_a, shape_b, n_dirs: int = 64, refine_iters: int = 30
                ) -> PairResult:
    """Signed distance + witness points between two convex shapes.

    Positive = separation gap (matches ``convex_pair``), negative =
    penetration depth (minimal translation distance).  Witness points are the
    closest points when separated, the deepest points when overlapping.
    (ref: findProximityByGJKEPA, prox_fundamentals_3D.hpp:57-264.)
    """
    ca, cb = _center(shape_a), _center(shape_b)
    dtype = ca.dtype
    batch = jnp.broadcast_shapes(ca.shape[:-1], cb.shape[:-1])

    def h_and_grad(d):
        hA, wA = support(shape_a, d)
        hB, wB = support(shape_b, -d)
        return hA + hB, wA - wB, (wA, wB)

    # --- seed set: Fibonacci sphere + SAT candidates + center axis ----------
    seeds = [_fibonacci_dirs(n_dirs, dtype) if batch == () else
             jnp.broadcast_to(_fibonacci_dirs(n_dirs, dtype)[
                 (slice(None),) + (None,) * len(batch)], (n_dirs,) + batch + (3,))]
    cands = []
    for f in _face_dirs(shape_a) + _face_dirs(shape_b):
        cands.extend([f, -f])
    # box-box edge-cross directions complete the SAT set; degenerate
    # (parallel-edge) crosses are replaced by a face normal — a zero vector
    # would spuriously win the argmin with h_C(0) = 0
    fa, fb = _face_dirs(shape_a), _face_dirs(shape_b)
    if isinstance(shape_a, Box) and isinstance(shape_b, Box):
        for ea in fa:
            for eb in fb:
                cr = jnp.cross(ea, eb)
                nrm = jnp.linalg.norm(cr, axis=-1, keepdims=True)
                cands.append(jnp.where(nrm > 1e-8, cr / jnp.maximum(nrm, 1e-12), ea))
    dc = cb - ca
    dcn = jnp.linalg.norm(dc, axis=-1, keepdims=True)
    # coincident centers would make this a zero vector (h_C(0) = radii sum,
    # spuriously winning the argmin) — substitute a fixed axis
    ex = jnp.zeros_like(dc).at[..., 0].set(1.0)
    cands.append(jnp.where(dcn > 1e-8, dc / jnp.maximum(dcn, 1e-12), ex))
    if cands:
        cands = [jnp.broadcast_to(c, batch + (3,))[None] for c in cands]
        seeds.append(jnp.concatenate(cands, axis=0))
    D = jnp.concatenate(seeds, axis=0)  # (K, ..., 3)

    hs, _, _ = h_and_grad(D)  # (K, ...)
    best = jnp.argmin(hs, axis=0)
    d = jnp.take_along_axis(
        D, best[None, ..., None], axis=0
    )[0]  # (..., 3)

    # --- projected subgradient refinement on the sphere ---------------------
    scale = jnp.maximum(jnp.linalg.norm(dc, axis=-1), 1e-3)

    def body(carry, k):
        d, h_best, d_best = carry
        h, g, _ = h_and_grad(d)
        gt = g - jnp.sum(g * d, axis=-1, keepdims=True) * d
        eta = 0.5 * (0.8 ** k) / scale
        d_new = d - eta[..., None] * gt
        d_new = d_new / jnp.maximum(
            jnp.linalg.norm(d_new, axis=-1, keepdims=True), 1e-12)
        better = h < h_best
        h_best = jnp.where(better, h, h_best)
        d_best = jnp.where(better[..., None], d, d_best)
        return (d_new, h_best, d_best), None

    h0, _, _ = h_and_grad(d)
    (d, h_best, d_best), _ = jax.lax.scan(
        body, (d, h0, d), jnp.arange(refine_iters))
    h_fin, _, (wA, wB) = h_and_grad(d_best)
    better = h_fin < h_best
    h_best = jnp.where(better, h_fin, h_best)

    # positive branch: POCS closest points are exact — keep them
    pocs = convex_pair(shape_a, shape_b)
    separated = pocs.distance > 1e-6
    dist = jnp.where(separated, pocs.distance, -h_best)
    pa = jnp.where(separated[..., None], pocs.point_a, wA)
    pb = jnp.where(separated[..., None], pocs.point_b, wB)
    return PairResult(distance=dist, point_a=pa, point_b=pb)


def dist_box_box(b1: Box, b2: Box, iters: int = 60):
    """Signed box-box distance: exact SAT on overlap, POCS when separated
    (ref: prox_box_box fallback via NLP/EPA, prox_fundamentals_3D.hpp:57)."""
    return signed_pair(b1, b2).distance


def dist_cylinder_cylinder(c1: Cylinder, c2: Cylinder, iters: int = 60):
    """(ref: prox_cylinder_cylinder.hpp — exact flat caps, not the capsule
    approximation).  Signed: negative depth on overlap."""
    return signed_pair(c1, c2).distance


def dist_cylinder_box(c: Cylinder, b: Box, iters: int = 60):
    """(ref: prox_cylinder_box.hpp)  Signed: negative depth on overlap."""
    return signed_pair(c, b).distance

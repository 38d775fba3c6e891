"""Sorting & selection utilities, device-batched.

JAX-native equivalent of the reference's core/sorting layer
(ref: core/sorting/*.hpp — bubble/insertion/selection/comb/heap/merge/shell/
quick/intro sorts, consumed by DVP-tree partitioning and reachability sorts,
path_planning/reachability_sort.hpp).

Two tiers:

* the *operation surface* (sort / argsort / rank / top-k / median partition
  / lexicographic multi-key sort — the primitives the DVP tree and the
  reachability sort consume), backed by XLA's variadic sort, batched over
  leading axes;
* an explicit **bitonic sorting network** (`bitonic_sort` /
  `bitonic_argsort` / `bitonic_sort_kv`): a fixed compare-exchange schedule
  of ``log²n`` elementwise min/max waves over a static permutation — no
  data-dependent control flow, so it fuses into surrounding elementwise
  pipelines and is the form a Pallas kernel sorts lane-resident tiles with
  (XLA's sort is a called routine and cannot fuse).  This is the JAX-native
  answer to the reference's nine comparison sorts: on hardware where
  branching is per-lane-impossible, the sorting *network* is the algorithm.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def sort(x, axis=-1):
    return jnp.sort(x, axis=axis)


def argsort(x, axis=-1):
    return jnp.argsort(x, axis=axis)


def rank(x, axis=-1):
    """Rank of each element in its slice (0 = smallest)."""
    return jnp.argsort(jnp.argsort(x, axis=axis), axis=axis)


def top_k(x, k):
    """Largest k along the last axis: (values, indices)."""
    return jax.lax.top_k(x, k)


def smallest_k(x, k):
    """Smallest k along the last axis: (values, indices) — the k-NN selection
    primitive (ref: dvp_tree_detail.hpp nearest-neighbor queue)."""
    v, i = jax.lax.top_k(-x, k)
    return -v, i


def median_partition(x):
    """(median, below-mask) for the last axis — the vantage-point split of
    the DVP tree (ref: dvp_tree_detail.hpp partitioning)."""
    med = jnp.median(x, axis=-1, keepdims=True)
    return med[..., 0], x <= med


def lexsort_2key(primary, secondary):
    """Indices sorting by ``primary`` then ``secondary`` (the reachability
    dual-key ordering, ref: path_planning/reachability_sort.hpp)."""
    # stable composite: sort by secondary first, then stable-sort by primary
    order2 = jnp.argsort(secondary, axis=-1, stable=True)
    p2 = jnp.take_along_axis(primary, order2, axis=-1)
    order1 = jnp.argsort(p2, axis=-1, stable=True)
    return jnp.take_along_axis(order2, order1, axis=-1)


# ---------------------------------------------------------------------------
# bitonic sorting network (ref: core/sorting/*.hpp — the comparison sorts;
# re-designed as a data-independent compare-exchange schedule)
# ---------------------------------------------------------------------------


def _bitonic_schedule(n):
    """Static (partner, want_min) pairs for Batcher's bitonic network on n
    (power of two) slots — computed at trace time with numpy."""
    idx = np.arange(n)
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            partner = idx ^ j
            ascending = (idx & k) == 0
            # a position keeps the smaller value iff it is the lower index of
            # its pair in an ascending block, or the upper index in a
            # descending block
            want_min = (idx < partner) == ascending
            stages.append((partner, want_min))
            j //= 2
        k *= 2
    return stages


def _pow2_above(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _bitonic_kv_core(keys, payload):
    """Sort the last axis ascending by ``keys``, carrying ``payload`` through
    the same compare-exchanges.  Ties break on the payload (assumed a
    permutation), so the result is always a valid permutation."""
    n = keys.shape[-1]
    for partner_np, want_min_np in _bitonic_schedule(n):
        partner = jnp.asarray(partner_np)
        want_min = jnp.asarray(want_min_np)
        kp = jnp.take(keys, partner, axis=-1)
        pp = jnp.take(payload, partner, axis=-1)
        less = (keys < kp) | ((keys == kp) & (payload < pp))
        take_self = want_min == less
        keys = jnp.where(take_self, keys, kp)
        payload = jnp.where(take_self, payload, pp)
    return keys, payload


def bitonic_sort(x, axis=-1):
    """Ascending sort along ``axis`` via the bitonic network: ~log²n
    elementwise min/max waves over static permutations, fully fusible.
    Handles any length (pads to the next power of two with +inf)."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    m = _pow2_above(n)
    if m != n:
        pad = jnp.full(x.shape[:-1] + (m - n,), jnp.inf, x.dtype)
        x = jnp.concatenate([x, pad], axis=-1)
    for partner_np, want_min_np in _bitonic_schedule(m):
        partner = jnp.asarray(partner_np)
        want_min = jnp.asarray(want_min_np)
        xp = jnp.take(x, partner, axis=-1)
        x = jnp.where(want_min, jnp.minimum(x, xp), jnp.maximum(x, xp))
    return jnp.moveaxis(x[..., :n], -1, axis)


def bitonic_sort_kv(keys, values, axis=-1):
    """(sorted_keys, permuted_values) along ``axis``, ascending by keys —
    the key-value compare-exchange form a Pallas kernel carries side arrays
    with.  Pads to a power of two with +inf keys."""
    keys = jnp.moveaxis(keys, axis, -1)
    values = jnp.moveaxis(values, axis, -1)
    n = keys.shape[-1]
    m = _pow2_above(n)
    iota = jnp.broadcast_to(jnp.arange(m), keys.shape[:-1] + (m,))
    if m != n:
        keys = jnp.concatenate(
            [keys, jnp.full(keys.shape[:-1] + (m - n,), jnp.inf, keys.dtype)],
            axis=-1)
    sk, perm = _bitonic_kv_core(keys, iota)
    sv = jnp.take_along_axis(
        jnp.concatenate(
            [values, jnp.zeros(values.shape[:-1] + (m - n,), values.dtype)],
            axis=-1) if m != n else values,
        perm, axis=-1)
    return (jnp.moveaxis(sk[..., :n], -1, axis),
            jnp.moveaxis(sv[..., :n], -1, axis))


def bitonic_argsort(x, axis=-1):
    """Ascending argsort along ``axis`` through the network (stable under
    the index tie-break: equal keys keep original order)."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    m = _pow2_above(n)
    if m != n:
        x = jnp.concatenate(
            [x, jnp.full(x.shape[:-1] + (m - n,), jnp.inf, x.dtype)], axis=-1)
    iota = jnp.broadcast_to(jnp.arange(m), x.shape)
    _, perm = _bitonic_kv_core(x, iota)
    return jnp.moveaxis(perm[..., :n], -1, axis)

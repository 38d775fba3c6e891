"""Mesh construction and scenario-batch sharding helpers.

Replaces nothing in the reference (its only distribution is TCP/UDP row
streaming, core/recorders/network_recorder.cpp) — this is the new multi-chip
capability demanded by the BASELINE north star (≥85% scaling efficiency at 2
hosts): pick a mesh, annotate shardings, let XLA insert collectives.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_name: str = "scenarios") -> Mesh:
    """1-D device mesh over the scenario-batch axis.

    Multi-host: call ``distribute_init`` first; ``jax.devices()`` then spans
    all hosts and the same code scales from 1 chip to a pod slice.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def shard_batch(x, mesh: Mesh, axis_name: str = "scenarios"):
    """Place a batch pytree with the leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), x)


def sharded_map(fn: Callable, mesh: Mesh, axis_name: str = "scenarios"):
    """shard_map a per-shard batch function over the scenario axis.

    ``fn`` receives the *local* shard of each input (leading axis divided by
    mesh size) and must be vmapped/batched internally.  Collectives
    (``jax.lax.psum(..., axis_name)``) are available inside.
    """
    return jax.shard_map(
        fn, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name))


def pmean_scalar(fn: Callable, mesh: Mesh, axis_name: str = "scenarios"):
    """shard_map a function returning (per-shard batch, scalar summary); the
    scalar is psum-averaged across the mesh."""

    def wrapped(*args):
        out, s = fn(*args)
        s = jax.lax.pmean(s, axis_name)
        return out, s

    return jax.shard_map(
        wrapped, mesh=mesh, in_specs=P(axis_name),
        out_specs=(P(axis_name), P()))


def distribute_init(coordinator: str | None = None, num_processes: int | None = None,
                    process_id: int | None = None):
    """Multi-host bring-up (``jax.distributed.initialize``); no-op when single
    host or when args are missing.  (SURVEY.md §5.8 JAX-native equivalent of
    the reference's network streaming backend.)"""
    if coordinator is None:
        return False
    jax.distributed.initialize(coordinator, num_processes, process_id)
    return True

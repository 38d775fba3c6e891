"""Failure detection: device-side status flags + host-side raising wrappers.

JAX-native replacement for the reference's exception surface
(ref: ctrl/mbd_kte/manipulator_model.cpp:351-354 ``singularity_error`` on a
singular mass matrix; core/integrators/integration_exceptions.hpp:38,82,136
``impossible_integration`` / ``untolerable_integration`` /
``invalid_state_derivative``; core/optimization/optim_exceptions.hpp).

Exceptions cannot cross a jit boundary, so the hot paths return STATUS FLAGS
computed on device (cheap, fused) and the host decides what to do:

    qdd, status = forward_dynamics_checked(spec, q, qd, tau)
    # status is a bitmask; vmapped over a scenario batch it localizes which
    # scenario went bad without ever syncing inside the loop.

For reference-style throwing behavior OUTSIDE jit, wrap with
:func:`raise_on_error` — it syncs once and raises the matching exception.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# status bitmask values (combine with |)
OK = 0
SINGULAR_MATRIX = 1  # ≙ singularity_error (manipulator_model.cpp:351)
NONFINITE = 2  # ≙ invalid_state_derivative
NOT_CONVERGED = 4  # ≙ optim exceptions / untolerable_integration
OUT_OF_BOUNDS = 8  # ≙ recorder out_of_bounds / domain violations


class SingularityError(RuntimeError):
    """Host-side analog of the reference's ReaK::singularity_error."""


class NonFiniteError(FloatingPointError):
    """Host-side analog of invalid_state_derivative."""


class NotConvergedError(RuntimeError):
    """Host-side analog of untolerable_integration / optim failures."""


def finite_flag(*trees):
    """0 where every leaf of every pytree is finite, NONFINITE otherwise.
    Reduces over all but the shared leading batch axes (none by default)."""
    bad = jnp.asarray(False)
    for tree in trees:
        for leaf in jax.tree_util.tree_leaves(tree):
            bad = bad | ~jnp.all(jnp.isfinite(jnp.asarray(leaf)))
    return jnp.where(bad, NONFINITE, OK)


def chol_singular_flag(A, rcond: float = 1e-12):
    """SINGULAR_MATRIX flag for an SPD solve: the Cholesky factor has a
    non-finite or relatively tiny pivot (the device analog of the
    reference's throw at manipulator_model.cpp:351)."""
    L = jnp.linalg.cholesky(A)
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    bad = ~jnp.all(jnp.isfinite(d), axis=-1) | (
        jnp.min(d, axis=-1) <= rcond * jnp.max(jnp.abs(d), axis=-1)
    )
    return jnp.where(bad, SINGULAR_MATRIX, OK)


def convergence_flag(residual, tol):
    """NOT_CONVERGED where a solver residual (e.g. PDIP complementarity gap,
    CLIK task error, adaptive-integrator error estimate) exceeds tol."""
    return jnp.where(jnp.asarray(residual) > tol, NOT_CONVERGED, OK)


def describe(status) -> str:
    s = int(status)
    if s == OK:
        return "ok"
    parts = []
    if s & SINGULAR_MATRIX:
        parts.append("singular-matrix")
    if s & NONFINITE:
        parts.append("non-finite")
    if s & NOT_CONVERGED:
        parts.append("not-converged")
    if s & OUT_OF_BOUNDS:
        parts.append("out-of-bounds")
    return "+".join(parts)


def raise_on_error(status):
    """Sync ``status`` to host and raise the matching exception (the
    reference's throwing behavior, usable only OUTSIDE jit).  Batched
    statuses raise if ANY element failed."""
    s = int(jnp.max(jnp.asarray(status)))
    if s == OK:
        return
    if s & SINGULAR_MATRIX:
        raise SingularityError(
            "singular matrix in dynamics solve (ref: singularity_error, "
            "manipulator_model.cpp:351)")
    if s & NONFINITE:
        raise NonFiniteError("non-finite values on the compute path")
    if s & NOT_CONVERGED:
        raise NotConvergedError("solver failed to converge to tolerance")
    raise RuntimeError(describe(s))

"""Finite-difference derivatives (validation/parity tool).

JAX-native equivalent of the reference's finite-difference Jacobians
(ref: core/optimization/finite_diff_jacobians.hpp — forward/central 2nd/4th
order).  In this framework AD is the production path; these exist to
cross-check AD pipelines and for black-box callables.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def fd_gradient(f, x, eps: float = 1e-6, order: int = 2):
    """Central (order=2) or 4th-order central gradient of scalar ``f``."""
    x = jnp.asarray(x, jnp.result_type(float))
    eye = jnp.eye(x.shape[-1], dtype=x.dtype)

    def one(e):
        if order == 4:
            return (-f(x + 2 * eps * e) + 8 * f(x + eps * e)
                    - 8 * f(x - eps * e) + f(x - 2 * eps * e)) / (12 * eps)
        return (f(x + eps * e) - f(x - eps * e)) / (2 * eps)

    return jax.vmap(one)(eye)


def fd_jacobian(f, x, eps: float = 1e-6, order: int = 2):
    """Jacobian of vector ``f`` by central differences, columns via vmap."""
    x = jnp.asarray(x, jnp.result_type(float))
    eye = jnp.eye(x.shape[-1], dtype=x.dtype)

    def one(e):
        if order == 4:
            return (-f(x + 2 * eps * e) + 8 * f(x + eps * e)
                    - 8 * f(x - eps * e) + f(x - 2 * eps * e)) / (12 * eps)
        return (f(x + eps * e) - f(x - eps * e)) / (2 * eps)

    return jax.vmap(one)(eye).T


def fd_hessian(f, x, eps: float = 1e-4):
    """Hessian of scalar ``f`` as FD-of-FD-gradient (central)."""
    return fd_jacobian(lambda y: fd_gradient(f, y, eps), x, eps)

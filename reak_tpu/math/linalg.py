"""Batched dense numerics: PD solves, least squares, matrix exponential, norms.

JAX-native replacement for the reference's decomposition library
(ref: core/lin_alg/mat_cholesky.hpp:426, mat_qr_decomp.hpp:560, mat_exp_methods.hpp:72,
mat_gaussian_elim.hpp:77, mat_norms.hpp).  All functions operate on ``(..., n, n)`` /
``(..., n, m)`` arrays and broadcast over leading batch axes; XLA batches the
decompositions.  Structured-matrix classes from the reference
(symmetric/skew/diag/identity/nil) collapse into plain arrays plus the helper
constructors below.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def symmetrize(A):
    """½(A + Aᵀ) — replaces the reference's mat_structure::symmetric invariant."""
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))


def solve_pd(A, b):
    """Solve A x = b for symmetric positive-definite A via Cholesky.

    Replaces ``linsolve_Cholesky`` (ref: core/lin_alg/mat_cholesky.hpp:426).
    ``b`` may be (..., n) or (..., n, k).
    """
    L = jnp.linalg.cholesky(A)
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    x = jax.scipy.linalg.solve_triangular(jnp.swapaxes(L, -1, -2), y, lower=False)
    return x[..., 0] if vec else x


def invert_pd(A):
    """Inverse of an SPD matrix via Cholesky (ref: mat_cholesky.hpp invert_Cholesky)."""
    n = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    return solve_pd(A, eye)


def logdet_pd(A):
    """log det of an SPD matrix (ref: mat_cholesky.hpp determinant_Cholesky)."""
    L = jnp.linalg.cholesky(A)
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def solve_lstsq(A, b):
    """Least-squares solve via QR (ref: mat_qr_decomp.hpp:495 linlsq_QR)."""
    q, r = jnp.linalg.qr(A)
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    x = jax.scipy.linalg.solve_triangular(r, jnp.swapaxes(q, -1, -2) @ b, lower=False)
    return x[..., 0] if vec else x


def solve_minnorm(A, b):
    """Minimum-norm solution of underdetermined A x = b (ref: mat_qr_decomp.hpp minnorm_QR)."""
    At = jnp.swapaxes(A, -1, -2)
    y = solve_pd(A @ At, b)
    if y.ndim == A.ndim - 1:
        return (At @ y[..., None])[..., 0]
    return At @ y


def expm_pade(A, order: int = 7, squarings: int = 8):
    """Matrix exponential by scaling-and-squaring with Padé approximant.

    Fixed squaring count keeps the computation trace-static (no norm-dependent
    branching), which is what we want under jit/vmap; for the step sizes used in
    system discretization (‖A·dt‖ ≲ 1) this is well within f32 accuracy.
    (ref: core/lin_alg/mat_exp_methods.hpp:72 exp_PadeSAS)
    """
    n = A.shape[-1]
    A = A / (2.0**squarings)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    # Padé coefficients for diagonal approximant of given order.
    c = [1.0]
    for k in range(1, order + 1):
        c.append(c[-1] * (order + 1 - k) / (k * (2 * order + 1 - k)))
    U = jnp.zeros_like(A)
    V = jnp.zeros_like(A)
    A2 = A @ A
    # Horner-style evaluation of even/odd parts.
    even = c[order] * eye if order % 2 == 0 else c[order - 1] * eye
    odd = c[order] * eye if order % 2 == 1 else c[order - 1] * eye
    # build even polynomial in A2 for V, odd*A for U
    ks_even = [k for k in range(0, order + 1, 2)]
    ks_odd = [k for k in range(1, order + 1, 2)]
    V = sum(c[k] * _matpow(A2, k // 2, eye) for k in ks_even)
    U = A @ sum(c[k] * _matpow(A2, (k - 1) // 2, eye) for k in ks_odd)
    F = jnp.linalg.solve(V - U, V + U)
    for _ in range(squarings):
        F = F @ F
    return F


def _matpow(A2, p, eye):
    out = eye
    for _ in range(p):
        out = out @ A2
    return out


def frobenius_norm(A):
    return jnp.sqrt(jnp.sum(A * A, axis=(-2, -1)))


def one_norm(A):
    """Max column abs sum (ref: mat_norms.hpp norm_1)."""
    return jnp.max(jnp.sum(jnp.abs(A), axis=-2), axis=-1)


def inf_norm(A):
    """Max row abs sum (ref: mat_norms.hpp norm_inf)."""
    return jnp.max(jnp.sum(jnp.abs(A), axis=-1), axis=-1)


def sqrtm_psd(A):
    """Symmetric PSD matrix square root via eigh."""
    w, V = jnp.linalg.eigh(A)
    w = jnp.maximum(w, 0.0)
    return (V * jnp.sqrt(w)[..., None, :]) @ jnp.swapaxes(V, -1, -2)


def small_chol_solve(G, rhs, unroll_max: int = 16):
    """SPD solve specialized for tiny matrices: fully unrolled Cholesky +
    substitution as straight-line elementwise ops (no XLA while-loops) that
    XLA fuses into the surrounding step.  ``G``: (..., n, n), ``rhs``:
    (..., n, k) or (..., n).

    (The JAX counterpart of the reference's fixed-size template solves,
    mat_cholesky.hpp:426 — trace-time unrolling plays the role of template
    instantiation.)
    """
    n = G.shape[-1]
    vec = rhs.ndim == G.ndim - 1
    if vec:
        rhs = rhs[..., None]
    if n > unroll_max:
        L = jnp.linalg.cholesky(G)
        y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
        x = jax.scipy.linalg.solve_triangular(jnp.swapaxes(L, -1, -2), y, lower=False)
        return x[..., 0] if vec else x

    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = G[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(s)
        for i in range(j + 1, n):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    out = jnp.stack(x, axis=-2)
    return out[..., 0] if vec else out


def block_2x2(A, B, C, D):
    """Assemble [[A, B], [C, D]] (replaces mat_composite_adaptor.hpp views)."""
    top = jnp.concatenate([A, B], axis=-1)
    bot = jnp.concatenate([C, D], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def star_product(M1, M2):
    """Redheffer star product of 2x2-blocked symplectic maps
    (ref: core/lin_alg/mat_star_product.hpp), used by symplectic Kalman filters.

    Each argument is a tuple of blocks ((A1, B1), (C1, D1)).
    """
    (A1, B1), (C1, D1) = M1
    (A2, B2), (C2, D2) = M2
    n = A1.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A1.dtype), A1.shape)
    W = jnp.linalg.solve(eye - B1 @ C2, A1)
    A = A2 @ W
    B = B2 + A2 @ jnp.linalg.solve(eye - B1 @ C2, B1 @ D2)
    C = C1 + D1 @ C2 @ W
    D = D1 @ jnp.linalg.solve(eye - C2 @ B1, D2)
    return ((A, B), (C, D))

"""Algebraic Riccati equation solvers (CARE / DARE), batched & jit-friendly.

JAX-native replacement for the reference's Schur-decomposition ARE solver
(ref: core/lin_alg/mat_are_solver.hpp:1449,1598).  XLA has no batched
nonsymmetric Schur decomposition, so we use iteration schemes with *static* iteration counts that map to
pure batched matmul/solve work:

- DARE: structure-preserving doubling algorithm (SDA) — quadratically convergent,
  ~25 doublings reach f64 machine precision.
- CARE: matrix sign function of the Hamiltonian with determinant-based scaling,
  followed by a least-squares extraction of the stabilizing solution.

Both broadcast over leading batch axes and differentiate cleanly (the iterations
are plain compositions of solves/matmuls).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from reak_tpu.math.linalg import solve_pd, symmetrize


def solve_dare(A, B, Q, R, iters: int = 30):
    """Stabilizing solution of  AᵀXA − X − AᵀXB(R + BᵀXB)⁻¹BᵀXA + Q = 0.

    Structure-preserving doubling:  with G₀ = B R⁻¹ Bᵀ, H₀ = Q, A₀ = A,
      A_{k+1} = A_k (I + G_k H_k)⁻¹ A_k
      G_{k+1} = G_k + A_k (I + G_k H_k)⁻¹ G_k A_kᵀ
      H_{k+1} = H_k + A_kᵀ H_k (I + G_k H_k)⁻¹ A_k
    H_k → X quadratically.  (ref behavior: mat_are_solver.hpp solve_dare_problem)
    """
    n = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    G = B @ solve_pd(R, jnp.swapaxes(B, -1, -2))
    H = Q

    def body(carry, _):
        Ak, Gk, Hk = carry
        W = eye + Gk @ Hk
        WinvA = jnp.linalg.solve(W, Ak)
        WinvG = jnp.linalg.solve(W, Gk)
        A1 = Ak @ WinvA
        G1 = Gk + Ak @ WinvG @ jnp.swapaxes(Ak, -1, -2)
        H1 = Hk + jnp.swapaxes(WinvA, -1, -2) @ Hk @ Ak
        return (A1, symmetrize(G1), symmetrize(H1)), None

    (Ak, Gk, Hk), _ = jax.lax.scan(body, (A, G, H), None, length=iters)
    return symmetrize(Hk)


def solve_care(A, B, Q, R, iters: int = 40):
    """Stabilizing solution of  AᵀX + XA − XBR⁻¹BᵀX + Q = 0.

    Matrix-sign-function method on the Hamiltonian
    H = [[A, −G], [−Q, −Aᵀ]], G = B R⁻¹ Bᵀ: Newton iteration
    Z ← ½(c⁻¹ Z + c Z⁻¹) with determinant scaling c = |det Z|^{1/2n}; then X
    solves  [S₁₂; S₂₂ + I] X = −[S₁₁ + I; S₂₁]  in the least-squares sense.
    (ref behavior: mat_are_solver.hpp solve_care_problem)
    """
    n = A.shape[-1]
    G = B @ solve_pd(R, jnp.swapaxes(B, -1, -2))
    At = jnp.swapaxes(A, -1, -2)
    top = jnp.concatenate([A, -G], axis=-1)
    bot = jnp.concatenate([-Q, -At], axis=-1)
    Z = jnp.concatenate([top, bot], axis=-2)
    two_n = 2 * n

    def body(Z, _):
        Zinv = jnp.linalg.inv(Z)
        # determinant scaling for fast convergence
        sign, logabsdet = jnp.linalg.slogdet(Z)
        c = jnp.exp(logabsdet / two_n)
        c = jnp.where(jnp.isfinite(c) & (c > 0), c, jnp.ones_like(c))
        c = c[..., None, None] if c.ndim == Z.ndim - 2 else c
        Z = 0.5 * (Z / c + c * Zinv)
        return Z, None

    Z, _ = jax.lax.scan(body, Z, None, length=iters)
    S11 = Z[..., :n, :n]
    S12 = Z[..., :n, n:]
    S21 = Z[..., n:, :n]
    S22 = Z[..., n:, n:]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    M = jnp.concatenate([S12, S22 + eye], axis=-2)  # (2n, n)
    rhs = -jnp.concatenate([S11 + eye, S21], axis=-2)  # (2n, n)
    Mt = jnp.swapaxes(M, -1, -2)
    X = jnp.linalg.solve(Mt @ M, Mt @ rhs)
    return symmetrize(X)


def dlqr(A, B, Q, R, iters: int = 30):
    """Discrete-time infinite-horizon LQR gain K (u = −K x) + cost-to-go P.

    (ref: ctrl/ctrl_sys/lqr_controllers.hpp:58 IHDT_LQR_controller)
    """
    P = solve_dare(A, B, Q, R, iters)
    Bt = jnp.swapaxes(B, -1, -2)
    K = solve_pd(R + Bt @ P @ B, Bt @ P @ A)
    return K, P


def clqr(A, B, Q, R, iters: int = 40):
    """Continuous-time infinite-horizon LQR gain K (u = −K x) + cost-to-go P.

    (ref: ctrl/ctrl_sys/lqr_controllers.hpp:259 IHCT_LQR_controller)
    """
    P = solve_care(A, B, Q, R, iters)
    K = solve_pd(R, jnp.swapaxes(B, -1, -2) @ P)
    return K, P


# ---------------------------------------------------------------------------
# Spectral factorization & infinite-horizon LQG
# (ref: mat_are_solver.hpp:2624 solve_ctsf_problem, :2754 solve_dtsf_problem,
#  :2136 solve_IHCT_LQG, :2606 solve_IHDT_LQG — QZ/Schur subspace extraction
#  there; here the same solutions via the CARE/DARE reductions below, which
#  map onto the batched sign-function/doubling machinery above.)
# ---------------------------------------------------------------------------


def solve_ctsf(A, B, C, D, iters: int = 40):
    """Continuous-time spectral factorization: the P ⪰ 0 solving

        B E⁻¹ Bᵀ + P Āᵀ + Ā P + P Cᵀ E⁻¹ C P = 0,
        E = D + Dᵀ,  Ā = A − B E⁻¹ C

    (ref: mat_are_solver.hpp:2624 — positive-real lemma equation; P is the
    state covariance of the minimum-phase spectral factor of
    Φ(s) = C(sI−A)⁻¹B + D, Φ + Φ* = W W*).

    Reduction: X = −P solves the standard CARE  A_cᵀX + XA_c − XS X + Q_c = 0
    with A_c = Āᵀ, S = CᵀE⁻¹C, Q_c = −BE⁻¹Bᵀ; the sign-function CARE solver
    handles the indefinite Q_c (it only needs the Hamiltonian off the
    imaginary axis).
    """
    E = D + jnp.swapaxes(D, -1, -2)
    Bt = jnp.swapaxes(B, -1, -2)
    EinvC = solve_pd(E, C)
    Abar = A - B @ EinvC
    W = B @ solve_pd(E, Bt)
    X = solve_care(jnp.swapaxes(Abar, -1, -2), jnp.swapaxes(C, -1, -2),
                   -W, E, iters=iters)
    return symmetrize(-X)


def solve_dtsf(A, B, C, D, iters: int = 30):
    """Discrete-time spectral factorization: the P ⪰ 0 solving

        P = F P Fᵀ + (G − F P Hᵀ)(E − H P Hᵀ)⁻¹(Gᵀ − H P Fᵀ),
        E = J + Jᵀ   (F = A, G = B, H = C, J = D in the reference's naming)

    (ref: mat_are_solver.hpp:2754).  Reduction: Y = −P solves the
    cross-term-free filter DARE with F̄ = F − G E⁻¹ H, R = E, and indefinite
    Q̄ = −G E⁻¹ Gᵀ, which in control form is  solve_dare(F̄ᵀ, Hᵀ, Q̄, E).
    """
    F, G, H, J = A, B, C, D
    E = J + jnp.swapaxes(J, -1, -2)
    Fbar = F - G @ solve_pd(E, H)
    Qbar = -G @ solve_pd(E, jnp.swapaxes(G, -1, -2))
    Y = solve_dare(jnp.swapaxes(Fbar, -1, -2), jnp.swapaxes(H, -1, -2),
                   Qbar, E, iters=iters)
    return symmetrize(-Y)


def solve_ihct_lqg(A, B, C, V, W, Q, R, iters: int = 40):
    """Infinite-horizon continuous-time LQG: returns (K, P, L, S) — LQR gain
    K (u = −Kx̂) with cost-to-go P, and steady-state Kalman-Bucy gain L with
    error covariance S (ref: mat_are_solver.hpp:2136 solve_IHCT_LQG;
    separation principle: one control CARE + one filter CARE)."""
    K, P = clqr(A, B, Q, R, iters)
    S = solve_care(jnp.swapaxes(A, -1, -2), jnp.swapaxes(C, -1, -2),
                   V, W, iters)
    L = jnp.swapaxes(solve_pd(W, C @ S), -1, -2)
    return K, P, L, S


def solve_ihdt_lqg(F, G, H, V, W, Q, R, iters: int = 30):
    """Infinite-horizon discrete-time LQG: (K, P, L, S) with K the LQR gain,
    S the steady-state *predicted* error covariance, and L = SHᵀ(W+HSHᵀ)⁻¹
    the Kalman gain (ref: mat_are_solver.hpp:2606 solve_IHDT_LQG)."""
    K, P = dlqr(F, G, Q, R, iters)
    S = solve_dare(jnp.swapaxes(F, -1, -2), jnp.swapaxes(H, -1, -2),
                   V, W, iters)
    Ht = jnp.swapaxes(H, -1, -2)
    L = jnp.swapaxes(solve_pd(W + H @ S @ Ht, H @ S), -1, -2)
    return K, P, L, S

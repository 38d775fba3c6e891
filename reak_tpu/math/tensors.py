"""Order-3/4 tensor algebra helpers.

JAX-native equivalent of the reference's core/tensors layer
(ref: core/tensors/tensor_alg_rectangular.hpp, tensor_alg_square.hpp,
tensor_alg_nil.hpp, adaptors + concepts — declared but lightly used in the
reference; SURVEY.md §2.5 flags it low priority).  In JAX a "tensor type"
is just an array with contraction conventions, so this module provides the
named contractions the reference's adaptors would perform, all batched.
"""
from __future__ import annotations

import jax.numpy as jnp


def tensor3_vec(T, v):
    """Mode-3 contraction: (..., i, j, k) × (..., k) → (..., i, j)
    (the reference's tensor-from-matrix adaptor applied in reverse)."""
    return jnp.einsum("...ijk,...k->...ij", T, v)


def tensor3_mat(T, M):
    """Mode-3 matrix product: (..., i, j, k) × (..., k, l) → (..., i, j, l)."""
    return jnp.einsum("...ijk,...kl->...ijl", T, M)


def vec_tensor3(v, T):
    """Mode-1 contraction: (..., i) × (..., i, j, k) → (..., j, k)."""
    return jnp.einsum("...i,...ijk->...jk", v, T)


def tensor4_mat(T, M):
    """Double contraction: (..., i, j, k, l) × (..., k, l) → (..., i, j)
    (e.g. an elasticity tensor applied to a strain matrix)."""
    return jnp.einsum("...ijkl,...kl->...ij", T, M)


def outer3(a, b, c):
    """Rank-1 order-3 tensor a ⊗ b ⊗ c."""
    return jnp.einsum("...i,...j,...k->...ijk", a, b, c)


def identity3(n, dtype=jnp.float32):
    """δ_ij e_k-style 'nil + diagonal' helper (ref: tensor_alg_nil.hpp role:
    structural zero/identity tensors collapse into explicit arrays here)."""
    eye = jnp.eye(n, dtype=dtype)
    return jnp.einsum("ij,k->ijk", eye, jnp.ones(n, dtype))


def sym_part3(T):
    """Symmetrize an order-3 tensor over its last two indices."""
    return 0.5 * (T + jnp.swapaxes(T, -1, -2))


# ---------------------------------------------------------------------------
# generic mode-n machinery (the reference's adaptor layer — a tensor viewed
# as a matrix along any mode, tensor_alg_rectangular.hpp adaptors — becomes
# explicit unfold/fold + mode products here)
# ---------------------------------------------------------------------------


def unfold(T, mode: int):
    """Mode-n matricization: move ``mode`` first, flatten the rest →
    (I_mode, prod(other dims)).  The reference's matrix-adaptor view of a
    tensor (core/tensors adaptors) as an explicit layout transform."""
    return jnp.moveaxis(T, mode, 0).reshape(T.shape[mode], -1)


def fold(M, mode: int, shape):
    """Inverse of :func:`unfold` back to ``shape``."""
    full = (shape[mode],) + tuple(s for i, s in enumerate(shape) if i != mode)
    return jnp.moveaxis(M.reshape(full), 0, mode)


def mode_dot(T, M, mode: int):
    """Mode-n product T ×_n M: contract tensor mode ``mode`` with the last
    axis of matrix ``M`` — T'(..., a, ...) = Σ_b M[a, b] T(..., b, ...)."""
    out = jnp.tensordot(M, T, axes=([1], [mode]))
    return jnp.moveaxis(out, 0, mode)


def multi_mode_dot(T, mats):
    """Apply ``mats[i]`` along mode i for every non-None entry (Tucker-style
    multilinear transform; e.g. rotating every index of a stiffness tensor
    into a new frame)."""
    for i, M in enumerate(mats):
        if M is not None:
            T = mode_dot(T, M, i)
    return T


def ttt(A, B, modes_a, modes_b):
    """Tensor-times-tensor contraction over the given mode lists
    (the general contraction the reference's concept layer specifies,
    core/tensors/tensor_concepts.hpp)."""
    return jnp.tensordot(A, B, axes=(tuple(modes_a), tuple(modes_b)))


def tensor3_rotate(T, R):
    """Rotate all three indices of an order-3 tensor into the frame of R:
    T'_{abc} = R_{ai} R_{bj} R_{ck} T_{ijk} (frame change of e.g. a
    piezoelectric/third-moment tensor)."""
    return multi_mode_dot(T, [R, R, R])


def tensor4_rotate(T, R):
    """Rotate all four indices: T'_{abcd} = R_{ai}R_{bj}R_{ck}R_{dl} T_{ijkl}."""
    return multi_mode_dot(T, [R, R, R, R])


# ---------------------------------------------------------------------------
# decompositions: HOSVD / Tucker truncation and CP-ALS
# (the working machinery the reference's tensor layer declares concepts for
# but never finishes — TODO_list.txt MATH flags the tensor expression engine
# unfinished; these are the standard multilinear factorizations, batched and
# jit-compatible: fixed iteration counts, no data-dependent shapes)
# ---------------------------------------------------------------------------


def hosvd(T, ranks=None):
    """Higher-order SVD (Tucker via mode-wise SVDs).

    ``ranks``: optional per-mode truncation (defaults to full).  Returns
    ``(core, factors)`` with ``T ≈ multi_mode_dot(core, factors)``; factors
    have orthonormal columns (left singular vectors of each unfolding).
    The full-rank reconstruction is exact to machine precision."""
    d = T.ndim
    if ranks is None:
        ranks = T.shape
    factors = []
    for mode in range(d):
        U, _, _ = jnp.linalg.svd(unfold(T, mode), full_matrices=False)
        factors.append(U[:, : ranks[mode]])
    core = multi_mode_dot(T, [U.T for U in factors])
    return core, factors


def tucker_reconstruct(core, factors):
    """Inverse of :func:`hosvd`: core ×_0 U_0 ×_1 U_1 ⋯."""
    return multi_mode_dot(core, factors)


def cp_als(T, rank: int, n_iters: int = 50, key=None):
    """CP decomposition by alternating least squares.

    Returns ``(weights (rank,), factors [(I_i, rank)])`` with
    ``T ≈ Σ_r weights[r] · ⊗_i factors[i][:, r]``.  Fixed ``n_iters``
    sweeps (XLA-friendly: no convergence branch); factors are initialized
    from the HOSVD leading vectors (key=None) or randomly (with a PRNG
    key).  Normalization is folded into ``weights`` each sweep for
    numerical stability — the standard Kolda-Bader ALS recursion."""
    import jax

    d = T.ndim
    if key is None:
        _, factors = hosvd(T, ranks=[min(rank, s) for s in T.shape])
        # pad (columns) if rank exceeds a mode dimension — with small
        # DETERMINISTIC pseudo-random columns, not zeros: if two or more
        # modes pad with zeros, the padded component's Khatri-Rao column is
        # identically zero and the component can never leave zero under the
        # ALS update (a permanently dead component; ADVICE r4)
        padded = []
        for mode, U in enumerate(factors):
            if U.shape[1] < rank:
                k = jax.random.fold_in(jax.random.PRNGKey(0), mode)
                extra = 0.1 * jax.random.normal(
                    k, (U.shape[0], rank - U.shape[1]), T.dtype)
                U = jnp.concatenate([U, extra], axis=1)
            padded.append(U[:, :rank])
        factors = padded
    else:
        keys = jax.random.split(key, d)
        factors = [jax.random.normal(k, (s, rank), T.dtype)
                   for k, s in zip(keys, T.shape)]
    weights = jnp.ones((rank,), T.dtype)

    def khatri_rao(mats):
        out = mats[0]
        for M in mats[1:]:
            out = (out[:, None, :] * M[None, :, :]).reshape(-1, M.shape[1])
        return out

    for _ in range(n_iters):
        for mode in range(d):
            others = [factors[i] for i in range(d) if i != mode]
            # gram of the Khatri-Rao product = Hadamard of the grams
            G = jnp.ones((rank, rank), T.dtype)
            for M in others:
                G = G * (M.T @ M)
            # unfold() flattens the remaining modes row-major (first
            # remaining mode slowest), so the Khatri-Rao runs in ascending
            # mode order (Kolda-Bader's reversed order assumes the
            # column-major unfolding convention)
            KR = khatri_rao(others)
            rhs = unfold(T, mode) @ KR                     # (I_mode, rank)
            F = jnp.linalg.solve(G + 1e-10 * jnp.eye(rank, dtype=T.dtype),
                                 rhs.T).T
            norms = jnp.maximum(jnp.linalg.norm(F, axis=0), 1e-30)
            factors[mode] = F / norms
            weights = norms
    return weights, factors


def cp_reconstruct(weights, factors):
    """Σ_r weights[r] · ⊗_i factors[i][:, r]."""
    d = len(factors)
    letters = "abcdefgh"[:d]
    spec = ",".join(f"{c}r" for c in letters) + ",r->" + letters
    return jnp.einsum(spec, *factors, weights)

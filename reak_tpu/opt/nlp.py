"""Unconstrained NLP solvers: Nelder–Mead, BFGS, SR1-TR, nonlinear CG, Newton.

JAX-native equivalents of the reference's NLP family
(ref: core/optimization/nelder_mead_method.hpp, quasi_newton_methods.hpp
bfgs_method / sr1_tr_method, nonlin_conjugate_gradient_methods.hpp,
newton_methods.hpp, trust_region_search.hpp, hessian_update.hpp).

Gradients/Hessians come from AD.  All solvers use static iteration budgets
and branch-free accept/reject logic, so they ``vmap`` across problem batches
(e.g. per-scenario posture optimization).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from reak_tpu.math.linalg import solve_pd
from reak_tpu.opt.line_search import backtracking_armijo


class NLPResult(NamedTuple):
    x: jax.Array
    f: jax.Array
    grad_norm: jax.Array


def pd_shift(H, reg: float = 1e-8):
    """Shift making a symmetric H positive definite: max(0, −λ_min) + reg.
    Exact (eigvalsh) — these solvers run at small n where this is cheap and
    a Gershgorin bound would cripple the Newton step."""
    lam_min = jnp.linalg.eigvalsh(0.5 * (H + H.T))[0]
    return jnp.maximum(0.0, -lam_min) + reg


def _result(f, x):
    g = jax.grad(f)(x)
    return NLPResult(x, f(x), jnp.linalg.norm(g))


def nelder_mead(f: Callable, x0, iters: int = 200, init_scale: float = 0.25,
                alpha: float = 1.0, gamma: float = 2.0, rho: float = 0.5,
                sigma: float = 0.5) -> NLPResult:
    """Nelder–Mead simplex (ref: nelder_mead_method.hpp).

    The simplex lives as one (n+1, n) array; each iteration sorts it and
    applies reflection/expansion/contraction/shrink via masked selects.
    ``f`` is evaluated via vmap over simplex vertices.
    """
    x0 = jnp.asarray(x0, jnp.result_type(float))
    n = x0.shape[-1]
    fv = jax.vmap(f)
    simplex = jnp.concatenate(
        [x0[None], x0[None] + init_scale * jnp.eye(n, dtype=x0.dtype)], axis=0)
    fs = fv(simplex)

    def body(_, c):
        simplex, fs = c
        order = jnp.argsort(fs)
        simplex, fs = simplex[order], fs[order]
        best, worst = simplex[0], simplex[-1]
        f_best, f_second, f_worst = fs[0], fs[-2], fs[-1]
        centroid = jnp.mean(simplex[:-1], axis=0)

        xr = centroid + alpha * (centroid - worst)
        fr = f(xr)
        xe = centroid + gamma * (xr - centroid)
        fe = f(xe)
        xc = centroid + rho * (worst - centroid)
        fc = f(xc)

        # choose replacement for the worst vertex
        reflect = (fr >= f_best) & (fr < f_second)
        expand = fr < f_best
        contract = (~reflect & ~expand) & (fc < f_worst)
        use_e = expand & (fe < fr)
        new_pt = jnp.where(use_e, xe,
                  jnp.where(expand | reflect, xr,
                   jnp.where(contract, xc, worst)))
        new_f = jnp.where(use_e, fe,
                 jnp.where(expand | reflect, fr,
                  jnp.where(contract, fc, f_worst)))
        shrink = ~reflect & ~expand & ~contract

        replaced = simplex.at[-1].set(new_pt)
        replaced_f = fs.at[-1].set(new_f)
        shrunk = best[None] + sigma * (simplex - best[None])
        shrunk_f = fv(shrunk)
        simplex = jnp.where(shrink, shrunk, replaced)
        fs = jnp.where(shrink, shrunk_f, replaced_f)
        return simplex, fs

    simplex, fs = lax.fori_loop(0, iters, body, (simplex, fs))
    i = jnp.argmin(fs)
    return _result(f, simplex[i])


def bfgs(f: Callable, x0, iters: int = 60, ls_iters: int = 20) -> NLPResult:
    """BFGS with Armijo backtracking (ref: quasi_newton_methods.hpp
    bfgs_method).  Maintains the inverse Hessian; curvature-guarded update."""
    x = jnp.asarray(x0, jnp.result_type(float))
    n = x.shape[-1]
    eye = jnp.eye(n, dtype=x.dtype)
    grad = jax.grad(f)

    def body(_, c):
        x, Hinv, fx, gx = c
        d = -(Hinv @ gx)
        # ensure descent; fall back to steepest descent
        desc = jnp.vdot(gx, d) < 0
        d = jnp.where(desc, d, -gx)
        a, fn = backtracking_armijo(f, x, d, fx, gx, iters=ls_iters)
        xn = x + a * d
        gn = grad(xn)
        s, y = xn - x, gn - gx
        sy = jnp.vdot(s, y)
        ok = sy > 1e-12
        rho_ = 1.0 / jnp.where(ok, sy, 1.0)
        V = eye - rho_ * jnp.outer(s, y)
        Hn = V @ Hinv @ V.T + rho_ * jnp.outer(s, s)
        Hinv = jnp.where(ok, Hn, Hinv)
        return xn, Hinv, fn, gn

    fx = f(x)
    gx = grad(x)
    x, _, fx, gx = lax.fori_loop(0, iters, body, (x, eye, fx, gx))
    return NLPResult(x, fx, jnp.linalg.norm(gx))


def sr1_trust_region(f: Callable, x0, iters: int = 60, tr0: float = 1.0,
                     eta: float = 0.1) -> NLPResult:
    """SR1 quasi-Newton in a trust region with dogleg steps
    (ref: quasi_newton_methods.hpp sr1_tr_method + trust_region_search.hpp)."""
    x = jnp.asarray(x0, jnp.result_type(float))
    n = x.shape[-1]
    eye = jnp.eye(n, dtype=x.dtype)
    grad = jax.grad(f)

    def dogleg(B, g, radius):
        # Newton point (PD-shifted — raw SR1 B may be indefinite) and Cauchy
        # point; blend to the boundary
        B = B + pd_shift(B) * eye
        pN = -solve_pd(B, g)
        gBg = jnp.vdot(g, B @ g)
        tau = jnp.vdot(g, g) / jnp.maximum(gBg, 1e-30)
        pC = -tau * g
        nN, nC = jnp.linalg.norm(pN), jnp.linalg.norm(pC)
        use_N = nN <= radius
        scale_C = radius / jnp.maximum(nC, 1e-30)
        p_boundary = pC * jnp.minimum(1.0, scale_C)
        # single-segment dogleg: if Cauchy inside, walk toward Newton
        d = pN - pC
        dd = jnp.vdot(d, d)
        pc_d = jnp.vdot(pC, d)
        disc = jnp.maximum(pc_d ** 2 - dd * (nC ** 2 - radius ** 2), 0.0)
        t = (-pc_d + jnp.sqrt(disc)) / jnp.maximum(dd, 1e-30)
        p_dog = pC + jnp.clip(t, 0.0, 1.0) * d
        p = jnp.where(use_N, pN, jnp.where(nC >= radius, p_boundary, p_dog))
        return p

    def body(_, c):
        x, B, radius, fx, gx = c
        p = dogleg(B, gx, radius)
        xn = x + p
        fn = f(xn)
        Bpd = B + pd_shift(B) * eye
        pred = -(jnp.vdot(gx, p) + 0.5 * jnp.vdot(p, Bpd @ p))
        ratio = (fx - fn) / jnp.maximum(pred, 1e-30)
        accept = ratio > eta
        radius = jnp.where(ratio > 0.75, radius * 2.0,
                  jnp.where(ratio < 0.25, radius * 0.25, radius))
        radius = jnp.clip(radius, 1e-8, 1e8)
        gn = grad(xn)
        y = gn - gx
        r_ = y - B @ p
        rp = jnp.vdot(r_, p)
        # SR1 safeguard (skip near-singular updates)
        ok = jnp.abs(rp) > 1e-8 * jnp.linalg.norm(r_) * jnp.linalg.norm(p)
        Bn = B + jnp.where(ok, 1.0 / jnp.where(ok, rp, 1.0), 0.0) * jnp.outer(r_, r_)
        x = jnp.where(accept, xn, x)
        fx = jnp.where(accept, fn, fx)
        gx = jnp.where(accept, gn, gx)
        return x, Bn, radius, fx, gx

    fx, gx = f(x), grad(x)
    x, _, _, fx, gx = lax.fori_loop(
        0, iters, body, (x, eye, jnp.asarray(tr0, x.dtype), fx, gx))
    return NLPResult(x, fx, jnp.linalg.norm(gx))


def nonlinear_cg(f: Callable, x0, iters: int = 100, ls_iters: int = 25,
                 variant: str = "pr") -> NLPResult:
    """Nonlinear conjugate gradient, Polak–Ribière+ or Fletcher–Reeves
    (ref: nonlin_conjugate_gradient_methods.hpp)."""
    x = jnp.asarray(x0, jnp.result_type(float))
    grad = jax.grad(f)

    def body(_, c):
        x, d, gx, fx, a_prev = c
        # warm-started trial step: keep the previous accepted step's scale
        # (standard CG heuristic — a fixed α₀=1 stalls on narrow valleys)
        a0 = jnp.clip(2.0 * a_prev, 1e-6, 4.0)
        a, fn = backtracking_armijo(f, x, d, fx, gx, alpha0=a0, iters=ls_iters)
        xn = x + a * d
        gn = grad(xn)
        gg = jnp.vdot(gx, gx)
        if variant == "fr":
            beta = jnp.vdot(gn, gn) / jnp.maximum(gg, 1e-30)
        else:  # PR+
            beta = jnp.maximum(jnp.vdot(gn, gn - gx) / jnp.maximum(gg, 1e-30), 0.0)
        dn = -gn + beta * d
        # restart with steepest descent if not a descent direction
        dn = jnp.where(jnp.vdot(gn, dn) < 0, dn, -gn)
        return xn, dn, gn, fn, a

    gx, fx = grad(x), f(x)
    x, _, gx, fx, _ = lax.fori_loop(
        0, iters, body, (x, -gx, gx, fx, jnp.asarray(1.0, x.dtype)))
    return NLPResult(x, fx, jnp.linalg.norm(gx))


def newton_method(f: Callable, x0, iters: int = 30, ls_iters: int = 20,
                  reg: float = 1e-8) -> NLPResult:
    """Damped (line-searched) Newton with Levenberg regularization of the AD
    Hessian (ref: newton_methods.hpp line-search Newton)."""
    x = jnp.asarray(x0, jnp.result_type(float))
    n = x.shape[-1]
    eye = jnp.eye(n, dtype=x.dtype)
    grad = jax.grad(f)
    hess = jax.hessian(f)

    def body(_, c):
        x, fx, gx = c
        H = hess(x)
        d = -solve_pd(H + pd_shift(H, reg) * eye, gx)
        a, fn = backtracking_armijo(f, x, d, fx, gx, iters=ls_iters)
        xn = x + a * d
        return xn, fn, grad(xn)

    fx, gx = f(x), grad(x)
    x, fx, gx = lax.fori_loop(0, iters, body, (x, fx, gx))
    return NLPResult(x, fx, jnp.linalg.norm(gx))

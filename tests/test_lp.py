"""LP interior-point solver (opt/lp.py) vs scipy.optimize.linprog — a
WORKING replacement for the two reference LP solvers its own README flags
as broken (ref: README:301-303, simplex_method.hpp, mehrotra_method.hpp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reak_tpu.opt.lp import solve_lp, solve_lp_inequality

scipy_opt = pytest.importorskip("scipy.optimize")


def _random_standard_lp(rng, m, n):
    """Feasible, bounded standard-form LP: pick x* > 0, s* ≥ 0 partitioned."""
    A = rng.standard_normal((m, n))
    x_feas = rng.uniform(0.5, 2.0, n)
    b = A @ x_feas
    y = rng.standard_normal(m)
    s = rng.uniform(0.1, 1.0, n)
    # make some reduced costs zero so the optimum is non-trivial
    s[rng.choice(n, size=m, replace=False)] = 0.0
    c = A.T @ y + s
    return A, b, c


@pytest.mark.parametrize("m,n", [(3, 7), (5, 12), (10, 25)])
def test_standard_form_matches_scipy(rng, m, n):
    A, b, c = _random_standard_lp(rng, m, n)
    res = jax.jit(lambda: solve_lp(A, b, c, iters=40))()
    sp = scipy_opt.linprog(c, A_eq=np.asarray(A), b_eq=np.asarray(b),
                           bounds=(0, None), method="highs")
    assert sp.status == 0
    assert float(res.primal_res) < 1e-7
    assert float(res.dual_res) < 1e-7
    assert float(res.gap) < 1e-8
    np.testing.assert_allclose(float(res.obj), sp.fun, rtol=1e-6, atol=1e-7)


def test_inequality_form_matches_scipy(rng):
    n, m = 6, 14
    G = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.uniform(0.1, 1.0, m)  # strictly feasible at x0
    c = rng.standard_normal(n)
    # bound the problem: add box rows ±x ≤ 5
    G = np.vstack([G, np.eye(n), -np.eye(n)])
    h = np.concatenate([h, np.full(n, 5.0), np.full(n, 5.0)])
    res = jax.jit(lambda: solve_lp_inequality(c, G, h, iters=50))()
    sp = scipy_opt.linprog(c, A_ub=G, b_ub=h, bounds=(None, None),
                           method="highs")
    assert sp.status == 0
    np.testing.assert_allclose(float(res.obj), sp.fun, rtol=1e-6, atol=1e-6)
    assert np.max(G @ np.asarray(res.x) - h) < 1e-6


def test_lp_vmap_batch(rng):
    """Batched LPs under vmap — the JAX-native usage mode."""
    m, n, B = 4, 9, 16
    As, bs, cs = [], [], []
    for _ in range(B):
        A, b, c = _random_standard_lp(rng, m, n)
        As.append(A)
        bs.append(b)
        cs.append(c)
    As, bs, cs = map(lambda x: jnp.asarray(np.stack(x)), (As, bs, cs))
    res = jax.jit(jax.vmap(lambda A, b, c: solve_lp(A, b, c, iters=40)))(
        As, bs, cs)
    for i in range(B):
        sp = scipy_opt.linprog(np.asarray(cs[i]), A_eq=np.asarray(As[i]),
                               b_eq=np.asarray(bs[i]), bounds=(0, None),
                               method="highs")
        assert sp.status == 0
        np.testing.assert_allclose(float(res.obj[i]), sp.fun, rtol=1e-5,
                                   atol=1e-6)


def test_degenerate_vertex(rng):
    """A known tiny LP with a degenerate optimum solves exactly:
    min −x1 −x2 s.t. x1 + x2 ≤ 1, x1 ≤ 1, x2 ≤ 1, x ≥ 0 → obj = −1."""
    c = np.array([-1.0, -1.0])
    G = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0],
                  [-1.0, 0.0], [0.0, -1.0]])
    h = np.array([1.0, 1.0, 1.0, 0.0, 0.0])
    res = solve_lp_inequality(c, G, h, iters=50)
    np.testing.assert_allclose(float(res.obj), -1.0, atol=1e-7)

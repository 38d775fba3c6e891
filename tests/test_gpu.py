"""The GPU entry points: the batched PDIP compiled for the card (marked
``gpu``; skipped on the CPU by the ``gpu`` fixture), the refusal of
chip_smoke.py and bench.py to run anywhere else, and the compile-cache
helper they share."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import reak_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _ok_line(stdout):
    lines = stdout.strip().splitlines()
    return bool(lines) and lines[-1].startswith('{"ok"')


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_refuses_the_cpu(script):
    res = _run(os.path.join(REPO, script), REPO)
    assert res.returncode != 0
    assert not _ok_line(res.stdout)
    assert "cpu" in res.stderr


def test_chip_smoke_refuses_to_run_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    res = _run(str(lone), str(tmp_path))
    assert res.returncode != 0
    assert not _ok_line(res.stdout)


def test_chip_smoke_checks(monkeypatch):
    """The device gate refuses CPU devices, and a bound check fails on an
    error above its bound or a non-finite one."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices("cpu"))
    chip_smoke.check("within", 1e-4, 1e-3)
    for err in (1e-2, float("nan")):
        with pytest.raises(SystemExit):
            chip_smoke.check("outside", err, 1e-3)


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    path = reak_tpu.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert reak_tpu.enable_compile_cache() == str(tmp_path)
    assert calls == []


# ---- on the card ------------------------------------------------------------


@pytest.mark.gpu
def test_lanes_pdip_on_the_card_matches_per_scenario_solver(gpu):
    """The batched lanes PDIP compiled for the card, at full f32 precision
    (no TF32 in its contractions), against the per-scenario solver."""
    from reak_tpu.ctrl import riccati
    from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused

    rng = np.random.default_rng(0)
    H, n, m, B = 10, 12, 6, 300
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    A = f32(np.eye(n)[None, :, :, None]
            + 0.05 * rng.standard_normal((H, n, n, B)))
    Bm = f32(0.1 * rng.standard_normal((H, n, m, B)))
    c = f32(0.01 * rng.standard_normal((H, n, B)))
    x0 = f32(rng.standard_normal((n, B)))
    Q, QN, R = jnp.eye(n), 5 * jnp.eye(n), 0.1 * jnp.eye(m)
    lb, ub = -jnp.ones(m), jnp.ones(m)
    bf = lambda a: jnp.moveaxis(a, -1, 0)
    with jax.default_matmul_precision("highest"):
        u = solve_box_mpc_riccati_soa_fused(A, Bm, c, Q, QN, R, x0, lb, ub)[0]
        u_v = jax.vmap(lambda a, b, cc, x: riccati.solve_box_mpc_riccati(
            a, b, cc, Q, QN, R, x, lb, ub))(bf(A), bf(Bm), bf(c), bf(x0))[0]
    assert float(jnp.max(jnp.abs(bf(u) - u_v))) < 1e-3

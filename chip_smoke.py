#!/usr/bin/env python
"""Bring-up check of the batched KTE-MPC path on one NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # four cards: the sharded path only

One process drives the card (a JAX process reserves most of its memory).
Phases, in order; any failure exits non-zero before the last line:

1. device: JAX must run on a GPU (never falls back to the CPU); prints the
   device, JAX version, XLA_FLAGS and the card's name and power limit;
2. the batched lanes PDIP as XLA compiles it for the card, at the real
   widths, against the independent per-scenario solver, with compile
   seconds and memory analysis (the path has no hand-written kernel);
3. the main path end to end through the user entry points (flagship arm,
   free-base satellite, floating arm) at full width: finite controls inside
   the bounds, and for the arm and the satellite the first scenarios
   re-solved by the same solver on the host's CPU backend;
4. the flagship solve and its two phases timed (informational).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the widths the repository ships (bench.py): batch and horizon of the
# flagship arm, the free-base satellite and the floating arm
FLAGSHIP = dict(B=8192, H=50)
SATELLITE = dict(B=8192, H=20)
FLOATING_ARM = dict(B=2048, H=16)

# Bound on the controls' difference from a reference, with its reason: the
# 8-iteration PDIP's own distance from convergence
# (tests/test_bench_accuracy.py) — f32 rounding in another summation order
# or on another device must stay well inside it.
U_ABS = 1e-3
# scenarios re-solved by the per-scenario solver or on the host CPU
N_REF = 64


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them (no JAX here)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def require_gpu(devices):
    """The device list must be GPUs; anything else ends the run."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {platform!r}")


def check(name, err, bound):
    print(f"  {name}: max error {err:.3e} (bound {bound:.0e})", flush=True)
    if not np.isfinite(err) or err > bound:
        raise SystemExit(f"FAILED {name}: {err} > {bound}")


def compiled(fn, *args):
    """AOT-compile ``fn`` for ``args``; print compile seconds and memory."""
    import jax

    t = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    print(f"  compile {time.perf_counter() - t:.1f} s; "
          f"memory {c.memory_analysis()}", flush=True)
    return c


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def in_bounds(u, lo, hi):
    u = np.asarray(u)
    ok = (np.all(np.isfinite(u)) and np.all(u >= np.asarray(lo) - 1e-5)
          and np.all(u <= np.asarray(hi) + 1e-5))
    if not ok:
        raise SystemExit("FAILED: controls not finite or out of bounds")


# ---------------------------------------------------------------------------
# configurations: the widths the repository ships (bench.py)
# ---------------------------------------------------------------------------


def flagship(H=None):
    import jax.numpy as jnp
    from reak_tpu.ctrl import mpc
    from reak_tpu.kte import models

    H = H or FLAGSHIP["H"]
    m = 6
    prob = mpc.MPCProblem(
        Q=jnp.diag(jnp.concatenate([jnp.full(6, 10.0), jnp.full(6, 1.0)])),
        R=jnp.eye(m) * 0.05,
        QN=jnp.diag(jnp.concatenate([jnp.full(6, 50.0), jnp.full(6, 5.0)])),
        u_min=jnp.full(m, -40.0), u_max=jnp.full(m, 40.0), horizon=H)
    return models.manip_3r3r(), prob


def flagship_inputs(B, H=None, seed=0):
    import jax.numpy as jnp

    H = H or FLAGSHIP["H"]
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([rng.uniform(-0.5, 0.5, (B, 6)),
                         rng.uniform(-0.2, 0.2, (B, 6))], axis=1)
    return jnp.asarray(x0, jnp.float32), jnp.zeros((B, H, 6), jnp.float32)


def satellite(H=None):
    import jax.numpy as jnp
    from reak_tpu.ctrl import mpc, ss_systems as ss

    H = H or SATELLITE["H"]
    params = ss.satellite3D(mass=10.0,
                            inertia=jnp.diag(jnp.asarray([4.0, 5.0, 6.0])))
    w12 = jnp.concatenate([jnp.full(6, 10.0), jnp.full(6, 1.0)])
    prob = mpc.MPCProblem(
        Q=jnp.diag(w12), R=jnp.eye(6) * 0.05, QN=jnp.diag(10.0 * w12),
        u_min=jnp.full(6, -20.0), u_max=jnp.full(6, 20.0), horizon=H)
    x_ref = ss.default_state().at[0:3].set(jnp.array([1.0, 0.5, -0.3]))
    return params, prob, x_ref.astype(jnp.float32)


def satellite_inputs(B, H=None, seed=0):
    import jax
    import jax.numpy as jnp
    from reak_tpu.ctrl import mpc_manifold as mm, ss_systems as ss
    from reak_tpu.ctrl.belief import GaussianBelief

    H = H or SATELLITE["H"]
    belief = GaussianBelief(ss.default_state(), 0.05 * jnp.eye(12))
    x0s = mm.sample_belief_states(jax.random.PRNGKey(seed), belief, B,
                                  ret=ss.sat3D_retraction())
    return x0s.astype(jnp.float32), jnp.zeros((B, H, 6), jnp.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_pdip():
    """The lanes PDIP at the flagship and satellite widths against the
    independent per-scenario solver (ctrl/riccati.py under vmap)."""
    import jax
    import jax.numpy as jnp
    from reak_tpu.ctrl import riccati
    from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused
    from reak_tpu.kte import lanes

    B, H = FLAGSHIP["B"], FLAGSHIP["H"]
    spec, prob = flagship(H)
    x0, _ = flagship_inputs(B, H)
    u0 = jnp.asarray(np.random.default_rng(1).uniform(-5, 5, (B, H, 6)),
                     jnp.float32)
    A, Bm, c, _ = jax.jit(lanes.make_rollout_ltv_lanes(spec, 0.01, H))(x0,
                                                                        u0)
    bf = lambda a: jnp.moveaxis(a[..., :N_REF], -1, 0)
    per_scenario = jax.jit(jax.vmap(
        lambda a, b, cc, x, *r: riccati.solve_box_mpc_riccati(
            a, b, cc, prob.Q, prob.QN, prob.R, x, prob.u_min, prob.u_max,
            *r, iters=8)))

    print(f"lanes PDIP (regulator, H={H}, n=12, m=6, B={B}) vs per-scenario"
          f" solver on {N_REF} scenarios")
    pdip = compiled(lambda A, Bm, c, x: solve_box_mpc_riccati_soa_fused(
        A, Bm, c, prob.Q, prob.QN, prob.R, x, prob.u_min, prob.u_max,
        iters=8), A, Bm, c, x0.T)
    u, _ = pdip(A, Bm, c, x0.T)
    in_bounds(u, -40.0, 40.0)
    u_v, _ = per_scenario(bf(A), bf(Bm), bf(c), x0[:N_REF])
    check("PDIP u vs per-scenario", max_abs(bf(u), u_v), U_ABS)

    Hs = SATELLITE["H"]
    print(f"lanes tracking PDIP (x_ref, H={Hs}, B={B}) vs per-scenario "
          f"solver on {N_REF} scenarios")
    xr = jnp.asarray(0.1 * np.random.default_rng(2).standard_normal(
        (Hs, 12, B)), jnp.float32)
    cut = lambda a: a[:Hs]
    trk = compiled(lambda A, Bm, c, x, xr: solve_box_mpc_riccati_soa_fused(
        A, Bm, c, prob.Q, prob.QN, prob.R, x, prob.u_min, prob.u_max,
        x_ref=xr, iters=8), cut(A), cut(Bm), cut(c), x0.T, xr)
    u_t, _ = trk(cut(A), cut(Bm), cut(c), x0.T, xr)
    u_tv, _ = per_scenario(bf(cut(A)), bf(cut(Bm)), bf(cut(c)), x0[:N_REF],
                           bf(xr))
    check("tracking PDIP u vs per-scenario", max_abs(bf(u_t), u_tv), U_ABS)


def _solve(name, solve, args, lo, hi, host=True):
    """Solve at full width on the card a few times; the controls must be
    finite and inside the bounds.  With ``host``, the first N_REF scenarios
    are solved again by the same solver on the host's CPU backend.
    Returns the jitted solver."""
    import jax

    f = jax.jit(solve)
    for _ in range(3):
        us = jax.block_until_ready(f(*args))
    in_bounds(us, lo, hi)
    print(f"  {name}: {us.shape} controls finite and inside the bounds",
          flush=True)
    if host:
        cpu = jax.devices("cpu")[0]
        ref = jax.jit(solve)(*[jax.device_put(a[:N_REF], cpu) for a in args])
        check(f"{name} u vs host CPU", max_abs(us[:N_REF], ref), U_ABS)
    return f


def phase_main_path():
    """The user entry points at the shipped widths; returns the jitted
    flagship solver."""
    import jax.numpy as jnp
    from reak_tpu.ctrl import mpc, manifold_lanes as ml, mpc_manifold as mm
    from reak_tpu.kte import models

    spec, prob = flagship()
    print(f"make_kte_mpc flagship ({FLAGSHIP}, qp_iters=8, sqp_iters=1)")
    solver = mpc.make_kte_mpc(spec, prob, 0.01, qp_iters=8, sqp_iters=1)
    flagship_solve = _solve("flagship", lambda x, u: solver(x, u)[0],
                            flagship_inputs(FLAGSHIP["B"]), -40.0, 40.0)

    params, sprob, x_ref = satellite()
    print(f"make_sat_scenario_mpc_lanes satellite ({SATELLITE}, sqp=2)")
    sat = ml.make_sat_scenario_mpc_lanes(params, sprob, 0.1, qp_iters=8,
                                         sqp_iters=2)
    _solve("satellite", lambda x, u: sat(x, x_ref, u)[0],
           satellite_inputs(SATELLITE["B"]), -20.0, 20.0)

    fa = models.floating_arm()
    nv, nq = fa.nv, fa.nq
    w = jnp.concatenate([jnp.full(nv, 5.0), jnp.full(nv, 0.5)])
    fprob = mpc.MPCProblem(
        Q=jnp.diag(w), R=jnp.eye(nv) * 0.05, QN=jnp.diag(10.0 * w),
        u_min=jnp.full(nv, -30.0), u_max=jnp.full(nv, 30.0),
        horizon=FLOATING_ARM["H"])
    rng = np.random.default_rng(3)
    Bf = FLOATING_ARM["B"]
    qr = rng.standard_normal((Bf, 4))
    qr /= np.linalg.norm(qr, axis=1, keepdims=True)
    xf = np.zeros((Bf, nq + nv))
    xf[:, 0:3] = 0.2 * rng.standard_normal((Bf, 3))
    xf[:, 3:7] = qr
    xf[:, 7:nq] = 0.3 * rng.standard_normal((Bf, nq - 7))
    xf[:, nq:] = 0.1 * rng.standard_normal((Bf, nv))
    xrf = jnp.zeros(nq + nv, jnp.float32).at[3].set(1.0)
    print(f"make_kte_scenario_mpc floating arm (nv=12, {FLOATING_ARM})")
    arm = mm.make_kte_scenario_mpc(fa, fprob, 0.02, qp_iters=8, sqp_iters=1)
    _solve("floating arm", lambda x, u: arm(x, xrf, u)[0],
           (jnp.asarray(xf, jnp.float32),
            jnp.zeros((Bf, FLOATING_ARM["H"], nv), jnp.float32)),
           -30.0, 30.0, host=False)
    return flagship_solve


def phase_timing(card, flagship_solve, reps=10):
    """The flagship solve (make_kte_mpc) and its two phases, the lanes
    rollout and the PDIP, in alternating turns, warm-up excluded
    (informational lines)."""
    import jax
    from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused
    from reak_tpu.kte import lanes

    spec, prob = flagship()
    x0, u0 = flagship_inputs(FLAGSHIP["B"])
    roll = jax.jit(lanes.make_rollout_ltv_lanes(spec, 0.01, FLAGSHIP["H"]))
    A, Bm, c, _ = roll(x0, u0)
    runs = {
        "full solve": (flagship_solve, (x0, u0)),
        "rollout + LTV": (roll, (x0, u0)),
        "PDIP": (jax.jit(lambda A, Bm, c, x: solve_box_mpc_riccati_soa_fused(
            A, Bm, c, prob.Q, prob.QN, prob.R, x, prob.u_min, prob.u_max,
            iters=8)), (A, Bm, c, x0.T)),
    }
    for f, args in runs.values():
        jax.block_until_ready(f(*args))
    times = {k: [] for k in runs}
    for r in range(reps):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for k in order:
            f, args = runs[k]
            t = time.perf_counter()
            jax.block_until_ready(f(*args))
            times[k].append(time.perf_counter() - t)
    for k, v in times.items():
        print(f"  flagship {FLAGSHIP}, {k}: median "
              f"{1e3 * float(np.median(v)):.3f} ms, min "
              f"{1e3 * float(np.min(v)):.3f} ms over {reps} [{card}]",
              flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)


def phase_four_cards():
    """The flagship and satellite solvers under shard_map on a 4-card mesh
    at 4 × 8192 scenarios, each shard against a one-card solve of the same
    scenarios, and the compiled HLO's collectives."""
    import re

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from reak_tpu.ctrl import mpc, manifold_lanes as ml

    devs = jax.devices()
    if len(devs) != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = Mesh(np.array(devs), ("scenarios",))
    shard = NamedSharding(mesh, P("scenarios"))
    B = FLAGSHIP["B"]

    spec, prob = flagship()
    params, sprob, x_ref = satellite()
    solver = mpc.make_kte_mpc(spec, prob, 0.01, qp_iters=8, sqp_iters=1)
    sat = ml.make_sat_scenario_mpc_lanes(params, sprob, 0.1, qp_iters=8,
                                         sqp_iters=2)
    cases = {
        "flagship": (lambda x, u: solver(x, u)[0], flagship_inputs(4 * B)),
        "satellite": (lambda x, u: sat(x, x_ref, u)[0],
                      satellite_inputs(4 * B)),
    }
    # one match per collective: the synchronous op or the -start of an
    # asynchronous pair (its -done names no new collective)
    pat = re.compile(r"(\w+)\[([\d,]*)\][^=\n]*?\s(all-reduce|all-gather|"
                     r"reduce-scatter|collective-permute|all-to-all)"
                     r"(?:-start)?\(")
    for name, (fn, (x0, u0)) in cases.items():
        print(f"{name} under shard_map on 4 cards, {4 * B} scenarios")

        def local(x, u, fn=fn):
            us = fn(x, u)
            return us, jax.lax.pmean(jnp.mean(us ** 2), "scenarios")

        step = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(P("scenarios"), P("scenarios")),
            out_specs=(P("scenarios"), P())))
        xs, us = jax.device_put(x0, shard), jax.device_put(u0, shard)
        c = step.lower(xs, us).compile()
        colls = [m.groups() for m in pat.finditer(c.as_text())]
        print(f"  collectives in the compiled HLO: {colls}", flush=True)
        if len(colls) != 1 or colls[0][2] != "all-reduce" or colls[0][1]:
            raise SystemExit(f"FAILED {name}: expected one scalar "
                             f"all-reduce, found {colls}")
        out, _ = c(xs, us)
        got = {s.device: s for s in out.addressable_shards}
        if set(got) != set(devs):
            raise SystemExit(f"FAILED {name}: shards on {set(got)}")
        one = jax.jit(fn)
        err = 0.0
        for d in devs:
            s = got[d]
            if s.data.shape[0] != B:
                raise SystemExit(f"FAILED {name}: shard {s.data.shape}")
            sl = s.index[0]
            ref = one(jax.device_put(x0[sl], devs[0]),
                      jax.device_put(u0[sl], devs[0]))
            err = max(err, max_abs(s.data, ref))
            print(f"  {d}: shard {sl.start}:{sl.stop}", flush=True)
        check(f"{name} sharded u vs one-card solve", err, U_ABS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the 4-card sharded path and its comparison "
                         "only")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # the host references of phase 3 run on the CPU backend; the GPU
        # stays JAX's default device
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    try:
        import reak_tpu
    except ImportError:
        raise SystemExit("chip_smoke.py runs from the root of a checkout "
                         "of the repository (no reak_tpu package here)")
    import jax

    require_gpu(jax.devices())
    reak_tpu.enable_full_precision()
    reak_tpu.enable_compile_cache()
    dev = jax.devices()[0]
    card = card_line()
    print(f"device {dev.device_kind} x{len(jax.devices())}, jax "
          f"{jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_pdip()
        phase_timing(card, phase_main_path())
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

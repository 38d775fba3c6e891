#!/usr/bin/env python
"""Headline benchmark: MPC solves/s on one GPU for the 6-DoF CRS-A465-style
KTE arm, horizon H=50 (BASELINE.json north star; target ≥ 5000 solves/s).

One "solve" = the full per-scenario pipeline on device: the lanes rollout +
LTV linearization, then the scan-fused Riccati interior-point box-QP, as
XLA compiles them.

Accounting:
  * phase_ms — rollout+linearize vs PDIP, timed separately (chained async
    calls, one block_until_ready at the end);
  * flops_per_solve — per-STEP XLA cost analysis of the loop-free step /
    iteration bodies (XLA's cost model undercounts `scan` bodies, so each
    body is compiled standalone and multiplied by its trip count).

Runs on a GPU only: on any other backend it exits non-zero before measuring.
Prints the card's name and power limit on one line, then ONE JSON line.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import reak_tpu

# full-f32 contractions for the parity bars (explicit opt-in)
reak_tpu.enable_full_precision()
reak_tpu.enable_compile_cache()


def amortized(fn, args, reps):
    """Seconds per call: one warm-up call (compile), then ``reps`` chained
    async calls and one block_until_ready at the end."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def card_line() -> str:
    """``name, power.limit`` of the card, read by nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    from reak_tpu.kte import models, lanes
    from reak_tpu.ctrl import mpc
    from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    print(card_line(), flush=True)

    horizon = int(os.environ.get("BENCH_HORIZON", 50))
    batch = int(os.environ.get("BENCH_BATCH", 8192))
    qp_iters = int(os.environ.get("BENCH_QP_ITERS", 8))
    reps = int(os.environ.get("BENCH_REPS", 10))
    dt = 0.01
    m = 6

    spec = models.manip_3r3r()
    prob = mpc.MPCProblem(
        Q=jnp.diag(jnp.concatenate([jnp.full(6, 10.0), jnp.full(6, 1.0)])),
        R=jnp.eye(m) * 0.05,
        QN=jnp.diag(jnp.concatenate([jnp.full(6, 50.0), jnp.full(6, 5.0)])),
        u_min=jnp.full(m, -40.0),
        u_max=jnp.full(m, 40.0),
        horizon=horizon,
    )

    solver = mpc.make_kte_mpc(spec, prob, dt, qp_iters=qp_iters, sqp_iters=1)
    step = jax.jit(lambda x0, u0: solver(x0, u0)[0])

    rng = np.random.default_rng(0)
    x0 = jnp.asarray(
        np.concatenate(
            [rng.uniform(-0.5, 0.5, (batch, 6)),
             rng.uniform(-0.2, 0.2, (batch, 6))],
            axis=1,
        ),
        dtype=jnp.float32,
    )
    u0 = jnp.zeros((batch, horizon, m), jnp.float32)

    t_full = amortized(step, (x0, u0), reps)
    solves_per_s = batch / t_full

    # ---- phase split -----------------------------------------------------
    f_roll = jax.jit(lanes.make_rollout_ltv_lanes(spec, dt, horizon))
    t_roll = amortized(f_roll, (x0, u0), reps)
    A_l, B_l, c_l, _ = f_roll(x0, u0)
    f_pdip = jax.jit(lambda A, Bm, c, xT: solve_box_mpc_riccati_soa_fused(
        A, Bm, c, prob.Q, prob.QN, prob.R, xT, prob.u_min, prob.u_max,
        iters=qp_iters)[0])
    t_pdip = amortized(f_pdip, (A_l, B_l, c_l, x0.T), reps)

    # ---- analytic FLOPs: per-step cost analysis x trip counts -------------
    # H=1 rollout is the loop-free step body; PDIP per-iteration flops come
    # from the iters=2 − iters=1 difference (removes the shared pre/post).
    roll1 = lanes.make_rollout_ltv_lanes(spec, dt, 1)
    ca_roll = jax.jit(roll1).lower(x0, u0[:, :1]).compile().cost_analysis()

    def pdip_flops(iters):
        f = jax.jit(lambda A, Bm, c, xT: solve_box_mpc_riccati_soa_fused(
            A, Bm, c, prob.Q, prob.QN, prob.R, xT, prob.u_min, prob.u_max,
            iters=iters)[0])
        return f.lower(A_l, B_l, c_l, x0.T).compile().cost_analysis()["flops"]

    fl1, fl2 = pdip_flops(1), pdip_flops(2)
    fl_iter = fl2 - fl1
    flops_per_solve = (horizon * ca_roll["flops"] + qp_iters * fl_iter
                       + fl1 - fl_iter) / batch

    # ---- free-base belief-sampled scenario MPC (satellite) ----------------
    from reak_tpu.ctrl import mpc_manifold as mm, ss_systems as ss
    from reak_tpu.ctrl import manifold_lanes as ml
    from reak_tpu.ctrl.belief import GaussianBelief

    fb_B = int(os.environ.get("BENCH_FREEBASE_BATCH", 8192))
    fb_H = 20
    params = ss.satellite3D(mass=10.0,
                            inertia=jnp.diag(jnp.asarray([4.0, 5.0, 6.0])))
    ret = ss.sat3D_retraction()
    w12 = jnp.concatenate([jnp.full(6, 10.0), jnp.full(6, 1.0)])
    prob_fb = mpc.MPCProblem(
        Q=jnp.diag(w12), R=jnp.eye(6) * 0.05, QN=jnp.diag(10.0 * w12),
        u_min=jnp.full(6, -20.0), u_max=jnp.full(6, 20.0), horizon=fb_H)
    solver_fb = ml.make_sat_scenario_mpc_lanes(
        params, prob_fb, 0.1, qp_iters=qp_iters, sqp_iters=2)
    x_ref = ss.default_state().at[0:3].set(jnp.array([1.0, 0.5, -0.3]))
    belief = GaussianBelief(ss.default_state(), 0.05 * jnp.eye(12))
    x0s = mm.sample_belief_states(jax.random.PRNGKey(0), belief, fb_B,
                                  ret=ret).astype(jnp.float32)
    u_init = jnp.zeros((fb_B, fb_H, 6), jnp.float32)
    fb_step = jax.jit(lambda xs, us: solver_fb(
        xs, x_ref.astype(jnp.float32), us)[0])
    t_fb = amortized(fb_step, (x0s, u_init), max(2, reps // 2))
    free_base = {
        "metric": "free_base_scenario_mpc_solves_per_s",
        "value": round(fb_B / t_fb, 1),
        "unit": "solves/s",
        "config": {"model": "satellite3D_imdt", "horizon": fb_H,
                   "scenarios": fb_B, "qp_iters": qp_iters,
                   "sqp_iters": 2, "state": "quaternion (error-state)",
                   "path": "lanes + scan-fused tracking PDIP"},
    }

    # ---- free-base KTE chain: the floating manipulator (free base + 6-DoF
    # arm, nv=12, tangent d=24) on the lanes manifold SQP
    from reak_tpu.kte.lanes import make_kte_manifold_lanes

    fa_spec = models.floating_arm()
    fa_B = int(os.environ.get("BENCH_FLOATARM_BATCH", 2048))
    fa_H = 16
    nv, nq = fa_spec.nv, fa_spec.nq
    w = jnp.concatenate([jnp.full(nv, 5.0), jnp.full(nv, 0.5)])
    prob_fa = mpc.MPCProblem(
        Q=jnp.diag(w), R=jnp.eye(nv) * 0.05, QN=jnp.diag(10.0 * w),
        u_min=jnp.full(nv, -30.0), u_max=jnp.full(nv, 30.0),
        horizon=fa_H)
    fstep, fltv = make_kte_manifold_lanes(fa_spec, 0.02)
    solver_fa = ml.make_scenario_mpc_lanes(
        fstep, fltv, prob_fa, tangent_dim=2 * nv, quat_index=3,
        qp_iters=qp_iters, sqp_iters=1)
    qr = rng.standard_normal((fa_B, 4)).astype(np.float32)
    qr /= np.linalg.norm(qr, axis=1, keepdims=True)
    x0f = np.zeros((fa_B, nq + nv), np.float32)
    x0f[:, 0:3] = 0.2 * rng.standard_normal((fa_B, 3))
    x0f[:, 3:7] = qr
    x0f[:, 7:nq] = 0.3 * rng.standard_normal((fa_B, nq - 7))
    x0f[:, nq:] = 0.1 * rng.standard_normal((fa_B, nv))
    xrf = np.zeros(nq + nv, np.float32)
    xrf[3] = 1.0
    f_fa = jax.jit(lambda a, b: solver_fa(a, jnp.asarray(xrf), b)[0])
    t_fa = amortized(f_fa, (jnp.asarray(x0f),
                            jnp.zeros((fa_B, fa_H, nv), jnp.float32)),
                     max(2, reps // 2))
    float_arm = {
        "metric": "floating_arm_scenario_mpc_solves_per_s",
        "value": round(fa_B / t_fa, 1),
        "unit": "solves/s",
        "config": {"model": "floating_arm (free base + 6-DoF arm)",
                   "nv": nv, "tangent_dim": 2 * nv, "horizon": fa_H,
                   "scenarios": fa_B, "qp_iters": qp_iters,
                   "sqp_iters": 1,
                   "path": "kte manifold lanes + scan-fused tracking PDIP"},
    }

    # ---- H=128 long-horizon point ----------------------------------------
    B128 = 2048
    roll128 = jax.jit(lanes.make_rollout_ltv_lanes(spec, dt, 128))
    x0h = x0[:B128]
    A_h, B_h, c_h, _ = roll128(x0h, jnp.zeros((B128, 128, m), jnp.float32))
    f_h128 = jax.jit(lambda A, Bm, c, xT: solve_box_mpc_riccati_soa_fused(
        A, Bm, c, prob.Q, prob.QN, prob.R, xT, prob.u_min, prob.u_max,
        iters=qp_iters)[0])
    t_h128 = amortized(f_h128, (A_h, B_h, c_h, x0h.T), max(2, reps // 2))
    h128 = {"horizon": 128, "batch": B128,
            "pdip_ms": round(t_h128 * 1e3, 2),
            "pdip_solves_per_s": round(B128 / t_h128, 1)}

    target = 5000.0
    print(json.dumps({
        "metric": "mpc_solves_per_s_per_chip_6dof_H50",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / target, 3),
        "phase_ms": {"rollout_linearize": round(t_roll * 1e3, 2),
                     "riccati_pdip": round(t_pdip * 1e3, 2),
                     "full": round(t_full * 1e3, 2)},
        "flops_per_solve": round(flops_per_solve),
        "config": {"batch": batch, "horizon": horizon,
                   "qp_iters": qp_iters, "reps": reps,
                   "dtype": "float32",
                   "backend": jax.default_backend()},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "free_base_scenario_mpc": free_base,
        "floating_arm_scenario_mpc": float_arm,
        "long_horizon_h128": h128,
    }))


if __name__ == "__main__":
    main()

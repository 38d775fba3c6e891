"""Two-process FLAGSHIP solver test: the exact
bench.py MPC pipeline (6-DoF 3R3R arm, H=50, lanes rollout + Riccati PDIP)
sharded over a 2-process × 2-virtual-device CPU mesh via jax.distributed.

Upgrades tests/test_distributed.py's toy psum to the real workload:

* asserts CONTROL-SEQUENCE EQUALITY between the distributed solve and a
  single-process solve of the same global batch (per addressable shard);
* counts the ACTUAL cross-device collective payload by parsing the compiled
  HLO for all-reduce/all-gather/… instructions — validating that the
  flagship's collective pattern is ONE scalar pmean per step (4 bytes), not
  a hidden re-gather.

Run as a script (``python tests/test_distributed_flagship.py``) to print the
result JSON to stdout.
"""
import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import json, os, re, sys, time
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.environ["REAK_REPO"])
    from reak_tpu.parallel.mesh import distribute_init
    from reak_tpu.kte import models
    from reak_tpu.ctrl import mpc

    coord = os.environ["COORD"]
    pid = int(os.environ["PROC_ID"])
    assert distribute_init(coord, num_processes=2, process_id=pid)
    assert jax.process_count() == 2
    devs = jax.devices()
    assert len(devs) == 4

    mesh = Mesh(np.array(devs), ("scenarios",))
    spec = models.manip_3r3r()
    H, m, n = 50, 6, 12
    prob = mpc.MPCProblem(
        Q=jnp.diag(jnp.concatenate([jnp.full(6, 10.0), jnp.full(6, 1.0)])),
        R=jnp.eye(m) * 0.05,
        QN=jnp.diag(jnp.concatenate([jnp.full(6, 50.0), jnp.full(6, 5.0)])),
        u_min=jnp.full(m, -40.0), u_max=jnp.full(m, 40.0), horizon=H)
    solver = mpc.make_kte_mpc(spec, prob, 0.01, qp_iters=8, sqp_iters=1)

    def local_step(x0_shard, u0_shard):
        us, xs = solver(x0_shard, u0_shard)
        mean_cost = jax.lax.pmean(jnp.mean(us**2), "scenarios")
        return us, mean_cost

    step = jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P("scenarios"), P("scenarios")),
        out_specs=(P("scenarios"), P())))

    B = 8  # 2 scenarios per device
    x0_np = np.zeros((B, n), np.float32)
    x0_np[:, 0] = np.linspace(0.1, 0.4, B)
    x0_np[:, 3] = np.linspace(-0.2, 0.2, B)
    u0_np = np.zeros((B, H, m), np.float32)
    shard = NamedSharding(mesh, P("scenarios"))
    x0 = jax.make_array_from_callback((B, n), shard, lambda i: x0_np[i])
    u0 = jax.make_array_from_callback(
        (B, H, m), NamedSharding(mesh, P("scenarios")),
        lambda i: u0_np[i])

    # ---- compiled-HLO collective audit --------------------------------
    compiled = step.lower(x0, u0).compile()
    hlo = compiled.as_text()
    coll_bytes = 0
    coll_ops = []
    pat = re.compile(
        r"(\\w+)\\[([\\d,]*)\\][^=]*\\b"
        r"(all-reduce|all-gather|reduce-scatter|collective-permute|"
        r"all-to-all)\\b")
    nbytes = {"f32": 4, "f64": 8, "bf16": 2, "s32": 4, "u32": 4, "pred": 1}
    for mt in pat.finditer(hlo):
        dtype, dims, op = mt.groups()
        cnt = 1
        for d in dims.split(","):
            if d:
                cnt *= int(d)
        coll_bytes += cnt * nbytes.get(dtype, 4)
        coll_ops.append(f"{op} {dtype}[{dims}]")

    t0 = time.perf_counter()
    us, mean_cost = step(x0, u0)
    jax.block_until_ready((us, mean_cost))
    dist_s = time.perf_counter() - t0

    # ---- single-process reference of the SAME global batch ------------
    ref_us, _ = jax.jit(solver)(jnp.asarray(x0_np), jnp.asarray(u0_np))
    ref_us = np.asarray(ref_us)
    max_err = 0.0
    for s in us.addressable_shards:
        idx = s.index
        max_err = max(max_err,
                      float(np.max(np.abs(np.asarray(s.data) - ref_us[idx]))))

    print("RESULT " + json.dumps({
        "proc": pid, "collective_bytes": coll_bytes,
        "collective_ops": coll_ops,
        "max_err_vs_single_process": max_err,
        "mean_cost": float(mean_cost),
        "wall_s_one_step": dist_s,
        "global_batch": B, "devices": len(devs),
        "processes": 2}), flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmpdir):
    script = os.path.join(tmpdir, "worker_flagship.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(COORD=coord, PROC_ID=str(pid), REAK_REPO=repo,
                   # set BEFORE the interpreter starts
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        procs.append(subprocess.Popen(
            [sys.executable, script], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            raise AssertionError(f"flagship worker hung; output:\n{out}")
        outs.append(out)
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        m = re.search(r"^RESULT (.*)$", out, re.M)
        assert m, f"proc{pid}: no RESULT line:\n{out}"
        results.append(json.loads(m.group(1)))
    return results


def test_two_process_flagship_solver(tmp_path):
    results = _run_workers(str(tmp_path))
    for r in results:
        # control sequences match the single-process solve (f32 exact-ish:
        # per-scenario math is independent of the batch partition)
        assert r["max_err_vs_single_process"] < 1e-5, r
        # the collective pattern really is one scalar pmean per step: the
        # all-reduce payload must be a handful of bytes, not a re-gather of
        # the (B, H, m) sequences (~9.6 KB/scenario)
        assert r["collective_bytes"] <= 64, r["collective_ops"]
        assert any("all-reduce" in op for op in r["collective_ops"]), r
    # both processes agree on the psum-reduced summary
    assert abs(results[0]["mean_cost"] - results[1]["mean_cost"]) < 1e-9


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        res = _run_workers(td)
    print(json.dumps({
        "test": "two_process_flagship_mpc",
        "workload": "6dof_3r3r_H50_qp8 lanes+PDIP, shard_map over "
                    "2 processes x 2 virtual CPU devices",
        "results": res,
    }, indent=1))

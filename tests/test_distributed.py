"""Multi-process jax.distributed smoke test (SURVEY §4 implication (f)): two localhost processes, parallel.mesh.distribute_init
coordinator bring-up, and a psum across the resulting 2-process CPU mesh.

This is the only multi-HOST correctness evidence available on a single
machine: it exercises the coordinator/DCN code path (jax.distributed) that
the single-process virtual-device tests cannot.  The same recipe scales to
real hosts — see README "multi-host launch".
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    sys.path.insert(0, os.environ["REAK_REPO"])
    from reak_tpu.parallel.mesh import distribute_init

    coord = os.environ["COORD"]
    pid = int(os.environ["PROC_ID"])
    ok = distribute_init(coord, num_processes=2, process_id=pid)
    assert ok, "distribute_init returned False with full arguments"
    assert jax.process_count() == 2, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 4, devs  # 2 processes x 2 virtual CPU devices

    mesh = Mesh(np.array(devs), ("scenarios",))

    def local_sum(x):
        return jax.lax.psum(jnp.sum(x), "scenarios")

    step = jax.jit(jax.shard_map(
        local_sum, mesh=mesh, in_specs=P("scenarios"), out_specs=P()))
    # global array: each process contributes its addressable shards
    global_shape = (8,)
    arrs = []
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, P("scenarios"))
    x = jax.make_array_from_callback(
        global_shape, sharding,
        lambda idx: np.arange(8.0)[idx])
    total = step(x)
    expected = float(np.arange(8.0).sum())
    assert abs(float(total) - expected) < 1e-9, (total, expected)
    print(f"proc{pid} psum ok: {float(total)}", flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_psum(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(COORD=coord, PROC_ID=str(pid), REAK_REPO=repo)
        # fresh interpreters: jax.distributed cannot re-init in-process
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            pytest.fail(f"distributed worker hung; partial output:\n{out}")
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid} psum ok: 28.0" in out, out

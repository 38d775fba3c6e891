"""reak_tpu — a JAX multibody dynamics / control / estimation / planning framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the ReaK platform
(multibody KTE dynamics, state estimation, optimal control / MPC, and probabilistic
path planning).  Everything is built around pure functions over explicit pytree
state, batched with ``vmap``, and scaled over device meshes with
``shard_map``/``pjit``.

Layer map (mirrors the capability layers of the reference, SURVEY.md §1):

- ``reak_tpu.math``        rotations / quaternions / frames / dense numerics  (ref: core/lin_alg, core/kinetostatics)
- ``reak_tpu.kte``         chain-spec multibody dynamics                      (ref: ctrl/mbd_kte, ctrl/kte_models)
- ``reak_tpu.integrators`` ODE steppers as scans                              (ref: core/integrators)
- ``reak_tpu.ctrl``        state-space systems, filters, LQR/MPC, vehicles    (ref: ctrl/ctrl_sys, ctrl/ss_systems)
- ``reak_tpu.spaces``      metric spaces / topologies                         (ref: ctrl/topologies)
- ``reak_tpu.interp``      interpolators & trajectories                       (ref: ctrl/interpolation)
- ``reak_tpu.planning``    sampling-based planners w/ batched device eval     (ref: ctrl/graph_alg, ctrl/path_planning)
- ``reak_tpu.geom``        shapes & batched proximity kernels                 (ref: geometry/*)
- ``reak_tpu.opt``         optimizers (line search, QP, NLLSQ, NLP)           (ref: core/optimization, core/root_finders)
- ``reak_tpu.io``          recorders, serialization, config                   (ref: core/recorders, core/serialization)
- ``reak_tpu.parallel``    device mesh / collectives helpers
- ``reak_tpu.errors``      failure detection: status flags + host exceptions  (ref: exception surface, SURVEY §5.3)
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def enable_full_precision() -> None:
    """Set the process-wide default matmul precision to full f32.

    The reference framework is double-precision scalar C++ throughout; its
    capabilities (filter consistency, QP duality gaps, proximity signs) assume
    true-precision contractions.  On an NVIDIA GPU, XLA may run f32
    contractions (every jnp.einsum/@ in the dynamics and solver paths) in
    TF32 on the tensor cores, which keeps ~3 decimal digits of the operands.
    "highest" keeps them in full f32.  The batched MPC path is mostly
    elementwise work that uses no tensor cores, so this costs it little; it
    is required for the documented parity bars (BASELINE.md: ≤1e-4 vs
    oracle).

    Explicit opt-in (never run at import time — a library import must not
    change numerics of unrelated co-resident JAX code): call this from your
    program's entry point, as bench.py, chip_smoke.py and the examples/ CLIs
    do.  No-op if
    the user has already chosen a precision.
    """
    if _jax.config.jax_default_matmul_precision is None:
        _jax.config.update("jax_default_matmul_precision", "highest")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set in code.  Otherwise the cache goes to the fixed path
    ``<checkout>/.jax_cache/`` (the directory is part of the cache key, so
    it must not move between runs)."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")
    _jax.config.update("jax_compilation_cache_dir", path)
    return path

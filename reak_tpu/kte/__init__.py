"""KTE multibody dynamics, JAX-native.

Re-design of the reference's Kinetostatic Transmission Element machinery
(ref: ctrl/mbd_kte/kte_map.hpp:85-106, kte_map_chain.hpp:49,
mass_matrix_calculator.hpp:54, manipulator_model.hpp:69,413).

Instead of a pointer-graph of mutable frames swept by doMotion/doForce, a chain
is *data*: a static :class:`ChainSpec` describing joints, links, inertias, and
passive elements, compiled once into pure functions

    fk(spec, q)                    → per-body global frames
    jacobians(spec, q)             → stacked twist-shaping matrices (the Tcm of
                                     mass_matrix_calc, ref mass_matrix_calculator.cpp:100)
    mass_matrix(spec, q)           → M = Tᵀ Mcm T
    bias_force(spec, q, qd)        → accumulated generalized force at q̈ = 0
                                     (the f_nl of the reference's sweeps)
    forward_dynamics(spec, q, qd, tau) → q̈     (ref: manipulator_model.cpp:292 computeStateRate)
    inverse_dynamics(spec, q, qd, qdd) → tau

All functions are single-sample; batching is ``jax.vmap``, horizons are
``lax.scan``, devices are ``shard_map``.
"""
from reak_tpu.kte.spec import (
    ChainSpec,
    JointType,
    REVOLUTE,
    PRISMATIC,
    FIXED,
    FREE,
)
from reak_tpu.kte.dynamics import (
    fk,
    body_frames,
    jacobians,
    velocities,
    mass_matrix,
    mass_matrix_and_derivative,
    bias_force,
    forward_dynamics,
    inverse_dynamics,
    state_rate,
    pack_state,
    unpack_state,
)
from reak_tpu.kte import models
from reak_tpu.kte import ik
from reak_tpu.kte import forces

__all__ = [
    "ChainSpec",
    "JointType",
    "REVOLUTE",
    "PRISMATIC",
    "FIXED",
    "FREE",
    "fk",
    "body_frames",
    "jacobians",
    "velocities",
    "mass_matrix",
    "mass_matrix_and_derivative",
    "bias_force",
    "forward_dynamics",
    "inverse_dynamics",
    "state_rate",
    "pack_state",
    "unpack_state",
    "models",
    "ik",
    "forces",
]

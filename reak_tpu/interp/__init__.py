"""Interpolators, paths & trajectories.

JAX-native re-design of the reference's interpolation library
(ref: ctrl/interpolation/* — linear_interp.hpp:179, cubic_hermite_interp.hpp:217,
quintic_hermite_interp.hpp:346, sustained_velocity_pulse.hpp:176,
sustained_acceleration_pulse.hpp:220, waypoint_container.hpp,
trajectory_base.hpp, transformed_trajectory.hpp).

Everything evaluates in batch: an interpolator maps (waypoint data, t) → point
with t broadcasting, so planners/controllers sample thousands of trajectory
points per device call.
"""
from reak_tpu.interp.hermite import (
    linear_interp,
    cubic_hermite_interp,
    quintic_hermite_interp,
)
from reak_tpu.interp.pulses import (
    svp_min_time,
    svp_peak_velocity,
    svp_eval,
    svp_interpolate,
    svp_reach_time,
    sap_min_time,
    sap_peak_velocity,
    sap_eval,
    sap_interpolate,
    sap_reach_time,
)
from reak_tpu.interp.trajectory import (
    Trajectory,
    waypoint_trajectory,
    constant_trajectory,
    transformed_trajectory,
    point_to_point_trajectory,
)

__all__ = [
    "linear_interp",
    "cubic_hermite_interp",
    "quintic_hermite_interp",
    "svp_min_time",
    "svp_peak_velocity",
    "svp_eval",
    "svp_interpolate",
    "svp_reach_time",
    "sap_min_time",
    "sap_peak_velocity",
    "sap_eval",
    "sap_interpolate",
    "sap_reach_time",
    "Trajectory",
    "waypoint_trajectory",
    "constant_trajectory",
    "transformed_trajectory",
    "point_to_point_trajectory",
]

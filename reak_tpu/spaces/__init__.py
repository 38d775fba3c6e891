"""Metric spaces / topologies for sampling-based planning and interpolation.

JAX-native re-design of the reference's configuration-space library
(ref: ctrl/topologies/* — metric_space_concept.hpp, differentiable_space.hpp:220,
metric_space_tuple.hpp, se3_topologies.hpp:186, joint_space_topologies.hpp:63,
Ndof_spaces.hpp:138, temporal_space.hpp, rate_limited_spaces.hpp).

A space is a small value object exposing pure functions over array "points":

    sample(key, batch)     random points         (random_sampler_concept.hpp)
    distance(a, b)         metric                (metric_space_concept.hpp)
    interpolate(a, b, t)   geodesic move         (the LERP of move_position_toward)
    clamp(p)               project into bounds   (bounded_space_concept.hpp)
    difference(a, b)       tangent delta

Points are plain arrays (leading batch axes everywhere), so planners batch
thousands of distance/steer evaluations per device call.
"""
from reak_tpu.spaces.base import Space, ProductSpace
from reak_tpu.spaces.vector import HyperboxSpace, HyperballSpace, NdofSpace, LineSpace
from reak_tpu.spaces.so3 import SO3Space
from reak_tpu.spaces.se3 import (
    SE3Space,
    SE31stOrderSpace,
    SE32ndOrderSpace,
    make_se3_space,
)
from reak_tpu.spaces.se2 import (
    SE2Space,
    SE21stOrderSpace,
    SE22ndOrderSpace,
    FlatSE2Space,
    make_se2_space,
)
from reak_tpu.spaces.topomaps import DirectKinTopoMap, InverseKinTopoMap
from reak_tpu.spaces.belief import GaussianBeliefSpace
from reak_tpu.spaces.temporal import TemporalSpace
from reak_tpu.spaces.rate_limited import RateLimitedNdofSpace, joint_limits_mapping
from reak_tpu.spaces.interpolated import InterpolatedSpace
from reak_tpu.spaces.tangent import (
    DifferentiableSpace,
    make_differentiable_ndof,
    Ndof1stOrderSpace,
    Ndof2ndOrderSpace,
    NdofPoint1,
    NdofPoint2,
    ReachabilitySpace,
    make_ndof_space,
)

__all__ = [
    "Space",
    "ProductSpace",
    "HyperboxSpace",
    "HyperballSpace",
    "NdofSpace",
    "LineSpace",
    "SO3Space",
    "SE3Space",
    "SE31stOrderSpace",
    "SE32ndOrderSpace",
    "make_se3_space",
    "SE2Space",
    "SE21stOrderSpace",
    "SE22ndOrderSpace",
    "FlatSE2Space",
    "make_se2_space",
    "DirectKinTopoMap",
    "InverseKinTopoMap",
    "TemporalSpace",
    "RateLimitedNdofSpace",
    "joint_limits_mapping",
    "DifferentiableSpace",
    "make_differentiable_ndof",
    "Ndof1stOrderSpace",
    "Ndof2ndOrderSpace",
    "NdofPoint1",
    "NdofPoint2",
    "ReachabilitySpace",
    "make_ndof_space",
]

"""Geometry: shape primitives + batched proximity (signed distance) kernels.

JAX-native re-design of the reference's geometry/proximity libraries
(ref: geometry/shapes/*.hpp — box/sphere/cylinder/capped_cylinder/plane/
rectangle/circle/capped_rectangle; geometry/proximity/prox_*_*.hpp pair
kernels, proxy_query_model.hpp:51-196 aggregate models,
kte_chain_geometry.hpp:52 chain-anchored geometry).

Shapes are dataclass records with pose parameters; proximity is a set of
closed-form pairwise distance functions vectorized over arbitrary batch axes —
planners evaluate tens of thousands of pairs per device call instead of the
reference's per-pair virtual dispatch (proximity_finder_3D.hpp:62).
The planar stack (circle / rectangle / capped-rectangle / line-seg and the
reference's six 2D pair kernels) lives in :mod:`reak_tpu.geom.shapes2d` and
:mod:`reak_tpu.geom.proximity2d`.
"""
from reak_tpu.geom.shapes import (
    Sphere,
    Capsule,
    Box,
    Cylinder,
    Plane,
    ShapeSet,
)
from reak_tpu.geom.proximity import (
    dist_sphere_sphere,
    dist_sphere_capsule,
    dist_sphere_box,
    dist_sphere_plane,
    dist_capsule_capsule,
    dist_capsule_box,
    dist_capsule_plane,
    dist_box_plane,
    dist_box_box,
    dist_point_box,
    dist_point_cylinder,
    dist_sphere_cylinder,
    dist_cylinder_plane,
    dist_cylinder_cylinder,
    dist_cylinder_box,
    dist_cylinder_capsule,
    dist_segment_segment,
    proxy_query,
    ProxyModel,
)

__all__ = [
    "convex",
    "Sphere",
    "Capsule",
    "Box",
    "Cylinder",
    "Plane",
    "ShapeSet",
    "dist_sphere_sphere",
    "dist_sphere_capsule",
    "dist_sphere_box",
    "dist_sphere_plane",
    "dist_capsule_capsule",
    "dist_capsule_box",
    "dist_capsule_plane",
    "dist_box_plane",
    "dist_box_box",
    "dist_point_box",
    "dist_point_cylinder",
    "dist_sphere_cylinder",
    "dist_cylinder_plane",
    "dist_cylinder_cylinder",
    "dist_cylinder_box",
    "dist_cylinder_capsule",
    "dist_segment_segment",
    "proxy_query",
    "ProxyModel",
    "Circle",
    "Rectangle",
    "CappedRectangle",
    "Seg2D",
    "ShapeSet2D",
    "ProxyModel2D",
    "proxy_query_2d",
]
from reak_tpu.geom import convex
from reak_tpu.geom.shapes2d import (
    Circle,
    Rectangle,
    CappedRectangle,
    Seg2D,
    ShapeSet2D,
    pose_shapes_2d,
)
from reak_tpu.geom.proximity2d import (
    dist_circle_circle,
    dist_circle_rect,
    dist_circle_crect,
    dist_rect_rect,
    dist_crect_rect,
    dist_crect_crect,
    ProxyModel2D,
    proxy_query_2d,
)

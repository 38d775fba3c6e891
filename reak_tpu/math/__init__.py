"""Dense math substrate: rotations, quaternions, kinematic frames, numerics.

JAX-native replacement for the reference's ``core/lin_alg`` + ``core/kinetostatics``
template libraries (ref: core/lin_alg/vect_alg.hpp, mat_alg_general.hpp,
core/kinetostatics/rotations_3D.hpp, frame_3D.hpp).  Structured-matrix *types*
collapse into plain arrays + convention; everything is batched by construction
(ops broadcast over leading axes).
"""
from reak_tpu.math import rotations, frames, linalg, are, tensors, sorting

__all__ = ["rotations", "frames", "linalg", "are", "tensors", "sorting"]

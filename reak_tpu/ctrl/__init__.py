"""Control & estimation framework.

JAX-native re-design of the reference's ctrl_sys layer
(ref: ctrl/ctrl_sys/* — state-space system concepts, Kalman-family filters,
belief states, LQR/LQG) plus the MPC/trajectory-optimization engine that the
JAX build adds as its north-star workload (BASELINE.md).
"""
from reak_tpu.ctrl import (systems, qp, mpc, belief, kalman, ukf, invariant,
                           lqg, ss_systems, aug_kalman, predictor, aqr_space)

__all__ = ["systems", "qp", "mpc", "belief", "kalman", "ukf", "invariant",
           "lqg", "ss_systems", "aug_kalman", "predictor", "aqr_space"]

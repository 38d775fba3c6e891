"""ODE integrators as XLA scans.

JAX-native replacement for the reference's integrator hierarchy
(ref: core/integrators/integrator.hpp:102,153, fixed_step_integrators.hpp,
variable_step_integrators.hpp, pred_corr_integrators.hpp and the per-topology
re-packagings in ctrl/sys_integrators/*).

Every stepper is a pure function ``(f, t, y, dt, *args) → y'`` lifted into a
``lax.scan`` rollout; adaptive methods use step-rejection inside a bounded
``lax.while_loop`` so the whole trajectory stays trace-static.
"""
from reak_tpu.integrators.fixed import (
    euler_step,
    midpoint_step,
    rk4_step,
    rk5_step,
    integrate,
    rollout,
)
from reak_tpu.integrators.adaptive import rkf45_step, dopri45_step, integrate_adaptive
from reak_tpu.integrators.multistep import adams_bm3, adams_bm5, hamming_mod, hamming_iter_mod

__all__ = [
    "euler_step",
    "midpoint_step",
    "rk4_step",
    "rk5_step",
    "integrate",
    "rollout",
    "rkf45_step",
    "dopri45_step",
    "integrate_adaptive",
    "adams_bm3",
    "adams_bm5",
    "hamming_mod",
    "hamming_iter_mod",
]

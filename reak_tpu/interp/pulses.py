"""Sustained velocity / acceleration pulse (SVP / SAP) min-time profiles.

(ref: ctrl/interpolation/sustained_velocity_pulse.hpp:176,
sustained_velocity_pulse_Ndof_detail.cpp — closed-form min-time trapezoidal
velocity profiles with NONZERO boundary velocities;
sustained_acceleration_pulse.hpp:220, sustained_acceleration_pulse_Ndof_detail.cpp
— jerk-limited S-curve profiles, root-solver assisted)

JAX-native design, not a translation of the reference's case cascades:

* **SVP** — closed form.  All candidate peak velocities (saturated cruise,
  triangular up, triangular down; quadratic/linear roots for the timed
  solve) are computed *simultaneously* as branch-free array expressions,
  validity-masked, and the first valid one selected with ``jnp.where``
  chains.  No Python branching → one fused XLA program, batched over
  joints / waypoint pairs / query times.
* **SAP** — the position-residual equation has no closed form (ramp shape
  switches between triangular and trapezoidal acceleration), so the peak
  velocity is found by **fixed-iteration bisection** (`lax.fori_loop`,
  branch-free, vectorized over every joint and — for the timed solve —
  over all 7 candidate root intervals in parallel), mirroring the
  reference's Brent/interest-point search as data-parallel work instead
  of sequential control flow.

Conventions (natural units):
  SVP ramps change velocity at rate ``a_ramp`` (the rate-limited space uses
  ``a_ramp = vmax``, reproducing the reference's normalized convention where
  a full-range ramp takes |Δv|/vmax seconds).
  SAP ramps are jerk-limited S-curves: jerk ``jmax``, peak accel ``amax``.

All solvers assume |v0|,|v1| ≤ vmax (clamp upstream; the reference throws).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_EPS = 1e-12


# ---------------------------------------------------------------------------
# SVP: trapezoidal velocity, ramp rate a_ramp
# ---------------------------------------------------------------------------


def _svp_ramp(v1, v2, a):
    """Time and distance of a linear velocity ramp v1→v2 at rate a.
    (ref: svp_Ndof_compute_ramp_dist_and_time)"""
    dt = jnp.abs(v2 - v1) / a
    dp = 0.5 * (v1 + v2) * dt
    return dp, dt


def svp_min_time(p0, p1, v0, v1, vmax, a_ramp=None):
    """Minimum-time SVP profile p0,v0 → p1,v1 under |v| ≤ vmax.

    Closed form (ref: svp_Ndof_compute_min_delta_time_closedform).  Returns
    ``(T, vp)`` elementwise (synchronize across joints with ``T.max(-1)`` +
    :func:`svp_peak_velocity`).
    """
    p0, p1, v0, v1, vmax = jnp.broadcast_arrays(
        *map(jnp.asarray, (p0, p1, v0, v1, vmax))
    )
    a = vmax if a_ramp is None else jnp.broadcast_to(jnp.asarray(a_ramp), p0.shape)
    # mirror so the displacement is non-negative; un-mirror vp at the end
    s = jnp.where(p1 >= p0, 1.0, -1.0)
    dp, w0, w1 = s * (p1 - p0), s * v0, s * v1

    # candidate 1: saturated cruise at +vmax
    dp1_a, dt1_a = _svp_ramp(w0, vmax, a)
    dp2_a, dt2_a = _svp_ramp(vmax, w1, a)
    cruise_a = dp - dp1_a - dp2_a  # distance left at vp=+vmax
    T_a = cruise_a / vmax + dt1_a + dt2_a
    ok_a = cruise_a > 0.0

    # candidate 2: triangular, vp above both boundary velocities
    vp_b = jnp.sqrt(jnp.maximum(a * dp + 0.5 * (w0 * w0 + w1 * w1), 0.0))
    T_b = (jnp.abs(vp_b - w0) + jnp.abs(vp_b - w1)) / a
    ok_b = (vp_b >= w0) & (vp_b >= w1)

    # candidate 3: vp below both (possibly opposing the displacement)
    vp_c2 = 0.5 * (w0 * w0 + w1 * w1) - a * dp
    vp_c_mag = jnp.sqrt(jnp.maximum(vp_c2, 0.0))
    vp_c = jnp.where(
        (vp_c_mag <= w0) & (vp_c_mag <= w1), vp_c_mag, -vp_c_mag
    )
    T_c = (jnp.abs(vp_c - w0) + jnp.abs(vp_c - w1)) / a
    ok_c = vp_c2 >= 0.0

    vp = jnp.where(ok_a, vmax, jnp.where(ok_b, vp_b, vp_c))
    T = jnp.where(ok_a, T_a, jnp.where(ok_b, T_b, T_c))
    trivial = (jnp.abs(dp) < _EPS) & (jnp.abs(w1 - w0) < _EPS)
    del ok_c  # candidate 3 is the guaranteed fallback (ref :270-281)
    return jnp.where(trivial, 0.0, T), s * jnp.where(trivial, w0, vp)


def svp_peak_velocity(p0, p1, v0, v1, vmax, T, a_ramp=None):
    """Peak velocity of the SVP profile stretched to duration T ≥ min time.

    Closed form (ref: svp_Ndof_compute_peak_velocity_closedform): the three
    regime equations (quadratic up-up, linear mid, quadratic down-down) are
    solved simultaneously and the first valid root is selected.
    """
    p0, p1, v0, v1, vmax, T = jnp.broadcast_arrays(
        *map(jnp.asarray, (p0, p1, v0, v1, vmax, T))
    )
    a = vmax if a_ramp is None else jnp.broadcast_to(jnp.asarray(a_ramp), p0.shape)
    s = jnp.where(p1 >= p0, 1.0, -1.0)
    dp, w0, w1 = s * (p1 - p0), s * v0, s * v1

    def cruise_slack(vp):
        _, dt1 = _svp_ramp(w0, vp, a)
        _, dt2 = _svp_ramp(vp, w1, a)
        return T - dt1 - dt2

    # Root selection by MINIMAL CONSTRAINT VIOLATION instead of a thresholded
    # first-valid cascade (the round-2 version accepted any root within
    # 1e-3·vmax of validity, so near regime boundaries the selected root
    # could be off at the tolerance scale).  Exact roots score ~float-eps;
    # on a regime boundary the coinciding roots tie at 0; there is no
    # accuracy-limiting tolerance left in the path.
    def violation(vp, lo, hi, ok):
        v = jnp.maximum(jnp.maximum(lo - vp, vp - hi), 0.0)
        v = jnp.maximum(v, jnp.maximum(jnp.abs(vp) - vmax, 0.0))
        v = jnp.maximum(v, jnp.maximum(-cruise_slack(vp), 0.0))
        return jnp.where(ok & jnp.isfinite(vp), v, jnp.inf)

    big = jnp.inf

    # regime 1: vp above both boundary velocities (ramp-up then ramp-down)
    b1 = w0 + w1 + a * T
    disc1 = b1 * b1 - 4.0 * (a * dp + 0.5 * (w0 * w0 + w1 * w1))
    sq1 = jnp.sqrt(jnp.maximum(disc1, 0.0))
    r1_hi = 0.5 * (b1 + sq1)
    r1_lo = 0.5 * (b1 - sq1)
    lo1 = jnp.maximum(w0, w1)

    # regime 2: vp between the boundary velocities (linear equation)
    denom2 = a * T - jnp.abs(w1 - w0)
    r2 = jnp.where(
        jnp.abs(denom2) > _EPS,
        (a * dp - 0.5 * (w1 * w1 - w0 * w0) * jnp.where(w1 >= w0, 1.0, -1.0))
        / denom2,
        jnp.inf,
    )
    # NOTE the signed form: for w1>w0 (ramp-up/ramp-up) the traversed ramp
    # distance is (w1²−w0²)/2a; mirrored for w1<w0.

    # regime 3: vp below both (ramp-down then ramp-up, possibly vp < 0)
    b3 = w0 + w1 - a * T
    disc3 = b3 * b3 - 4.0 * (0.5 * (w0 * w0 + w1 * w1) - a * dp)
    sq3 = jnp.sqrt(jnp.maximum(disc3, 0.0))
    r3_hi = 0.5 * (b3 + sq3)
    r3_lo = 0.5 * (b3 - sq3)
    hi3 = jnp.minimum(w0, w1)

    cands = jnp.stack([r1_hi, r1_lo, r2, r3_hi, r3_lo])
    viols = jnp.stack([
        violation(r1_hi, lo1, big, disc1 >= 0),
        violation(r1_lo, lo1, big, disc1 >= 0),
        violation(r2, jnp.minimum(w0, w1), jnp.maximum(w0, w1),
                  jnp.isfinite(r2)),
        violation(r3_hi, -big, hi3, disc3 >= 0),
        # r3_lo is the always-finite fallback root (matches the round-2
        # cascade's final branch): cap its score so argmin lands here when
        # every candidate is out-of-regime
        jnp.minimum(violation(r3_lo, -big, hi3, disc3 >= 0), 1e30),
    ])
    pick = jnp.argmin(viols, axis=0)
    vp = jnp.take_along_axis(cands, pick[None], axis=0)[0]
    trivial = (jnp.abs(dp) < _EPS) & (jnp.abs(w1 - w0) < _EPS)
    return s * jnp.where(trivial, w0, vp)


def svp_eval(p0, p1, v0, v1, vp, vmax, T, t, a_ramp=None):
    """Evaluate the SVP profile with peak velocity vp at time(s) t ∈ [0, T].

    Branch-free piecewise evaluation
    (ref: svp_Ndof_compute_interpolated_values_balanced).
    Returns ``(pos, vel, acc)``; query times broadcast against joints when
    ``t`` carries extra leading axes.
    """
    p0, p1, v0, v1, vp, vmax, T = jnp.broadcast_arrays(
        *map(jnp.asarray, (p0, p1, v0, v1, vp, vmax, T))
    )
    a = vmax if a_ramp is None else jnp.broadcast_to(jnp.asarray(a_ramp), p0.shape)
    t = jnp.asarray(t)

    s1 = jnp.where(vp >= v0, 1.0, -1.0)
    s2 = jnp.where(v1 >= vp, 1.0, -1.0)
    dt1 = jnp.abs(vp - v0) / a
    dt2 = jnp.abs(v1 - vp) / a
    tc = jnp.maximum(T - dt1 - dt2, 0.0)

    pis = p0 + 0.5 * (v0 + vp) * dt1  # cruise start position
    pie = p1 - 0.5 * (vp + v1) * dt2  # cruise end position

    tcl = jnp.clip(t, 0.0, T)
    # segment 1: ramp v0 → vp
    tau1 = jnp.minimum(tcl, dt1)
    pos1 = p0 + (v0 + 0.5 * s1 * a * tau1) * tau1
    vel1 = v0 + s1 * a * tau1
    # segment 2: cruise (robust lerp between analytic endpoints, ref :90)
    frac = jnp.clip((tcl - dt1) / jnp.maximum(tc, _EPS), 0.0, 1.0)
    pos2 = pis + (pie - pis) * frac
    # segment 3: ramp vp → v1, measured back from the end
    mdt = jnp.clip(T - tcl, 0.0, dt2)
    pos3 = p1 - (v1 - 0.5 * s2 * a * mdt) * mdt
    vel3 = v1 - s2 * a * mdt

    in1 = tcl < dt1
    in3 = tcl > dt1 + tc
    pos = jnp.where(in1, pos1, jnp.where(in3, pos3, pos2))
    vel = jnp.where(in1, vel1, jnp.where(in3, vel3, vp))
    acc = jnp.where(in1, s1 * a, jnp.where(in3, s2 * a, 0.0))
    outside = (t < 0.0) | (t > T)
    pos = jnp.where(t < 0.0, p0, jnp.where(t > T, p1, pos))
    vel = jnp.where(t < 0.0, v0, jnp.where(t > T, v1, vel))
    acc = jnp.where(outside, 0.0, acc)
    return pos, vel, acc


def svp_interpolate(p0, v0, p1, v1, vmax, t, a_ramp=None, min_T=None):
    """Synchronized N-DoF SVP interpolation: per-joint min times, shared
    duration T = max, per-joint peak velocities re-solved for that T
    (ref: svp_compute_Ndof_interpolation_data_impl).  Returns (pos, vel, T).
    """
    T_j, _ = svp_min_time(p0, p1, v0, v1, vmax, a_ramp)
    T = jnp.max(T_j, axis=-1)
    if min_T is not None:
        T = jnp.maximum(T, min_T)
    Tb = T[..., None]
    vp = svp_peak_velocity(p0, p1, v0, v1, vmax, Tb, a_ramp)
    pos, vel, _ = svp_eval(p0, p1, v0, v1, vp, vmax, Tb, t, a_ramp)
    return pos, vel, T


# ---------------------------------------------------------------------------
# SAP: jerk-limited S-curve ramps (trapezoidal/triangular acceleration)
# ---------------------------------------------------------------------------


def _sap_ramp(v1, v2, amax, jmax):
    """Time and distance of a jerk-limited ramp v1→v2.
    (ref: sap_Ndof_compute_ramp_dist_and_time — accel trapezoid when
    |Δv| ≥ amax²/jmax, else accel triangle with peak √(|Δv|·jmax))"""
    dv = jnp.abs(v2 - v1)
    dt_trap = dv / amax + amax / jmax
    dt_tri = 2.0 * jnp.sqrt(dv / jmax)
    dt = jnp.where(dv >= amax * amax / jmax, dt_trap, dt_tri)
    dp = 0.5 * (v1 + v2) * dt  # odd-symmetric accel ⇒ mean velocity = midpoint
    return dp, dt


def _bisect(f, lo, hi, iters=72):
    """Branch-free fixed-iteration bisection; lo/hi are arrays (batched)."""
    flo = f(lo)

    def body(_, carry):
        lo, hi, flo = carry
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        left = flo * fm <= 0.0
        return (
            jnp.where(left, lo, mid),
            jnp.where(left, mid, hi),
            jnp.where(left, flo, fm),
        )

    lo, hi, _ = lax.fori_loop(0, iters, body, (lo, hi, flo))
    return 0.5 * (lo + hi)


def sap_min_time(p0, p1, v0, v1, vmax, amax, jmax=None):
    """Minimum-time SAP (S-curve) profile p0,v0 → p1,v1 under |v| ≤ vmax,
    |a| ≤ amax, |jerk| ≤ jmax (default jmax = amax, the reference's
    rate-limited normalization).  Returns ``(T, vp)`` elementwise.

    (ref: sap_Ndof_compute_min_delta_time_numsolve — reference uses Brent;
    here a fixed-72-iteration branch-free bisection, batched over joints.)
    """
    p0, p1, v0, v1, vmax, amax = jnp.broadcast_arrays(
        *map(jnp.asarray, (p0, p1, v0, v1, vmax, amax))
    )
    j = amax if jmax is None else jnp.broadcast_to(jnp.asarray(jmax), p0.shape)
    s = jnp.where(p1 >= p0, 1.0, -1.0)
    dp, w0, w1 = s * (p1 - p0), s * v0, s * v1

    def resid(vp):
        dp1, _ = _sap_ramp(w0, vp, amax, j)
        dp2, _ = _sap_ramp(vp, w1, amax, j)
        return dp - dp1 - dp2

    def ramps_T(vp):
        _, dt1 = _sap_ramp(w0, vp, amax, j)
        _, dt2 = _sap_ramp(vp, w1, amax, j)
        return dt1 + dt2

    # The min-time profile either cruises at ±vmax or has zero cruise
    # (a root of the position residual).  The residual is only piecewise
    # monotone — its derivative kinks at the boundary velocities, the ramp
    # shape knees, and vp = 0 — so bisect every sub-interval between
    # interest points IN PARALLEL and take the fastest feasible candidate.
    knee = amax * amax / j
    pts = jnp.stack(
        [
            -vmax,
            w0 - knee,
            w0,
            w0 + knee,
            w1 - knee,
            w1,
            w1 + knee,
            jnp.zeros_like(dp),
            vmax,
        ]
    )
    pts = jnp.sort(jnp.clip(pts, -vmax, vmax), axis=0)
    lo, hi = pts[:-1], pts[1:]  # (8, ...)
    roots = _bisect(resid, lo, hi)
    root_ok = (resid(lo) * resid(hi) <= 0.0) & (
        jnp.abs(resid(roots)) < 1e-6 * (1.0 + jnp.abs(dp))
    )
    T_roots = jnp.where(root_ok, ramps_T(roots), jnp.inf)
    # saturated-cruise candidates at ±vmax
    sat = jnp.stack([vmax, -vmax])
    tc_sat = resid(sat) / sat
    T_sat = jnp.where(tc_sat >= 0.0, ramps_T(sat) + tc_sat, jnp.inf)
    cand_vp = jnp.concatenate([roots, sat], axis=0)
    cand_T = jnp.concatenate([T_roots, T_sat], axis=0)
    best = jnp.argmin(cand_T, axis=0)
    T = jnp.take_along_axis(cand_T, best[None], axis=0)[0]
    vp = jnp.take_along_axis(cand_vp, best[None], axis=0)[0]
    trivial = (jnp.abs(dp) < _EPS) & (jnp.abs(w1 - w0) < _EPS)
    return jnp.where(trivial, 0.0, T), s * jnp.where(trivial, w0, vp)


def sap_peak_velocity(p0, p1, v0, v1, vmax, amax, T, jmax=None):
    """Peak velocity of the SAP profile stretched to duration T ≥ min time.

    (ref: sap_Ndof_compute_peak_velocity_numsolve — the reference walks 7
    intervals between "interest points" sequentially with Brent; here all 7
    intervals are bisected IN PARALLEL (a stacked leading axis) and the first
    valid root is selected, so joints × intervals is one fused batch.)
    """
    p0, p1, v0, v1, vmax, amax, T = jnp.broadcast_arrays(
        *map(jnp.asarray, (p0, p1, v0, v1, vmax, amax, T))
    )
    j = amax if jmax is None else jnp.broadcast_to(jnp.asarray(jmax), p0.shape)
    s = jnp.where(p1 >= p0, 1.0, -1.0)
    dp, w0, w1 = s * (p1 - p0), s * v0, s * v1

    def pd(vp):
        dp1, dt1 = _sap_ramp(w0, vp, amax, j)
        dp2, dt2 = _sap_ramp(vp, w1, amax, j)
        return dp - dp1 - dp2 - vp * (T - dt1 - dt2)

    def slack(vp):
        _, dt1 = _sap_ramp(w0, vp, amax, j)
        _, dt2 = _sap_ramp(vp, w1, amax, j)
        return T - dt1 - dt2

    dv_knee = amax * amax / j  # Δv where ramp shape switches
    pts = jnp.stack(
        [
            vmax,
            w0 + dv_knee,
            w0,
            w0 - dv_knee,
            w1 + dv_knee,
            w1,
            w1 - dv_knee,
            -vmax,
        ]
    )  # (8, ...)
    pts = jnp.clip(pts, -vmax, vmax)
    pts = -jnp.sort(-pts, axis=0)  # descending: search from +vmax downward
    lo, hi = pts[1:], pts[:-1]  # (7, ...) intervals
    roots = _bisect(pd, lo, hi)
    tol = 1e-3 * vmax
    ok = (
        (jnp.abs(pd(roots)) < tol)
        & (slack(roots) >= -tol)
        & (pd(lo) * pd(hi) <= 0.0)
    )
    # also accept interval endpoints that are exact solutions (ref :450-457)
    ok_hi_pt = (jnp.abs(pd(hi)) < tol) & (slack(hi) >= -tol)
    roots = jnp.where(ok, roots, jnp.where(ok_hi_pt, hi, jnp.nan))
    ok = ok | ok_hi_pt
    # first valid candidate in descending-vp order
    first = jnp.argmax(ok, axis=0)
    vp = jnp.take_along_axis(roots, first[None], axis=0)[0]
    any_ok = jnp.any(ok, axis=0)
    vp = jnp.where(any_ok, vp, jnp.sign(dp) * vmax)
    trivial = (jnp.abs(dp) < _EPS) & (jnp.abs(w1 - w0) < _EPS)
    return s * jnp.where(trivial, w0, vp)


def sap_eval(p0, p1, v0, v1, vp, vmax, amax, T, t, jmax=None):
    """Evaluate the SAP (S-curve) profile at time(s) t ∈ [0, T].

    Branch-free 7-segment evaluation (jerk-up / const-accel / jerk-down per
    ramp + cruise; ref: sap_Ndof_compute_interpolated_values_balanced).
    Returns ``(pos, vel, acc, jerk)``.
    """
    p0, p1, v0, v1, vp, vmax, amax, T = jnp.broadcast_arrays(
        *map(jnp.asarray, (p0, p1, v0, v1, vp, vmax, amax, T))
    )
    j = amax if jmax is None else jnp.broadcast_to(jnp.asarray(jmax), p0.shape)
    t = jnp.asarray(t)

    def ramp_phases(va, vb):
        """Phase durations of the jerk-limited ramp va→vb: (dt_a, dt_v, a_pk)."""
        dv = jnp.abs(vb - va)
        tri = dv < amax * amax / j
        a_pk = jnp.where(tri, jnp.sqrt(jnp.maximum(dv * j, 0.0)), amax)
        dt_a = a_pk / j
        dt_v = jnp.where(tri, 0.0, dv / jnp.maximum(amax, _EPS) - amax / j)
        return dt_a, dt_v, a_pk

    def ramp_eval(va, vb, p_start, p_end, tau, dt_a, dt_v, a_pk):
        """(pos, vel, acc, jerk) inside a ramp, tau ∈ [0, 2·dt_a+dt_v]."""
        sg = jnp.where(vb >= va, 1.0, -1.0)
        dtr = 2.0 * dt_a + dt_v
        # phase A: jerk up, tau ∈ [0, dt_a]
        tA = jnp.clip(tau, 0.0, dt_a)
        velA = va + 0.5 * sg * j * tA * tA
        posA = p_start + va * tA + sg * j * tA ** 3 / 6.0
        # phase B: const accel, tau-dt_a ∈ [0, dt_v]
        tB = jnp.clip(tau - dt_a, 0.0, dt_v)
        vA_end = va + 0.5 * sg * j * dt_a * dt_a
        pA_end = p_start + va * dt_a + sg * j * dt_a ** 3 / 6.0
        velB = vA_end + sg * a_pk * tB
        posB = pA_end + vA_end * tB + 0.5 * sg * a_pk * tB * tB
        # phase C: jerk down, measured back from ramp end
        mdt = jnp.clip(dtr - tau, 0.0, dt_a)
        velC = vb - 0.5 * sg * j * mdt * mdt
        posC = p_end - vb * mdt + sg * j * mdt ** 3 / 6.0
        inA = tau < dt_a
        inC = tau > dt_a + dt_v
        pos = jnp.where(inA, posA, jnp.where(inC, posC, posB))
        vel = jnp.where(inA, velA, jnp.where(inC, velC, velB))
        acc = jnp.where(
            inA, sg * j * tA, jnp.where(inC, sg * j * mdt, sg * a_pk)
        )
        jerk = jnp.where(inA, sg * j, jnp.where(inC, -sg * j, 0.0))
        return pos, vel, acc, jerk

    dt_a1, dt_v1, apk1 = ramp_phases(v0, vp)
    dt_a2, dt_v2, apk2 = ramp_phases(vp, v1)
    dtr1 = 2.0 * dt_a1 + dt_v1
    dtr2 = 2.0 * dt_a2 + dt_v2
    dp1 = 0.5 * (v0 + vp) * dtr1
    dp2 = 0.5 * (vp + v1) * dtr2
    tc = jnp.maximum(T - dtr1 - dtr2, 0.0)
    pis = p0 + dp1
    pie = p1 - dp2

    tcl = jnp.clip(t, 0.0, T)
    pos1, vel1, acc1, jrk1 = ramp_eval(v0, vp, p0, pis, tcl, dt_a1, dt_v1, apk1)
    frac = jnp.clip((tcl - dtr1) / jnp.maximum(tc, _EPS), 0.0, 1.0)
    pos2 = pis + (pie - pis) * frac
    pos3, vel3, acc3, jrk3 = ramp_eval(
        vp, v1, pie, p1, tcl - dtr1 - tc, dt_a2, dt_v2, apk2
    )
    in1 = tcl < dtr1
    in3 = tcl > dtr1 + tc
    pos = jnp.where(in1, pos1, jnp.where(in3, pos3, pos2))
    vel = jnp.where(in1, vel1, jnp.where(in3, vel3, vp))
    acc = jnp.where(in1, acc1, jnp.where(in3, acc3, 0.0))
    jerk = jnp.where(in1, jrk1, jnp.where(in3, jrk3, 0.0))
    outside = (t < 0.0) | (t > T)
    pos = jnp.where(t < 0.0, p0, jnp.where(t > T, p1, pos))
    vel = jnp.where(t < 0.0, v0, jnp.where(t > T, v1, vel))
    acc = jnp.where(outside, 0.0, acc)
    jerk = jnp.where(outside, 0.0, jerk)
    return pos, vel, acc, jerk


def sap_interpolate(p0, v0, p1, v1, vmax, amax, t, jmax=None, min_T=None):
    """Synchronized N-DoF SAP interpolation (shared duration = max over
    joints of per-joint min times).  Returns (pos, vel, acc, T)."""
    T_j, _ = sap_min_time(p0, p1, v0, v1, vmax, amax, jmax)
    T = jnp.max(T_j, axis=-1)
    if min_T is not None:
        T = jnp.maximum(T, min_T)
    Tb = T[..., None]
    vp = sap_peak_velocity(p0, p1, v0, v1, vmax, amax, Tb, jmax)
    pos, vel, acc, _ = sap_eval(p0, p1, v0, v1, vp, vmax, amax, Tb, t, jmax)
    return pos, vel, acc, T


# ---------------------------------------------------------------------------
# Reach-time metrics (ref: svp_Ndof_metrics.hpp, sap_Ndof_metrics.hpp)
# ---------------------------------------------------------------------------


def svp_reach_time(p0, v0, p1, v1, vmax, a_ramp=None):
    """Synchronized min travel time between two 1st-order Ndof points — the
    SVP distance metric (ref: svp_Ndof_metrics.hpp svp_Ndof_reach_time_metric)."""
    T_j, _ = svp_min_time(p0, p1, v0, v1, vmax, a_ramp)
    return jnp.max(T_j, axis=-1)


def sap_reach_time(p0, v0, p1, v1, vmax, amax, jmax=None):
    """Synchronized min travel time between two 2nd-order Ndof points — the
    SAP distance metric (ref: sap_Ndof_metrics.hpp)."""
    T_j, _ = sap_min_time(p0, p1, v0, v1, vmax, amax, jmax)
    return jnp.max(T_j, axis=-1)

"""Named robot chain builders.

JAX-native equivalents of the reference's concrete manipulator models
(ref: ctrl/kte_models/manip_3R_arm.hpp:48,152, manip_3R3R_arm.hpp:54,
manip_P3R3R_arm.hpp:60, manip_SCARA_arm.hpp:50, manip_ERA_arm.hpp:50,
manip_SSRMS_arm.hpp:51, free_floating_platform.hpp:48,175) and the classic
test mechanisms (pendulum of mbd_kte/test_am.cpp:100-126, double pendulum of
test_bm.cpp).  Each returns a :class:`ChainSpec`.
"""
from __future__ import annotations

import numpy as np

from reak_tpu.kte.spec import ChainSpec, REVOLUTE, PRISMATIC, FIXED, FREE


def _z(n):
    return np.tile(np.array([0.0, 0.0, 1.0]), (n, 1))


def _quat_id(n):
    q = np.zeros((n, 4))
    q[:, 0] = 1.0
    return q


def pendulum(
    length=0.5,
    mass=1.0,
    motor_inertia=5.0,
    damping=0.0,
    gravity=9.81,
    stiction=None,
) -> ChainSpec:
    """Single revolute pendulum in the x-y plane, matching the advanced
    pendulum of the reference's test_am.cpp:100-126: z-axis revolute joint,
    link of ``length`` along +x, point mass at the tip, rotor inertia on the
    joint coordinate, gravity −y.

    The motor (rotor) inertia about the joint axis is modeled as body-frame
    Izz on the first body (equivalent to inertia_gen on the coordinate,
    ref: inertia.hpp:53).
    """
    n = 1
    inert = np.zeros((n, 3, 3))
    inert[0, 2, 2] = motor_inertia
    kw = {}
    if stiction is not None:
        v_st, v_sl, c_st, c_sl = stiction
        kw = dict(
            stiction_vel=[v_st], slip_vel=[v_sl],
            stiction_coef=[c_st], slip_coef=[c_sl],
        )
    return ChainSpec.build(
        joint_types=[REVOLUTE],
        axes=_z(n),
        com_pos=[[length, 0.0, 0.0]],
        masses=[mass],
        inertias=inert,
        damping=[damping],
        gravity=(0.0, -gravity, 0.0),
        name="pendulum",
        **kw,
    )


def double_pendulum(l1=0.5, l2=0.5, m1=1.0, m2=1.0, gravity=9.81) -> ChainSpec:
    """Planar double pendulum (point masses at link tips), the mechanism of the
    reference's test_bm.cpp mass-matrix demo."""
    return ChainSpec.build(
        joint_types=[REVOLUTE, REVOLUTE],
        axes=_z(2),
        offsets_pos=[[0.0, 0.0, 0.0], [l1, 0.0, 0.0]],
        com_pos=[[l1, 0.0, 0.0], [l2, 0.0, 0.0]],
        masses=[m1, m2],
        gravity=(0.0, -gravity, 0.0),
        name="double_pendulum",
    )


def planar_2link(
    l1=0.4, l2=0.3, m1=2.0, m2=1.0, com_ratio=0.5, rod_inertia=True, gravity=9.81
) -> ChainSpec:
    """Planar 2-link arm with distributed-mass links (BASELINE config 2)."""
    inert = np.zeros((2, 3, 3))
    if rod_inertia:
        inert[0, 2, 2] = m1 * l1 * l1 / 12.0
        inert[1, 2, 2] = m2 * l2 * l2 / 12.0
    return ChainSpec.build(
        joint_types=[REVOLUTE, REVOLUTE],
        axes=_z(2),
        offsets_pos=[[0.0, 0.0, 0.0], [l1, 0.0, 0.0]],
        com_pos=[[com_ratio * l1, 0.0, 0.0], [com_ratio * l2, 0.0, 0.0]],
        masses=[m1, m2],
        inertias=inert,
        gravity=(0.0, -gravity, 0.0),
        name="planar_2link",
    )


def manip_3r_planar(l1=0.4, l2=0.3, l3=0.2, masses=(1.5, 1.0, 0.5)) -> ChainSpec:
    """Planar 3R arm (ref: manip_3R_arm.hpp:48 manip_3R_2D_kinematics)."""
    return ChainSpec.build(
        joint_types=[REVOLUTE] * 3,
        axes=_z(3),
        offsets_pos=[[0, 0, 0], [l1, 0, 0], [l2, 0, 0]],
        com_pos=[[l1 / 2, 0, 0], [l2 / 2, 0, 0], [l3 / 2, 0, 0]],
        masses=list(masses),
        gravity=(0.0, -9.81, 0.0),
        name="manip_3R_planar",
    )


def manip_3r3r(
    base_to_shoulder=0.3302,
    shoulder_to_elbow=0.3048,
    elbow_to_joint4=0.1500,
    joint4_to_wrist=0.1802,
    wrist_to_flange=0.0762,
    link_masses=(9.0, 6.0, 4.0, 1.0, 0.7, 0.3),
    rotor_inertia=0.05,
    gravity=9.81,
) -> ChainSpec:
    """6-DoF decoupled 3R-3R manipulator, CRS-A465 geometry — the flagship
    benchmark arm (BASELINE config 3).

    Joint layout matches the reference (manip_3R3R_arm.cpp:107-212):
    axes z, −y, −y, z, −y, z with inter-joint offsets along local +z.
    Link inertias are simple solid-rod estimates about each COM.
    """
    offs = [
        [0.0, 0.0, 0.0],
        [0.0, 0.0, base_to_shoulder],
        [0.0, 0.0, shoulder_to_elbow],
        [0.0, 0.0, elbow_to_joint4],
        [0.0, 0.0, joint4_to_wrist],
        [0.0, 0.0, wrist_to_flange],
    ]
    lengths = [
        base_to_shoulder,
        shoulder_to_elbow,
        elbow_to_joint4,
        joint4_to_wrist,
        wrist_to_flange,
        0.05,
    ]
    axes = np.array(
        [
            [0.0, 0.0, 1.0],
            [0.0, -1.0, 0.0],
            [0.0, -1.0, 0.0],
            [0.0, 0.0, 1.0],
            [0.0, -1.0, 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    com = np.zeros((6, 3))
    inert = np.zeros((6, 3, 3))
    for i, (m, L) in enumerate(zip(link_masses, lengths)):
        com[i] = [0.0, 0.0, L / 2.0]
        # solid rod along z plus reflected rotor/gearbox inertia on every axis
        # (keeps M well-conditioned, as on the physical CRS-A465 where geared
        # drives dominate the wrist inertia)
        I_perp = m * L * L / 12.0
        inert[i] = np.diag(
            [I_perp + rotor_inertia, I_perp + rotor_inertia, rotor_inertia]
        )
    return ChainSpec.build(
        joint_types=[REVOLUTE] * 6,
        axes=axes,
        offsets_pos=offs,
        com_pos=com,
        masses=list(link_masses),
        inertias=inert,
        gravity=(0.0, 0.0, -gravity),
        name="manip_3R3R",
    )


def manip_p3r3r(track_length=3.0, carriage_mass=20.0, **kw) -> ChainSpec:
    """Track + 6-DoF arm (CRS-A465 on rail), ref: manip_P3R3R_arm.hpp:60.

    A prismatic x-axis track joint carrying the 3R3R arm.
    """
    arm = manip_3r3r(**kw)
    n = 7
    axes = np.vstack([[1.0, 0.0, 0.0], np.asarray(arm.axes)])
    offs = np.vstack([[0.0, 0.0, 0.0], np.asarray(arm.offsets_pos)])
    com = np.vstack([[0.0, 0.0, 0.0], np.asarray(arm.com_pos)])
    masses = np.concatenate([[carriage_mass], np.asarray(arm.masses)])
    inert = np.concatenate(
        [np.diag([0.1, 0.1, 0.1])[None], np.asarray(arm.inertias).reshape(-1, 3, 3)], axis=0
    )
    return ChainSpec.build(
        joint_types=[PRISMATIC] + [REVOLUTE] * 6,
        axes=axes,
        offsets_pos=offs,
        com_pos=com,
        masses=masses,
        inertias=inert,
        gravity=arm.gravity,
        name="manip_P3R3R",
    )


def manip_scara(l1=0.35, l2=0.25, m=(4.0, 3.0, 0.8), gravity=9.81) -> ChainSpec:
    """SCARA arm: two z revolute joints + vertical prismatic
    (ref: manip_SCARA_arm.hpp:50)."""
    inert = np.zeros((3, 3, 3))
    inert[0, 2, 2] = m[0] * l1 * l1 / 12.0
    inert[1, 2, 2] = m[1] * l2 * l2 / 12.0
    inert[2] = np.eye(3) * 1e-3
    return ChainSpec.build(
        joint_types=[REVOLUTE, REVOLUTE, PRISMATIC],
        axes=np.array([[0, 0, 1.0], [0, 0, 1.0], [0, 0, 1.0]]),
        offsets_pos=[[0, 0, 0], [l1, 0, 0], [l2, 0, 0]],
        com_pos=[[l1 / 2, 0, 0], [l2 / 2, 0, 0], [0, 0, 0]],
        masses=list(m),
        inertias=inert,
        gravity=(0.0, 0.0, -gravity),
        name="manip_SCARA",
    )


def manip_era(link_lengths=None, masses=None) -> ChainSpec:
    """7-DoF European Robotic Arm-style symmetric arm
    (ref: manip_ERA_arm.hpp:50): roll-yaw-pitch — elbow pitch — pitch-yaw-roll."""
    L = link_lengths or [0.34, 0.34, 3.1, 3.1, 0.34, 0.34, 0.2]
    m = masses or [30.0, 25.0, 120.0, 120.0, 25.0, 30.0, 10.0]
    axes = np.array(
        [
            [0.0, 0.0, 1.0],  # roll
            [0.0, 1.0, 0.0],  # yaw
            [1.0, 0.0, 0.0],  # pitch
            [1.0, 0.0, 0.0],  # elbow pitch
            [1.0, 0.0, 0.0],  # pitch
            [0.0, 1.0, 0.0],  # yaw
            [0.0, 0.0, 1.0],  # roll
        ]
    )
    offs = np.zeros((7, 3))
    com = np.zeros((7, 3))
    inert = np.zeros((7, 3, 3))
    for i in range(7):
        offs[i] = [0.0, 0.0, L[i - 1] if i > 0 else 0.0]
        com[i] = [0.0, 0.0, L[i] / 2]
        I_perp = m[i] * L[i] ** 2 / 12.0
        inert[i] = np.diag([I_perp, I_perp, 0.02 * m[i] + 1e-3])
    return ChainSpec.build(
        joint_types=[REVOLUTE] * 7,
        axes=axes,
        offsets_pos=offs,
        com_pos=com,
        masses=m,
        inertias=inert,
        gravity=(0.0, 0.0, 0.0),  # on-orbit arm
        name="manip_ERA",
    )


def manip_ssrms(link_lengths=None, masses=None) -> ChainSpec:
    """7-DoF SSRMS/Canadarm2-style arm (ref: manip_SSRMS_arm.hpp:51)."""
    L = link_lengths or [0.38, 0.635, 6.85, 6.85, 0.635, 0.38, 0.3]
    m = masses or [80.0, 60.0, 300.0, 300.0, 60.0, 80.0, 30.0]
    axes = np.array(
        [
            [0.0, 0.0, 1.0],
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 1.0, 0.0],
            [1.0, 0.0, 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    offs = np.zeros((7, 3))
    com = np.zeros((7, 3))
    inert = np.zeros((7, 3, 3))
    for i in range(7):
        offs[i] = [0.0, 0.0, L[i - 1] if i > 0 else 0.0]
        com[i] = [0.0, 0.0, L[i] / 2]
        I_perp = m[i] * L[i] ** 2 / 12.0
        inert[i] = np.diag([I_perp, I_perp, 0.05 * m[i] + 1e-3])
    return ChainSpec.build(
        joint_types=[REVOLUTE] * 7,
        axes=axes,
        offsets_pos=offs,
        com_pos=com,
        masses=m,
        inertias=inert,
        gravity=(0.0, 0.0, 0.0),
        name="manip_SSRMS",
    )


def free_floating_3d(
    mass=100.0, inertia_diag=(50.0, 60.0, 70.0), gravity=0.0
) -> ChainSpec:
    """Free-floating rigid platform (satellite) — single FREE joint
    (ref: free_floating_platform.hpp:175 manip_free_floater_3D_kinematics)."""
    inert = np.zeros((1, 3, 3))
    inert[0] = np.diag(inertia_diag)
    return ChainSpec.build(
        joint_types=[FREE],
        masses=[mass],
        inertias=inert,
        gravity=(0.0, 0.0, -gravity),
        name="free_floating_3D",
    )


def floating_arm(
    base_mass=200.0,
    base_inertia=(80.0, 90.0, 100.0),
    arm_builder=manip_3r3r,
    **kw,
) -> ChainSpec:
    """Free-floating base carrying a serial arm (chaser-satellite style,
    BASELINE config 4; ref: free_floating_platform.hpp + kte chain mounting)."""
    arm = arm_builder(gravity=0.0, **kw) if "gravity" in arm_builder.__code__.co_varnames else arm_builder(**kw)
    n = 1 + arm.n_joints
    axes = np.vstack([[0.0, 0.0, 1.0], np.asarray(arm.axes)])
    offs = np.vstack([[0.0, 0.0, 0.0], np.asarray(arm.offsets_pos)])
    com = np.vstack([[0.0, 0.0, 0.0], np.asarray(arm.com_pos)])
    masses = np.concatenate([[base_mass], np.asarray(arm.masses)])
    inert = np.concatenate(
        [np.diag(base_inertia)[None], np.asarray(arm.inertias).reshape(-1, 3, 3)], axis=0
    )
    return ChainSpec.build(
        joint_types=[FREE] + list(arm.joint_types),
        axes=axes,
        offsets_pos=offs,
        com_pos=com,
        masses=masses,
        inertias=inert,
        gravity=(0.0, 0.0, 0.0),
        name="floating_arm",
    )


def flexible_beam(
    n_segments=8,
    length=1.0,
    mass=1.0,
    EI=50.0,
    axis=(0.0, 1.0, 0.0),
    gravity=9.81,
    tip_mass=0.0,
    rayleigh_beta=0.002,
) -> ChainSpec:
    """Cantilever Euler-Bernoulli beam as a pseudo-rigid-body chain
    (ref: ctrl/mbd_kte/flexible_beam.hpp:52,209 flexible_beam_3D,
    inertial_beam.hpp:50 — the reference's two-node bending elements become
    N elastic revolute pseudo-joints with stiffness k = EI/h).

    Pseudo-joints sit at the MIDPOINTS of the n equal elements (first joint at
    h/2 from the clamp), so the static deflection is the midpoint-rule quadrature
    of ∫M(x)(L−x)/EI dx — O(h²)-convergent to the analytic qL⁴/(8EI) (≈0.2%
    at n=16) instead of the O(h) of joint-at-node placement.

    Damping is stiffness-proportional (Rayleigh): d = β·k per joint, damping
    mode ω at ratio ζ = βω/2 — high stiff modes are strongly damped, the first
    bending mode stays visibly oscillatory.  NOTE the resulting ODE is stiff:
    integrate with ``ctrl.systems.semi_implicit_kte`` (unconditionally stable
    in the spring/damper terms); explicit RK4 needs dt ≲ 2/(βω_max²).

    The beam extends along +x from a clamped base; bending about ``axis``.
    """
    n = n_segments
    h = length / n
    seg_mass = mass / n
    k = EI / h
    axes = np.tile(np.asarray(axis, np.float64), (n, 1))
    offs = np.zeros((n, 3))
    offs[0, 0] = h / 2  # first pivot at the midpoint of element 0
    offs[1:, 0] = h
    # body i spans joint i → joint i+1 (length h); the last body is the tip
    # half-element (length h/2).  The clamped proximal half-element is static.
    com = np.zeros((n, 3))
    com[:-1, 0] = h / 2
    masses = np.full(n, seg_mass)
    inert = np.zeros((n, 3, 3))
    for i in range(n - 1):
        inert[i][1, 1] = inert[i][2, 2] = seg_mass * h * h / 12.0
        inert[i][0, 0] = 1e-8
    m_tip_seg = seg_mass / 2
    m_last = m_tip_seg + tip_mass
    com[-1, 0] = (m_tip_seg * h / 4 + tip_mass * h / 2) / m_last
    masses[-1] = m_last
    inert[-1][1, 1] = inert[-1][2, 2] = m_tip_seg * (h / 2) ** 2 / 12.0
    inert[-1][0, 0] = 1e-8
    return ChainSpec.build(
        joint_types=[REVOLUTE] * n,
        axes=axes,
        offsets_pos=offs,
        com_pos=com,
        masses=masses,
        inertias=inert,
        stiffness=np.full(n, k),
        damping=np.full(n, rayleigh_beta * k),
        gravity=(0.0, 0.0, -gravity),
        name=f"flexible_beam_{n}",
    )


def floating_flexible_beam(
    n_segments=4,
    length=1.0,
    mass=1.0,
    EI=50.0,
    base_mass=10.0,
    rayleigh_beta=0.002,
) -> ChainSpec:
    """Free-flying rigid hub with a flexible (pseudo-rigid-body) beam
    appendage — the flexible-spacecraft regime (ref: flexible_beam.hpp:52
    elements mounted on free_joints.hpp:165; the Canadarm/SSRMS-on-station
    configuration class).  Zero gravity; integrate with
    ctrl/systems.semi_implicit_kte (the beam modes are stiff).
    """
    beam = flexible_beam(n_segments=n_segments, length=length, mass=mass,
                         EI=EI, gravity=0.0, rayleigh_beta=rayleigh_beta)
    n = n_segments
    joint_types = [FREE] + list(beam.joint_types)
    axes = np.vstack([[0.0, 0.0, 1.0], np.asarray(beam.axes)])
    offs = np.vstack([np.zeros(3), np.asarray(beam.offsets_pos)])
    com = np.vstack([np.zeros(3), np.asarray(beam.com_pos)])
    masses = np.concatenate([[base_mass], np.asarray(beam.masses)])
    hub_I = np.eye(3) * (0.4 * base_mass * 0.25**2)  # solid-sphere hub
    inert = np.concatenate([hub_I[None], np.asarray(beam.inertias).reshape(n, 3, 3)])
    return ChainSpec.build(
        joint_types=joint_types,
        axes=axes,
        offsets_pos=offs,
        com_pos=com,
        masses=masses,
        inertias=inert,
        stiffness=np.concatenate([[0.0], np.asarray(beam.stiffness)]),
        damping=np.concatenate([[0.0], np.asarray(beam.damping)]),
        gravity=(0.0, 0.0, 0.0),
        name=f"floating_flexible_beam_{n}",
    )


def uav_kinematics(
    mass=1.0,
    inertia_diag=(0.01, 0.01, 0.02),
    sensor_offset=(0.1, 0.0, -0.05),
    gravity=9.81,
) -> ChainSpec:
    """UAV (quadrotor) kinematics chain: one FREE joint carrying the airframe
    body plus a FIXED sensor/camera frame offset from it
    (ref: ctrl/kte_models/uav_kinematics.hpp UAV_kinematics — a free-floating
    coordinate frame with the quadrotor body hanging off it; the dynamics
    pairing lives in ctrl.ss_systems.quadrotor).

    The fixed second link gives the planner/DK-map a distinct end-effector
    frame (the ref model's output frame) without adding DoFs.
    """
    inert = np.zeros((2, 3, 3))
    inert[0] = np.diag(inertia_diag)
    return ChainSpec.build(
        joint_types=[FREE, FIXED],
        offsets_pos=[[0.0, 0.0, 0.0], list(sensor_offset)],
        masses=[mass, 0.0],
        inertias=inert,
        gravity=(0.0, 0.0, -gravity),
        name="uav_kinematics",
    )

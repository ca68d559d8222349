"""Leg kinematic parameters and forward kinematics.

Re-derivation of the reference robot model layer:
``LegDimensions`` (reference HeaderCPP.h:19-52), the factory functions
(reference static_variables.cpp:6-93) and the YPP forward kinematics
(reference one_leg.cu:377-402).

All angles are radians, all lengths millimetres, all dtypes float32.  The
struct is a NamedTuple of host ``numpy.float32`` scalars: leg parameters are
constants baked into the workspace tables and the CUDA kernels' parameter
blocks, never tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_f32 = np.float32
PI_F32 = _f32(np.pi)


class LegDimensions(NamedTuple):
    """Kinematic parameters of one 3-DoF yaw-pitch-pitch leg.

    Frames: the leg is mounted on the body at azimuth ``body_angle`` about
    +z, at planar offset ``body`` mm from the body origin; the coxa yaw axis
    is tilted by ``coxa_pitch`` about the (mounted) y axis.  ``tibia_absolute_
    pos/neg`` bound the tibia's *absolute* orientation (relative to the body
    horizon, e.g. "tibia always points down"), not the tibia joint itself.
    """

    body_angle: np.float32  # leg mount azimuth about body z [rad]
    body: np.float32  # body origin -> coxa joint offset [mm]
    coxa_pitch: np.float32  # coxa axis pitch [rad]
    coxa_length: np.float32  # coxa joint -> femur joint [mm]
    femur_length: np.float32  # femur joint -> tibia joint [mm]
    tibia_length: np.float32  # tibia joint -> tip [mm]
    tibia_absolute_pos: np.float32  # absolute tibia orientation bounds [rad]
    tibia_absolute_neg: np.float32
    max_angle_coxa: np.float32  # joint limits [rad]
    min_angle_coxa: np.float32
    max_angle_femur: np.float32
    min_angle_femur: np.float32
    max_angle_tibia: np.float32
    min_angle_tibia: np.float32

    def replace(self, **kw) -> "LegDimensions":
        return self._replace(**kw)


def leg_factory(
    azimuth: float,
    body2coxa: float,
    coxa_pitch_deg: float,
    coxa2femur: float,
    femur2tibia: float,
    tibia2tip: float,
    coxa_angle_deg: float,
    femur_angle_deg: float,
    tibia_angle_deg: float,
    tib_abs_pos_deg: float,
    tib_abs_neg_deg: float,
) -> LegDimensions:
    """Build a :class:`LegDimensions` from the reference's parameterization.

    Numerically identical to reference static_variables.cpp:6-42, including
    the unusual absolute-tibia conventions:

    * ``tibia_absolute_pos = tib_abs_pos_deg/180*pi - coxa_pitch``
    * ``tibia_absolute_neg = (-180 - tib_abs_neg_deg)/180*pi - coxa_pitch``

    and symmetric joint limits ``+-{coxa,femur,tibia}_angle_deg``.
    Computation is done in strict float32 so the resulting parameters match
    the fp32 reference bit-for-bit.
    """
    coxa_pitch = _f32(coxa_pitch_deg) / _f32(180.0) * PI_F32
    tib_abs_pos = _f32(tib_abs_pos_deg) / _f32(180.0) * PI_F32 - coxa_pitch
    tib_abs_neg = (
        (_f32(-180.0) - _f32(tib_abs_neg_deg)) / _f32(180.0) * PI_F32 - coxa_pitch
    )
    vals = dict(
        body_angle=_f32(azimuth),
        body=_f32(body2coxa),
        coxa_pitch=coxa_pitch,
        coxa_length=_f32(coxa2femur),
        femur_length=_f32(femur2tibia),
        tibia_length=_f32(tibia2tip),
        tibia_absolute_pos=tib_abs_pos,
        tibia_absolute_neg=tib_abs_neg,
        max_angle_coxa=PI_F32 / _f32(180.0) * _f32(coxa_angle_deg),
        min_angle_coxa=-PI_F32 / _f32(180.0) * _f32(coxa_angle_deg),
        max_angle_femur=PI_F32 / _f32(180.0) * _f32(femur_angle_deg),
        min_angle_femur=-PI_F32 / _f32(180.0) * _f32(femur_angle_deg),
        max_angle_tibia=PI_F32 / _f32(180.0) * _f32(tibia_angle_deg),
        min_angle_tibia=-PI_F32 / _f32(180.0) * _f32(tibia_angle_deg),
    )
    return LegDimensions(**{k: _f32(v) for k, v in vals.items()})


def get_moonbot_leg(azimuth: float = 0.0) -> LegDimensions:
    """Moonbot leg (reference static_variables.cpp:44-67)."""
    return leg_factory(
        azimuth=azimuth,
        body2coxa=181.0,
        coxa_pitch_deg=0.0,
        coxa2femur=65.5,
        femur2tibia=129.0,
        tibia2tip=160.0,
        coxa_angle_deg=60.0,
        femur_angle_deg=90.0,
        tibia_angle_deg=120.0,
        tib_abs_pos_deg=-5.0,
        tib_abs_neg_deg=-5.0,
    )


def get_m2_leg(azimuth: float = 0.0) -> LegDimensions:
    """M2 leg with -45 deg coxa pitch (reference static_variables.cpp:69-93).

    This is the leg selected by the reference benchmark (settings.h:58
    ``RobotNumb = 1``), so it is the flagship geometry for benchmarks here.
    """
    return leg_factory(
        azimuth=azimuth,
        body2coxa=181.0,
        coxa_pitch_deg=-45.0,
        coxa2femur=65.5,
        femur2tibia=129.0,
        tibia2tip=135.0,
        coxa_angle_deg=60.0,
        femur_angle_deg=90.0,
        tibia_angle_deg=120.0,
        tib_abs_pos_deg=-5.0,
        tib_abs_neg_deg=-5.0,
    )


def leg_from_numpy(d) -> LegDimensions:
    """:class:`LegDimensions` from a dict of numpy values keyed by field.

    Carries a leg made elsewhere (e.g. ``{k: np.asarray(v) for k, v in
    leg._asdict().items()}`` of another array library's struct) across
    without recomputing anything, so both sides hold the same bits.
    """
    return LegDimensions(
        **{k: _f32(np.asarray(d[k])) for k in LegDimensions._fields}
    )


def robot_from_numpy(d) -> LegDimensions:
    """A stacked robot (every field an ``[L]`` float32 array, see
    models/robot.py) from a dict of numpy arrays keyed by field: carries a
    robot made elsewhere across, bit for bit, like :func:`leg_from_numpy`."""
    fields = {k: np.ascontiguousarray(np.asarray(d[k]), dtype=_f32)
              for k in LegDimensions._fields}
    shapes = {v.shape for v in fields.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 1:
        raise ValueError(f"robot fields must share one [L] shape, got {shapes}")
    return LegDimensions(**fields)


def forward_kinematics(angles, leg: LegDimensions) -> torch.Tensor:
    """Tip position for joint angles ``[..., 3]`` = (coxa, femur, tibia).

    Standard YPP chain (semantics of reference one_leg.cu:377-402): yaw the
    whole leg by the coxa angle, then femur and tibia pitch in the coxa-
    aligned vertical plane; the tibia angle is relative to the femur.
    Note the reference FK ignores ``coxa_pitch`` (it models the coxa_pitch=0
    moonbot); we keep that semantic and it is exercised only on such legs.
    The result lives on the device of ``angles`` (a numpy input gives a CPU
    tensor).
    """
    angles = torch.as_tensor(angles, dtype=torch.float32)
    coxa, femur, tibia = angles[..., 0], angles[..., 1], angles[..., 2]
    cos_h, sin_h = torch.cos(coxa), torch.sin(coxa)
    cf, sf = torch.cos(femur), torch.sin(femur)
    ct, st = torch.cos(tibia + femur), torch.sin(tibia + femur)
    fem, tib = float(leg.femur_length), float(leg.tibia_length)
    horiz = float(leg.coxa_length) + cf * fem + ct * tib
    x = float(leg.body) + cos_h * horiz
    y = sin_h * horiz
    z = sf * fem + st * tib
    return torch.stack([x, y, z], dim=-1)

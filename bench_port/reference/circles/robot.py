"""Multi-leg robot model: a stacked struct of legs.

The reference hardcodes the robot as ``LegCount`` copies of one leg geometry
mounted at compile-time azimuths (reference settings.h:42-45 ``LegMount``,
several_leg.cpp:19-23).  Here the robot is simply a :class:`LegDimensions`
whose every field is an ``[L]`` float32 numpy array (one entry per leg): leg
parameters stay host constants, as for a single leg, and every multi-leg op
carries the leg axis as a batch dimension written out.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .config import PI
from .leg import (
    LegDimensions,
    get_m2_leg,
    get_moonbot_leg,
)

#: Default quadruped mount azimuths (reference settings.h:42
#: ``LegMount = {0, pi/4, pi/2, 3pi/4}``).
QUAD_MOUNTS: tuple[float, ...] = (0.0, PI / 4, PI / 2, 3 * PI / 4)

#: Hexapod mount azimuths (uniform 60-degree spacing).
HEX_MOUNTS: tuple[float, ...] = tuple(k * PI / 3 for k in range(6))


def stack_legs(legs: Sequence[LegDimensions]) -> LegDimensions:
    """Stack individual legs into one struct with a leading leg axis."""
    return LegDimensions(
        *[np.stack([np.float32(getattr(leg, f)) for leg in legs])
          for f in LegDimensions._fields]
    )


def make_robot(
    mounts: Sequence[float] = QUAD_MOUNTS,
    leg_fn: Callable[[float], LegDimensions] = get_m2_leg,
) -> LegDimensions:
    """Robot = one leg geometry replicated at each mount azimuth.

    ``leg_fn(azimuth)`` builds one leg (default: the benchmark M2 leg,
    reference settings.h:58).  Returns a stacked ``LegDimensions`` whose
    every field has a leading ``[L]`` axis.
    """
    return stack_legs([leg_fn(float(a)) for a in mounts])


def get_moonbot_robot(mounts: Sequence[float] = QUAD_MOUNTS) -> LegDimensions:
    return make_robot(mounts, get_moonbot_leg)


def get_m2_robot(mounts: Sequence[float] = QUAD_MOUNTS) -> LegDimensions:
    return make_robot(mounts, get_m2_leg)


def leg_count(robot: LegDimensions) -> int:
    """Number of legs in a stacked robot (static)."""
    return int(np.shape(robot.body_angle)[0])


def leg_of(robot: LegDimensions, i: int) -> LegDimensions:
    """Leg ``i`` of a stacked robot as a single :class:`LegDimensions`."""
    return LegDimensions(*[np.float32(f[i]) for f in robot])

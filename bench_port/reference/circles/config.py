"""Runtime configuration of the frozen circle math.

The CUDA reference hardcodes all of this as compile-time ``constexpr``
(reference settings.h:9-62).  Here it is a runtime dataclass so one build
serves every robot / solver configuration.  :func:`resolve_device` is the
one place that decides where an entry point computes.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: Margin in mm separating "circles" from "corner points" and padding the
#: inside/outside decision (reference settings.h:9 ``CIRCLE_MARGIN``).
CIRCLE_MARGIN: float = 0.001

#: Tolerance for joint-limit checks when enumerating workspace corner points
#: (reference circles.cu.h:7 ``EPS``).
EPS: float = 0.001

PI: float = math.pi

#: Maximum number of boundary circles evaluated per plane point
#: (reference circles.cu.h:12-13 ``MAX_CIRCLES``).
MAX_CIRCLES: int = 4

#: Maximum number of workspace corner points (reference circles.cu.h:14).
MAX_INTERSECT: int = 10

#: Circles + corner points (reference circles.cu.h:15 ``MAX_CIRCLE_INTER``).
MAX_CIRCLE_INTER: int = MAX_CIRCLES + MAX_INTERSECT


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Positionability solver configuration.

    Mirrors the reference's compile-time search constants
    (settings.h:24-46): root search box, minimum cell size, orientation
    sampling, legs and the stability quorum.
    """

    #: Center of the root body-position search box, mm.
    box_center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    #: Half-extent of the root search box, mm (settings.h:26 ``BoxSize``).
    box_size: tuple[float, float, float] = (5000.0, 5000.0, 5000.0)
    #: Minimum cell half-extent per axis, mm (settings.h:17 ``MINBOXSIZE``).
    min_box: tuple[float, float, float] = (100.0, 100.0, 100.0)
    #: Maximum refinement depth (settings.h:15 ``MAX_DEPTH``).
    max_depth: int = 1
    #: Body-orientation samples per axis (roll, pitch, yaw)
    #: (settings.h:35 ``AngleSample``).
    angle_samples: tuple[int, int, int] = (3, 3, 3)
    #: Orientation sweep ranges [(min,max)] per axis, radians
    #: (settings.h:38 ``AngleMinMax``).
    angle_min_max: tuple[tuple[float, float], ...] = (
        (-PI / 4, PI / 4),
        (-PI / 8, PI / 8),
        (-PI / 8, PI / 8),
    )
    #: Only sample non-identity orientations for cells smaller than this, mm
    #: (settings.h:33 ``EnableRotBelow``).
    enable_rot_below: float = 50.0
    #: Convexity radius for edge detection, mm (settings.h:34).
    convex_radius: float = 100.0
    #: Leg mount azimuths, radians (settings.h:42 ``LegMount``).
    leg_mounts: tuple[float, ...] = (0.0, PI / 4, PI / 2, 3 * PI / 4)
    #: Minimum number of legs that must find a foothold
    #: (settings.h:46 ``LegNumberForStab``).
    legs_for_stability: int = 4

    @property
    def leg_count(self) -> int:
        return len(self.leg_mounts)

    @property
    def total_angle_samples(self) -> int:
        n = 1
        for s in self.angle_samples:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    """Candidate-pruning radii for the multi-leg pipeline.

    Mirrors the reference thrust pipeline's hardcoded radii
    (several_leg.cu:413-502 and :504-559).
    """

    #: Bodies with any foothold inside this sphere always collide, mm.
    collide_radius: float = 60.0
    #: Bodies/targets farther than this from every counterpart are dropped, mm.
    far_radius: float = 400.0
    #: Vertical extent of the body-collision exclusion cylinder, mm.
    body_cyl_plus_z: float = 250.0
    body_cyl_minus_z: float = -110.0


def resolve_device(device=None) -> torch.device:
    """Device an entry point computes on; ``None`` means the CUDA card.

    There is no silent CPU path: with ``device=None`` (or ``"cuda"``) and no
    card this raises.  Callers that want the CPU say ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the reference computes on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the host"
        )
    return dev

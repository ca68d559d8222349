"""The inputs a configuration file describes: the robot, for the program
and for the reference, and the terrain."""

from __future__ import annotations

import math

from bench_port.gen.moon import moon_ground
from bench_port.reference.circles.leg import leg_factory as ref_leg_factory
from bench_port.reference.circles.robot import stack_legs as ref_stack_legs


def mount_angles(cfg: dict) -> list:
    """Leg mount azimuths in radians: ``k * pi / over`` for each ``k``."""
    m = cfg["robot"]["mounts"]
    return [k * math.pi / m["over"] for k in m["pi_times"]]


def _leg_kwargs(cfg: dict) -> dict:
    return {k: v for k, v in cfg["robot"]["leg"].items() if k != "name"}


def program_robot(cfg: dict):
    """The program's stacked robot, built by the program's own factory."""
    from legmov_tpu_torch.models.leg import leg_factory
    from legmov_tpu_torch.models.robot import stack_legs

    kw = _leg_kwargs(cfg)
    return stack_legs([leg_factory(azimuth=a, **kw) for a in mount_angles(cfg)])


def reference_robot(cfg: dict):
    """The same robot, built by the reference's frozen factory."""
    kw = _leg_kwargs(cfg)
    return ref_stack_legs([ref_leg_factory(azimuth=a, **kw)
                           for a in mount_angles(cfg)])


def angle_min_max(cfg: dict) -> tuple:
    return tuple((lo * math.pi, hi * math.pi)
                 for lo, hi in cfg["solver"]["angle_range_pi"])


def terrain(cfg: dict, detail_seed, device):
    """``[N, 3]`` float32 footholds on ``device`` (see gen/moon.py)."""
    t = cfg["terrain"]
    if t["generator"] != "moon":
        raise ValueError(f"unknown terrain generator {t['generator']!r}")
    return moon_ground(t["shape"], t["x_range"], t["y_range"],
                       t["n_craters"], t["relief_seed"], detail_seed,
                       t["saturate_z"], device)

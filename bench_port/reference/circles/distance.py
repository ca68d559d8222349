"""Single-leg distance-to-reachable-volume over point batches (plain
PyTorch formulation).

Semantics of reference ``distance_circles`` (one_leg.cu:321-341) and
``finish_finding_closest`` (one_leg.cu:215-278): for every query point,
produce the 3-D displacement vector from the closest point on the boundary
of the leg's reachable volume to the query (norm = distance to the
workspace edge; zero-crossing = the edge itself), plus the reachability
boolean.

Both the direct coxa heading and its pi-flip (point behind the leg) are
evaluated densely and the better one selected with masks — the reference's
per-thread double evaluation becomes a doubled lane, not a branch.

Cost model: one ``atan2`` per point (the raw coxa angle, needed for the
reference's saturation comparisons) and a handful of square roots; every
rotation uses cos/sin obtained from coordinates (cos(atan2(y, x)) = x / rho)
or from precomputed limit directions, never from per-point trig, and every
distance comparison is done on squared values.  The fused CUDA kernel for
the same function (ops/cuda_kernels.py ``make_distance_kernel``) replaces
the ``atan2`` compares by cross-product sign tests; this module keeps the
raw-angle form and is the independent formulation the kernel is held
against.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .leg import LegDimensions
from .workspace import (
    LegWorkspace,
    build_workspace,
    workspace_tensors,
)
from . import frames, trig32
from .plane import plane_clamp

_PI = float(np.float32(3.14159265358979323846))
_HALF_PI = float(np.float32(_PI) / np.float32(2.0))


def _finish_finding_closest(x, y, z, ws: LegWorkspace, coxa_angle, cos_a, sin_a):
    """Clamp in the (possibly saturated) coxa plane (one_leg.cu:215-278).

    ``coxa_angle`` is the raw heading of this branch (direct or pi-flipped)
    and ``(cos_a, sin_a)`` its direction — supplied by the caller from
    coordinate ratios, so no trig happens here: the saturated direction is
    a select between (cos_a, sin_a), its negation (mega-saturation), and
    the precomputed limit directions.

    Returns ``(valid, dx, dy, dz)``: validity = in-plane validity AND coxa
    not saturated; (dx, dy, dz) = displacement from the chosen boundary
    point to the query, in the coxa frame.
    """
    ws = workspace_tensors(ws, x.device)
    max_a, min_a = ws.max_angle_coxa, ws.min_angle_coxa
    cos_max, sin_max = ws.coxa_max_dir[0], ws.coxa_max_dir[1]
    cos_min, sin_min = ws.coxa_min_dir[0], ws.coxa_min_dir[1]

    mega = (coxa_angle > max_a + _HALF_PI) | (coxa_angle < min_a - _HALF_PI)
    over = coxa_angle > max_a
    under = coxa_angle < min_a
    coxa_saturated = mega | over | under

    # direction of the saturated angle, via selects (no trig):
    #   mega     -> angle -+ pi    -> negated direction
    #   over max -> clamped to max -> precomputed max direction
    #   under min-> clamped to min -> precomputed min direction
    #   else     -> the angle itself
    c1 = torch.where(
        mega, -cos_a,
        torch.where(over, cos_max, torch.where(under, cos_min, cos_a)),
    )
    s1 = torch.where(
        mega, -sin_a,
        torch.where(over, sin_max, torch.where(under, sin_min, sin_a)),
    )

    # rotate into the saturated coxa plane (cancel_coxa_rotation semantics)
    xr = x * c1 + y * s1
    yr = -x * s1 + y * c1
    was_valid, dxp, dzp = plane_clamp(xr - ws.coxa_length, z, ws)

    # alternative boundary: the coxa angular-limit plane (one_leg.cu:258-274).
    # Rotating the saved point by (limit - sat_angle) needs cos/sin of the
    # difference -> angle-addition formulas on precomputed limit directions.
    use_max = coxa_angle > (max_a + min_a) / 2.0
    cl = torch.where(use_max, cos_max, cos_min)
    sl = torch.where(use_max, sin_max, sin_min)
    c2 = cl * c1 + sl * s1  # cos(limit - sat)
    s2 = sl * c1 - cl * s1  # sin(limit - sat)
    ys = -xr * s2 + yr * c2  # residual y in the limit plane

    dist2_clamped = dxp * dxp + yr * yr + dzp * dzp
    better_not_clamp = (
        was_valid & torch.logical_not(mega) & (dist2_clamped > ys * ys)
    )
    rx, ry = frames.restore_coxa_rotation(torch.zeros_like(ys), ys, c2, s2)

    fx = torch.where(better_not_clamp, rx, dxp)
    fy = torch.where(better_not_clamp, ry, yr)
    fz = torch.where(better_not_clamp, 0.0, dzp)
    gx, gy = frames.restore_coxa_rotation(fx, fy, c1, s1)
    return was_valid & torch.logical_not(coxa_saturated), gx, gy, fz


def distance_xyz(x, y, z, ws: LegWorkspace):
    """Component-form distance core: ``(reachable, dx, dy, dz)``."""
    ws = workspace_tensors(ws, x.device)
    x, y, z = frames.place_over_coxa_xyz(x, y, z, ws.body, ws.coxa_pitch)

    coxangle = torch.atan2(y, x)
    coxangle_flip = torch.where(coxangle > 0, coxangle - _PI, coxangle + _PI)

    # direction of the heading from coordinates: cos = x/rho, sin = y/rho
    # (identity direction for the degenerate on-axis point, where atan2=0)
    rho = trig32.sqrt(x * x + y * y)
    on_axis = rho == 0
    inv = torch.where(on_axis, 1.0, rho)
    cos_a = torch.where(on_axis, 1.0, x / inv)
    sin_a = torch.where(on_axis, 0.0, y / inv)

    res, dx, dy, dz = _finish_finding_closest(
        x, y, z, ws, coxangle, cos_a, sin_a
    )
    resf, fx, fy, fz = _finish_finding_closest(
        x, y, z, ws, coxangle_flip, -cos_a, -sin_a
    )

    d2_direct = dx * dx + dy * dy + dz * dz
    d2_flip = fx * fx + fy * fy + fz * fz
    use_direct = torch.where(res == resf, d2_direct < d2_flip, res)
    ox = torch.where(use_direct, dx, fx)
    oy = torch.where(use_direct, dy, fy)
    oz = torch.where(use_direct, dz, fz)
    ox, oy, oz = frames.unplace_over_coxa_xyz(ox, oy, oz, ws.coxa_pitch)
    return res | resf, ox, oy, oz


def distance_ws(points: torch.Tensor, ws: LegWorkspace):
    """``(reachable [...], displacement [..., 3])`` given a prebuilt workspace."""
    ok, ox, oy, oz = distance_xyz(
        points[..., 0], points[..., 1], points[..., 2], ws
    )
    return ok, torch.stack([ox, oy, oz], dim=-1)


def distance(points: torch.Tensor, leg: LegDimensions):
    """``(reachable [...], displacement [..., 3])`` for one leg, computed on
    the device the tensor lives on."""
    return distance_ws(points, build_workspace(leg))


def distance_batch(points, leg: LegDimensions, device=None):
    """Flat entry point: ``[N, 3] float32 -> ([N] bool, [N, 3])`` on
    ``device`` (``None`` = the CUDA card, which must exist)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev)
    return distance(pts, leg)

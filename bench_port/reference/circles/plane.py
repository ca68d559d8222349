"""In-plane workspace evaluation: validity test and boundary clamp.

Dense re-derivation of the reference's hot loops (one_leg.cu:31-145,
:167-208): instead of a per-thread loop over a divergent circle stack, every
point evaluates a fixed [4]-circle table (selected by its region bits) and,
for the distance path, a fixed [10]-corner table — dense fp32 element-wise
math, branch-free, O(4^2 + 10) per point.

Conventions: the plane is the coxa-rotated vertical plane; ``x`` is the
radial coordinate *in the femur frame* (the caller subtracts coxa_length)
and ``y`` is world z.  ``attract=True`` means the point must be inside the
circle to be valid; False means outside.  A ``CIRCLE_MARGIN`` band around
every circumference is always valid.

This is the plain-tensor formulation (direct ``(x-cx)^2 + (y-cy)^2`` circle
form, gathered ``[..., 4]`` tables).  The CUDA kernels and their plain
versions in ops/cuda_kernels.py use the expanded linear form instead; the
tests hold the two formulations against each other.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CIRCLE_MARGIN
from .workspace import (
    LegWorkspace,
    select_validate_tables,
    workspace_tensors,
)
from . import trig32

_MARGIN = float(np.float32(CIRCLE_MARGIN))
_BIG = float(np.float32(3.4e38))


def _angle_gt(x, y, dir_cs, theta_neg):
    """Trig-free ``atan2(y, x) > theta`` for a precomputed threshold.

    ``dir_cs = (cos(theta), sin(theta))``, ``theta_neg = theta < 0``.  Uses
    ``sign(sin(angle - theta)) = sign(y cos(theta) - x sin(theta))`` on the
    half-plane where that identity is wrap-free:

    * theta <  0: y >= 0 means angle in [0, pi] > theta (always true);
      y < 0 means angle in (-pi, 0), where the cross test is safe.
    * theta >= 0: y < 0 means angle < 0 <= theta (always false);
      y >= 0 means angle in [0, pi], where the cross test is safe.

    Matches the raw float comparison of the reference (circles.cu.h:48-78)
    up to fp32 ulp at the decision boundary.
    """
    cross = y * dir_cs[0] - x * dir_cs[1]
    pos = cross > 0
    return torch.where(y >= 0, theta_neg | pos, theta_neg & pos)


def find_region(x, y, ws: LegWorkspace):
    """Classify plane points: (upper, fully_extended) bits.

    Semantics of reference circles.cu.h:48-78 with all leg-dependent terms
    precomputed into ``ws`` and the two ``atan2`` comparisons replaced by
    trig-free half-plane tests.
    """
    ws = workspace_tensors(ws, x.device)
    upper = _angle_gt(x, y, (ws.mid_dir[..., 0], ws.mid_dir[..., 1]),
                      ws.mid_neg)
    sat_dir = torch.where(upper[..., None], ws.sat_dir[..., 1, :],
                          ws.sat_dir[..., 0, :])
    sat_neg = torch.where(upper, ws.sat_neg[..., 1], ws.sat_neg[..., 0])
    gt_sat = _angle_gt(x, y, (sat_dir[..., 0], sat_dir[..., 1]), sat_neg)
    fully_extended = upper ^ gt_sat
    return upper, fully_extended


def plane_validate(x, y, ws: LegWorkspace):
    """Reachability in the plane: point valid against all 4 region circles.

    Semantics of ``eval_plane_circles<REACH>`` -> ``multi_circle_validate``
    (one_leg.cu:65-89, :167-208) with every test done on squared distances
    against precomputed thresholds — zero square roots, zero trig.
    ``x``/``y`` are femur-frame coordinates (coxa_length already subtracted
    by the caller).  Shape ``[...] -> [...]`` bool.
    """
    ws = workspace_tensors(ws, x.device)
    upper, ext = find_region(x, y, ws)
    cx, cy, r2, hi2, lo2, attract = select_validate_tables(ws, upper, ext)
    dx = x[..., None] - cx
    dy = y[..., None] - cy
    d2 = dx * dx + dy * dy
    inside = d2 <= r2
    near = (d2 < hi2) & (d2 > lo2)
    valid = (inside == attract) | near
    return torch.all(valid, dim=-1)


def plane_clamp(x, y, ws: LegWorkspace):
    """Distance-to-boundary in the plane.

    Semantics of ``eval_plane_circles<DIST>`` -> ``multi_circle_clamp``
    (one_leg.cu:91-145, :167-208):

    * clamp the query onto each of the 4 region circles; a clamp is a
      candidate iff the clamped point is valid against *all* 4 circles;
    * the query is valid iff it is valid against all 4 circles;
    * workspace corner points become candidates only when the query is
      invalid;
    * keep the candidate whose boundary is closest (first wins ties, same
      iteration order as the reference: circles then corners);
    * if no candidate exists the displacement degenerates to the query
      itself (reference leaves potential=(0,0)).

    Returns ``(valid, out_x, out_y)`` where (out_x, out_y) is the
    displacement from the chosen boundary point to the query.
    """
    ws = workspace_tensors(ws, x.device)
    upper, ext = find_region(x, y, ws)
    cx4, cy4, r2, hi2, lo2, attract4 = select_validate_tables(ws, upper, ext)
    u, e = upper[..., None], ext[..., None]
    r4 = torch.where(
        u,
        torch.where(e, ws.circle_r[..., 1, 1, :], ws.circle_r[..., 1, 0, :]),
        torch.where(e, ws.circle_r[..., 0, 1, :], ws.circle_r[..., 0, 0, :]),
    )

    # per-circle: squared distance, validity (squared thresholds), clamp
    dx = x[..., None] - cx4
    dy = y[..., None] - cy4
    d2 = dx * dx + dy * dy
    inside = d2 <= r2
    near = (d2 < hi2) & (d2 > lo2)
    valid = (inside == attract4) | near  # [..., 4]
    overall_valid = torch.all(valid, dim=-1)

    mag = trig32.sqrt(d2)
    deg = mag < _MARGIN  # degenerate point-at-center guard (one_leg.cu:54-58)
    scale = r4 / torch.where(deg, 1.0, mag)
    clamp_x = cx4 + torch.where(deg, 1.0, dx) * scale  # [..., 4]
    clamp_y = cy4 + torch.where(deg, 0.0, dy) * scale
    score2 = (r4 - mag) * (r4 - mag)  # squared |signed distance|

    # validate each clamped point against all 4 circles (squared thresholds)
    vx = clamp_x[..., None] - cx4[..., None, :]
    vy = clamp_y[..., None] - cy4[..., None, :]
    v2 = vx * vx + vy * vy
    cvalid = ((v2 <= r2[..., None, :]) == attract4[..., None, :]) | (
        (v2 < hi2[..., None, :]) & (v2 > lo2[..., None, :])
    )
    clamp_ok = torch.all(cvalid, dim=-1)  # [..., 4]

    # fold the 4 circle candidates then the 10 corner candidates, in the
    # reference's iteration order with strict-< first-wins tie-breaking
    # (one_leg.cu:91-145); squared scores compare identically to |scores|.
    best_s2 = torch.full_like(x, _BIG)
    best_x = torch.zeros_like(x)
    best_y = torch.zeros_like(x)
    for i in range(4):
        s2 = torch.where(clamp_ok[..., i], score2[..., i], _BIG)
        take = s2 < best_s2
        best_s2 = torch.where(take, s2, best_s2)
        best_x = torch.where(take, clamp_x[..., i], best_x)
        best_y = torch.where(take, clamp_y[..., i], best_y)
    # corner points participate only when the query is invalid
    invalid = torch.logical_not(overall_valid)
    for j in range(int(ws.corner_valid.shape[-1])):
        pcx = ws.corner_xy[..., j, 0]
        pcy = ws.corner_xy[..., j, 1]
        cdx = x - pcx
        cdy = y - pcy
        s2 = torch.where(
            ws.corner_valid[..., j] & invalid, cdx * cdx + cdy * cdy, _BIG
        )
        take = s2 < best_s2
        best_s2 = torch.where(take, s2, best_s2)
        best_x = torch.where(take, pcx, best_x)
        best_y = torch.where(take, pcy, best_y)

    found = best_s2 < _BIG
    out_x = x - torch.where(found, best_x, 0.0)
    out_y = y - torch.where(found, best_y, 0.0)
    return overall_valid, out_x, out_y

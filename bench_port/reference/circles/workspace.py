"""Precomputed circle-decomposition workspace for one leg.

This is the dense-table re-derivation of the reference's workspace geometry
core (reference circles.cu.h, leg_geometry.cu.h).  The reference rebuilds a
small per-point stack of "circles" inside every CUDA thread
(circles.cu.h:337-383 ``insert_circles``); here we precompute, once per
(leg, orientation), a dense table of every circle variant the stack could
ever contain, so the per-point work collapses to masked selects + a handful
of multiply-adds — pure element-wise math with no divergence.

Geometry recap (in the coxa-rotated vertical plane, origin at femur joint,
x = radial, y = vertical):

* ``inner``    — circle at origin, radius = min femur->tip distance; the tip
  can never be closer than this (repulsive: point must be outside).
* ``outer``    — radius = femur + tibia; fully-extended reach (attractive).
* ``fromabove_pos/neg`` — centers at tibia_length * (cos, sin)(tibia_absolute
  limit): the loci of femur joints when the tibia saturates its *absolute*
  orientation limit; radius = femur_length.
* ``winglet_pos/neg``   — centers at femur_length * (cos, sin)(femur joint
  limit): tip circles when the femur joint saturates; radius = tibia_length.
* 10 corner points: closed-form (femur, tibia) configurations where two
  constraints intersect (circles.cu.h:417-476 ``insert_intersecv2``),
  emitted as radius-0 circles used only by the distance clamp.

Which 4 of these circles constrain a query point, and with which polarity
("attractivity": True = valid inside, False = valid outside), depends only
on two per-point bits — ``upper`` (above/below the workspace mid-angle) and
``fully_extended`` — plus per-leg constants.  So the full decision table is
a [2 regions, 2 extended, 4 slots] table of (cx, cy, r, attractivity),
precomputed here on the host in strict numpy float32: the tables are
constants (the CUDA kernels take them as a by-value parameter block), and
:func:`workspace_tensors` turns them into tensors for the plain PyTorch
evaluators.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import CIRCLE_MARGIN, EPS
from .leg import LegDimensions

_f32 = np.float32


def _sincos(a):
    """(sin, cos) of float32 ``a`` as numpy float32 arrays of its shape: the
    JAX package's float32 values (glibc's ``sinf``/``cosf``, which XLA:CPU
    calls), from :mod:`trig32`.  numpy's own float32
    ``sin``/``cos`` are SIMD approximations whose last bit differs from
    those and varies with the host CPU."""
    # here, not at the top: the ops package imports this module
    from . import trig32

    s, c = trig32.sincos(torch.from_numpy(np.array(a, _f32, ndmin=1)))
    shape = np.shape(a)
    return s.numpy().reshape(shape), c.numpy().reshape(shape)


def _cos(a):
    """float32 cosine with the JAX package's bits (see :func:`_sincos`)."""
    return _sincos(a)[1]


def _sin(a):
    """float32 sine with the JAX package's bits (see :func:`_sincos`)."""
    return _sincos(a)[0]


class LegWorkspace(NamedTuple):
    """Dense workspace decision tables for one leg (all float32).

    ``circle_*[region, extended, slot]`` with region 0 = lower, 1 = upper,
    extended 0/1 = FullyExtended bit, slots ordered [inner, neg, pos,
    winglet] — the exact stack order of the reference (circles.cu.h:337-383)
    so that distance-clamp tie-breaking matches.

    ``corner_xy[10, 2]`` / ``corner_valid[10]`` are the candidate workspace
    corner points with their joint-limit feasibility mask.

    Scalars: ``middle_angle`` splits upper/lower; ``sat_limit[region]`` is
    the angle beyond which the leg is fully extended.
    """

    circle_x: np.ndarray  # [2, 2, 4]
    circle_y: np.ndarray  # [2, 2, 4]
    circle_r: np.ndarray  # [2, 2, 4]
    circle_attract: np.ndarray  # [2, 2, 4] bool
    corner_xy: np.ndarray  # [10, 2]
    corner_valid: np.ndarray  # [10] bool
    middle_angle: np.ndarray  # scalar
    sat_limit: np.ndarray  # [2] (lower, upper)
    # leg fields needed downstream of the plane evaluation
    body: np.ndarray
    coxa_pitch: np.ndarray
    coxa_length: np.ndarray
    max_angle_coxa: np.ndarray
    min_angle_coxa: np.ndarray
    # --- precomputed fast-path tables (all derived from the above) --------
    # Squared circle-test thresholds: d2 <= r2 means "inside";
    # lo2 < d2 < hi2 means "within CIRCLE_MARGIN of the circumference"
    # (lo2 = -1 when r < margin so the lower bound never fires).
    circle_r2: np.ndarray  # [2, 2, 4]
    circle_hi2: np.ndarray  # [2, 2, 4]  (r + margin)^2
    circle_lo2: np.ndarray  # [2, 2, 4]  (r - margin)^2 or -1
    # Unit direction of each angular threshold, for trig-free half-plane
    # comparisons sign(sin(angle - theta)) = sign(y cos(theta) - x sin(theta)).
    coxa_max_dir: np.ndarray  # [2] (cos, sin) of max_angle_coxa
    coxa_min_dir: np.ndarray  # [2]
    coxa_gt_possible: np.ndarray  # bool: max_angle_coxa < pi/2
    coxa_lt_possible: np.ndarray  # bool: min_angle_coxa > -pi/2
    mid_dir: np.ndarray  # [2] (cos, sin) of middle_angle
    mid_neg: np.ndarray  # bool: middle_angle < 0
    sat_dir: np.ndarray  # [2, 2] per region (cos, sin) of sat_limit
    sat_neg: np.ndarray  # [2] bool: sat_limit < 0


def _circle(cx, cy, r, attract):
    return (
        np.asarray(cx, _f32),
        np.asarray(cy, _f32),
        np.asarray(r, _f32),
        np.asarray(attract, bool),
    )


def build_workspace(leg: LegDimensions) -> LegWorkspace:
    """Precompute the full circle/corner decision table for ``leg``.

    This plays the role of the reference's ``LegDim2LegComp``
    (circles.cu.h:507-530) but bakes in the *entire* region logic of
    ``find_region`` + ``insert_circles`` (circles.cu.h:48-78, :337-383),
    not just the six base circles.
    """
    fem, tib = leg.femur_length, leg.tibia_length
    min_fem, max_fem = leg.min_angle_femur, leg.max_angle_femur
    min_tib, max_tib = leg.min_angle_tibia, leg.max_angle_tibia
    abs_pos, abs_neg = leg.tibia_absolute_pos, leg.tibia_absolute_neg

    # --- region constants (find_region, circles.cu.h:48-78) --------------
    middle_angle = (
        np.maximum(abs_neg, min_fem) + np.minimum(abs_pos, max_fem)
    ) / _f32(2.0)
    # "Femur angle limitation" bit: does the femur joint saturate before the
    # absolute-tibia limit?  Upper region compares the + limits, lower the -.
    fal_up = max_fem < abs_pos
    fal_low = np.logical_not(min_fem < abs_neg)
    # The same bit for the *other* side of the region we are in.
    falo_up = min_fem < abs_neg
    falo_low = np.logical_not(max_fem < abs_pos)
    # Angle past which the leg is fully extended, per region.
    sat_up = np.where(fal_up, max_fem, abs_pos)
    sat_low = np.where(fal_low, min_fem, abs_neg)

    # --- corner points (insert_intersecv2, circles.cu.h:417-476) ---------
    # 10 candidate (femur, tibia) configurations where two constraints meet;
    # keep those inside all three joint-limit boxes (within EPS).
    fem_list = np.stack(
        [
            min_fem,
            min_fem,
            min_fem,
            abs_neg - min_tib,
            abs_neg - max_tib,
            max_fem,
            max_fem,
            max_fem,
            abs_pos - min_tib,
            abs_pos - min_tib,
        ]
    )
    tib_list = np.stack(
        [
            max_tib,
            min_tib,
            abs_neg - min_fem,
            min_tib,
            max_tib,
            min_tib,
            max_tib,
            abs_pos - max_fem,
            abs_pos - (abs_pos - min_tib),
            abs_pos - (abs_pos - min_tib),
        ]
    )
    eps = _f32(EPS)
    abs_ang = fem_list + tib_list
    corner_valid = (
        (fem_list < max_fem + eps)
        & (fem_list > min_fem - eps)
        & (tib_list < max_tib + eps)
        & (tib_list > min_tib - eps)
        & (abs_ang < abs_pos + eps)
        & (abs_ang > abs_neg - eps)
    )

    # every angle the tables take a sine or cosine of, in one call: the
    # base circles' (0-4), the corners' femur and absolute angles (5-14,
    # 15-24) and the unit directions' (25-29)
    sn, cs = _sincos(np.concatenate([
        np.asarray([min_tib, abs_pos, abs_neg, max_fem, min_fem], _f32),
        fem_list, abs_ang,
        np.asarray([leg.max_angle_coxa, leg.min_angle_coxa, middle_angle,
                    sat_low, sat_up], _f32)]))

    # --- the six base circles (circles.cu.h:80-135, leg_geometry.cu.h) ----
    # min femur->tip distance: |femur + tibia * e^{i*min_tibia}|
    mx = fem + tib * cs[0]
    my = tib * sn[0]
    inner = _circle(0.0, 0.0, np.sqrt(mx * mx + my * my), False)
    outer = _circle(0.0, 0.0, fem + tib, True)
    fa_pos = _circle(tib * cs[1], tib * sn[1], fem, True)
    fa_neg = _circle(tib * cs[2], tib * sn[2], fem, True)
    wing_pos = _circle(fem * cs[3], fem * sn[3], tib, True)
    wing_neg = _circle(fem * cs[4], fem * sn[4], tib, True)

    def select(cond, a, b):
        """Per-field select between two circles."""
        return tuple(
            np.where(cond, fa, fb) for fa, fb in zip(a, b)
        )

    def with_attract(c, attract):
        return (c[0], c[1], c[2], np.asarray(attract, bool))

    # --- slot tables, mirroring insert_circles exactly --------------------
    # Slot order [inner, neg, pos, winglet].  Per region:
    #   * the opposite side's slot is always repulsive; it holds the opposite
    #     winglet when the *other* side is femur-limited, else the opposite
    #     fromabove circle.
    #   * the same side's fromabove slot is attractive iff the femur does NOT
    #     saturate first; the same-side winglet iff it does.
    #   * when fully extended, whichever of those two is attractive is
    #     replaced by the outer circle.
    def region_slots(upper: bool):
        if upper:
            fal, falo = fal_up, falo_up
            excl = select(falo, wing_neg, fa_neg)  # neg side repulsive
            excl = with_attract(excl, False)
            other = with_attract(fa_pos, np.logical_not(fal))  # pos side
            wing = with_attract(wing_pos, fal)
            slots = [inner, excl, other, wing]
            other_slot, wing_slot = 2, 3
        else:
            fal, falo = fal_low, falo_low
            excl = select(falo, wing_pos, fa_pos)  # pos side repulsive
            excl = with_attract(excl, False)
            other = with_attract(fa_neg, np.logical_not(fal))  # neg side
            wing = with_attract(wing_neg, fal)
            slots = [inner, other, excl, wing]
            other_slot, wing_slot = 1, 3
        # fully-extended variant: replace the attractive of {other, wing}
        # (exactly one is attractive: attractivities are !fal and fal)
        ext = list(slots)
        outer_a = with_attract(outer, True)
        ext[other_slot] = select(np.logical_not(fal), outer_a, ext[other_slot])
        ext[wing_slot] = select(fal, outer_a, ext[wing_slot])
        return slots, ext

    low, low_ext = region_slots(False)
    up, up_ext = region_slots(True)

    def stack(field_idx):
        # -> [region, extended, slot]
        return np.stack(
            [
                np.stack(
                    [np.stack([c[field_idx] for c in low]),
                     np.stack([c[field_idx] for c in low_ext])]
                ),
                np.stack(
                    [np.stack([c[field_idx] for c in up]),
                     np.stack([c[field_idx] for c in up_ext])]
                ),
            ]
        )

    circle_x, circle_y, circle_r, circle_attract = (stack(i) for i in range(4))

    # the corner points of the configurations above
    corner_x = fem * cs[5:15] + tib * cs[15:25]
    corner_y = fem * sn[5:15] + tib * sn[15:25]
    corner_xy = np.stack([corner_x, corner_y], axis=-1)

    # --- fast-path tables --------------------------------------------------
    margin = _f32(CIRCLE_MARGIN)
    r_tab = circle_r
    r2 = r_tab * r_tab
    hi2 = (r_tab + margin) * (r_tab + margin)
    lo = r_tab - margin
    lo2 = np.where(lo < 0, _f32(-1.0), lo * lo)

    # unit directions of the coxa limits, the middle and the saturations
    dirs = np.stack([cs[25:30], sn[25:30]], axis=-1)

    half_pi = _f32(np.pi / 2)
    sat_angles = np.stack([sat_low, sat_up]).astype(_f32)

    return LegWorkspace(
        circle_x=circle_x.astype(_f32),
        circle_y=circle_y.astype(_f32),
        circle_r=circle_r.astype(_f32),
        circle_attract=circle_attract,
        corner_xy=corner_xy.astype(_f32),
        corner_valid=corner_valid,
        middle_angle=np.asarray(middle_angle, _f32),
        sat_limit=np.stack([sat_low, sat_up]).astype(_f32),
        body=np.asarray(leg.body, _f32),
        coxa_pitch=np.asarray(leg.coxa_pitch, _f32),
        coxa_length=np.asarray(leg.coxa_length, _f32),
        max_angle_coxa=np.asarray(leg.max_angle_coxa, _f32),
        min_angle_coxa=np.asarray(leg.min_angle_coxa, _f32),
        circle_r2=r2.astype(_f32),
        circle_hi2=hi2.astype(_f32),
        circle_lo2=lo2.astype(_f32),
        coxa_max_dir=dirs[0],
        coxa_min_dir=dirs[1],
        coxa_gt_possible=np.asarray(leg.max_angle_coxa < half_pi),
        coxa_lt_possible=np.asarray(leg.min_angle_coxa > -half_pi),
        mid_dir=dirs[2],
        mid_neg=np.asarray(middle_angle, _f32) < 0,
        sat_dir=dirs[3:5],
        sat_neg=sat_angles < 0,
    )


def workspace_from_numpy(d) -> LegWorkspace:
    """:class:`LegWorkspace` from a dict of numpy arrays keyed by field.

    Carries tables built elsewhere (e.g. ``{k: np.asarray(v) for k, v in
    ws._asdict().items()}`` of another array library's struct) across
    without recomputing anything, so both sides evaluate the same bits.
    """
    out = {}
    for k in LegWorkspace._fields:
        a = np.asarray(d[k])
        out[k] = a.astype(bool) if a.dtype == bool else a.astype(_f32)
    return LegWorkspace(**out)


def workspace_tensors(ws: LegWorkspace, device) -> LegWorkspace:
    """``ws`` with every field a tensor on ``device`` (float32 / bool).

    A workspace that already holds tensors passes through, so the plain
    evaluators accept either form.
    """
    if isinstance(ws.circle_x, torch.Tensor):
        return ws
    return LegWorkspace(
        *[torch.as_tensor(np.asarray(f), device=device) for f in ws]
    )


def stack_workspaces(items, shape, device) -> LegWorkspace:
    """Workspaces of many legs as one struct of tensors on ``device``.

    ``items`` is a flat sequence of host workspaces, ``shape`` the batch
    shape they fill in row-major order; every field gets those leading axes
    (``circle_x`` becomes ``[*shape, 2, 2, 4]``).  The plain evaluators
    broadcast the batch axes against the point axes, so a caller appends
    singleton axes to ``shape`` where the points go.
    """
    out = []
    for name in LegWorkspace._fields:
        a = np.stack([np.asarray(getattr(ws, name)) for ws in items])
        a = a.reshape(tuple(shape) + a.shape[1:])
        out.append(torch.as_tensor(a, device=device))
    return LegWorkspace(*out)


def _pick(t, u, e):
    low = torch.where(e, t[..., 0, 1, :], t[..., 0, 0, :])
    up = torch.where(e, t[..., 1, 1, :], t[..., 1, 0, :])
    return torch.where(u, up, low)


def select_circles(ws: LegWorkspace, upper, extended):
    """Gather the 4 active circles for per-point bits ``upper``/``extended``.

    ``upper``/``extended`` are broadcastable bool tensors ``[...]``; returns
    (cx, cy, r, attract) each shaped ``[..., 4]``.  Pure selects — the dense
    equivalent of the reference's per-thread stack construction.
    """
    ws = workspace_tensors(ws, upper.device)
    u = upper[..., None]
    e = extended[..., None]
    return (
        _pick(ws.circle_x, u, e),
        _pick(ws.circle_y, u, e),
        _pick(ws.circle_r, u, e),
        _pick(ws.circle_attract, u, e),
    )


def select_validate_tables(ws: LegWorkspace, upper, extended):
    """Like :func:`select_circles` but with the squared fast-path thresholds.

    Returns ``(cx, cy, r2, hi2, lo2, attract)`` each ``[..., 4]`` — all a
    reachability test needs, with no square roots downstream.
    """
    ws = workspace_tensors(ws, upper.device)
    u = upper[..., None]
    e = extended[..., None]
    return (
        _pick(ws.circle_x, u, e),
        _pick(ws.circle_y, u, e),
        _pick(ws.circle_r2, u, e),
        _pick(ws.circle_hi2, u, e),
        _pick(ws.circle_lo2, u, e),
        _pick(ws.circle_attract, u, e),
    )

"""Fused CUDA kernels for single-leg reachability and distance.

The plain-tensor paths (ops/reachability.py, ops/distance.py) launch one
elementwise kernel per operation and materialize every ``[N]`` and ``[N, 4]``
intermediate in device memory.  The two kernels here (source:
``csrc/leg_kernels.cu``) run a point's whole program in one thread's
registers: read 12 B/point, write 1 B (reachability) or 13 B (distance).

Design: a **factory specialized to one concrete leg** — every workspace
table entry (models/workspace.py) becomes a float32 constant of a parameter
block that the kernel receives by value, so one compiled binary serves every
leg.  The constants are computed here with strict numpy-float32 expressions
(their trig with ops/trig32.py, the JAX package's float32 values).

Beside each kernel stands its **plain PyTorch version**
(:func:`reachability_kernel_plain`, :func:`distance_kernel_plain`): the
kernel's own arithmetic in the kernel's own order (expanded linear circle
form, select chains, trig-free angle tests, ``rsqrt``) on whole tensors.
The wrappers use it for CPU tensors only; for a CUDA tensor they launch the
kernel or raise.  On the card the two are compared bit for bit.

K2 has a second kernel, for the identity levels of the hierarchical solve:
:func:`distance_cells_kernel` gives the (valid, edge, leaf) flags of a batch
of cells over the batch's footholds in one launch, on the same body, beside
its plain version :func:`distance_cells_plain` (the eager loop over foothold
chunks and legs that wrapped K2's point kernel before).

The reach probe's io-only floor (:func:`io_only_kernel`, K1's input and
output with no geometry) lives in the same source; it has no path of its
own and launches only on the card.

Each wrapper counts its launches in a plain integer attribute
(``reachability_kernel.launches``, ``distance_kernel.launches``,
``distance_cells_kernel.launches``, ``io_only_kernel.launches``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from legmov_tpu_torch.models.leg import LegDimensions
from legmov_tpu_torch.models.workspace import LegWorkspace, build_workspace
from legmov_tpu_torch.ops import _build, trig32

_f32 = np.float32
_PI = _f32(math.pi)
_MAX_CIRCLES = 16
_MAX_CORNERS = 10
#: legs (and distinct leg geometries) the cell kernel takes
MAX_CELL_LEGS = 8
#: fp32 operations of the cell kernel per (cell, foothold) pair (the
#: elongated-box prefilter: 3 subtractions, 6 compares) and per pair inside
#: the box and leg beside the body (azimuth yaw 6, restore 6, crossing
#: test 6)
PREFILTER_FLOPS = 9
PAIR_LEG_FLOPS = 18


class Direction(NamedTuple):
    """A constant angular threshold as (cos, sin, threshold < 0)."""

    c: float
    s: float
    neg: bool


class ReachConsts(NamedTuple):
    """Everything the reachability kernel knows about one leg."""

    body: float
    cp: float  # cos / sin of -coxa_pitch
    sp: float
    coxa_length: float
    cmax: tuple  # (cos, sin) of max_angle_coxa
    cmin: tuple
    gt_possible: bool
    lt_possible: bool
    mid: Direction
    sat: tuple  # (lower, upper) Direction
    #: unique circles as (-2cx, -2cy, r2-k, hi2-k, lo2-k), k = cx^2 + cy^2
    circles: tuple
    #: per unique circle: lo2k < r2k < hi2k, the interval collapse is legal
    collapse: tuple
    #: [region][ext][slot] -> (unique circle index, attract)
    slot_map: tuple


class DistConsts(NamedTuple):
    """Everything the distance kernel knows about one leg."""

    body: float
    cp: float
    sp: float
    coxa_length: float
    cp_inv: float  # cos / sin of +coxa_pitch
    sp_inv: float
    cmax: tuple
    cmin: tuple
    mid: Direction
    sat: tuple
    margin2: float
    big: float
    #: name -> [region][ext][slot] floats: x, y, r, r2, hi2, lo2
    tabs: dict
    att: tuple  # [region][ext][slot] bool
    #: live corners as (x, y, -2x, -2y, x^2 + y^2)
    corners: tuple
    #: threshold directions mega_hi, mega_lo, max, min, mid
    dirs: tuple


def _host_ws(leg_or_ws) -> LegWorkspace:
    ws = leg_or_ws
    if isinstance(ws, LegDimensions):
        ws = build_workspace(ws)
    return LegWorkspace(*[np.asarray(f) for f in ws])


def _table(ws, name):
    a = getattr(ws, name)
    return tuple(
        tuple(tuple(float(a[r, e, s]) for s in range(4)) for e in range(2))
        for r in range(2)
    )


def _att_table(ws):
    a = ws.circle_attract
    return tuple(
        tuple(tuple(bool(a[r, e, s]) for s in range(4)) for e in range(2))
        for r in range(2)
    )


def _frame_consts(ws):
    (sp,), (cp,) = trig32.host_sincos([-_f32(ws.coxa_pitch)])
    return float(ws.body), cp, sp, float(ws.coxa_length)


def _region_consts(ws):
    mid = Direction(float(ws.mid_dir[0]), float(ws.mid_dir[1]),
                    bool(ws.mid_neg))
    sat = tuple(
        Direction(float(ws.sat_dir[r, 0]), float(ws.sat_dir[r, 1]),
                  bool(ws.sat_neg[r]))
        for r in range(2)
    )
    return mid, sat


def reach_consts(leg_or_ws) -> ReachConsts:
    """Constants of the reachability kernel for a leg (or its workspace)."""
    ws = _host_ws(leg_or_ws)
    tab = {n: _table(ws, n) for n in
           ("circle_x", "circle_y", "circle_r2", "circle_hi2", "circle_lo2")}
    att = _att_table(ws)

    # The 16 (region, ext, slot) table entries reference only ~6 distinct
    # circles (inner/outer/fromabove+-/winglet+-); deduplicate them and
    # evaluate each once via the expanded linear form
    #   d2 = (q - 2 cx xp - 2 cy yp) + (cx^2 + cy^2),  q = xp^2 + yp^2
    # with the centre norm folded into the thresholds.
    uniq: dict = {}
    circles: list = []
    slot_map = [[[None] * 4 for _ in range(2)] for _ in range(2)]
    for r in range(2):
        for e in range(2):
            for s in range(4):
                key = (tab["circle_x"][r][e][s], tab["circle_y"][r][e][s],
                       tab["circle_r2"][r][e][s])
                if key not in uniq:
                    cx, cy, _ = key
                    k = _f32(_f32(cx) * _f32(cx) + _f32(cy) * _f32(cy))
                    uniq[key] = len(circles)
                    circles.append((
                        float(_f32(-2.0 * cx)),
                        float(_f32(-2.0 * cy)),
                        float(_f32(_f32(tab["circle_r2"][r][e][s]) - k)),
                        float(_f32(_f32(tab["circle_hi2"][r][e][s]) - k)),
                        float(_f32(_f32(tab["circle_lo2"][r][e][s]) - k)),
                    ))
                slot_map[r][e][s] = (uniq[key], att[r][e][s])
    mid, sat = _region_consts(ws)
    body, cp, sp, coxa_length = _frame_consts(ws)
    return ReachConsts(
        body=body, cp=cp, sp=sp, coxa_length=coxa_length,
        cmax=(float(ws.coxa_max_dir[0]), float(ws.coxa_max_dir[1])),
        cmin=(float(ws.coxa_min_dir[0]), float(ws.coxa_min_dir[1])),
        gt_possible=bool(ws.coxa_gt_possible),
        lt_possible=bool(ws.coxa_lt_possible),
        mid=mid, sat=sat,
        circles=tuple(circles),
        collapse=tuple(lo2k < r2k < hi2k for (_, _, r2k, hi2k, lo2k) in circles),
        slot_map=tuple(tuple(tuple(e) for e in r) for r in slot_map),
    )


def dist_consts(leg_or_ws) -> DistConsts:
    """Constants of the distance kernel for a leg (or its workspace).

    Raises ``ValueError`` for legs whose mega-clamp thresholds leave
    (-pi, pi): the trig-free angle comparisons are wrap-free only inside.
    """
    ws = _host_ws(leg_or_ws)
    max_a = float(ws.max_angle_coxa)
    min_a = float(ws.min_angle_coxa)
    half_pi = float(_PI) / 2.0
    mid_coxa = (max_a + min_a) / 2.0
    pitch = _f32(ws.coxa_pitch)
    inv = trig32.host_sincos([pitch])
    margin = _f32(0.001)

    if abs(max_a + half_pi) >= float(_PI) or abs(min_a - half_pi) >= float(_PI):
        raise ValueError(
            f"coxa limits ({min_a:.3f}, {max_a:.3f}) rad put the mega-clamp "
            "thresholds outside (-pi, pi); the trig-free distance kernel "
            "does not support such legs — use ops/distance.py"
        )

    def _dir(theta):
        t = _f32(theta)
        (s,), (c,) = trig32.host_sincos([t])
        return Direction(c, s, bool(t < 0))

    corners = []
    for j in range(ws.corner_xy.shape[0]):
        if not bool(ws.corner_valid[j]):
            continue
        pcx, pcy = float(ws.corner_xy[j, 0]), float(ws.corner_xy[j, 1])
        corners.append((
            pcx, pcy,
            float(_f32(-2.0 * pcx)), float(_f32(-2.0 * pcy)),
            float(_f32(_f32(pcx) * _f32(pcx) + _f32(pcy) * _f32(pcy))),
        ))
    mid, sat = _region_consts(ws)
    body, cp, sp, coxa_length = _frame_consts(ws)
    return DistConsts(
        body=body, cp=cp, sp=sp, coxa_length=coxa_length,
        cp_inv=inv[1][0],
        sp_inv=inv[0][0],
        cmax=(float(ws.coxa_max_dir[0]), float(ws.coxa_max_dir[1])),
        cmin=(float(ws.coxa_min_dir[0]), float(ws.coxa_min_dir[1])),
        mid=mid, sat=sat,
        margin2=float(margin * margin),
        big=float(_f32(3.4e38)),
        tabs={short: _table(ws, "circle_" + short)
              for short in ("x", "y", "r", "r2", "hi2", "lo2")},
        att=_att_table(ws),
        corners=tuple(corners),
        dirs=(_dir(max_a + half_pi), _dir(min_a - half_pi), _dir(max_a),
              _dir(min_a), _dir(mid_coxa)),
    )


def reach_flops_per_point(c: ReachConsts) -> int:
    """fp32 adds, multiplies, compares and square roots the reachability
    kernel does per point (selects and boolean logic not counted): coxa
    frame 7, limit tests 4 each, sqrt and plane coordinate 5, region bits
    15, q 3, then 6 per collapsed circle (7 in the full form)."""
    n = 7 + 4 * int(c.gt_possible) + 4 * int(c.lt_possible) + 5 + 15 + 3
    return n + sum(6 if col else 7 for col in c.collapse)


def dist_flops_per_point(c: DistConsts) -> int:
    """fp32 operations the distance kernel does per point, counted as in
    :func:`reach_flops_per_point`: frame and heading 14; per finish branch
    five angle tests 25, rotation 7, region bits 16, four circles validated
    and clamped 72, cross-validation 96, circle tournament 4, corner
    tournament 3 + 6 per corner, result 3, limit plane and un-rotation 24;
    final select and un-pitch 17."""
    plane = 16 + 72 + 96 + 4 + _corner_flops(c) + 3
    return 14 + 2 * (25 + 7 + plane + 24) + 17


def cells_flops(pairs: int, pairs_in_box: int, leg_flops) -> int:
    """fp32 operations of the cell kernel: ``pairs`` (cell, foothold) pairs
    prefiltered, ``pairs_in_box`` of them through every leg, whose bodies
    cost ``leg_flops`` (one :func:`dist_flops_per_point` per leg)."""
    per_pair = sum(f + PAIR_LEG_FLOPS for f in leg_flops)
    return pairs * PREFILTER_FLOPS + pairs_in_box * per_pair


class CellLevel(NamedTuple):
    """Constants of one identity level, float32 values (see
    :func:`cell_level`)."""

    elong: tuple  # [3] elongated-box half-extent: parent half + reach
    hm: tuple  # [3] crossing box: half + margin
    h2m: float  # crossing sphere: |half|^2 + margin
    big_cell: bool  # |half|^2 > 100^2 (convexRadius): the box test


def cell_level(half, parent_half, margin: float, reach: float) -> CellLevel:
    """The level constants on the host, in float32, in this order:
    ``elong = parent_half + reach``; ``h2 = (hx*hx + hy*hy) + hz*hz``;
    ``big_cell = h2 > 100*100``; ``hm = half + margin``; ``h2m = h2 +
    margin``.  The cell kernel and its plain version both read them, so no
    batch reads the device for them."""
    h = np.asarray(half, _f32)
    ph = np.asarray(parent_half, _f32)
    m = _f32(margin)
    elong = ph + _f32(reach)
    h2 = (h[0] * h[0] + h[1] * h[1]) + h[2] * h[2]
    hm = h + m
    return CellLevel(elong=tuple(float(e) for e in elong),
                     hm=tuple(float(e) for e in hm),
                     h2m=float(_f32(h2 + m)),
                     big_cell=bool(h2 > _f32(100.0 * 100.0)))


class CellLegs:
    """A robot's legs as the cell kernel takes them: the distinct leg
    geometries (legs that differ only by their mount azimuth share one) and
    per leg its geometry's index and ``cos / sin(-azimuth)`` in float32."""

    def __init__(self, legs):
        if not 1 <= len(legs) <= MAX_CELL_LEGS:
            raise ValueError(f"the cell kernel takes 1 to {MAX_CELL_LEGS} "
                             f"legs, got {len(legs)}")
        keys: dict = {}
        self.consts: list = []
        self.pidx, self.ca, self.sa = [], [], []
        for leg in legs:
            key = tuple(float(getattr(leg, f)) for f in leg._fields
                        if f != "body_angle")
            if key not in keys:
                keys[key] = len(self.consts)
                self.consts.append(dist_consts(leg))
            self.pidx.append(keys[key])
            (sa,), (ca,) = trig32.host_sincos([-float(leg.body_angle)])
            self.ca.append(ca)
            self.sa.append(sa)
        self.params = [dist_params(c) for c in self.consts]
        self.leg_flops = [dist_flops_per_point(self.consts[p])
                          for p in self.pidx]
        self._on_device: dict = {}
        self._scratch: dict = {}

    def __len__(self):
        return len(self.pidx)

    def params_on(self, device) -> torch.Tensor:
        """The parameter blocks as bytes on ``device``, copied once per
        device from pinned memory without a synchronisation."""
        key = str(device)
        if key not in self._on_device:
            raw = b"".join(bytes(p) for p in self.params)
            host = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
            self._on_device[key] = host.pin_memory().to(device,
                                                        non_blocking=True)
        return self._on_device[key]

    def scratch_on(self, device, n_cells: int) -> torch.Tensor:
        """The cell kernel's zeroed scratch words on ``device``, two a cell,
        which every launch leaves zeroed: the launches through this object
        go on one stream."""
        key = str(device)
        if key not in self._scratch or self._scratch[key].numel() < 2 * n_cells:
            self._scratch[key] = torch.zeros(max(2 * n_cells, 2048),
                                             dtype=torch.int32, device=device)
        return self._scratch[key]


# ---------------------------------------------------------------------------
# plain PyTorch versions: the kernels' arithmetic, in the kernels' order
# ---------------------------------------------------------------------------

def _sel3(upper, ext, t):
    """3-select pick of scalar table ``t[region][ext]`` per point."""
    hi = torch.where(ext, t[1][1], t[1][0])
    lo = torch.where(ext, t[0][1], t[0][0])
    return torch.where(upper, hi, lo)


def _angle_gt_const(xp, yp, d: Direction):
    """Trig-free raw ``atan2(yp, xp) > theta`` with constant threshold."""
    pos = (yp * d.c - xp * d.s) > 0
    nn = yp >= 0
    return (nn | pos) if d.neg else (nn & pos)


def _angle_lt_const(xp, yp, d: Direction):
    """Raw ``atan2(yp, xp) < theta`` (strict); mirror of _angle_gt_const:
    theta < 0 -> only y < 0 can satisfy it, cross test safe there;
    theta >= 0 -> y < 0 always satisfies, else cross test."""
    neg = (yp * d.c - xp * d.s) < 0
    below = yp < 0
    return (below & neg) if d.neg else (below | neg)


def _region_bits(xp, yp, c):
    upper = _angle_gt_const(xp, yp, c.mid)
    gt_lo = _angle_gt_const(xp, yp, c.sat[0])
    gt_up = _angle_gt_const(xp, yp, c.sat[1])
    ext = upper ^ torch.where(upper, gt_up, gt_lo)
    return upper, ext


def _coxa_frame(x, y, z, c):
    px = x - c.body
    return px * c.cp - z * c.sp, y, px * c.sp + z * c.cp


def _reach_plane(x, y, z, c: ReachConsts):
    """K1's steps up to the plane: ``(coxa_invalid or None, xp, yp, upper,
    ext)``."""
    x, y, z = _coxa_frame(x, y, z, c)
    flip = torch.signbit(x)
    fx = torch.where(flip, -x, x)
    fy = torch.where(flip, -y, y)
    coxa_invalid = None
    if c.gt_possible:
        coxa_invalid = (fy * c.cmax[0] - fx * c.cmax[1]) > 0
    if c.lt_possible:
        lt = (fy * c.cmin[0] - fx * c.cmin[1]) < 0
        coxa_invalid = lt if coxa_invalid is None else coxa_invalid | lt
    rho = trig32.sqrt(x * x + y * y)
    xp = torch.where(flip, -rho, rho) - c.coxa_length
    yp = z
    upper, ext = _region_bits(xp, yp, c)
    return coxa_invalid, xp, yp, upper, ext


def reach_configuration(x, y, z, consts: ReachConsts) -> torch.Tensor:
    """K1's (upper, ext) configuration of each point, ``upper * 2 + ext``
    as int64 ``[N]``: which masks the kernel checks."""
    _, _, _, upper, ext = _reach_plane(x, y, z, consts)
    return upper.long() * 2 + ext.long()


def reachability_kernel_plain(x, y, z, consts: ReachConsts) -> torch.Tensor:
    """Plain PyTorch version of the reachability kernel: ``[N]`` float32
    components in, ``[N]`` bool out, on the tensors' device."""
    c = consts
    coxa_invalid, xp, yp, upper, ext = _reach_plane(x, y, z, c)
    # each unique circle once, both validity polarities
    q = xp * xp + yp * yp
    val_pos, val_neg = [], []
    for (ax, ay, r2k, hi2k, lo2k), collapse in zip(c.circles, c.collapse):
        t = q + ax * xp + ay * yp
        if collapse:
            # contiguous-interval collapse; ~(t <= lo2) rather than
            # (t > lo2) so a NaN t keeps the truth of ``~inside | near``
            val_pos.append(t < hi2k)
            val_neg.append(~(t <= lo2k))
        else:
            inside = t <= r2k
            near = (t < hi2k) & (t > lo2k)
            val_pos.append(inside | near)
            val_neg.append(~inside | near)
    # per-(region, ext) config: AND its 4 slot lookups, then 3 selects
    v = [[None, None], [None, None]]
    for r in range(2):
        for e in range(2):
            ok = None
            for s in range(4):
                ci, attract = c.slot_map[r][e][s]
                good = val_pos[ci] if attract else val_neg[ci]
                ok = good if ok is None else ok & good
            v[r][e] = ok
    plane_ok = _sel3(upper, ext, v)
    return plane_ok if coxa_invalid is None else (~coxa_invalid & plane_ok)


def _plane_clamp_plain(xp, yp, c: DistConsts):
    """ops/plane.py plane_clamp with select-chain scalar tables, rsqrt
    clamps and the linear-form corner tournament."""
    upper, ext = _region_bits(xp, yp, c)
    big = c.big

    def pick(name, s):
        t = c.tabs[name]
        return _sel3(upper, ext, [[t[0][0][s], t[0][1][s]],
                                  [t[1][0][s], t[1][1][s]]])

    # ones is False and zeros True at a NaN coordinate: there every slot's
    # polarity is inverted, in the kernel as here
    ones = xp == xp
    zeros = ~ones

    def pick_att(s):
        a = [[ones if c.att[r][e][s] else zeros for e in range(2)]
             for r in range(2)]
        return _sel3(upper, ext, a)

    cxs = [pick("x", s) for s in range(4)]
    cys = [pick("y", s) for s in range(4)]
    rs = [pick("r", s) for s in range(4)]
    r2s = [pick("r2", s) for s in range(4)]
    hi2s = [pick("hi2", s) for s in range(4)]
    lo2s = [pick("lo2", s) for s in range(4)]
    atts = [pick_att(s) for s in range(4)]

    def circ_valid(px, py, s):
        dx = px - cxs[s]
        dy = py - cys[s]
        d2 = dx * dx + dy * dy
        inside = d2 <= r2s[s]
        near = (d2 < hi2s[s]) & (d2 > lo2s[s])
        return (inside == atts[s]) | near

    overall = None
    clamps = []
    scores = []
    for s in range(4):
        dx = xp - cxs[s]
        dy = yp - cys[s]
        d2 = dx * dx + dy * dy
        inside = d2 <= r2s[s]
        near = (d2 < hi2s[s]) & (d2 > lo2s[s])
        valid = (inside == atts[s]) | near
        overall = valid if overall is None else overall & valid
        deg = d2 < c.margin2
        rinv = torch.rsqrt(torch.where(deg, 1.0, d2))
        mag = d2 * rinv
        scale = rs[s] * rinv
        clamps.append(
            (cxs[s] + torch.where(deg, 1.0, dx) * scale,
             cys[s] + torch.where(deg, 0.0, dy) * scale)
        )
        scores.append((rs[s] - mag) * (rs[s] - mag))
    best_s2 = torch.full_like(xp, big)
    best_x = torch.zeros_like(xp)
    best_y = torch.zeros_like(xp)
    for s in range(4):
        cx, cy = clamps[s]
        ok = None
        for t in range(4):
            if t == s:
                # a clamp lies on its own circumference (inside the
                # CIRCLE_MARGIN band) — self-validation is always true
                continue
            good = circ_valid(cx, cy, t)
            ok = good if ok is None else ok & good
        s2 = torch.where(ok, scores[s], big)
        take = s2 < best_s2
        best_s2 = torch.where(take, s2, best_s2)
        best_x = torch.where(take, cx, best_x)
        best_y = torch.where(take, cy, best_y)
    invalid = ~overall
    if c.corners:
        # corner-only tournament, merged with the circle winner once;
        # first-wins strict < ordering
        q = xp * xp + yp * yp
        c_s2 = c_x = c_y = None
        for (pcx, pcy, ax, ay, kc) in c.corners:
            s2 = q + ax * xp + ay * yp + kc
            if c_s2 is None:
                c_s2 = s2
                c_x = torch.full_like(xp, pcx)
                c_y = torch.full_like(xp, pcy)
            else:
                take = s2 < c_s2
                c_s2 = torch.where(take, s2, c_s2)
                c_x = torch.where(take, pcx, c_x)
                c_y = torch.where(take, pcy, c_y)
        take = invalid & (c_s2 < best_s2)
        best_s2 = torch.where(take, c_s2, best_s2)
        best_x = torch.where(take, c_x, best_x)
        best_y = torch.where(take, c_y, best_y)
    found = best_s2 < big
    out_x = xp - torch.where(found, best_x, 0.0)
    out_y = yp - torch.where(found, best_y, 0.0)
    return overall, out_x, out_y


def _finish_plain(x, y, z, cos_a, sin_a, flipped, c: DistConsts):
    """ops/distance.py _finish_finding_closest with constants; ``flipped``
    selects the pi-flip branch, whose raw angle is that of (-x, -y)."""
    d_mega_hi, d_mega_lo, d_max, d_min, d_mid = c.dirs
    ax, ay = (-x, -y) if flipped else (x, y)
    mega = _angle_gt_const(ax, ay, d_mega_hi) | _angle_lt_const(ax, ay, d_mega_lo)
    over = _angle_gt_const(ax, ay, d_max)
    under = _angle_lt_const(ax, ay, d_min)
    saturated = mega | over | under
    c1 = torch.where(
        mega, -cos_a,
        torch.where(over, c.cmax[0], torch.where(under, c.cmin[0], cos_a)),
    )
    s1 = torch.where(
        mega, -sin_a,
        torch.where(over, c.cmax[1], torch.where(under, c.cmin[1], sin_a)),
    )
    xr = x * c1 + y * s1
    yr = -x * s1 + y * c1
    was_valid, dxp, dzp = _plane_clamp_plain(xr - c.coxa_length, z, c)
    use_max = _angle_gt_const(ax, ay, d_mid)
    cl = torch.where(use_max, c.cmax[0], c.cmin[0])
    sl = torch.where(use_max, c.cmax[1], c.cmin[1])
    c2 = cl * c1 + sl * s1
    s2 = sl * c1 - cl * s1
    ys = -xr * s2 + yr * c2
    d2c = dxp * dxp + yr * yr + dzp * dzp
    better = was_valid & ~mega & (d2c > ys * ys)
    rx = -ys * s2
    ry = ys * c2
    fx = torch.where(better, rx, dxp)
    fy = torch.where(better, ry, yr)
    fz = torch.where(better, 0.0, dzp)
    gx = fx * c1 - fy * s1
    gy = fx * s1 + fy * c1
    return was_valid, saturated, gx, gy, fz


class _DistParts(NamedTuple):
    ok: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    #: each finish branch's plane validity (direct, pi-flipped)
    valid_d: torch.Tensor
    valid_f: torch.Tensor
    #: each branch's result, ``valid & ~saturated``
    res: torch.Tensor
    resf: torch.Tensor
    #: the direct branch's vector was taken
    use_d: torch.Tensor


def _distance_parts(x, y, z, c: DistConsts) -> _DistParts:
    x, y, z = _coxa_frame(x, y, z, c)
    rho = trig32.sqrt(x * x + y * y)
    on_axis = rho == 0
    inv = torch.where(on_axis, 1.0, rho)
    cos_a = torch.where(on_axis, 1.0, x / inv)
    sin_a = torch.where(on_axis, 0.0, y / inv)
    valid_d, sat_d, dx, dy, dz = _finish_plain(x, y, z, cos_a, sin_a, False, c)
    valid_f, sat_f, fx, fy, fz = _finish_plain(x, y, z, -cos_a, -sin_a, True,
                                               c)
    res = valid_d & ~sat_d
    resf = valid_f & ~sat_f
    d2d = dx * dx + dy * dy + dz * dz
    d2f = fx * fx + fy * fy + fz * fz
    use_d = torch.where(res == resf, d2d < d2f, res)
    ox = torch.where(use_d, dx, fx)
    oy = torch.where(use_d, dy, fy)
    oz = torch.where(use_d, dz, fz)
    wx = ox * c.cp_inv - oz * c.sp_inv
    wz = ox * c.sp_inv + oz * c.cp_inv
    return _DistParts(res | resf, wx, oy, wz, valid_d, valid_f, res, resf,
                      use_d)


def distance_kernel_plain(x, y, z, consts: DistConsts):
    """Plain PyTorch version of the distance kernel: ``[N]`` float32
    components in, ``(ok [N] bool, dx, dy, dz [N] float32)`` out."""
    p = _distance_parts(x, y, z, consts)
    return p.ok, p.dx, p.dy, p.dz


#: fp32 operations of one finish branch's head (four angle tests 20,
#: rotation 7, region bits 16, four circles validated 32) and of its tail
#: (the limit-plane angle test 5, four clamps 40, cross-validation 96,
#: circle tournament 4, result 3, limit plane and un-rotation 24), corners
#: apart: together dist_flops_per_point's branch
DIST_HEAD_FLOPS = 75
DIST_TAIL_FLOPS = 172


def _corner_flops(c: DistConsts) -> int:
    nc = len(c.corners)
    return 3 + 5 * nc + (nc - 1) + 1 if nc else 0


def dist_flops_needed(x, y, z, consts: DistConsts) -> int:
    """fp32 operations that the distance of these points needs, counted as
    in :func:`dist_flops_per_point`, where each point needs its frame,
    heading, final select and both branch heads, the tail of a branch only
    where that branch's vector is read (the two results agree or the branch
    won), and a tail's corner tournament only for an invalid query."""
    c = consts
    p = _distance_parts(x, y, z, c)
    agree = p.res == p.resf
    corner = _corner_flops(c)
    n = x.shape[0]
    total = n * (14 + 17 + 2 * DIST_HEAD_FLOPS)
    for need, valid in ((agree | p.res, p.valid_d),
                        (agree | p.resf, p.valid_f)):
        total += int(need.sum()) * DIST_TAIL_FLOPS
        total += int((need & ~valid).sum()) * corner
    return total


def mixed_points(leg, n: int, seed: int, device="cpu") -> torch.Tensor:
    """``[n, 3]`` float32 points, seeded, whose every 32 consecutive rows
    mix what a warp of K1 or K2 can meet: each class of (K1's (upper, ext)
    configuration, K1's result, K2's dual-finish winner) that a uniform
    draw over the bench envelope (x -100..601, y -400..401, z -350..51)
    holds for ``leg`` comes once in every run of that many rows (at most
    16), drawn from that class in the draw's order, again from its start
    when a class runs out."""
    rng = np.random.default_rng(seed)
    m = max(n, 1 << 16)
    lo = np.array([-100.0, -400.0, -350.0], np.float32)
    hi = np.array([601.0, 401.0, 51.0], np.float32)
    pool = torch.from_numpy(
        rng.uniform(lo, hi, (m, 3)).astype(np.float32)).to(device)
    x, y, z = (pool[:, i].contiguous() for i in range(3))
    rc = reach_consts(leg)
    key = (reach_configuration(x, y, z, rc) * 4
           + reachability_kernel_plain(x, y, z, rc).long() * 2
           + _distance_parts(x, y, z, dist_consts(leg)).use_d.long())
    counts = torch.bincount(key, minlength=16)
    classes = torch.nonzero(counts).flatten()
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(key, stable=True)
    i = torch.arange(n, device=pool.device)
    cls = classes[i % classes.numel()]
    j = torch.div(i, classes.numel(), rounding_mode="floor") % counts[cls]
    return pool[order[starts[cls] + j]].contiguous()


def special_rows(p: torch.Tensor) -> torch.Tensor:
    """``p`` (``[N, 3]`` float32) with 64 seeded rows of NaN, +-inf, 0.0 and
    -0.0 mixes in front, on ``p``'s device."""
    vals = torch.tensor([np.nan, np.inf, -np.inf, 0.0, -0.0],
                        dtype=torch.float32)
    pick = torch.from_numpy(np.random.default_rng(5).integers(0, 5, (64, 3)))
    return torch.cat([vals[pick].to(p.device), p])


def distance_cells_plain(centers, parent_valid, footholds, legs: CellLegs,
                         level: CellLevel, k: int, shared: bool,
                         chunk: int = 512, dist=None) -> torch.Tensor:
    """Plain version of the cell kernel: the (valid, edge, leaf) flags
    ``[3, C]`` bool of ``centers [C, 3]`` (parents' validity
    ``parent_valid [C]``) over ``footholds [F, 3]`` at the identity
    orientation, as eager tensor code over foothold chunks of ``chunk`` and
    the legs.  ``dist(x, y, z, consts) -> (ok, dx, dy, dz)`` is the distance
    of points in a leg's frame: :func:`distance_kernel_plain` by default;
    :func:`distance_kernel` makes this the form that launched K2's point
    kernel per (chunk, leg)."""
    if dist is None:
        dist = distance_kernel_plain
    dev = centers.device
    C = centers.shape[0]
    L = len(legs)
    e0, e1, e2 = level.elong
    hm = level.hm
    any_valid = torch.zeros(C, dtype=torch.bool, device=dev)
    any_edge = torch.zeros(C, dtype=torch.bool, device=dev)
    any_leaf = torch.zeros(C, dtype=torch.bool, device=dev)
    la = torch.zeros((L, C), dtype=torch.bool, device=dev)
    lc = torch.zeros((L, C), dtype=torch.bool, device=dev)
    lp = torch.zeros((L, C), dtype=torch.bool, device=dev)
    F = footholds.shape[0]
    for lo in range(0, F, chunk):
        fh_c = footholds[lo:lo + chunk]
        vect = fh_c[None, :, :] - centers[:, None, :]  # [C, Fc, 3]
        # elongated-box prefilter (asymmetric bounds like isInBox,
        # octree_util.cu.h:153-159)
        vx, vy, vz = vect[..., 0], vect[..., 1], vect[..., 2]
        pre = ((vx > -e0) & (vx <= e0) & (vy > -e1) & (vy <= e1)
               & (vz > -e2) & (vz <= e2))
        z0 = vz.reshape(-1).contiguous()
        reach_count = torch.zeros(pre.shape, dtype=torch.int32, device=dev)
        cross_count = torch.zeros(pre.shape, dtype=torch.int32, device=dev)
        for l in range(L):
            ca, sa = legs.ca[l], legs.sa[l]
            x0 = (vx * ca - vy * sa).reshape(-1)
            y0 = (vx * sa + vy * ca).reshape(-1)
            ok, dx, dy, dz = dist(x0, y0, z0, legs.consts[legs.pidx[l]])
            # vector back to the world frame (yaw by +azimuth)
            wx = (dx * ca + dy * sa).reshape(C, -1)
            wy = (-dx * sa + dy * ca).reshape(C, -1)
            wz = dz.reshape(C, -1)
            ok = ok.reshape(C, -1)
            # boundary-crossing test on the displacement vector
            # (several_leg_octree.cu:96-105)
            if level.big_cell:
                cross = ((wx > -hm[0]) & (wx <= hm[0])
                         & (wy > -hm[1]) & (wy <= hm[1])
                         & (wz > -hm[2]) & (wz <= hm[2]))
            else:
                cross = (wx * wx + wy * wy + wz * wz) < level.h2m
            cross = cross & pre
            okp = ok & pre
            reach_count += okp
            cross_count += cross
            la[l] |= okp.any(dim=-1)
            lc[l] |= (okp & ~cross).any(dim=-1)
            lp[l] |= (okp | cross).any(dim=-1)
        item_valid = ((reach_count >= k) | parent_valid[:, None]) & pre
        item_edge = (cross_count > (L - k)) & pre
        any_valid |= item_valid.any(dim=1)
        any_edge |= item_edge.any(dim=1)
        any_leaf |= (item_valid & ~item_edge).any(dim=1)
    if not shared:
        any_valid = (la.sum(dim=0) >= k) | parent_valid
        any_edge = (lc.sum(dim=0) < k) & (lp.sum(dim=0) >= k)
        any_leaf = any_valid & ~any_edge
    return torch.stack([any_valid, any_edge, any_leaf])


# ---------------------------------------------------------------------------
# parameter blocks, field for field as in csrc/leg_kernels.cu
# ---------------------------------------------------------------------------

class _ReachParams(ctypes.Structure):
    _fields_ = [
        ("body", ctypes.c_float), ("cp", ctypes.c_float),
        ("sp", ctypes.c_float), ("coxa_length", ctypes.c_float),
        ("cmax_c", ctypes.c_float), ("cmax_s", ctypes.c_float),
        ("cmin_c", ctypes.c_float), ("cmin_s", ctypes.c_float),
        ("mid_c", ctypes.c_float), ("mid_s", ctypes.c_float),
        ("sat_c", ctypes.c_float * 2), ("sat_s", ctypes.c_float * 2),
        ("gt_possible", ctypes.c_int), ("lt_possible", ctypes.c_int),
        ("mid_neg", ctypes.c_int),
        ("sat_neg", ctypes.c_int * 2),
        ("n_circles", ctypes.c_int),
        ("ax", ctypes.c_float * _MAX_CIRCLES),
        ("ay", ctypes.c_float * _MAX_CIRCLES),
        ("r2k", ctypes.c_float * _MAX_CIRCLES),
        ("hi2k", ctypes.c_float * _MAX_CIRCLES),
        ("lo2k", ctypes.c_float * _MAX_CIRCLES),
        ("collapse", ctypes.c_int * _MAX_CIRCLES),
        ("pos_mask", ctypes.c_uint * 4), ("neg_mask", ctypes.c_uint * 4),
    ]


class _DistParams(ctypes.Structure):
    _fields_ = [
        ("body", ctypes.c_float), ("cp", ctypes.c_float),
        ("sp", ctypes.c_float), ("coxa_length", ctypes.c_float),
        ("cp_inv", ctypes.c_float), ("sp_inv", ctypes.c_float),
        ("cmax_c", ctypes.c_float), ("cmax_s", ctypes.c_float),
        ("cmin_c", ctypes.c_float), ("cmin_s", ctypes.c_float),
        ("mid_c", ctypes.c_float), ("mid_s", ctypes.c_float),
        ("sat_c", ctypes.c_float * 2), ("sat_s", ctypes.c_float * 2),
        ("margin2", ctypes.c_float), ("big", ctypes.c_float),
        ("cx", ctypes.c_float * 16), ("cy", ctypes.c_float * 16),
        ("r", ctypes.c_float * 16), ("r2", ctypes.c_float * 16),
        ("hi2", ctypes.c_float * 16), ("lo2", ctypes.c_float * 16),
        ("corner_x", ctypes.c_float * _MAX_CORNERS),
        ("corner_y", ctypes.c_float * _MAX_CORNERS),
        ("corner_ax", ctypes.c_float * _MAX_CORNERS),
        ("corner_ay", ctypes.c_float * _MAX_CORNERS),
        ("corner_k", ctypes.c_float * _MAX_CORNERS),
        ("dir_c", ctypes.c_float * 5), ("dir_s", ctypes.c_float * 5),
        ("mid_neg", ctypes.c_int),
        ("sat_neg", ctypes.c_int * 2),
        ("att", ctypes.c_int * 16),
        ("n_corners", ctypes.c_int),
        ("dir_neg", ctypes.c_int * 5),
    ]


class _CellArgs(ctypes.Structure):
    _fields_ = [
        ("ca", ctypes.c_float * MAX_CELL_LEGS),
        ("sa", ctypes.c_float * MAX_CELL_LEGS),
        ("elong", ctypes.c_float * 3), ("hm", ctypes.c_float * 3),
        ("h2m", ctypes.c_float),
        ("pidx", ctypes.c_int * MAX_CELL_LEGS),
        ("n_legs", ctypes.c_int), ("k", ctypes.c_int),
        ("shared", ctypes.c_int), ("big_cell", ctypes.c_int),
    ]


def cell_args(legs: CellLegs, level: CellLevel, k: int,
              shared: bool) -> _CellArgs:
    """The cell kernel's by-value block for one level."""
    a = _CellArgs()
    for l in range(len(legs)):
        a.ca[l], a.sa[l], a.pidx[l] = legs.ca[l], legs.sa[l], legs.pidx[l]
    for i in range(3):
        a.elong[i], a.hm[i] = level.elong[i], level.hm[i]
    a.h2m = level.h2m
    a.n_legs, a.k, a.shared = len(legs), int(k), int(bool(shared))
    a.big_cell = int(level.big_cell)
    return a


def _fill_common(p, c):
    p.body, p.cp, p.sp, p.coxa_length = c.body, c.cp, c.sp, c.coxa_length
    p.cmax_c, p.cmax_s = c.cmax
    p.cmin_c, p.cmin_s = c.cmin
    p.mid_c, p.mid_s, p.mid_neg = c.mid.c, c.mid.s, int(c.mid.neg)
    for r in range(2):
        p.sat_c[r], p.sat_s[r] = c.sat[r].c, c.sat[r].s
        p.sat_neg[r] = int(c.sat[r].neg)


def reach_params(c: ReachConsts) -> _ReachParams:
    """The kernel's parameter block for ``c``.  The slot map is folded into
    two bit masks per (upper, ext) configuration: the unique circles its
    four slots test attractively and repulsively."""
    if len(c.circles) > _MAX_CIRCLES:
        raise ValueError(f"{len(c.circles)} unique circles exceed the "
                         f"kernel's {_MAX_CIRCLES}")
    p = _ReachParams()
    _fill_common(p, c)
    p.gt_possible, p.lt_possible = int(c.gt_possible), int(c.lt_possible)
    p.n_circles = len(c.circles)
    for i, (ax, ay, r2k, hi2k, lo2k) in enumerate(c.circles):
        p.ax[i], p.ay[i], p.r2k[i], p.hi2k[i], p.lo2k[i] = ax, ay, r2k, hi2k, lo2k
        p.collapse[i] = int(c.collapse[i])
    for r in range(2):
        for e in range(2):
            pos = neg = 0
            for ci, attract in c.slot_map[r][e]:
                if attract:
                    pos |= 1 << ci
                else:
                    neg |= 1 << ci
            p.pos_mask[r * 2 + e], p.neg_mask[r * 2 + e] = pos, neg
    return p


def dist_params(c: DistConsts) -> _DistParams:
    """The kernel's parameter block for ``c``."""
    if len(c.corners) > _MAX_CORNERS:
        raise ValueError(f"{len(c.corners)} corners exceed the kernel's "
                         f"{_MAX_CORNERS}")
    p = _DistParams()
    _fill_common(p, c)
    p.cp_inv, p.sp_inv = c.cp_inv, c.sp_inv
    p.margin2, p.big = c.margin2, c.big
    for r in range(2):
        for e in range(2):
            for s in range(4):
                i = (r * 2 + e) * 4 + s
                p.cx[i] = c.tabs["x"][r][e][s]
                p.cy[i] = c.tabs["y"][r][e][s]
                p.r[i] = c.tabs["r"][r][e][s]
                p.r2[i] = c.tabs["r2"][r][e][s]
                p.hi2[i] = c.tabs["hi2"][r][e][s]
                p.lo2[i] = c.tabs["lo2"][r][e][s]
                p.att[i] = int(c.att[r][e][s])
    p.n_corners = len(c.corners)
    for j, (pcx, pcy, ax, ay, kc) in enumerate(c.corners):
        p.corner_x[j], p.corner_y[j] = pcx, pcy
        p.corner_ax[j], p.corner_ay[j], p.corner_k[j] = ax, ay, kc
    for k, d in enumerate(c.dirs):
        p.dir_c[k], p.dir_s[k], p.dir_neg[k] = d.c, d.s, int(d.neg)
    return p


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_bound = None


def signatures() -> dict:
    """The C functions of ``csrc/leg_kernels.cu`` -> their argument types
    (each returns an int: 0 or a CUDA error)."""
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    pci = ctypes.POINTER(ci)
    return {
        # x, y, z, in_stride, out, n, params, stream
        "legmov_reachability": [vp, vp, vp, ll, vp, ll,
                                ctypes.POINTER(_ReachParams), vp],
        # x, y, z, out, n, stream
        "legmov_io_only": [vp, vp, vp, vp, ll, vp],
        # x, y, z, in_stride, ok, dx, dy, dz, out_stride, n, params, stream
        "legmov_distance": [vp, vp, vp, ll, vp, vp, vp, vp, ll, ll,
                            ctypes.POINTER(_DistParams), vp],
        # centers, parent_valid, C, x, y, z, f_stride, F, params, n_params,
        # flags, scratch, audit, args, stream
        "legmov_distance_cells": [vp, vp, ll, vp, vp, vp, ll, ll, vp, ci,
                                  vp, vp, vp, ctypes.POINTER(_CellArgs), vp],
        "legmov_dist_cells_occupancy": [pci] * 5,
        "legmov_param_sizes": [pci] * 3,
    }


def _library():
    """The shared library with argument types set, checked against the
    parameter blocks' sizes."""
    global _bound
    if _bound is not None:
        return _bound
    lib = _build.load_library()
    for name, argtypes in signatures().items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    got = [ctypes.c_int() for _ in range(3)]
    lib.legmov_param_sizes(*[ctypes.byref(g) for g in got])
    want = (ctypes.sizeof(_ReachParams), ctypes.sizeof(_DistParams),
            ctypes.sizeof(_CellArgs))
    if tuple(g.value for g in got) != want:
        raise RuntimeError(
            "parameter blocks of csrc/leg_kernels.cu and ops/cuda_kernels.py "
            f"differ in size: {tuple(g.value for g in got)} bytes in the "
            f"library, {want} here")
    _bound = lib
    return lib


def _check_components(x, y, z):
    """Validate three 1-D float32 components with one common element stride;
    returns ``(n, stride)``."""
    for name, t in (("x", x), ("y", y), ("z", z)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("x, y and z must live on one device")
    n = x.shape[0]
    if y.shape[0] != n or z.shape[0] != n:
        raise ValueError(
            f"x, y and z differ in length: {n}, {y.shape[0]}, {z.shape[0]}")
    if n <= 1:
        return n, 1
    stride = x.stride(0)
    if stride < 1 or y.stride(0) != stride or z.stride(0) != stride:
        raise ValueError(
            "x, y and z need one common positive element stride, got "
            f"{x.stride(0)}, {y.stride(0)}, {z.stride(0)}")
    return n, stride


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def reachability_kernel(x, y, z, consts: ReachConsts,
                        params: _ReachParams | None = None) -> torch.Tensor:
    """Reachability of points given as three ``[N]`` float32 components.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`reachability_kernel_plain`.  The components may be SoA arrays
    (stride 1) or the columns of one ``[N, 3]`` tensor (stride 3).
    """
    n, stride = _check_components(x, y, z)
    if x.device.type == "cpu":
        return reachability_kernel_plain(x, y, z, consts)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty(n, dtype=torch.bool, device=x.device)
    if n == 0:
        return out
    lib = _library()
    if params is None:
        params = reach_params(consts)
    with torch.cuda.device(x.device):
        err = lib.legmov_reachability(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), stride,
            out.data_ptr(), n, ctypes.byref(params), _stream())
    if err != 0:
        raise RuntimeError(f"legmov_reachability launch failed: CUDA error {err}")
    reachability_kernel.launches += 1
    return out


reachability_kernel.launches = 0


def io_only_plain(x, y, z) -> torch.Tensor:
    """Plain version of the io-only kernel: ``(x + y) + z > 0`` in float32
    (NaN gives False)."""
    return (x + y) + z > 0


def io_only_kernel(x, y, z) -> torch.Tensor:
    """The reach probe's io-only floor (``csrc/leg_kernels.cu``
    ``legmov_io_only_kernel``): K1's input and output, three contiguous
    ``[N]`` float32 arrays in and ``[N]`` bool out, ``(x + y) + z > 0`` a
    point, so that its time is the memory floor of K1's access pattern.

    A timing kernel with no path of its own: it launches on CUDA tensors and
    refuses any other (its plain version is :func:`io_only_plain`)."""
    n, stride = _check_components(x, y, z)
    if x.device.type != "cuda":
        raise ValueError(
            f"the io-only kernel runs on the card, got {x.device} tensors "
            "(io_only_plain is its plain version)")
    if stride != 1 or not (x.is_contiguous() and y.is_contiguous()
                           and z.is_contiguous()):
        raise ValueError("the io-only kernel takes contiguous SoA arrays")
    out = torch.empty(n, dtype=torch.bool, device=x.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.legmov_io_only(x.data_ptr(), y.data_ptr(), z.data_ptr(),
                                 out.data_ptr(), n, _stream())
    if err != 0:
        raise RuntimeError(f"legmov_io_only launch failed: CUDA error {err}")
    io_only_kernel.launches += 1
    return out


io_only_kernel.launches = 0


def distance_kernel(x, y, z, consts: DistConsts,
                    params: _DistParams | None = None,
                    interleaved: bool = False):
    """Distance to the workspace boundary for points given as components.

    Returns ``(ok [N] bool, dx, dy, dz [N] float32)``, or with
    ``interleaved`` ``(ok, vec [N, 3])`` written in place by the kernel.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`distance_kernel_plain`.
    """
    n, stride = _check_components(x, y, z)
    if x.device.type == "cpu":
        ok, dx, dy, dz = distance_kernel_plain(x, y, z, consts)
        if interleaved:
            return ok, torch.stack([dx, dy, dz], dim=-1)
        return ok, dx, dy, dz
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ok = torch.empty(n, dtype=torch.bool, device=x.device)
    if interleaved:
        vec = torch.empty((n, 3), dtype=torch.float32, device=x.device)
        comps, out_stride = (vec[:, 0], vec[:, 1], vec[:, 2]), 3
    else:
        vec = torch.empty((3, n), dtype=torch.float32, device=x.device)
        comps, out_stride = (vec[0], vec[1], vec[2]), 1
    if n > 0:
        lib = _library()
        if params is None:
            params = dist_params(consts)
        with torch.cuda.device(x.device):
            err = lib.legmov_distance(
                x.data_ptr(), y.data_ptr(), z.data_ptr(), stride,
                ok.data_ptr(), comps[0].data_ptr(), comps[1].data_ptr(),
                comps[2].data_ptr(), out_stride, n, ctypes.byref(params),
                _stream())
        if err != 0:
            raise RuntimeError(f"legmov_distance launch failed: CUDA error {err}")
        distance_kernel.launches += 1
    if interleaved:
        return ok, vec
    return ok, comps[0], comps[1], comps[2]


distance_kernel.launches = 0


def distance_cells_kernel(centers, parent_valid, footholds, legs: CellLegs,
                          level: CellLevel, k: int, shared: bool, *,
                          audit: torch.Tensor | None = None,
                          chunk: int = 512) -> torch.Tensor:
    """(valid, edge, leaf) flags ``[3, C]`` bool of one identity-level
    batch: ``centers [C, 3]`` float32, ``parent_valid [C]`` bool,
    ``footholds [F, 3]`` float32 (F may be 0; NaN, inf and far rows fail
    the prefilter), all contiguous on one device.

    CUDA tensors launch the cell kernel once (or raise); CPU tensors run
    :func:`distance_cells_plain` (over foothold chunks of ``chunk``).
    ``audit``, an int64 ``[C, 2]`` CUDA tensor, receives per cell the footholds it tested (F) and the
    pairs it sent through the legs (those inside its elongated box)."""
    for name, t, dtype, ndim in (("centers", centers, torch.float32, 2),
                                 ("parent_valid", parent_valid, torch.bool, 1),
                                 ("footholds", footholds, torch.float32, 2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != centers.device:
            raise ValueError("centers, parent_valid and footholds must live "
                             "on one device")
    C = centers.shape[0]
    if centers.shape[1] != 3 or footholds.shape[1] != 3 \
            or parent_valid.shape[0] != C:
        raise ValueError(
            f"centers {tuple(centers.shape)}, parent_valid "
            f"{tuple(parent_valid.shape)}, footholds {tuple(footholds.shape)}: "
            "need [C, 3], [C] and [F, 3]")
    dev = centers.device
    if dev.type == "cpu":
        return distance_cells_plain(centers, parent_valid, footholds, legs,
                                    level, k, shared, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (centers.is_contiguous() and footholds.is_contiguous()
            and parent_valid.is_contiguous()):
        raise ValueError("centers, parent_valid and footholds must be "
                         "contiguous")
    if audit is not None and (audit.dtype != torch.int64
                              or tuple(audit.shape) != (C, 2)
                              or audit.device != dev
                              or not audit.is_contiguous()):
        raise ValueError(f"audit must be a contiguous int64 [{C}, 2] tensor "
                         f"on {dev}")
    flags = torch.empty((3, C), dtype=torch.bool, device=dev)
    if C == 0:
        return flags
    lib = _library()
    params = legs.params_on(dev)
    args = cell_args(legs, level, k, shared)
    scratch = legs.scratch_on(dev, C)
    if audit is not None:
        audit.zero_()
    with torch.cuda.device(dev):
        err = lib.legmov_distance_cells(
            centers.data_ptr(), parent_valid.data_ptr(), C,
            footholds.data_ptr(), footholds.data_ptr() + 4,
            footholds.data_ptr() + 8, 3, footholds.shape[0],
            params.data_ptr(), len(legs.params), flags.data_ptr(),
            scratch.data_ptr(),
            None if audit is None else audit.data_ptr(),
            ctypes.byref(args), _stream())
    if err != 0:
        raise RuntimeError(
            f"legmov_distance_cells launch failed: CUDA error {err}")
    distance_cells_kernel.launches += 1
    return flags


distance_cells_kernel.launches = 0


def dist_cells_occupancy() -> dict:
    """How the card holds the cell kernel: registers and local memory a
    thread, threads and shared memory a block, blocks and warps an SM."""
    lib = _library()
    got = [ctypes.c_int() for _ in range(5)]
    err = lib.legmov_dist_cells_occupancy(*[ctypes.byref(g) for g in got])
    if err != 0:
        raise RuntimeError(
            f"legmov_dist_cells_occupancy failed: CUDA error {err}")
    regs, local, threads, smem, blocks = (g.value for g in got)
    return {"registers": regs, "local_bytes": local, "threads": threads,
            "shared_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}


def _check_points(points):
    if not isinstance(points, torch.Tensor):
        raise TypeError(
            f"points must be a torch.Tensor, got {type(points).__name__}")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {tuple(points.shape)}")
    return points[:, 0], points[:, 1], points[:, 2]


def make_reachability_kernel(leg: LegDimensions):
    """``[N, 3] float32 -> [N] bool`` fused evaluator for ``leg``.

    Semantics of ops/reachability.py ``reachability_xyz`` with the leg's
    workspace as kernel constants.  ``fn(points)`` reads the ``[N, 3]``
    tensor in place (element stride 3); ``fn.soa(x, y, z)`` takes the SoA
    layout of the ``.bin`` protocol.  Both return a ``torch.bool`` tensor on
    the input's device.  ``fn.consts`` holds the constants.
    """
    consts = reach_consts(leg)
    params = reach_params(consts)

    def fn(points: torch.Tensor) -> torch.Tensor:
        return reachability_kernel(*_check_points(points), consts, params)

    def fn_soa(x, y, z) -> torch.Tensor:
        return reachability_kernel(x, y, z, consts, params)

    fn.soa = fn_soa
    fn.consts = consts
    return fn


def make_distance_kernel(leg: LegDimensions):
    """``[N, 3] -> ([N] bool, [N, 3])`` fused distance evaluator for ``leg``.

    Semantics of ops/distance.py ``distance_xyz`` (incl. the pi-flip dual
    evaluation, coxa saturation and the limit-plane alternative) with the
    leg's workspace as kernel constants.  ``fn.soa(x, y, z)`` is SoA in, SoA
    out: ``(ok, dx, dy, dz)`` — the layout of the ``.bin`` file protocol.
    Raises ``ValueError`` for legs the trig-free angle tests cannot serve
    (see :func:`dist_consts`).
    """
    consts = dist_consts(leg)
    params = dist_params(consts)

    def fn(points: torch.Tensor):
        return distance_kernel(*_check_points(points), consts, params,
                               interleaved=True)

    def fn_soa(x, y, z):
        return distance_kernel(x, y, z, consts, params)

    fn.soa = fn_soa
    fn.consts = consts
    return fn

"""Fused multi-leg oriented-DISTANCE item kernel (validity_child twin).

The reference's active positionability path evaluates, per (octree cell,
foothold, orientation, leg), the full distance function and aggregates
reachable-leg counts and boundary-box-crossing counts
(several_leg_octree.cu:19-151 ``validity_child`` calling distance() ->
one_leg_global.cu:253 -> one_leg.cu:321-341).  The item kernel (source:
``csrc/cell_kernels.cu``, ``legmov_item_kernel``) fuses that entire per-item
pipeline — quaternion un-rotation, per-leg azimuth/coxa frames, the dual
pi-branch plane clamp with corners, the coxa-limit-plane alternative, the
elongated-box prefilter, the cell-crossing test, and ALL the reductions —
into one thread's registers per (pose item, candidate).

A pose item is one (cell, orientation) pair of the hierarchical solver.
Per-item quantities ride in a packed ``[P, W]`` table
(:func:`oriented_dist_tables`): a 16-float header (quaternion, item
position, parent-valid, the crossing box, the elongated box) and one
151-float block per leg with the ``[2, 2, 4]`` circle tables, the 10
corners and the region threshold directions of the leg's workspace under
that orientation.  The leg blocks depend on the orientation only
(:func:`leg_blocks`, host numpy, one ``build_workspace`` per (orientation,
leg)), so a solve builds them once and repeats them under per-item headers.
Orientation-independent leg constants (mount azimuth, coxa pitch/length,
coxa yaw limits, the saturation threshold directions) go to the kernels as a
by-value parameter block (:func:`dist_leg_constants`).

The item's arithmetic is written once in plain tensor operations
(:func:`item_head_plain`, :func:`item_leg_plain`) in the kernel's order and
shared by every plain version here and in ops/csr_cell_eval.py.  Two kernels
run it over dense candidates:

* the item form (:func:`multileg_distance_kernel`, ``legmov_item_kernel``):
  ``[P, W]`` items x ``[1 or P, C]`` candidates -> ``[P, 3L + 3]`` bits;
* the cell driver (:func:`item_cells_kernel`, ``legmov_item_cells_kernel``),
  the orientation-active levels of ``cli solve --candidates dense``: a batch
  of cells under the level's ``S`` orientation rows (:func:`level_table`)
  over the batch's footholds -> ``[3, C]`` (valid, edge, leaf) flags, one
  launch a batch (:func:`make_cell_eval_rot`).

Each wrapper runs its plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from legmov_tpu_torch.models.leg import LegDimensions
from legmov_tpu_torch.models.robot import leg_count, leg_of
from legmov_tpu_torch.models.workspace import build_workspace
from legmov_tpu_torch.ops import _build, trig32
from legmov_tpu_torch.ops.orientation import oriented_workspace_items

_f32 = np.float32
_LANES = 128
_PI = _f32(math.pi)
MAX_LEGS = 6

#: per-leg slice layout (offsets relative to the leg block start)
_CX, _CY, _CR, _CR2, _CHI2, _CLO2, _ATT = 0, 16, 32, 48, 64, 80, 96
_CORX, _CORY, _CORV = 112, 122, 132
_MID_DIR, _MID_NEG, _SAT_DIR, _SAT_NEG = 142, 144, 145, 149
LEG_BLOCK = 151
#: header: quat(4) body(3) parent_valid(1) hm(3 = half+margin)
#: h2m(1 = h2+margin) big_cell(1) elong(3 = parent_half+reach)
_HDR = 16

_MARGIN2 = float(_f32(0.001) * _f32(0.001))
_BIG = float(_f32(3.4e38))

#: fp32 adds, multiplies, divides, compares and square roots per (item,
#: candidate), counted from the source as ops/cuda_multileg.py ``leg_flops``
#: is (selects, negations and boolean logic not counted).  Head: relative
#: vector 3, doubled cross product 12, rotated sum 18, box test 6.
HEAD_FLOPS = 39
#: Per leg: mount yaw, coxa frame and heading 20; per finish branch 387
#: (five angle tests 25, rotation 7, region bits 16, four circles validated
#: and clamped 80, 4 x 3 cross-validations 96, circle tournament 4, q 3, ten
#: corners scored and compared 123, merge and result 4, limit-plane
#: alternative and un-rotation 29); branch select 11, un-pitch, un-yaw and
#: body rotation 42, crossing tests 13.
LEG_FLOPS = 20 + 2 * 387 + 66
#: The cell driver's count (:func:`item_cells_flops` of
#: :func:`item_cells_need`): the box test once per (cell, foothold) pair, 3
#: subtractions and 6 compares; the un-rotation (doubled cross product 12,
#: rotated sum 18) once per pair inside the box and orientation.
BOX_FLOPS = 9
UNROTATE_FLOPS = 30


def item_cells_flops(box_tests: int, unrotations: int,
                     leg_pipelines: int) -> int:
    """fp32 operations of a cell batch's counts: :data:`BOX_FLOPS` per box
    test, :data:`UNROTATE_FLOPS` per un-rotation, :data:`LEG_FLOPS` per leg
    pipeline."""
    return (box_tests * BOX_FLOPS + unrotations * UNROTATE_FLOPS
            + leg_pipelines * LEG_FLOPS)


def table_width(n_legs: int) -> int:
    """Floats per item row: header + leg blocks, padded to a multiple of 128
    (the layout the tables are exchanged in)."""
    w = _HDR + n_legs * LEG_BLOCK
    return ((w + _LANES - 1) // _LANES) * _LANES


def _leg_block(ws) -> np.ndarray:
    parts = [
        ws.circle_x.reshape(-1),
        ws.circle_y.reshape(-1),
        ws.circle_r.reshape(-1),
        ws.circle_r2.reshape(-1),
        ws.circle_hi2.reshape(-1),
        ws.circle_lo2.reshape(-1),
        ws.circle_attract.reshape(-1),
        ws.corner_xy[:, 0],
        ws.corner_xy[:, 1],
        ws.corner_valid,
        ws.mid_dir.reshape(-1),
        ws.mid_neg.reshape(-1),
        ws.sat_dir.reshape(-1),
        ws.sat_neg.reshape(-1),
    ]
    return np.concatenate([np.asarray(p, _f32).reshape(-1) for p in parts])


def leg_blocks(quats, robot: LegDimensions) -> np.ndarray:
    """``[S, L * LEG_BLOCK]`` float32 (host): the workspace tables of every
    leg under every orientation, ``build_workspace(rotate_leg_data(q, leg))``
    flattened in the block layout above."""
    q = torch.as_tensor(np.asarray(quats, _f32))
    S, L = q.shape[0], leg_count(robot)
    items = oriented_workspace_items(q, robot)
    out = np.stack([_leg_block(ws) for ws in items])
    return out.reshape(S, L * LEG_BLOCK)


def _header(quats, body_pos, parent_valid, half, parent_half, margin, reach):
    """``[P, 16]`` header columns, float32 arithmetic in the table's order."""
    dev = quats.device
    P = quats.shape[0]
    half = torch.as_tensor(np.asarray(half, _f32), device=dev)
    parent_half = torch.as_tensor(np.asarray(parent_half, _f32), device=dev)
    margin = float(_f32(margin))
    hm = (half + margin)[None, :].expand(P, 3)
    h2 = torch.sum(half * half)
    h2m = (h2 + margin).reshape(1, 1).expand(P, 1)
    bigc = (h2 > 100.0 * 100.0).to(torch.float32).reshape(1, 1).expand(P, 1)
    elong = (parent_half + float(_f32(reach)))[None, :].expand(P, 3)
    return torch.cat(
        [quats, body_pos, parent_valid[:, None].to(torch.float32),
         hm, h2m, bigc, elong], dim=-1)


def tables_from_blocks(blocks, quat_index, quats, body_pos, parent_valid,
                       half, parent_half, margin: float,
                       reach: float) -> torch.Tensor:
    """``[P, table_width(L)]`` item table from ``blocks [S, L * LEG_BLOCK]``
    (a tensor on the items' device) and each item's orientation index."""
    P = quats.shape[0]
    L = blocks.shape[1] // LEG_BLOCK
    tab = torch.zeros((P, table_width(L)), dtype=torch.float32,
                      device=quats.device)
    tab[:, :_HDR] = _header(quats, body_pos, parent_valid, half, parent_half,
                            margin, reach)
    tab[:, _HDR:_HDR + L * LEG_BLOCK] = blocks[quat_index]
    return tab


def level_table(blocks, quats, half, parent_half, margin: float,
                reach: float) -> torch.Tensor:
    """``[S, table_width(L)]`` rows of one level: orientation ``q``'s
    quaternion, the level's header (crossing box, elongated box) and
    ``blocks[q]``; the item position and parent-valid slots are 0 (a cell
    batch brings its own)."""
    S = quats.shape[0]
    dev = quats.device
    return tables_from_blocks(
        blocks, torch.arange(S, device=dev), quats,
        torch.zeros((S, 3), dtype=torch.float32, device=dev),
        torch.zeros(S, dtype=torch.bool, device=dev), half, parent_half,
        margin, reach)


def oriented_dist_tables(body_pos, quats, parent_valid, half, parent_half,
                         robot: LegDimensions, margin: float,
                         reach: float) -> torch.Tensor:
    """``[P, table_width(L)]`` packed per-item scalars, on the quaternions'
    device: one row per pose item with its own orientation (one host
    ``build_workspace`` per (item, leg); callers whose items share a few
    orientations use :func:`leg_blocks` + :func:`tables_from_blocks`)."""
    quats = quats.to(torch.float32)
    dev = quats.device
    blocks = torch.as_tensor(leg_blocks(quats.cpu().numpy(), robot),
                             device=dev)
    idx = torch.arange(quats.shape[0], device=dev)
    return tables_from_blocks(
        blocks, idx, quats, body_pos.to(torch.float32),
        torch.as_tensor(parent_valid, device=dev), half, parent_half,
        margin, reach)


def dist_tables_from_numpy(tab, n_legs: int, device=None) -> torch.Tensor:
    """A ``[P, table_width(L)]`` table built elsewhere (the layout above,
    e.g. another array library's ``oriented_dist_tables`` or
    ``level_tables`` as a numpy array) as a tensor on ``device`` (default
    CPU), so both sides evaluate the same bits."""
    a = np.ascontiguousarray(np.asarray(tab), dtype=_f32)
    if a.ndim != 2 or a.shape[1] != table_width(n_legs):
        raise ValueError(
            f"table must be [P, {table_width(n_legs)}], got {a.shape}")
    return torch.from_numpy(a.copy()).to(device or "cpu")


def dist_leg_constants(robot: LegDimensions) -> list[dict]:
    """Orientation-independent per-leg scalars of the fused distance item
    pipeline (the kernels' by-value parameter block)."""
    half_pi = float(_PI) / 2.0
    legs_const = []
    for i in range(leg_count(robot)):
        leg = leg_of(robot, i)
        ws = build_workspace(leg)
        ba = float(leg.body_angle)
        pitch = float(leg.coxa_pitch)
        max_a = float(ws.max_angle_coxa)
        min_a = float(ws.min_angle_coxa)
        if (abs(max_a + half_pi) >= float(_PI)
                or abs(min_a - half_pi) >= float(_PI)):
            raise ValueError("coxa limits beyond +-pi/2 unsupported")

        angles = [-ba, -pitch, pitch, max_a + half_pi, min_a - half_pi,
                  max_a, min_a, (max_a + min_a) / 2.0]
        sn, cs = trig32.host_sincos(angles)

        def _dir(i):
            return (cs[i], sn[i], bool(_f32(angles[i]) < 0))

        legs_const.append(
            dict(
                ca=cs[0],
                sa=sn[0],
                body=float(leg.body),
                cp=cs[1],
                sp=sn[1],
                cpi=cs[2],
                spi=sn[2],
                coxa_len=float(ws.coxa_length),
                cmax=(float(ws.coxa_max_dir[0]), float(ws.coxa_max_dir[1])),
                cmin=(float(ws.coxa_min_dir[0]), float(ws.coxa_min_dir[1])),
                d_mega_hi=_dir(3),
                d_mega_lo=_dir(4),
                d_max=_dir(5),
                d_min=_dir(6),
                d_mid=_dir(7),
            )
        )
    return legs_const


# ---------------------------------------------------------------------------
# the item in plain tensor operations: the kernels' arithmetic, in their order
# ---------------------------------------------------------------------------

def _bsel(c, a, b):
    return (c & a) | (~c & b)


def _agt_dyn(ax, ay, cos_t, sin_t, neg: bool):
    pos = (ay * cos_t - ax * sin_t) > 0
    nn = ay >= 0
    return (nn | pos) if neg else (nn & pos)


def _alt_dyn(ax, ay, cos_t, sin_t, neg: bool):
    below = ay < 0
    ng = (ay * cos_t - ax * sin_t) < 0
    return (below & ng) if neg else (below | ng)


def item_head_plain(s, x_in, y_in, z_in):
    """``(pre, vx, vy, vz)``: the shared elongated-box prefilter and the
    body-frame candidate vector.  ``s(i)`` returns the per-item scalar at
    index ``i`` of the table layout, broadcastable against the candidates;
    ``x/y/z`` are candidate WORLD coordinates."""
    # candidate relative position, body frame
    rx = x_in - s(4)
    ry = y_in - s(5)
    rz = z_in - s(6)
    w = s(0)
    ux, uy, uz = -s(1), -s(2), -s(3)
    tx = 2.0 * (uy * rz - uz * ry)
    ty = 2.0 * (uz * rx - ux * rz)
    tz = 2.0 * (ux * ry - uy * rx)
    vx = rx + w * tx + (uy * tz - uz * ty)
    vy = ry + w * ty + (uz * tx - ux * tz)
    vz = rz + w * tz + (ux * ty - uy * tx)
    # elongated-box prefilter on the UNROTATED relative vector
    # (isInBox on foothold - cell center, several_leg_octree.cu:76-82)
    pre = (
        (rx > -s(13)) & (rx <= s(13))
        & (ry > -s(14)) & (ry <= s(14))
        & (rz > -s(15)) & (rz <= s(15))
    )
    return pre, vx, vy, vz


def _plane_clamp_plain(ls, xp, yp):
    """ops/plane.py plane_clamp on the (upper, ext) configuration's four
    circles and the ten corners; ``ls(i)`` reads the leg block."""
    nn = yp >= 0
    mid_neg = ls(_MID_NEG) > 0.5
    crossm = (yp * ls(_MID_DIR) - xp * ls(_MID_DIR + 1)) > 0
    upper = _bsel(nn, mid_neg | crossm, mid_neg & crossm)
    lo_neg = ls(_SAT_NEG) > 0.5
    hi_neg = ls(_SAT_NEG + 1) > 0.5
    c_lo = (yp * ls(_SAT_DIR) - xp * ls(_SAT_DIR + 1)) > 0
    c_hi = (yp * ls(_SAT_DIR + 2) - xp * ls(_SAT_DIR + 3)) > 0
    gt_lo = _bsel(nn, lo_neg | c_lo, lo_neg & c_lo)
    gt_hi = _bsel(nn, hi_neg | c_hi, hi_neg & c_hi)
    ext = upper ^ _bsel(upper, gt_hi, gt_lo)

    def pick(base, slot):
        def t(r, e):
            return ls(base + r * 8 + e * 4 + slot)

        hi = torch.where(ext, t(1, 1), t(1, 0))
        lo = torch.where(ext, t(0, 1), t(0, 0))
        return torch.where(upper, hi, lo)

    overall = None
    best_s2 = torch.full_like(xp, _BIG)
    best_x = torch.zeros_like(xp)
    best_y = torch.zeros_like(xp)
    cxs, cys, r2s, hi2s, lo2s, atts = [], [], [], [], [], []
    clamps, scores = [], []
    for slot in range(4):
        cx = pick(_CX, slot)
        cy = pick(_CY, slot)
        r = pick(_CR, slot)
        r2 = pick(_CR2, slot)
        hi2 = pick(_CHI2, slot)
        lo2 = pick(_CLO2, slot)
        att = pick(_ATT, slot) > 0.5
        dx = xp - cx
        dy = yp - cy
        d2 = dx * dx + dy * dy
        inside = d2 <= r2
        near = (d2 < hi2) & (d2 > lo2)
        valid = _bsel(att, inside, ~inside) | near
        overall = valid if overall is None else overall & valid
        deg = d2 < _MARGIN2
        rinv = torch.rsqrt(torch.where(deg, 1.0, d2))
        mag = d2 * rinv
        scale = r * rinv
        clamps.append((cx + torch.where(deg, 1.0, dx) * scale,
                       cy + torch.where(deg, 0.0, dy) * scale))
        scores.append((r - mag) * (r - mag))
        cxs.append(cx)
        cys.append(cy)
        r2s.append(r2)
        hi2s.append(hi2)
        lo2s.append(lo2)
        atts.append(att)
    for sl in range(4):
        cx, cy = clamps[sl]
        okc = None
        for t in range(4):
            if t == sl:
                continue
            dx = cx - cxs[t]
            dy = cy - cys[t]
            d2 = dx * dx + dy * dy
            inside = d2 <= r2s[t]
            near = (d2 < hi2s[t]) & (d2 > lo2s[t])
            good = _bsel(atts[t], inside, ~inside) | near
            okc = good if okc is None else okc & good
        s2 = torch.where(okc, scores[sl], _BIG)
        take = s2 < best_s2
        best_s2 = torch.where(take, s2, best_s2)
        best_x = torch.where(take, cx, best_x)
        best_y = torch.where(take, cy, best_y)
    invalid = ~overall
    q = xp * xp + yp * yp
    c_s2 = c_x = c_y = None
    for j in range(10):
        pcx = ls(_CORX + j)
        pcy = ls(_CORY + j)
        pok = ls(_CORV + j) > 0.5
        s2 = q - 2.0 * pcx * xp - 2.0 * pcy * yp + pcx * pcx + pcy * pcy
        s2 = torch.where(pok, s2, _BIG)
        if c_s2 is None:
            c_s2, c_x, c_y = s2, pcx + 0.0 * xp, pcy + 0.0 * xp
        else:
            take = s2 < c_s2
            c_s2 = torch.where(take, s2, c_s2)
            c_x = torch.where(take, pcx, c_x)
            c_y = torch.where(take, pcy, c_y)
    take = invalid & (c_s2 < best_s2)
    best_s2 = torch.where(take, c_s2, best_s2)
    best_x = torch.where(take, c_x, best_x)
    best_y = torch.where(take, c_y, best_y)
    found = best_s2 < _BIG
    out_x = xp - torch.where(found, best_x, 0.0)
    out_y = yp - torch.where(found, best_y, 0.0)
    return overall, out_x, out_y


def item_leg_plain(s, l: int, c: dict, pre, vx, vy, vz):
    """``(okp, crossed)`` of leg ``l``: the full distance pipeline on the
    body-frame candidate vector, the vector back in the world frame, and the
    crossing test against the item's cell box; both gated by ``pre``."""
    off = _HDR + l * LEG_BLOCK
    hmx, hmy, hmz = s(8), s(9), s(10)
    h2m = s(11)
    bigc = s(12) > 0.5

    def ls(i):
        return s(off + i)

    # yaw to "as if leg 0", then coxa frame
    x0 = vx * c["ca"] - vy * c["sa"]
    y0 = vx * c["sa"] + vy * c["ca"]
    px = x0 - c["body"]
    x = px * c["cp"] - vz * c["sp"]
    z = px * c["sp"] + vz * c["cp"]
    y = y0
    rho = trig32.sqrt(x * x + y * y)
    on_axis = rho == 0
    inv = torch.where(on_axis, 1.0, rho)
    cos_a = torch.where(on_axis, 1.0, x / inv)
    sin_a = torch.where(on_axis, 0.0, y / inv)

    def finish(ca_, sa_, flipped):
        ax = -x if flipped else x
        ay = -y if flipped else y
        mega = _agt_dyn(ax, ay, *c["d_mega_hi"]) | _alt_dyn(
            ax, ay, *c["d_mega_lo"])
        over = _agt_dyn(ax, ay, *c["d_max"])
        under = _alt_dyn(ax, ay, *c["d_min"])
        saturated = mega | over | under
        c1 = torch.where(
            mega, -ca_,
            torch.where(over, c["cmax"][0],
                        torch.where(under, c["cmin"][0], ca_)))
        s1 = torch.where(
            mega, -sa_,
            torch.where(over, c["cmax"][1],
                        torch.where(under, c["cmin"][1], sa_)))
        xr = x * c1 + y * s1
        yr = -x * s1 + y * c1
        was_valid, dxp, dzp = _plane_clamp_plain(ls, xr - c["coxa_len"], z)
        use_max = _agt_dyn(ax, ay, *c["d_mid"])
        cl = torch.where(use_max, c["cmax"][0], c["cmin"][0])
        sl_ = torch.where(use_max, c["cmax"][1], c["cmin"][1])
        c2 = cl * c1 + sl_ * s1
        s2_ = sl_ * c1 - cl * s1
        ys = -xr * s2_ + yr * c2
        d2c = dxp * dxp + yr * yr + dzp * dzp
        better = was_valid & ~mega & (d2c > ys * ys)
        fx = torch.where(better, -ys * s2_, dxp)
        fy = torch.where(better, ys * c2, yr)
        fz = torch.where(better, 0.0, dzp)
        gx = fx * c1 - fy * s1
        gy = fx * s1 + fy * c1
        return was_valid & ~saturated, gx, gy, fz

    res, dx, dy, dz = finish(cos_a, sin_a, False)
    resf, fx, fy, fz = finish(-cos_a, -sin_a, True)
    d2d = dx * dx + dy * dy + dz * dz
    d2f = fx * fx + fy * fy + fz * fz
    use_d = _bsel(res == resf, d2d < d2f, res)
    ox = torch.where(use_d, dx, fx)
    oy = torch.where(use_d, dy, fy)
    oz = torch.where(use_d, dz, fz)
    ok = res | resf
    # vector back: coxa pitch inverse, yaw +azimuth, then the body
    # quaternion (dv is compared against the AXIS-ALIGNED cell box in the
    # world frame)
    wx0 = ox * c["cpi"] - oz * c["spi"]
    wz0 = ox * c["spi"] + oz * c["cpi"]
    wx1 = wx0 * c["ca"] + oy * c["sa"]
    wy1 = -wx0 * c["sa"] + oy * c["ca"]
    # rotate by q (not conjugate): v_world = q (v_body) q^-1
    qw, qx, qy, qz = s(0), s(1), s(2), s(3)
    t2x = 2.0 * (qy * wz0 - qz * wy1)
    t2y = 2.0 * (qz * wx1 - qx * wz0)
    t2z = 2.0 * (qx * wy1 - qy * wx1)
    wvx = wx1 + qw * t2x + (qy * t2z - qz * t2y)
    wvy = wy1 + qw * t2y + (qz * t2x - qx * t2z)
    wvz = wz0 + qw * t2z + (qx * t2y - qy * t2x)
    cross_big = (
        (wvx > -hmx) & (wvx <= hmx)
        & (wvy > -hmy) & (wvy <= hmy)
        & (wvz > -hmz) & (wvz <= hmz)
    )
    dv2 = wvx * wvx + wvy * wvy + wvz * wvz
    cross_small = dv2 < h2m
    crossed = _bsel(bigc, cross_big, cross_small) & pre
    okp = ok & pre
    return okp, crossed


def item_math_plain(s, consts, x_in, y_in, z_in):
    """``(pre, [(okp, crossed) per leg])``: head and every leg."""
    pre, vx, vy, vz = item_head_plain(s, x_in, y_in, z_in)
    outs = [item_leg_plain(s, l, c, pre, vx, vy, vz)
            for l, c in enumerate(consts)]
    return pre, outs


#: items x candidates one pass of the plain version holds at a time (it
#: keeps some hundred temporaries of that size alive)
_PLAIN_TILE = 1 << 22


def multileg_distance_kernel_plain(tab, gx, gy, gz, consts, k: int,
                                   work=None) -> torch.Tensor:
    """Plain PyTorch version of the item kernel: ``tab [P, W]``, ``gx, gy,
    gz [P, C]`` or ``[1, C]`` (one candidate row shared by every item)
    float32 -> ``[P, 3L + 3]`` bool, columns

    * ``l`` (l < L): leg l has some candidate with ``ok & pre``;
    * ``L + l``: some candidate ``ok & ~cross & pre`` (certainly valid
      across the cell, per-leg-rule edge bands);
    * ``2L + l``: some candidate ``(ok | cross) & pre``;
    * ``3L``: some candidate item is valid
      (``(reach_count >= k) | parent_valid``) under ``pre``;
    * ``3L + 1``: some item is on-edge (``cross_count > L - k``);
    * ``3L + 2``: some item is a valid non-edge leaf.

    ``work``, when given a dict, receives ``pairs`` (items x candidates) and
    ``pre_pairs`` (those inside the elongated box: the only ones whose legs
    can contribute), as Python ints.
    """
    P = tab.shape[0]
    C = gx.shape[1]
    L = len(consts)
    out = torch.zeros((P, 3 * L + 3), dtype=torch.bool, device=tab.device)
    n_pre = torch.zeros((), dtype=torch.int64, device=tab.device)
    rows = max(1, _PLAIN_TILE // max(C, 1))
    shared_row = gx.shape[0] == 1
    for lo in range(0, P if C else 0, rows):
        t = tab[lo:lo + rows]
        sl = slice(0, 1) if shared_row else slice(lo, lo + rows)

        def s(i, t=t):
            return t[:, i:i + 1]

        pre, outs = item_math_plain(s, consts, gx[sl], gy[sl], gz[sl])
        n_pre += pre.sum()
        pvalid = s(7) > 0.5
        reach_cnt = sum(okp.to(torch.float32) for okp, _ in outs)
        cross_cnt = sum(cr.to(torch.float32) for _, cr in outs)
        # reach_cnt is already pre-gated; parent_valid must not leak
        # through pre-rejected items either
        item_valid = ((reach_cnt >= float(k)) | pvalid) & pre
        item_edge = (cross_cnt > float(L - k)) & pre
        o = out[lo:lo + rows]
        for l, (okp, crossed) in enumerate(outs):
            o[:, l] = okp.any(dim=1)
            o[:, L + l] = (okp & ~crossed).any(dim=1)
            o[:, 2 * L + l] = (okp | crossed).any(dim=1)
        o[:, 3 * L] = item_valid.any(dim=1)
        o[:, 3 * L + 1] = item_edge.any(dim=1)
        o[:, 3 * L + 2] = (item_valid & ~item_edge).any(dim=1)
    if work is not None:
        work["pairs"] = P * C
        work["pre_pairs"] = int(n_pre)
    return out


# ---------------------------------------------------------------------------
# parameter block, field for field as in csrc/cell_kernels.cu
# ---------------------------------------------------------------------------

class _ItemParams(ctypes.Structure):
    _fields_ = [
        ("n_legs", ctypes.c_int), ("table_width", ctypes.c_int),
        ("k", ctypes.c_int), ("balls", ctypes.c_int),
        ("margin2", ctypes.c_float), ("big", ctypes.c_float),
        ("ca", ctypes.c_float * MAX_LEGS), ("sa", ctypes.c_float * MAX_LEGS),
        ("body", ctypes.c_float * MAX_LEGS),
        ("cp", ctypes.c_float * MAX_LEGS), ("sp", ctypes.c_float * MAX_LEGS),
        ("cpi", ctypes.c_float * MAX_LEGS), ("spi", ctypes.c_float * MAX_LEGS),
        ("coxa_len", ctypes.c_float * MAX_LEGS),
        ("cmax_c", ctypes.c_float * MAX_LEGS),
        ("cmax_s", ctypes.c_float * MAX_LEGS),
        ("cmin_c", ctypes.c_float * MAX_LEGS),
        ("cmin_s", ctypes.c_float * MAX_LEGS),
        # threshold directions mega_hi, mega_lo, max, min, mid per leg
        ("dir_c", ctypes.c_float * (MAX_LEGS * 5)),
        ("dir_s", ctypes.c_float * (MAX_LEGS * 5)),
        ("dir_neg", ctypes.c_int * (MAX_LEGS * 5)),
        # K6b's per-element reach balls (ops/csr_cell_eval.py
        # ball_params); K6b refuses a block whose ``balls`` is 0
        ("ball_x", ctypes.c_float * MAX_LEGS),
        ("ball_y", ctypes.c_float * MAX_LEGS),
        ("ball_z", ctypes.c_float * MAX_LEGS),
        ("ball_ok2", ctypes.c_float * MAX_LEGS),
        ("ball_in2", ctypes.c_float * MAX_LEGS),
    ]


_DIRS = ("d_mega_hi", "d_mega_lo", "d_max", "d_min", "d_mid")


def item_params(consts, k: int) -> _ItemParams:
    """The kernels' parameter block for ``consts``
    (:func:`dist_leg_constants`) and quorum ``k``."""
    L = len(consts)
    if not 1 <= L <= MAX_LEGS:
        raise ValueError(f"the kernels take 1 to {MAX_LEGS} legs, got {L}")
    p = _ItemParams()
    p.n_legs, p.table_width, p.k = L, table_width(L), int(k)
    p.margin2, p.big = _MARGIN2, _BIG
    for i, c in enumerate(consts):
        p.ca[i], p.sa[i], p.body[i] = c["ca"], c["sa"], c["body"]
        p.cp[i], p.sp[i] = c["cp"], c["sp"]
        p.cpi[i], p.spi[i] = c["cpi"], c["spi"]
        p.coxa_len[i] = c["coxa_len"]
        p.cmax_c[i], p.cmax_s[i] = c["cmax"]
        p.cmin_c[i], p.cmin_s[i] = c["cmin"]
        for d, name in enumerate(_DIRS):
            cos_t, sin_t, neg = c[name]
            p.dir_c[i * 5 + d], p.dir_s[i * 5 + d] = cos_t, sin_t
            p.dir_neg[i * 5 + d] = int(neg)
    return p


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_bound = None


def signatures() -> dict:
    """The C functions of ``csrc/cell_kernels.cu`` -> their argument types
    (each returns an int: 0 or a CUDA error)."""
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    pp = ctypes.POINTER(_ItemParams)
    # chunk starts, lengths, role bytes, tot, cellinfo, legtab, xs, ys, zs
    queue = [vp] * 9
    return {
        # tab, gx, gy, gz, P, C, shared_row, out_bits, params, stream
        "legmov_item": [vp, vp, vp, vp, ll, ll, ci, vp, pp, vp],
        # legtab, S, centers, parent_valid, C, x, y, z, f_stride, F, shared,
        # flags, scratch, params, stream
        "legmov_item_cells": [vp, ci, vp, vp, ll, vp, vp, vp, ll, ll, ci, vp,
                              vp, pp, vp],
        # queue, out, C, CH, S, window, shared, params, stream
        "legmov_cell_quat_major": queue + [vp, ll, ll, ci, ci, ci, pp, vp],
        # queue, out, C, CH, S, window, params, stream
        "legmov_cell_shared": queue + [vp, ll, ll, ci, ci, pp, vp],
        # queue, out, C, CH, S, window, params, stream
        "legmov_cell_cm_perleg": queue + [vp, ll, ll, ci, ci, pp, vp],
        "legmov_cell_layout": [ctypes.POINTER(ci)] * 4,
        # form, legs, window, then five results
        "legmov_cell_occupancy": [ci, ci, ci] + [ctypes.POINTER(ci)] * 5,
    }


def library():
    """The shared library of ``csrc/cell_kernels.cu`` with argument types
    set, checked against the parameter block's size and the table layout."""
    global _bound
    if _bound is not None:
        return _bound
    lib = _build.load_library("cell_kernels")
    for name, argtypes in signatures().items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    got = [ctypes.c_int() for _ in range(4)]
    lib.legmov_cell_layout(*[ctypes.byref(g) for g in got])
    want = (ctypes.sizeof(_ItemParams), _HDR, LEG_BLOCK, OUT_WORDS)
    if tuple(g.value for g in got) != want:
        raise RuntimeError(
            "csrc/cell_kernels.cu and ops/cuda_multileg_dist.py disagree on "
            "the parameter block, the table layout or the output width: "
            f"{tuple(g.value for g in got)} in the library, {want} here")
    _bound = lib
    return lib


#: int32 words per cell the cell-evaluation kernels write: flags
#: (valid, edge, leaf), the three work counters, the four element counters
OUT_WORDS = 10

#: the kernels of ``csrc/cell_kernels.cu``, as :func:`occupancy` names them
KERNEL_FORMS = ("item", "cell_quat_major", "cell_shared", "cell_cm_perleg",
                "item_cells", "item_cells_shared")


def occupancy(form: str, n_legs: int, window: int = 0) -> dict:
    """How the card holds kernel ``form`` (one of :data:`KERNEL_FORMS`)
    launched for ``n_legs`` legs and chunks of ``window`` elements (for
    the cell driver, ``item_cells`` under the per-leg rule and
    ``item_cells_shared`` under the shared rule: ``window`` orientations):
    registers and local memory (spills and stack) a thread, threads and
    shared memory a block, blocks and warps an SM."""
    lib = library()
    got = [ctypes.c_int() for _ in range(5)]
    err = lib.legmov_cell_occupancy(KERNEL_FORMS.index(form), n_legs,
                                    window, *[ctypes.byref(g) for g in got])
    if err != 0:
        raise RuntimeError(f"legmov_cell_occupancy failed: CUDA error {err}")
    regs, local, threads, smem, blocks = (g.value for g in got)
    return {"registers": regs, "local_bytes": local, "threads": threads,
            "shared_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_tensor(name, t, dtype, ndim, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} lives on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bits_to_bool(bits: torch.Tensor, n: int) -> torch.Tensor:
    shifts = torch.arange(n, device=bits.device, dtype=torch.int32)
    return ((bits[:, None] >> shifts[None, :]) & 1) != 0


def multileg_distance_kernel(tab, gx, gy, gz, consts, k: int,
                             params=None) -> torch.Tensor:
    """The fused ``validity_child`` item evaluation: ``tab [P, W]`` from
    :func:`oriented_dist_tables`, ``gx, gy, gz [P, C]`` candidate world
    coordinates per item, or ``[1, C]`` shared by every item -> ``[P, 3L +
    3]`` bool (columns as in :func:`multileg_distance_kernel_plain`).

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version.  Any ``P >= 0`` and ``C >= 0``; an empty axis launches nothing.
    """
    L = len(consts)
    check_tensor("tab", tab, torch.float32, 2)
    for name, t in (("gx", gx), ("gy", gy), ("gz", gz)):
        check_tensor(name, t, torch.float32, 2, tab.device)
        if t.shape != gx.shape:
            raise ValueError("gx, gy and gz differ in shape")
    P = tab.shape[0]
    rows, C = gx.shape
    if tab.shape[1] != table_width(L):
        raise ValueError(
            f"tab must be [P, {table_width(L)}], got {tuple(tab.shape)}")
    if rows != P and rows != 1:
        raise ValueError(
            f"candidates must have {P} rows or 1 shared row, got {rows}")
    if tab.device.type == "cpu":
        return multileg_distance_kernel_plain(tab, gx, gy, gz, consts, k)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    bits = torch.zeros(P, dtype=torch.int32, device=tab.device)
    if P == 0 or C == 0:
        return _bits_to_bool(bits, 3 * L + 3)
    lib = library()
    if params is None:
        params = item_params(consts, k)
    elif params.k != k:
        raise ValueError("parameter block was built for a different quorum")
    with torch.cuda.device(tab.device):
        err = lib.legmov_item(
            tab.data_ptr(), gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
            P, C, int(rows == 1), bits.data_ptr(),
            ctypes.byref(params), stream())
    if err != 0:
        raise RuntimeError(f"legmov_item launch failed: CUDA error {err}")
    multileg_distance_kernel.launches += 1
    return _bits_to_bool(bits, 3 * L + 3)


multileg_distance_kernel.launches = 0


def make_multileg_distance_kernel(robot: LegDimensions,
                                  cand_cols: int | None = None, *, k: int):
    """Kernel factory for a fixed robot and quorum.

    Returns ``fn(tab [P, W], gx, gy, gz [P, C] or [1, C]) -> [P, 3L + 3]
    bool`` (see :func:`multileg_distance_kernel`).  ``cand_cols``, when
    given, is the one candidate width the caller will use and is checked on
    every call.  ``fn.consts`` holds the leg constants, ``fn.plain`` the
    plain version with them bound."""
    consts = dist_leg_constants(robot)
    params = item_params(consts, k)

    def fn(tab, gx, gy, gz):
        if cand_cols is not None and gx.shape[-1] != cand_cols:
            raise ValueError(
                f"candidate width {gx.shape[-1]} != cand_cols {cand_cols}")
        return multileg_distance_kernel(tab, gx, gy, gz, consts, k, params)

    def plain(tab, gx, gy, gz, work=None):
        return multileg_distance_kernel_plain(tab, gx, gy, gz, consts, k,
                                              work)

    fn.consts = consts
    fn.plain = plain
    fn.k = k
    return fn


def item_rows(centers, parent_valid, legtab) -> torch.Tensor:
    """``[C * S, W]`` rows of the (cell, orientation) items of a batch,
    cell-major: the level's rows ``legtab [S, W]`` with each cell's centre
    and parent-valid written in."""
    C, S = centers.shape[0], legtab.shape[0]
    tab = legtab.repeat(C, 1)
    tab[:, 4:7] = centers.repeat_interleave(S, dim=0)
    tab[:, 7] = parent_valid.repeat_interleave(S).to(torch.float32)
    return tab


def fold_item_lanes(lanes, parent_valid, S: int, k: int,
                    shared: bool) -> torch.Tensor:
    """(valid, edge, leaf) ``[3, C]`` bool from the item lanes ``[C * S, 3L
    + 3]`` (cell-major, as :func:`multileg_distance_kernel_plain` gives
    them): under the shared rule the any over the orientations, under the
    per-leg rule the leg counts of each orientation
    (``models/hier_solver.py`` ``_eval_cells``)."""
    L = (lanes.shape[1] - 3) // 3
    lanes = lanes.reshape(-1, S, 3 * L + 3)
    if shared:
        any_valid = lanes[:, :, 3 * L].any(dim=1)
        any_edge = lanes[:, :, 3 * L + 1].any(dim=1)
        any_leaf = lanes[:, :, 3 * L + 2].any(dim=1)
    else:
        counts = lanes[:, :, :L].sum(dim=-1)  # [C, S]
        n_min = lanes[:, :, L:2 * L].sum(dim=-1)
        n_max = lanes[:, :, 2 * L:3 * L].sum(dim=-1)
        any_valid = (counts >= k).any(dim=1) | parent_valid
        any_edge = ((n_min < k) & (n_max >= k)).any(dim=1)
        any_leaf = any_valid & ~any_edge
    return torch.stack([any_valid, any_edge, any_leaf])


def item_cells_plain(centers, parent_valid, footholds, legtab, consts,
                     k: int, shared: bool, *,
                     cand_chunk: int = 2048) -> torch.Tensor:
    """Plain PyTorch version of the cell driver: (valid, edge, leaf) flags
    ``[3, C]`` bool of a batch of cells (``centers [C, 3]``,
    ``parent_valid [C]`` bool) under the level's orientation rows ``legtab
    [S, W]`` (:func:`level_table`) over ``footholds [F, 3]``.

    The (cell, orientation) items (:func:`item_rows`) run through the
    item's plain version over foothold windows of ``cand_chunk`` shared by
    every item, and their lanes fold into the flags
    (:func:`fold_item_lanes`)."""
    C, S = centers.shape[0], legtab.shape[0]
    L = len(consts)
    tab = item_rows(centers, parent_valid, legtab)
    lanes = torch.zeros((C * S, 3 * L + 3), dtype=torch.bool,
                        device=centers.device)
    fx, fy, fz = (footholds[:, i].contiguous()[None, :] for i in range(3))
    for lo in range(0, footholds.shape[0], cand_chunk):
        g = [f[:, lo:lo + cand_chunk].contiguous() for f in (fx, fy, fz)]
        lanes |= multileg_distance_kernel_plain(tab, *g, consts, k)
    return fold_item_lanes(lanes, parent_valid, S, k, shared)


def item_cells_need(centers, parent_valid, footholds, legtab, consts,
                    k: int, shared: bool) -> torch.Tensor:
    """What the cell driver's batch needs to decide its flags, from the
    plain item's bits: int64 ``[3]`` on the batch's device, the box tests,
    the un-rotations and the leg pipelines of a walk over each cell's
    footholds in order.

    The walk box-tests footholds until the cell is settled (every foothold
    if it never is), un-rotates each pair inside the box once per
    orientation and runs the item's leg pipelines on it:

    * shared rule: the cell is settled once valid, edge and leaf are all
      seen; a pair runs every orientation's L legs, except that after the
      pair that sets edge, with no valid parent, an item's legs stop once it
      cannot reach ``k`` (such an item gives neither valid nor leaf);
    * per-leg rule: a leg of an orientation is settled once ok and ok & ~
      crossed are seen (no pair can change its three bits); a pair runs the
      unsettled legs of the orientations with one, and the cell is settled
      once every (orientation, leg) is."""
    C, S, F = centers.shape[0], legtab.shape[0], footholds.shape[0]
    L = len(consts)
    dev = centers.device
    need = torch.zeros(3, dtype=torch.int64, device=dev)
    if C == 0 or F == 0:
        return need
    # the (cell, foothold) pairs inside the box, cell-major, footholds in
    # order: the box test of the kernel on r = f - c
    e = legtab[0, 13:16]
    keys = []
    for lo in range(0, F, 1 << 12):
        r = footholds[None, lo:lo + (1 << 12)] - centers[:, None]
        cell, foot = ((r > -e) & (r <= e)).all(dim=-1).nonzero(as_tuple=True)
        keys.append(cell * F + foot + lo)
    key = torch.sort(torch.cat(keys)).values
    cell, foot = key // F, key % F
    n = key.shape[0]
    per_cell = torch.bincount(cell, minlength=C)
    start = torch.cumsum(per_cell, 0) - per_cell
    big = torch.iinfo(torch.int64).max
    # leg bits of every pair and orientation: ok at bit l, crossed at L + l
    bits = torch.zeros((S, n), dtype=torch.int32, device=dev)
    r = footholds[foot] - centers[cell]
    step = max(1, _PLAIN_TILE // S)
    for lo in range(0, n, step):
        g = [r[None, lo:lo + step, i] for i in range(3)]
        _, outs = item_math_plain(lambda i: legtab[:, i:i + 1], consts, *g)
        for l, (ok, crossed) in enumerate(outs):
            bits[:, lo:lo + step] |= ((ok.to(torch.int32) << l)
                                      | (crossed.to(torch.int32) << (L + l)))
    pos = torch.arange(n, device=dev)

    def first(mask):
        """[C]: the first pair of each cell where ``mask [n]`` holds."""
        return torch.full((C,), big, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, cell, torch.where(mask, pos, big), "amin")

    def upto(last):
        """[n]: the pair is at or before its cell's pair ``last [C]``."""
        return pos <= last[cell]

    def done(last):
        """[C]: footholds box-tested up to and including pair ``last``."""
        hit = last < big
        f = foot[torch.where(hit, last, 0)] if n else last
        return torch.where(hit, f + 1, F)

    ok = bits & ((1 << L) - 1)
    crossed = bits >> L
    if shared:
        pv = parent_valid[cell]
        iv = (sum((ok >> l) & 1 for l in range(L)) >= k) | pv
        ie = sum((crossed >> l) & 1 for l in range(L)) > L - k
        seen = [first(iv.any(dim=0)), first(ie.any(dim=0)),
                first((iv & ~ie).any(dim=0))]
        last = torch.maximum(torch.maximum(seen[0], seen[1]), seen[2])
        take = upto(last)
        # the leg chain: after the pair that sets edge, no valid parent
        chain = take & ~pv & (pos > seen[1][cell])
        legs = torch.full((S, n), L, dtype=torch.int64, device=dev)
        got = torch.zeros((S, n), dtype=torch.int64, device=dev)
        for l in range(L - 1):
            got += (ok >> l) & 1
            legs -= (chain & (got + (L - 1 - l) < k)).to(torch.int64)
        need[1] = take.sum() * S
        need[2] = (legs * take).sum()
    else:
        # per (orientation, leg): the pair that settles it
        settle = torch.full((S, L, C), big, dtype=torch.int64, device=dev)
        for q in range(S):
            for l in range(L):
                o = ((ok[q] >> l) & 1) != 0
                mn = o & (((crossed[q] >> l) & 1) == 0)
                settle[q, l] = torch.maximum(first(o), first(mn))
        row = settle.amax(dim=1)  # [S, C]
        last = row.amax(dim=0)
        need[1] = sum(upto(row[q]).sum() for q in range(S))
        need[2] = sum(upto(settle[q, l]).sum()
                      for q in range(S) for l in range(L))
    need[0] = done(last).sum()
    return need


def item_cells_kernel(centers, parent_valid, footholds, legtab, consts,
                      k: int, shared: bool, *, params=None,
                      cand_chunk: int = 2048) -> torch.Tensor:
    """(valid, edge, leaf) flags ``[3, C]`` bool of one orientation-active
    batch, see :func:`item_cells_plain` for the arguments (all contiguous,
    on one device; F may be 0; NaN, inf and far footholds fail the box).

    CUDA tensors launch the cell driver once (or raise); CPU tensors run
    :func:`item_cells_plain` (over foothold windows of ``cand_chunk``)."""
    L = len(consts)
    for name, t, dtype, ndim in (("centers", centers, torch.float32, 2),
                                 ("parent_valid", parent_valid, torch.bool, 1),
                                 ("footholds", footholds, torch.float32, 2)):
        check_tensor(name, t, dtype, ndim, centers.device)
    check_tensor("legtab", legtab, torch.float32, 2, centers.device)
    C, S = centers.shape[0], legtab.shape[0]
    if centers.shape[1] != 3 or footholds.shape[1] != 3 \
            or parent_valid.shape[0] != C:
        raise ValueError(
            f"centers {tuple(centers.shape)}, parent_valid "
            f"{tuple(parent_valid.shape)}, footholds {tuple(footholds.shape)}: "
            "need [C, 3], [C] and [F, 3]")
    if legtab.shape[1] != table_width(L) or S < 1:
        raise ValueError(f"legtab must be [S >= 1, {table_width(L)}], got "
                         f"{tuple(legtab.shape)}")
    dev = centers.device
    if dev.type == "cpu":
        return item_cells_plain(centers, parent_valid, footholds, legtab,
                                consts, k, shared, cand_chunk=cand_chunk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    flags = torch.empty((3, C), dtype=torch.bool, device=dev)
    if C == 0:
        return flags
    lib = library()
    if params is None:
        params = item_params(consts, k)
    elif params.k != k:
        raise ValueError("parameter block was built for a different quorum")
    # where the splits of a cell meet: S + 1 words a cell, zero
    scratch = torch.zeros(C * (S + 1), dtype=torch.int32, device=dev)
    f = footholds.data_ptr()
    with torch.cuda.device(dev):
        err = lib.legmov_item_cells(
            legtab.data_ptr(), S, centers.data_ptr(), parent_valid.data_ptr(),
            C, f, f + 4, f + 8, 3, footholds.shape[0], int(shared),
            flags.data_ptr(), scratch.data_ptr(), ctypes.byref(params),
            stream())
    if err != 0:
        raise RuntimeError(f"legmov_item_cells launch failed: CUDA error {err}")
    item_cells_kernel.launches += 1
    return flags


item_cells_kernel.launches = 0


def make_cell_eval_rot(robot: LegDimensions, k: int, cand_chunk: int = 2048,
                       plain: bool = False):
    """Orientation-active ``_eval_cells`` twin on K5's cell driver.

    Same contract as models/hier_solver.py ``_eval_cells``: one call is one
    launch of :func:`item_cells_kernel` on a card and its plain version on
    the CPU (foothold windows of ``cand_chunk``); ``plain`` asks for the
    plain version on any device.  The leg blocks of the orientation samples
    are built once and kept for as long as the same quaternion tensor (the
    same storage, unchanged) comes in, the level's rows for as long as the
    same level does, so a batch reads nothing back from the device."""
    consts = dist_leg_constants(robot)
    params = item_params(consts, k)
    quorum_k = k
    cache: dict = {}

    def eval_cells(centers, parent_valid, half, parent_half, footholds,
                   quats, robot_=None, k: int = quorum_k, margin: float = 0.0,
                   reach: float = 0.0, chunk: int = 0, use_rot: bool = True,
                   shared: bool = True):
        del robot_, chunk, use_rot
        if k != quorum_k:
            raise ValueError("kernel was built for a different quorum")
        dev = centers.device
        key = (quats.data_ptr(), tuple(quats.shape), tuple(quats.stride()),
               quats._version, str(dev))
        if cache.get("key") != key:
            cache.clear()
            # the tensor is held, so no other one takes its storage
            cache.update(key=key, quats=quats, blocks=torch.as_tensor(
                leg_blocks(quats.cpu().numpy(), robot), device=dev))
        level = (np.asarray(half, _f32).tobytes(),
                 np.asarray(parent_half, _f32).tobytes(), float(margin),
                 float(reach))
        if level not in cache:
            cache[level] = level_table(cache["blocks"], quats.to(dev), half,
                                       parent_half, margin, reach)
        args = (centers, parent_valid, footholds.contiguous(), cache[level],
                consts, k, shared)
        if plain:
            flags = item_cells_plain(*args, cand_chunk=cand_chunk)
        else:
            flags = item_cells_kernel(*args, params=params,
                                      cand_chunk=cand_chunk)
        return flags.unbind(0)

    return eval_cells

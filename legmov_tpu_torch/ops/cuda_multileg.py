"""Fused multi-leg oriented-reachability CUDA kernels.

The positionability hot loop evaluates, for every (pose, candidate
foothold), all L legs' reachability under the pose's body orientation.  The
plain-tensor path (ops/orientation.py) materializes ``[P, L, C]``
intermediates between launches; the two kernels here (source:
``csrc/multileg_kernels.cu``) do the entire chain — quaternion un-rotation,
per-leg azimuth/coxa frames, region bits, circle tests, per-leg
any-candidate OR — in one thread's registers per candidate:

* **multi-leg any-reach** (:func:`multileg_kernel`): ``[P, C]`` candidate
  coordinates per pose -> ``[P, L]`` bits;
* **CSR window streaming** (:func:`csr_window_kernel`): per (pose, queue
  step) one window of the cell-sorted foothold arrays, read in place from a
  per-step start offset, only the legs in the step's bit mask evaluated,
  hits ORed into the pose's bits.

Per-pose quantities (quaternion, body position, and the orientation-
dependent workspace tables of every leg) ride in one packed ``[P, W]`` table
(:func:`oriented_tables`): the 6 UNIQUE circles (inner / outer /
fromabove+- / winglet+-) in the expanded linear form of ops/cuda_kernels.py
(each evaluated ONCE) plus the 4 region-construction bits (fal/falo); the
kernels re-derive the four (region, ext) slot configurations as boolean
algebra on those bits.  Leg-static scalars (mount azimuth, coxa pitch frame,
coxa yaw-limit directions) go to the kernels as a by-value parameter block
(:func:`leg_constants`).

Beside each kernel stands its **plain PyTorch version**
(:func:`multileg_kernel_plain`, :func:`csr_window_kernel_plain`): the
kernel's arithmetic in the kernel's order on whole tensors.  The wrappers
use it for CPU tensors only; for a CUDA tensor they launch the kernel or
raise.  Each wrapper counts its launches in a plain integer attribute
(``multileg_kernel.launches``, ``csr_window_kernel.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from legmov_tpu_torch.config import CIRCLE_MARGIN
from legmov_tpu_torch.models.leg import LegDimensions
from legmov_tpu_torch.models.robot import leg_count, leg_of
from legmov_tpu_torch.models.workspace import build_workspace
from legmov_tpu_torch.ops import _build
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.ops import trig32

_f32 = np.float32
_LANES = 128
MAX_LEGS = 6

#: per-leg slice layout inside the packed table (offsets relative to the
#: leg block start): linear-form params for the 6 UNIQUE circles
#: [inner, outer, fa_neg, fa_pos, wing_neg, wing_pos] (x 5 params), the
#: 4 region-construction bits (fal_low, fal_up, falo_low, falo_up), and
#: the region threshold directions.
_AX, _AY, _R2K, _HI2K, _LO2K = 0, 6, 12, 18, 24
_FAL = 30  # fal_low, fal_up, falo_low, falo_up
_MID_DIR, _MID_NEG, _SAT_DIR, _SAT_NEG = 34, 36, 37, 41
LEG_BLOCK = 43
_HDR = 7  # quat (4) + body position (3)
#: unique-circle indices
_INNER, _OUTER, _FAN, _FAP, _WN, _WP = range(6)

SENTINEL = 1e9  # a candidate this far away is reachable by no leg
#: a candidate this far (mm) from the pose's body in some axis reaches no
#: leg, so the multi-leg kernel skips it (csrc/multileg_kernels.cu ML_FAR);
#: that holds while every leg reaches less than FAR / 1e3 from the body
#: (:func:`oriented_tables` refuses a leg that reaches further)
FAR = 1e8


def leg_reach(leg: LegDimensions) -> float:
    """How far (mm) from the body origin a leg's circles reach at most:
    every circle lies within femur + tibia (and the margin) of the femur
    joint."""
    return (abs(float(leg.body)) + abs(float(leg.coxa_length))
            + float(leg.femur_length) + float(leg.tibia_length)
            + CIRCLE_MARGIN)


def table_width(n_legs: int) -> int:
    """Floats per pose row: header + leg blocks, padded to a multiple of 128
    (the layout the per-pose tables are exchanged in)."""
    w = _HDR + n_legs * LEG_BLOCK
    return ((w + _LANES - 1) // _LANES) * _LANES


def _linear_form(cx, cy, r):
    """(-2cx, -2cy, r2 - k, hi2 - k, lo2 - k), k = cx^2 + cy^2, of float32
    tensors, in the order of operations of models/workspace.py."""
    margin = float(_f32(CIRCLE_MARGIN))
    r2 = r * r
    hi2 = (r + margin) * (r + margin)
    lo = r - margin
    lo2 = torch.where(lo < 0, -1.0, lo * lo)
    k = cx * cx + cy * cy
    return -2.0 * cx, -2.0 * cy, r2 - k, hi2 - k, lo2 - k


def leg_block_from_workspace(oriented: LegDimensions, ws) -> np.ndarray:
    """``[LEG_BLOCK]`` float32 table block of one oriented leg, read out of
    its workspace tables (host numpy): the reference for
    :func:`oriented_tables`, which computes the same numbers for every
    (pose, leg) at once on the device.

    The ``[2, 2, 4]`` slot tables reference only inner / outer /
    fromabove+- / winglet+-; which circle sits in which slot is the
    region-construction logic, which the kernels re-evaluate from the
    fal/falo bits.
    """
    min_fem, max_fem = oriented.min_angle_femur, oriented.max_angle_femur
    abs_pos, abs_neg = oriented.tibia_absolute_pos, oriented.tibia_absolute_neg
    fal_low = not (min_fem < abs_neg)
    fal_up = bool(max_fem < abs_pos)
    falo_low = not (max_fem < abs_pos)
    falo_up = bool(min_fem < abs_neg)

    def tabsel(t):
        t = np.asarray(t, _f32)
        outer = t[0, 1, 3] if fal_low else t[0, 1, 1]
        return np.stack([t[0, 0, 0], outer, t[0, 0, 1], t[1, 0, 2],
                         t[0, 0, 3], t[1, 0, 3]]).astype(_f32)

    cx = tabsel(ws.circle_x)
    cy = tabsel(ws.circle_y)
    k = cx * cx + cy * cy
    parts = [
        _f32(-2.0) * cx,
        _f32(-2.0) * cy,
        tabsel(ws.circle_r2) - k,
        tabsel(ws.circle_hi2) - k,
        tabsel(ws.circle_lo2) - k,
        np.asarray([fal_low, fal_up, falo_low, falo_up], _f32),
        np.asarray(ws.mid_dir, _f32).reshape(-1),
        np.asarray(ws.mid_neg, _f32).reshape(-1),
        np.asarray(ws.sat_dir, _f32).reshape(-1),
        np.asarray(ws.sat_neg, _f32).reshape(-1),
    ]
    return np.concatenate(parts).astype(_f32)


def _robot_key(robot: LegDimensions) -> tuple:
    """``robot``'s fields as a hashable key (float32 values)."""
    return tuple(tuple(np.asarray(f, _f32).reshape(-1).tolist())
                 for f in robot)


@functools.lru_cache(maxsize=16)
def _robot_tables(key: tuple, dev: torch.device):
    """What :func:`oriented_tables` takes from the robot alone, built once a
    robot and device on the host and moved to ``dev`` once: the blocks of
    the unoriented legs ``[L, LEG_BLOCK]``, the rotations into the legs'
    frames and back (``[L, 4]`` each, :func:`quaternion.frame_quats`), and
    the per-leg fields the orientation shifts or reads ``[6, 1, L]``."""
    robot = LegDimensions(*(np.asarray(f, _f32) for f in key))
    L = leg_count(robot)
    for l in range(L):
        if not leg_reach(leg_of(robot, l)) < FAR / 1e3:
            raise ValueError(
                f"leg {l} reaches {leg_reach(leg_of(robot, l))} mm from the "
                f"body: the kernels skip candidates {FAR} mm away, which "
                f"needs every leg within {FAR / 1e3} mm")
    static = np.stack([
        leg_block_from_workspace(leg_of(robot, l),
                                 build_workspace(leg_of(robot, l)))
        for l in range(L)
    ])
    qz, qz_inv = quat.frame_quats(robot.body_angle)
    legs = np.stack([np.asarray(getattr(robot, name), _f32) for name in (
        "tibia_absolute_pos", "tibia_absolute_neg", "min_angle_femur",
        "max_angle_femur", "femur_length", "tibia_length")])[:, None, :]
    return (torch.as_tensor(static, device=dev), qz.to(dev), qz_inv.to(dev),
            torch.as_tensor(legs, device=dev))


def oriented_tables(body_pos: torch.Tensor, quats: torch.Tensor,
                    robot: LegDimensions) -> torch.Tensor:
    """``[P, table_width(L)]`` packed per-pose scalars, on the poses' device.

    O(P x L) scalar work, negligible next to the candidate axis, but done on
    the device in whole-tensor operations so that no host loop paces a sweep:
    per (pose, leg), shift the absolute-tibia limits by the pose pitch in
    the leg's frame (one_leg_global.cu:48-60), rebuild what depends on them
    (the two fromabove circles, the fal/falo bits, the middle and
    saturation directions) in the arithmetic order of
    models/workspace.py ``build_workspace`` (float32, the JAX package's
    trig from ops/trig32.py), and fold each circle into the expanded linear form
    ``t = q - 2 cx xp - 2 cy yp`` vs thresholds with the centre norm
    pre-subtracted.  The four circles that no orientation moves (inner,
    outer, winglet+-) come from the host workspace of each leg, built once
    a robot (:func:`_robot_tables`).  Row for row equal to
    :func:`leg_block_from_workspace` of the oriented leg.
    """
    dev = quats.device
    P = quats.shape[0]
    L = leg_count(robot)
    quats = quats.to(torch.float32)
    body_pos = body_pos.to(torch.float32)
    static_t, qz, qz_inv, legs = _robot_tables(_robot_key(robot), dev)

    pitch = quat.pitch_in_frames(quats[:, None, :], qz, qz_inv)
    abs_pos = legs[0] - pitch  # [P, L]
    abs_neg = legs[1] - pitch
    min_fem = legs[2].expand(P, L)
    max_fem = legs[3].expand(P, L)
    fem = legs[4].expand(P, L)
    tib = legs[5]

    fal_up = max_fem < abs_pos
    fal_low = ~(min_fem < abs_neg)
    falo_up = min_fem < abs_neg
    falo_low = ~(max_fem < abs_pos)
    middle = (torch.maximum(abs_neg, min_fem)
              + torch.minimum(abs_pos, max_fem)) / 2.0
    sat_up = torch.where(fal_up, max_fem, abs_pos)
    sat_low = torch.where(fal_low, min_fem, abs_neg)

    # one elementwise call for every angle of the block
    sin, cos = trig32.sincos(torch.stack([abs_neg, abs_pos, middle, sat_low,
                                          sat_up]))
    fan = _linear_form(tib * cos[0], tib * sin[0], fem)
    fap = _linear_form(tib * cos[1], tib * sin[1], fem)

    blocks = static_t[None, :, :].repeat(P, 1, 1)  # [P, L, LEG_BLOCK]
    for base, neg_v, pos_v in zip((_AX, _AY, _R2K, _HI2K, _LO2K), fan, fap):
        blocks[:, :, base + _FAN] = neg_v
        blocks[:, :, base + _FAP] = pos_v
    for i, bit in enumerate((fal_low, fal_up, falo_low, falo_up)):
        blocks[:, :, _FAL + i] = bit.to(torch.float32)
    blocks[:, :, _MID_DIR] = cos[2]
    blocks[:, :, _MID_DIR + 1] = sin[2]
    blocks[:, :, _MID_NEG] = (middle < 0).to(torch.float32)
    blocks[:, :, _SAT_DIR] = cos[3]
    blocks[:, :, _SAT_DIR + 1] = sin[3]
    blocks[:, :, _SAT_DIR + 2] = cos[4]
    blocks[:, :, _SAT_DIR + 3] = sin[4]
    blocks[:, :, _SAT_NEG] = (sat_low < 0).to(torch.float32)
    blocks[:, :, _SAT_NEG + 1] = (sat_up < 0).to(torch.float32)

    tab = torch.zeros((P, table_width(L)), dtype=torch.float32, device=dev)
    tab[:, 0:4] = quats
    tab[:, 4:7] = body_pos
    tab[:, _HDR:_HDR + L * LEG_BLOCK] = blocks.reshape(P, L * LEG_BLOCK)
    return tab


def tables_from_numpy(tab, n_legs: int, device=None) -> torch.Tensor:
    """A ``[P, table_width(L)]`` table built elsewhere (the layout above,
    e.g. another array library's ``oriented_tables`` as a numpy array) as a
    tensor on ``device`` (default CPU), so both sides evaluate the same
    bits."""
    a = np.ascontiguousarray(np.asarray(tab), dtype=_f32)
    if a.ndim != 2 or a.shape[1] != table_width(n_legs):
        raise ValueError(
            f"table must be [P, {table_width(n_legs)}], got {a.shape}")
    return torch.from_numpy(a.copy()).to(device or "cpu")


def leg_constants(robot: LegDimensions) -> list[dict]:
    """Leg-static scalars of the kernels (orientation does not shift
    these): mount yaw, coxa frame and coxa yaw-limit directions."""
    out = []
    for i in range(leg_count(robot)):
        leg = leg_of(robot, i)
        ws = build_workspace(leg)
        (sa, sp), (ca, cp) = trig32.host_sincos(
            [-float(leg.body_angle), -float(leg.coxa_pitch)])
        out.append(
            dict(
                ca=ca,
                sa=sa,
                body=float(leg.body),
                cp=cp,
                sp=sp,
                coxa_len=float(leg.coxa_length),
                cmax=(float(ws.coxa_max_dir[0]), float(ws.coxa_max_dir[1])),
                cmin=(float(ws.coxa_min_dir[0]), float(ws.coxa_min_dir[1])),
                gt_possible=bool(ws.coxa_gt_possible),
                lt_possible=bool(ws.coxa_lt_possible),
            )
        )
    return out


#: fp32 adds, multiplies, compares and square roots per candidate, counted
#: from the source as ops/cuda_kernels.py ``reach_flops_per_point`` does
#: (selects, negations and boolean logic not counted).  Un-rotation: 3
#: subtractions, 3 x 4 for the doubled cross product, 3 x 6 for the sum.
UNROTATE_FLOPS = 33


def leg_flops(c: dict) -> int:
    """Operations per (candidate, leg): mount yaw 6, coxa frame 7, limit
    tests 4 each, sqrt and plane coordinate 5, region bits 13, q 3, six
    circles x 7."""
    return (6 + 7 + 4 * int(c["gt_possible"]) + 4 * int(c["lt_possible"])
            + 5 + 13 + 3 + 42)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the kernels' arithmetic, in the kernels' order
# ---------------------------------------------------------------------------

def _bsel(c, a, b):
    return (c & a) | (~c & b)


def _unrotate_plain(s, x, y, z):
    """Body-frame candidate coordinates, shared across legs: subtract the
    body position and un-rotate by the body quaternion (conjugate
    rotation).  ``s(i)`` is the per-pose scalar getter."""
    rx = x - s(4)
    ry = y - s(5)
    rz = z - s(6)
    w = s(0)
    ux = -s(1)
    uy = -s(2)
    uz = -s(3)
    tx = 2.0 * (uy * rz - uz * ry)
    ty = 2.0 * (uz * rx - ux * rz)
    tz = 2.0 * (ux * ry - uy * rx)
    vx = rx + w * tx + (uy * tz - uz * ty)
    vy = ry + w * ty + (uz * tx - ux * tz)
    vz = rz + w * tz + (ux * ty - uy * tx)
    return vx, vy, vz


def _one_leg_plain(s, l, c, vx, vy, vz):
    """``[P, C]`` reachability of leg ``l`` over body-frame candidates."""
    off = _HDR + l * LEG_BLOCK
    # yaw by -body_angle ("as if leg 0")
    x0 = vx * c["ca"] - vy * c["sa"]
    y0 = vx * c["sa"] + vy * c["ca"]
    # coxa frame
    px = x0 - c["body"]
    x1 = px * c["cp"] - vz * c["sp"]
    z1 = px * c["sp"] + vz * c["cp"]
    y1 = y0
    flip = torch.signbit(x1)
    fx = torch.where(flip, -x1, x1)
    fy = torch.where(flip, -y1, y1)
    coxa_invalid = None
    if c["gt_possible"]:
        coxa_invalid = (fy * c["cmax"][0] - fx * c["cmax"][1]) > 0
    if c["lt_possible"]:
        lt = (fy * c["cmin"][0] - fx * c["cmin"][1]) < 0
        coxa_invalid = lt if coxa_invalid is None else coxa_invalid | lt
    rho = trig32.sqrt(x1 * x1 + y1 * y1)
    xp = torch.where(flip, -rho, rho) - c["coxa_len"]
    yp = z1

    # region bits from per-pose scalars
    nn = yp >= 0
    mid_neg = s(off + _MID_NEG) > 0.5
    crossm = (yp * s(off + _MID_DIR) - xp * s(off + _MID_DIR + 1)) > 0
    upper = _bsel(nn, mid_neg | crossm, mid_neg & crossm)
    sat_lo_neg = s(off + _SAT_NEG) > 0.5
    sat_hi_neg = s(off + _SAT_NEG + 1) > 0.5
    cross_lo = (yp * s(off + _SAT_DIR) - xp * s(off + _SAT_DIR + 1)) > 0
    cross_hi = (yp * s(off + _SAT_DIR + 2) - xp * s(off + _SAT_DIR + 3)) > 0
    gt_lo = _bsel(nn, sat_lo_neg | cross_lo, sat_lo_neg & cross_lo)
    gt_hi = _bsel(nn, sat_hi_neg | cross_hi, sat_hi_neg & cross_hi)
    ext = upper ^ _bsel(upper, gt_hi, gt_lo)

    # 6 unique circles once each (both validity polarities), then the four
    # (region, ext) configurations as boolean algebra on the per-pose
    # fal/falo construction bits
    q2 = xp * xp + yp * yp
    pos, neg = [], []
    for u in range(6):
        t = q2 + s(off + _AX + u) * xp + s(off + _AY + u) * yp
        inside = t <= s(off + _R2K + u)
        near = (t < s(off + _HI2K + u)) & (t > s(off + _LO2K + u))
        pos.append(inside | near)
        neg.append((~inside) | near)
    b_fal_low = s(off + _FAL) > 0.5
    b_fal_up = s(off + _FAL + 1) > 0.5
    b_falo_low = s(off + _FAL + 2) > 0.5
    b_falo_up = s(off + _FAL + 3) > 0.5
    # lower region: [inner, fa_neg(att=!fal), excl(rep), wing]
    excl0 = _bsel(b_falo_low, neg[_WP], neg[_FAP])
    other0 = _bsel(b_fal_low, neg[_FAN], pos[_FAN])
    wing0 = _bsel(b_fal_low, pos[_WN], neg[_WN])
    base0 = neg[_INNER] & excl0
    v00 = base0 & other0 & wing0
    other0e = _bsel(b_fal_low, other0, pos[_OUTER])
    wing0e = _bsel(b_fal_low, pos[_OUTER], wing0)
    v01 = base0 & other0e & wing0e
    # upper region: [inner, excl(rep), fa_pos(att=!fal), wing]
    excl1 = _bsel(b_falo_up, neg[_WN], neg[_FAN])
    other1 = _bsel(b_fal_up, neg[_FAP], pos[_FAP])
    wing1 = _bsel(b_fal_up, pos[_WP], neg[_WP])
    base1 = neg[_INNER] & excl1
    v10 = base1 & other1 & wing1
    other1e = _bsel(b_fal_up, other1, pos[_OUTER])
    wing1e = _bsel(b_fal_up, pos[_OUTER], wing1)
    v11 = base1 & other1e & wing1e
    plane_ok = _bsel(upper, _bsel(ext, v11, v10), _bsel(ext, v01, v00))
    return plane_ok if coxa_invalid is None else (~coxa_invalid & plane_ok)


def multileg_kernel_plain(tab, gx, gy, gz, consts,
                          legs_in=None) -> torch.Tensor:
    """Plain PyTorch version of the multi-leg kernel: ``tab [P, W]``,
    ``gx, gy, gz [P, C]`` float32 -> ``[P, L]`` bool, on the tensors'
    device, ORed with ``legs_in [P, L]`` bool (legs found before) when
    given.  Any ``P >= 0`` and ``C >= 0``."""
    def s(i):
        return tab[:, i:i + 1]  # [P, 1], broadcasts against the candidates

    vx, vy, vz = _unrotate_plain(s, gx, gy, gz)
    bits = [torch.any(_one_leg_plain(s, l, c, vx, vy, vz), dim=1)
            for l, c in enumerate(consts)]
    out = torch.stack(bits, dim=1)
    return out if legs_in is None else out | legs_in


def multileg_need(tab, gx, gy, gz, consts, legs_in) -> torch.Tensor:
    """What one multi-leg launch needs to decide its output, from the plain
    version's leg bits: int64 ``[2 + L]`` on the tensors' device, the
    candidates read, their un-rotations, then each leg's evaluations.

    A walk over each pose's candidates in order reads them until every leg
    the pose misses (not in ``legs_in``) is found, or to the end; a
    candidate :data:`FAR` from the body in some axis (padding) costs its
    read only; a leg runs on the near candidates up to and including its
    first hit.  Any other order of the walk needs as much or more."""
    L = len(consts)
    dev = tab.device
    need = torch.zeros(2 + L, dtype=torch.int64, device=dev)
    # only the poses that miss a leg need anything
    some = (~legs_in).any(dim=1).nonzero()[:, 0]
    tab, legs_in = tab[some], legs_in[some]
    gx, gy, gz = gx[some], gy[some], gz[some]
    P, C = gx.shape
    rows = max(1, (1 << 22) // max(C, 1))
    for lo in range(0, P if C else 0, rows):
        t = tab[lo:lo + rows]

        def s(i, t=t):
            return t[:, i:i + 1]

        g = [c[lo:lo + rows] for c in (gx, gy, gz)]
        near = ~(((g[0] - s(4)).abs() > FAR) | ((g[1] - s(5)).abs() > FAR)
                 | ((g[2] - s(6)).abs() > FAR))
        # near candidates among the first i of a row: cum[:, i]
        cum = torch.nn.functional.pad(near.cumsum(1), (1, 0))
        v = _unrotate_plain(s, *g)
        miss = ~legs_in[lo:lo + rows]
        read = torch.zeros(t.shape[0], dtype=torch.int64, device=dev)
        for l, c in enumerate(consts):
            hit = (_one_leg_plain(s, l, c, *v) & near).to(torch.int32)
            # candidates up to and including the first hit, or all of them
            upto = torch.where(hit.any(dim=1), hit.argmax(dim=1) + 1, C)
            upto = torch.where(miss[:, l], upto, 0)
            read = torch.maximum(read, upto)
            need[2 + l] += cum.gather(1, upto[:, None]).sum()
        need[0] += read.sum()
        need[1] += cum.gather(1, read[:, None]).sum()
    return need


def multileg_flops(need, consts) -> int:
    """fp32 operations of :func:`multileg_need`'s counts ``need`` (a
    tensor or a sequence)."""
    need = torch.as_tensor(need).tolist()
    return need[1] * UNROTATE_FLOPS + sum(
        n * leg_flops(c) for n, c in zip(need[2:], consts))


def csr_window_kernel_plain(tab, legs_in, starts, lens, masks, xs, ys, zs,
                            consts, work=None) -> torch.Tensor:
    """Plain PyTorch version of the CSR window kernel.

    ``tab [A, W]`` float32, ``legs_in [A, L]`` bool, ``starts, lens, masks
    [A, S]`` int32 (element offset into the cell-sorted arrays, candidates
    in the step, bit l = leg l is served by the step; mask 0 or length 0 =
    dead step), ``xs, ys, zs [F]`` float32 -> ``[A, L]`` bool: ``legs_in``
    ORed with, for every step and every leg in its mask, "some candidate of
    the window is reachable".

    ``work``, when given a dict, receives what a sequential walk that skips
    legs already found needs: ``points`` (candidates of the steps that still
    serve a missing leg) and ``leg_points`` (candidate x missing masked leg
    evaluations), as Python ints.
    """
    A, S = starts.shape
    L = len(consts)
    legs = legs_in.clone()
    if work is not None:
        work["points"] = work["leg_points"] = 0
    if A == 0 or S == 0:
        return legs
    width = int(lens.max())
    F = xs.shape[0]
    pos = torch.arange(width, device=tab.device)[None, :]
    bit = (1 << torch.arange(L, device=tab.device, dtype=torch.int32))[None, :]
    pts = torch.zeros((), dtype=torch.int64, device=tab.device)
    leg_pts = torch.zeros((), dtype=torch.int64, device=tab.device)
    for step in range(S):
        st = starts[:, step].to(torch.int64)[:, None]
        ln = lens[:, step][:, None]
        idx = torch.clamp(st + pos, 0, max(F - 1, 0))
        live = pos < ln

        def take(comp):
            return torch.where(live, comp[idx], SENTINEL)

        served = (masks[:, step][:, None] & bit) != 0  # [A, L]
        if work is not None:
            need = served & ~legs
            n = ln[:, 0].to(torch.int64)
            pts += torch.sum(torch.where(need.any(dim=1), n, 0))
            leg_pts += torch.sum(need.sum(dim=1) * n)
        got = multileg_kernel_plain(tab, take(xs), take(ys), take(zs), consts)
        legs |= got & served
    if work is not None:
        work["points"], work["leg_points"] = int(pts), int(leg_pts)
    return legs


# ---------------------------------------------------------------------------
# parameter block, field for field as in csrc/multileg_kernels.cu
# ---------------------------------------------------------------------------

class _MultilegParams(ctypes.Structure):
    _fields_ = [
        ("n_legs", ctypes.c_int), ("table_width", ctypes.c_int),
        ("ca", ctypes.c_float * MAX_LEGS), ("sa", ctypes.c_float * MAX_LEGS),
        ("body", ctypes.c_float * MAX_LEGS),
        ("cp", ctypes.c_float * MAX_LEGS), ("sp", ctypes.c_float * MAX_LEGS),
        ("coxa_len", ctypes.c_float * MAX_LEGS),
        ("cmax_c", ctypes.c_float * MAX_LEGS),
        ("cmax_s", ctypes.c_float * MAX_LEGS),
        ("cmin_c", ctypes.c_float * MAX_LEGS),
        ("cmin_s", ctypes.c_float * MAX_LEGS),
        ("gt_possible", ctypes.c_int * MAX_LEGS),
        ("lt_possible", ctypes.c_int * MAX_LEGS),
    ]


def multileg_params(consts) -> _MultilegParams:
    """The kernels' parameter block for ``consts`` (:func:`leg_constants`)."""
    L = len(consts)
    if not 1 <= L <= MAX_LEGS:
        raise ValueError(f"the kernels take 1 to {MAX_LEGS} legs, got {L}")
    p = _MultilegParams()
    p.n_legs, p.table_width = L, table_width(L)
    for i, c in enumerate(consts):
        p.ca[i], p.sa[i], p.body[i] = c["ca"], c["sa"], c["body"]
        p.cp[i], p.sp[i], p.coxa_len[i] = c["cp"], c["sp"], c["coxa_len"]
        p.cmax_c[i], p.cmax_s[i] = c["cmax"]
        p.cmin_c[i], p.cmin_s[i] = c["cmin"]
        p.gt_possible[i] = int(c["gt_possible"])
        p.lt_possible[i] = int(c["lt_possible"])
    return p


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_bound = None


def _library():
    """The shared library with argument types set, checked against the
    parameter block's size and the table layout."""
    global _bound
    if _bound is not None:
        return _bound
    lib = _build.load_library("multileg_kernels")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    pp = ctypes.POINTER(_MultilegParams)
    lib.legmov_multileg.restype = ctypes.c_int
    lib.legmov_multileg.argtypes = [vp, vp, vp, vp, ll, ll, vp, pp, vp]
    lib.legmov_csr_window.restype = ctypes.c_int
    lib.legmov_csr_window.argtypes = [
        vp, vp, vp, ll, ll, vp, vp, vp, vp, vp, vp, pp, vp]
    lib.legmov_multileg_layout.restype = ctypes.c_int
    lib.legmov_multileg_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    nbytes, hdr, block = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.legmov_multileg_layout(ctypes.byref(nbytes), ctypes.byref(hdr),
                               ctypes.byref(block))
    want = (ctypes.sizeof(_MultilegParams), _HDR, LEG_BLOCK)
    if (nbytes.value, hdr.value, block.value) != want:
        raise RuntimeError(
            "csrc/multileg_kernels.cu and ops/cuda_multileg.py disagree on "
            "the parameter block or the table layout: "
            f"{(nbytes.value, hdr.value, block.value)} in the library, "
            f"{want} here")
    _bound = lib
    return lib


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(name, t, dtype, ndim, device=None):
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


def _bits_to_bool(bits: torch.Tensor, L: int) -> torch.Tensor:
    shifts = torch.arange(L, device=bits.device, dtype=torch.int32)
    return ((bits[:, None] >> shifts[None, :]) & 1) != 0


def multileg_kernel(tab, gx, gy, gz, legs_in, consts,
                    params=None) -> torch.Tensor:
    """Per-leg any-candidate reachability: ``tab [P, W]`` from
    :func:`oriented_tables`, ``gx, gy, gz [P, C]`` candidate world
    coordinates per pose -> ``[P, L]`` bool, ORed with ``legs_in [P, L]``
    bool (legs found before: the kernel spends no work on them).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`multileg_kernel_plain`.  Any ``P >= 0`` and ``C >= 0``; an empty
    axis launches nothing.
    """
    L = len(consts)
    _check("tab", tab, torch.float32, 2)
    for name, t in (("gx", gx), ("gy", gy), ("gz", gz)):
        _check(name, t, torch.float32, 2, tab.device)
        if t.shape != gx.shape:
            raise ValueError("gx, gy and gz differ in shape")
    P, C = gx.shape
    if tab.shape != (P, table_width(L)):
        raise ValueError(
            f"tab must be [{P}, {table_width(L)}], got {tuple(tab.shape)}")
    _check("legs_in", legs_in, torch.bool, 2, tab.device)
    if legs_in.shape != (P, L):
        raise ValueError(f"legs_in must be [{P}, {L}], got "
                         f"{tuple(legs_in.shape)}")
    if tab.device.type == "cpu":
        return multileg_kernel_plain(tab, gx, gy, gz, consts, legs_in)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    shifts = torch.arange(L, device=tab.device, dtype=torch.int32)
    bits = (legs_in.to(torch.int32) << shifts).sum(dim=1, dtype=torch.int32)
    if P == 0 or C == 0:
        return _bits_to_bool(bits, L)
    lib = _library()
    if params is None:
        params = multileg_params(consts)
    with torch.cuda.device(tab.device):
        err = lib.legmov_multileg(
            tab.data_ptr(), gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
            P, C, bits.data_ptr(), ctypes.byref(params), _stream())
    if err != 0:
        raise RuntimeError(f"legmov_multileg launch failed: CUDA error {err}")
    multileg_kernel.launches += 1
    return _bits_to_bool(bits, L)


multileg_kernel.launches = 0


def csr_window_kernel(tab, legs_in, starts, lens, masks, xs, ys, zs, consts,
                      params=None) -> torch.Tensor:
    """CSR window streaming, see :func:`csr_window_kernel_plain` for the
    arguments.  Every live step must lie inside the arrays
    (``0 <= start``, ``start + len <= F``): the solver's queues do by
    construction, and the kernel does not clamp.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version.  ``A == 0`` or ``S == 0`` launches nothing.
    """
    L = len(consts)
    _check("tab", tab, torch.float32, 2)
    dev = tab.device
    _check("legs_in", legs_in, torch.bool, 2, dev)
    for name, t in (("starts", starts), ("lens", lens), ("masks", masks)):
        _check(name, t, torch.int32, 2, dev)
        if t.shape != starts.shape:
            raise ValueError("starts, lens and masks differ in shape")
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs)):
        _check(name, t, torch.float32, 1, dev)
        if t.shape != xs.shape:
            raise ValueError("xs, ys and zs differ in length")
    A, S = starts.shape
    if tab.shape != (A, table_width(L)) or legs_in.shape != (A, L):
        raise ValueError(
            f"tab must be [{A}, {table_width(L)}] and legs_in [{A}, {L}], got "
            f"{tuple(tab.shape)} and {tuple(legs_in.shape)}")
    if dev.type == "cpu":
        return csr_window_kernel_plain(tab, legs_in, starts, lens, masks,
                                       xs, ys, zs, consts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if A == 0 or S == 0:
        return legs_in.clone()
    out = torch.empty((A, L), dtype=torch.bool, device=dev)
    lib = _library()
    if params is None:
        params = multileg_params(consts)
    with torch.cuda.device(dev):
        err = lib.legmov_csr_window(
            starts.data_ptr(), lens.data_ptr(), masks.data_ptr(), A, S,
            tab.data_ptr(), legs_in.data_ptr(), xs.data_ptr(), ys.data_ptr(),
            zs.data_ptr(), out.data_ptr(), ctypes.byref(params), _stream())
    if err != 0:
        raise RuntimeError(f"legmov_csr_window launch failed: CUDA error {err}")
    csr_window_kernel.launches += 1
    return out


csr_window_kernel.launches = 0


def make_multileg_kernel(robot: LegDimensions, cand_cols: int | None = None):
    """Kernel factory for a fixed robot.

    Returns ``fn(tab [P, W], gx, gy, gz [P, C], legs_in [P, L]) -> [P, L]
    bool`` where (gx, gy, gz) are candidate foothold world coordinates per
    pose (padding = :data:`SENTINEL`), ``tab`` comes from
    :func:`oriented_tables` for the same poses and ``legs_in`` holds legs
    found before (ORed in, and skipped by the kernel).
    ``cand_cols``, when given, is the one candidate width the caller will
    use and is checked on every call.  ``fn.consts`` holds the leg
    constants, ``fn.plain`` the plain version with them bound.
    """
    consts = leg_constants(robot)
    params = multileg_params(consts)

    def fn(tab, gx, gy, gz, legs_in):
        if cand_cols is not None and gx.shape[-1] != cand_cols:
            raise ValueError(
                f"candidate width {gx.shape[-1]} != cand_cols {cand_cols}")
        return multileg_kernel(tab, gx, gy, gz, legs_in, consts, params)

    def plain(tab, gx, gy, gz, legs_in):
        return multileg_kernel_plain(tab, gx, gy, gz, consts, legs_in)

    fn.consts = consts
    fn.plain = plain
    return fn


def make_csr_window_kernel(robot: LegDimensions):
    """``fn(tab, legs_in, starts, lens, masks, xs, ys, zs) -> [A, L] bool``
    for a fixed robot (see :func:`csr_window_kernel`), with ``fn.consts`` and
    ``fn.plain`` as :func:`make_multileg_kernel` has them."""
    consts = leg_constants(robot)
    params = multileg_params(consts)

    def fn(tab, legs_in, starts, lens, masks, xs, ys, zs):
        return csr_window_kernel(tab, legs_in, starts, lens, masks, xs, ys,
                                 zs, consts, params)

    def plain(tab, legs_in, starts, lens, masks, xs, ys, zs, work=None):
        return csr_window_kernel_plain(tab, legs_in, starts, lens, masks,
                                       xs, ys, zs, consts, work)

    fn.consts = consts
    fn.plain = plain
    return fn

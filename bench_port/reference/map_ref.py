"""Plain reference of the any-orientation body-pose map.

A body position stands if, under one orientation of the sweep, at least
``k`` legs each reach some foothold (several_leg.cu ``eliminateUnreachable``
and ``agregateReachability``, swept over ``robot_full_struct``'s
orientations, several_leg.cu:796-877).  This module decides that for a
batch of body positions from the inputs alone, on the frozen circle math
of :mod:`bench_port.reference.circles`:

1. each position's candidates are every foothold inside a float64 ball
   about the body of radius ``max_l(|mount_l| + reach_l) + 1`` mm, a
   superset of what any leg reaches under any orientation (a leg's tip
   lies within ``coxa + femur + tibia`` of its coxa joint, and the joint
   within ``|mount_l|`` of the body);
2. for each orientation in the sweep's order, every leg is tested on every
   candidate (float32 relative vectors, the reachability of
   ``reachability_oriented_poses`` with that orientation's workspaces), and
   the position stands there when at least ``k`` legs reach one.

Besides the verdict it reports, per (position, orientation, leg), whether
the leg reaches a candidate and how many candidates lie inside the leg's
own reach ball (about its rotated coxa joint), which
``bench_port/counts/k4.py`` turns into the work a request needs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bench_port.reference.circles import quaternion as quat
from bench_port.reference.circles.leg import LegDimensions
from bench_port.reference.circles.orientation import (
    oriented_workspaces,
    reachability_oriented_poses,
)
from bench_port.reference.circles.reachability import reachability_xyz
from bench_port.reference.circles.robot import leg_count
from bench_port.reference.circles.workspace import _cos, _sin

_f32 = np.float32
#: a padded candidate this far away is reached by no leg
_FAR = 1e9
#: (position, foothold) distances a block computes at once
_BLOCK_PAIRS = 1 << 23
#: (position, leg, candidate) elements an orientation evaluates at once
_BLOCK_ELEMENTS = 1 << 23


def sweep(cfg_sweep: dict) -> torch.Tensor:
    """``[S, 4]`` quaternions of the sweep: roll, pitch and yaw each
    ``linspace(lo * pi, hi * pi, n)``, roll outermost and yaw fastest,
    composed extrinsically roll, then pitch, then yaw (float32 angles)."""
    axes = [np.linspace(lo * np.pi, hi * np.pi, int(n))
            for lo, hi, n in (cfg_sweep["roll_pi"], cfg_sweep["pitch_pi"],
                              cfg_sweep["yaw_pi"])]
    r, p, y = np.meshgrid(*axes, indexing="ij")
    return quat.from_rpy(r.ravel().astype(_f32), p.ravel().astype(_f32),
                         y.ravel().astype(_f32))


def leg_balls(robot: LegDimensions):
    """``(mount [L, 3], reach [L])`` float64: each coxa joint in the body
    frame and the leg's reach from it."""
    body = np.asarray(robot.body, np.float64)
    ang = np.asarray(robot.body_angle, np.float64)
    mount = np.stack([body * np.cos(ang), body * np.sin(ang),
                      np.zeros_like(body)], -1)
    reach = (np.asarray(robot.coxa_length, np.float64)
             + np.asarray(robot.femur_length, np.float64)
             + np.asarray(robot.tibia_length, np.float64))
    return mount, reach


def superset_radius(robot: LegDimensions) -> float:
    mount, reach = leg_balls(robot)
    return float(np.max(np.linalg.norm(mount, axis=1) + reach)) + 1.0


def _rotation(q: np.ndarray) -> np.ndarray:
    """``[S, 3, 3]`` float64 rotation matrices of unit quaternions."""
    w, x, y, z = (np.asarray(q, np.float64)[:, i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def _ball_centres(quats: torch.Tensor, robot: LegDimensions, dev):
    """``(centres [S, L, 3], reach2 [L])`` float64 tensors on ``dev``: each
    leg's coxa joint rotated by each orientation, and its squared reach."""
    mount, reach = leg_balls(robot)
    rot = _rotation(quats.cpu().numpy())
    return (torch.from_numpy(np.einsum("sij,lj->sli", rot, mount)).to(dev),
            torch.from_numpy(reach * reach).to(dev))


def gather(poses: torch.Tensor, footholds: torch.Tensor, radius: float):
    """``(idx [n, W] int64, valid [n, W] bool)``: the footholds within
    ``radius`` of each pose (float64 distances), padded with ``valid``
    False."""
    n, F = poses.shape[0], footholds.shape[0]
    dev = footholds.device
    f64 = footholds.double()
    r2 = radius * radius
    blocks = []
    step = max(1, _BLOCK_PAIRS // max(F, 1))
    for lo in range(0, n, step):
        p = poses[lo:lo + step].double()
        d2 = ((f64[None, :, 0] - p[:, None, 0]) ** 2
              + (f64[None, :, 1] - p[:, None, 1]) ** 2
              + (f64[None, :, 2] - p[:, None, 2]) ** 2)
        within = d2 <= r2
        width = max(int(within.sum(dim=1).max()), 1)
        order = torch.argsort((~within).to(torch.int8), dim=1, stable=True)
        idx = order[:, :width]
        blocks.append((idx, torch.gather(within, 1, idx)))
    width = max([b[0].shape[1] for b in blocks], default=1)
    idx = torch.zeros((n, width), dtype=torch.int64, device=dev)
    valid = torch.zeros((n, width), dtype=torch.bool, device=dev)
    lo = 0
    for i, v in blocks:
        idx[lo:lo + i.shape[0], :i.shape[1]] = i
        valid[lo:lo + i.shape[0], :i.shape[1]] = v
        lo += i.shape[0]
    return idx, valid


class MapEval(NamedTuple):
    stands: np.ndarray  # [n] bool: some orientation stands
    first: np.ndarray  # [n] int: first orientation that stands, S if none
    legs: np.ndarray  # [n, S, L] bool: the leg reaches a candidate
    in_ball: np.ndarray  # [n, S, L] int: candidates in the leg's reach ball
    idx: torch.Tensor  # [n, W] foothold index of each candidate
    valid: torch.Tensor  # [n, W] bool
    rel: torch.Tensor  # [n, W, 3] float64 candidate minus position
    centres: torch.Tensor  # [S, L, 3] float64 coxa joints, rotated
    reach2: torch.Tensor  # [L] float64 squared reach

    def ball(self, s: int, legs: torch.Tensor) -> torch.Tensor:
        """``[n, W]`` bool: the candidates inside the reach ball of leg
        ``legs[i]`` (an index per position) under orientation ``s``."""
        d = self.rel - self.centres[s][legs][:, None, :]
        return (((d * d).sum(dim=-1) < self.reach2[legs][:, None])
                & self.valid)


def lowered_leg_test(rel: torch.Tensor, quats: torch.Tensor,
                     robot: LegDimensions, ws, low) -> torch.Tensor:
    """``reachability_oriented_poses`` with its inputs in a lower precision:
    the relative vectors, and each leg's frame coordinates made from them,
    pass through ``low`` (a rounding, such as to bfloat16 and back) before
    the leg test, as a program that ran its leg math in that precision
    would see them."""
    quats = quats.to(torch.float32)
    p = quat.inv_rotate(quats[:, None, :], low(rel))  # [A, C, 3]
    ba = np.asarray(robot.body_angle, np.float32)
    c = torch.as_tensor(_cos(-ba), device=rel.device)[None, :, None]
    s = torch.as_tensor(_sin(-ba), device=rel.device)[None, :, None]
    px, py = low(p[:, None, :, 0]), low(p[:, None, :, 1])
    x = low(px * c - py * s)  # [A, L, C]
    y = low(px * s + py * c)
    z = low(p[:, None, :, 2]).expand_as(x)
    return reachability_xyz(x, y, z, ws)


def evaluate(poses: np.ndarray, footholds: torch.Tensor, quats: torch.Tensor,
             robot: LegDimensions, k: int, quantize=None) -> MapEval:
    """Decide ``[n, 3]`` float32 body positions over ``footholds`` (a
    float32 tensor on the device that computes) under every orientation of
    ``quats``.  ``quantize``, when given, is applied to the footholds and
    the leg test's inputs (the control, see :func:`lowered_leg_test`).
    """
    dev = footholds.device
    L = leg_count(robot)
    S = quats.shape[0]
    n = poses.shape[0]
    p = torch.from_numpy(np.ascontiguousarray(poses, _f32)).to(dev)
    fh = footholds
    idx, valid = gather(p, fh, superset_radius(robot))
    rel = fh[idx] - p[:, None, :]  # float32, as the solvers subtract
    rel = torch.where(valid[..., None], rel, torch.full_like(rel, _FAR))
    centres, reach2 = _ball_centres(quats, robot, dev)
    rel64 = rel.double()
    legs = torch.zeros((n, S, L), dtype=torch.bool, device=dev)
    in_ball = torch.zeros((n, S, L), dtype=torch.int64, device=dev)
    q_dev = quats.to(dev)
    step = max(1, _BLOCK_ELEMENTS // max(L * idx.shape[1], 1))
    for s in range(S):
        ws = oriented_workspaces(q_dev[s:s + 1], robot)
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            r = rel[lo:hi]
            qs = q_dev[s].expand(hi - lo, 4)
            ok = (reachability_oriented_poses(r, qs, robot, ws)  # [m, L, W]
                  if quantize is None else
                  lowered_leg_test(r, qs, robot, ws, quantize))
            legs[lo:hi, s] = (ok & valid[lo:hi, None, :]).any(dim=-1)
            d = rel64[lo:hi, None, :, :] - centres[s][None, :, None, :]
            inb = ((d * d).sum(dim=-1) < reach2[None, :, None]) & valid[
                lo:hi, None, :]
            in_ball[lo:hi, s] = inb.sum(dim=-1)
    stand_at = legs.sum(dim=-1) >= k  # [n, S]
    stands = stand_at.any(dim=1)
    first = torch.where(stands, stand_at.int().argmax(dim=1),
                        torch.full_like(stands, S, dtype=torch.int64))
    return MapEval(stands.cpu().numpy(), first.cpu().numpy(),
                   legs.cpu().numpy(), in_ball.cpu().numpy(), idx, valid,
                   rel64, centres, reach2)


def near_any_leg(poses: np.ndarray, footholds: torch.Tensor,
                 quats: torch.Tensor, robot: LegDimensions) -> np.ndarray:
    """``[n]`` bool: some foothold lies inside some leg's reach ball under
    some orientation of the sweep (float64)."""
    dev = footholds.device
    p = torch.from_numpy(np.ascontiguousarray(poses, _f32)).to(dev)
    idx, valid = gather(p, footholds, superset_radius(robot))
    rel = footholds[idx].double() - p.double()[:, None, :]
    centres, reach2 = _ball_centres(quats, robot, dev)
    out = torch.zeros(p.shape[0], dtype=torch.bool, device=dev)
    for c, r2 in zip(centres.reshape(-1, 3), reach2.repeat(quats.shape[0])):
        d = rel - c
        out |= (((d * d).sum(dim=-1) < r2) & valid).any(dim=1)
    return out.cpu().numpy()

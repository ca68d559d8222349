"""Body-orientation layer: evaluate legs under a rotated body.

Semantics of reference one_leg_global.cu:48-130: given a body orientation
quaternion,

1. the leg's *absolute* tibia limits (which are defined against the world
   horizon — "tibia always points down") shift by the body pitch expressed
   in that leg's azimuth frame (``rotate_leg_data``);
2. the query point is un-rotated into the body frame and yawed by
   ``-body_angle`` so every leg evaluates "as if leg 0";
3. distance displacement vectors are rotated back to the world frame.

The single-orientation functions take one quaternion ``[4]`` and one leg;
:func:`reachability_oriented_poses` is the batch form over poses and the legs
of a robot (per-pose quaternions, a workspace rebuilt per (pose, leg): cheap
O(1) work against the point axis).  Points and quaternions are tensors; the
result lives on the points' device.
"""

from __future__ import annotations

import numpy as np
import torch

from .leg import LegDimensions
from .robot import leg_count, leg_of
from .workspace import (
    _cos,
    _sin,
    build_workspace,
    stack_workspaces,
)
from . import quaternion as quat
from .distance import distance_ws
from .reachability import reachability_ws, reachability_xyz


def _quat_tensor(q, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(q, torch.Tensor):
        return q.to(torch.float32)
    return torch.as_tensor(np.asarray(q, np.float32), device=dev)


def rotate_leg_data(q, leg: LegDimensions) -> LegDimensions:
    """Shift the absolute-tibia limits by the body pitch in the leg frame.

    Semantics of reference one_leg_global.cu:48-60.  Note this is the
    reference's deliberate approximation: ONE pitch shift is applied per
    leg, while the true tilt of a target's vertical plane varies with the
    target's coxa yaw theta (error ~ pitch * (1 - cos theta) +
    roll * sin theta; exact at theta = 0 and for pure-yaw body rotations).
    We reproduce the model faithfully.

    Leg parameters are host constants, so the pitch is brought to the host
    (one device-to-host copy when ``q`` lives on the card).  With a batch of
    quaternions ``[..., 4]`` (and/or a stacked robot) the two shifted fields
    come back as float32 arrays of the broadcast shape.
    """
    q = _quat_tensor(q)
    pitch = quat.pitch_in_frame(q, np.asarray(leg.body_angle, np.float32))
    pitch = pitch.cpu().numpy().astype(np.float32)
    if pitch.ndim == 0:
        pitch = np.float32(pitch)
    return leg.replace(
        tibia_absolute_pos=np.float32(leg.tibia_absolute_pos) - pitch,
        tibia_absolute_neg=np.float32(leg.tibia_absolute_neg) - pitch,
    )


def _as_leg0(points: torch.Tensor, q: torch.Tensor, body_angle):
    """Un-rotate by the body quaternion, then yaw by -body_angle."""
    p = quat.inv_rotate(q, points)
    c = float(_cos(-np.float32(body_angle)))
    s = float(_sin(-np.float32(body_angle)))
    x = p[..., 0] * c - p[..., 1] * s
    y = p[..., 0] * s + p[..., 1] * c
    return torch.stack([x, y, p[..., 2]], dim=-1), (c, s)


def _undo_leg0(vec: torch.Tensor, cs, q: torch.Tensor):
    c, s = cs
    x = vec[..., 0] * c + vec[..., 1] * s
    y = -vec[..., 0] * s + vec[..., 1] * c
    v = torch.stack([x, y, vec[..., 2]], dim=-1)
    return quat.rotate(q, v)


def reachability_oriented(points: torch.Tensor, leg: LegDimensions, q):
    """Reachability under body orientation ``q`` (one_leg_global.cu:103-130)."""
    q = _quat_tensor(q, like=points).to(points.device)
    oriented = rotate_leg_data(q, leg)
    ws = build_workspace(oriented)
    p0, _ = _as_leg0(points, q, oriented.body_angle)
    return reachability_ws(p0, ws)


def distance_oriented(points: torch.Tensor, leg: LegDimensions, q):
    """Distance under body orientation ``q`` (one_leg_global.cu:74-101).

    Returns ``(reachable, displacement)`` with the displacement re-expressed
    in the world frame.
    """
    q = _quat_tensor(q, like=points).to(points.device)
    oriented = rotate_leg_data(q, leg)
    ws = build_workspace(oriented)
    p0, cs = _as_leg0(points, q, oriented.body_angle)
    ok, vec = distance_ws(p0, ws)
    return ok, _undo_leg0(vec, cs, q)


def oriented_workspace_items(quats: torch.Tensor, robot: LegDimensions) -> list:
    """Host workspaces of every (pose, leg), pose-major: one
    :func:`build_workspace` per pair, on the leg whose absolute-tibia limits
    are shifted by that pose's pitch in the leg's frame
    (:func:`rotate_leg_data`)."""
    A = quats.shape[0]
    L = leg_count(robot)
    oriented = rotate_leg_data(quats[:, None, :], robot)  # fields [A, L] / [L]
    legs = [leg_of(robot, l) for l in range(L)]
    return [
        build_workspace(legs[l].replace(
            tibia_absolute_pos=np.float32(oriented.tibia_absolute_pos[a, l]),
            tibia_absolute_neg=np.float32(oriented.tibia_absolute_neg[a, l]),
        ))
        for a in range(A) for l in range(L)
    ]


def oriented_workspaces(quats: torch.Tensor, robot: LegDimensions):
    """Workspace tables of every (pose, leg) as ``[A, L, 1, ...]`` tensors
    on the quaternions' device (:func:`oriented_workspace_items`, stacked)."""
    items = oriented_workspace_items(quats, robot)
    return stack_workspaces(items, (quats.shape[0], leg_count(robot), 1),
                            quats.device)


def reachability_oriented_poses(rel: torch.Tensor, quats: torch.Tensor,
                                robot: LegDimensions, ws=None) -> torch.Tensor:
    """``[A, L, C]`` bool: candidate c of pose a is reachable by leg l.

    ``rel [A, C, 3]`` are candidate positions relative to each pose's body
    position, ``quats [A, 4]`` the poses' orientations, ``robot`` a stacked
    robot.  The same chain as :func:`reachability_oriented`, with the pose
    and leg axes written out and the tables of :func:`oriented_workspaces`
    (pass them as ``ws`` to reuse them over several candidate sets)
    broadcast against the candidates.
    """
    quats = quats.to(torch.float32)
    if ws is None:
        ws = oriented_workspaces(quats, robot)
    p = quat.inv_rotate(quats[:, None, :], rel)  # [A, C, 3]
    ba = np.asarray(robot.body_angle, np.float32)
    c = torch.as_tensor(_cos(-ba), device=rel.device)[None, :, None]
    s = torch.as_tensor(_sin(-ba), device=rel.device)[None, :, None]
    px, py = p[:, None, :, 0], p[:, None, :, 1]
    x = px * c - py * s  # [A, L, C]
    y = px * s + py * c
    z = p[:, None, :, 2].expand_as(x)
    return reachability_xyz(x, y, z, ws)


def gravity_check(points: torch.Tensor, leg: LegDimensions, q):
    """Outward-side heuristic (reference ``simpleGravityCheck``,
    one_leg_global.cu:9-23; compiled out by default via settings.h:22
    ``enableGrav = false`` — likewise opt-in here).

    A target is "gravity-valid" for a leg if it lies on the outward side of
    the vertical plane through the (orientation-rotated) coxa joint:
    ``dot(target - coxa, horiz(R(q) coxa)) > 0``.  Returns
    ``(valid, plane_to_point)`` where ``plane_to_point`` is the projection
    displacement the reference substitutes for the distance vector when the
    check fails (one_leg_global.cu:253-264).
    """
    q = _quat_tensor(q, like=points).to(points.device)
    c = _cos(np.float32(leg.body_angle))
    s = _sin(np.float32(leg.body_angle))
    body = np.float32(leg.body)
    coxa = torch.as_tensor(
        np.stack([c * body, s * body, np.zeros_like(c)], axis=-1),
        device=points.device)
    rot = quat.rotate(q, coxa)
    horiz = rot * torch.tensor([1.0, 1.0, 0.0], device=points.device)
    rel = points - coxa
    dotp = torch.sum(rel * horiz, dim=-1)
    valid = dotp > 0
    denom = torch.sum(horiz * horiz, dim=-1)
    plane_to_point = horiz * (dotp / denom)[..., None]
    return valid, plane_to_point


def distance_oriented_grav(points, leg, q):
    """``distance_oriented`` with the gravity heuristic enabled
    (the ``enableGrav = true`` build of reference distance(),
    one_leg_global.cu:253-264): gravity-invalid points report unreachable
    with the plane-projection displacement."""
    gvalid, gdist = gravity_check(points, leg, q)
    ok, vec = distance_oriented(points, leg, q)
    ok = ok & gvalid
    vec = torch.where(gvalid[..., None], vec, gdist)
    return ok, vec


def _on_device(points, device):
    from .config import resolve_device

    dev = resolve_device(device)
    return torch.as_tensor(points, dtype=torch.float32).to(dev)


def reachability_oriented_batch(points, leg, q, device=None):
    """Flat entry point: ``[N, 3]`` points (array or tensor) moved to
    ``device`` (``None`` = the CUDA card, which must exist)."""
    return reachability_oriented(_on_device(points, device), leg, q)


def distance_oriented_batch(points, leg, q, device=None):
    """Flat entry point of :func:`distance_oriented`, see
    :func:`reachability_oriented_batch`."""
    return distance_oriented(_on_device(points, device), leg, q)

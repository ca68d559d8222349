"""Multi-leg body-pose positionability: dense (pose x foothold x leg) solve.

Semantics of the reference's two positionability pipelines:

* thrust pipeline ``multi_rot_estimator::eliminateUnreachable``
  (several_leg.cu:707-741): per (pose, leg), is ANY terrain point reachable?
  then AND across legs (``agregateReachability``, several_leg.cu:681-697);
* octree kernel ``validity_child`` (several_leg_octree.cu:19-151): count
  reachable legs per (pose, orientation), feasible iff
  ``count >= LegNumberForStab``.

The CUDA block-per-pose / thread-per-foothold warp-vote reduction becomes a
dense ``[chunk, L, F]`` reachability tensor reduced with ``any``, the pose
axis walked in chunks so that tensor stays bounded.  This is the exhaustive
ground truth every pruned solver (ops/grid.py, ops/csr_grid.py) is held
against: it goes through the plain tensor formulation of
ops/orientation.py, not through the fused kernels' arithmetic.

Per-foothold evaluation is the reference ``reachable_rotate_leg``
(several_leg.cu:48-67) generalized to arbitrary body orientation via the
orientation layer (one_leg_global.cu:74-130): vect = foothold - body_pos,
evaluated in the quaternion-rotated, azimuth-aligned leg frame.
"""

from __future__ import annotations

import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.leg import LegDimensions
from legmov_tpu_torch.models.robot import leg_count
from legmov_tpu_torch.ops.orientation import (
    oriented_workspaces,
    reachability_oriented_poses,
)
from legmov_tpu_torch.ops.quaternion import IDENTITY

#: elements of the ``[chunk, L, F]`` tensor a call keeps alive at once (the
#: plain evaluator holds some twenty float32 temporaries of ``[.., 4]`` that
#: size: 2^22 elements are about 1.5 GB of peak)
_CHUNK_ELEMENTS = 1 << 22


def _identity_quats(n: int, device) -> torch.Tensor:
    return torch.as_tensor(IDENTITY, device=device).expand(n, 4)


def reachable_legs(
    body_pos: torch.Tensor,
    body_quat: torch.Tensor | None,
    footholds: torch.Tensor,
    robot: LegDimensions,
    chunk: int = 0,
) -> torch.Tensor:
    """``[P, L]`` bool: leg l of a robot at pose p can grab some foothold.

    ``body_pos [P, 3]``, ``body_quat [P, 4]`` (or None = identity),
    ``footholds [F, 3]``, all on one device.  ``chunk`` poses are evaluated
    at a time (0 = as many as keep ``chunk * L * F`` near 4 M elements).
    """
    P, F = body_pos.shape[0], footholds.shape[0]
    L = leg_count(robot)
    out = torch.zeros((P, L), dtype=torch.bool, device=body_pos.device)
    if P == 0 or F == 0:
        return out
    ws = None
    if body_quat is None:
        body_quat = _identity_quats(P, body_pos.device)
        # one orientation for every pose: its workspace tables are built
        # once and broadcast over the poses (building them is per pose)
        ws = oriented_workspaces(body_quat[:1], robot)
    if not chunk:
        chunk = max(1, _CHUNK_ELEMENTS // (L * F))
    for lo in range(0, P, chunk):
        pos = body_pos[lo:lo + chunk]
        rel = footholds[None, :, :] - pos[:, None, :]
        out[lo:lo + chunk] = torch.any(
            reachability_oriented_poses(rel, body_quat[lo:lo + chunk], robot,
                                        ws),
            dim=-1)
    return out


def reachable_leg_counts(body_pos, body_quat, footholds, robot) -> torch.Tensor:
    """``[P]`` int32: number of legs with at least one reachable foothold."""
    return torch.sum(
        reachable_legs(body_pos, body_quat, footholds, robot), dim=-1
    ).to(torch.int32)


def positionable(
    body_pos, body_quat, footholds, robot: LegDimensions, k: int | None = None,
    chunk: int = 0,
) -> torch.Tensor:
    """``[P]`` bool: >= ``k`` legs can grab a foothold (default: all legs).

    Reference: validity condition ``reachabilityCount >= LegNumberForStab``
    (several_leg_octree.cu:115-129, settings.h:46).
    """
    legs = reachable_legs(body_pos, body_quat, footholds, robot, chunk)
    if k is None:
        k = leg_count(robot)
    return torch.sum(legs, dim=-1) >= int(k)


def positionable_batch(
    body_pos, body_quat, footholds, robot, k: int | None = None,
    chunk: int = 0, device=None,
) -> torch.Tensor:
    """Flat entry point: arrays or tensors in, ``[P]`` bool on ``device``
    (``None`` = the CUDA card, which must exist).  ``chunk > 0`` bounds peak
    memory to ``chunk * L * F`` booleans' worth of temporaries — the
    analogue of the reference's <=1024-thread target tiling
    (several_leg.cu:143-156); any pose count works.
    """
    dev = resolve_device(device)

    def to_dev(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    quat = None if body_quat is None else to_dev(body_quat)
    return positionable(to_dev(body_pos), quat, to_dev(footholds), robot, k,
                        chunk)

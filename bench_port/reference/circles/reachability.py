"""Single-leg reachability over point batches (plain PyTorch formulation).

Semantics of reference ``reachability_circles`` (one_leg.cu:280-319): world
point -> coxa frame -> coxa yaw-limit test -> rotate into the coxa vertical
plane -> 4 masked circle tests.  One thread per point becomes one tensor
element per point.  The fused CUDA kernel for the same function is
ops/cuda_kernels.py ``make_reachability_kernel``; this module is the
independent tensor formulation the kernel is also held against.
"""

from __future__ import annotations

import torch

from .config import resolve_device
from .leg import LegDimensions
from .workspace import (
    LegWorkspace,
    build_workspace,
    workspace_tensors,
)
from . import frames, trig32
from .plane import plane_validate


def reachability_xyz(x, y, z, ws: LegWorkspace) -> torch.Tensor:
    """Component-form reachability core (world coordinates in, bool out).

    Fully trig-free per point: the reference's ``atan2`` + ``sincos`` chain
    (one_leg.cu:288-315) collapses to one ``sqrt`` plus cross-product sign
    tests against precomputed limit directions, because rotating a point
    into its own coxa plane just replaces (x, y) by its radius.
    """
    ws = workspace_tensors(ws, x.device)
    x, y, z = frames.place_over_coxa_xyz(x, y, z, ws.body, ws.coxa_pitch)

    # required coxa yaw, computed on the mirrored half-plane when x < 0
    # (one_leg.cu:288-303): angle = atan2(fy, fx) in (-pi/2, pi/2].  The
    # limit tests angle > max / angle < min become cross-product signs
    # (wrap-free because |angle| <= pi/2 and |limit| < pi/2; limits beyond
    # +-pi/2 can never fire on the mirrored half-plane).
    flip = torch.signbit(x)
    fx = torch.where(flip, -x, x)
    fy = torch.where(flip, -y, y)
    gt_max = ws.coxa_gt_possible & (
        fy * ws.coxa_max_dir[..., 0] - fx * ws.coxa_max_dir[..., 1] > 0
    )
    lt_min = ws.coxa_lt_possible & (
        fy * ws.coxa_min_dir[..., 0] - fx * ws.coxa_min_dir[..., 1] < 0
    )
    coxa_invalid = gt_max | lt_min

    # "rotate into the coxa vertical plane" = radial coordinate +-rho
    rho = trig32.sqrt(x * x + y * y)
    xr = torch.where(flip, -rho, rho)
    reach = plane_validate(xr - ws.coxa_length, z, ws)
    return torch.logical_not(coxa_invalid) & reach


def reachability_ws(points: torch.Tensor, ws: LegWorkspace) -> torch.Tensor:
    """Reachability booleans for ``points [..., 3]`` given a prebuilt workspace."""
    return reachability_xyz(
        points[..., 0], points[..., 1], points[..., 2], ws
    )


def reachability(points: torch.Tensor, leg: LegDimensions) -> torch.Tensor:
    """Reachability booleans for ``points [..., 3]`` for one leg, computed
    on the device the tensor lives on."""
    return reachability_ws(points, build_workspace(leg))


def reachability_batch(points, leg: LegDimensions, device=None) -> torch.Tensor:
    """Flat entry point: ``[N, 3] float32 -> [N] bool`` on ``device``.

    ``points`` may be a numpy array or a tensor; it is moved to ``device``
    (``None`` = the CUDA card, which must exist).
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev)
    return reachability(pts, leg)

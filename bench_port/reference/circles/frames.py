"""Frame transforms between world, coxa and the coxa-rotated vertical plane.

Semantics of reference one_leg.cu:9-29 (``place_over_coxa``,
``find_coxa_angle``) and :146-165 (``cancel/restore_coxa_rotation``),
vectorized over arbitrary leading axes.  All inputs/outputs are float32
coordinate tensors ``[..., 3]`` or component tuples; angles may be tensors
or host scalars.
"""

from __future__ import annotations

import torch


def _sincos(angle, like: torch.Tensor):
    """(sin, cos) of ``angle`` as float32 tensors on ``like``'s device."""
    a = torch.as_tensor(angle, dtype=torch.float32, device=like.device)
    return torch.sin(a), torch.cos(a)


def place_over_coxa_xyz(x, y, z, body, coxa_pitch):
    """Component form of :func:`place_over_coxa` (one_leg.cu:9-24)."""
    x = x - body
    s, c = _sincos(-coxa_pitch, x)
    return x * c - z * s, y, x * s + z * c


def place_over_coxa(xyz: torch.Tensor, body, coxa_pitch) -> torch.Tensor:
    """World -> coxa frame: shift by -body along x, pitch by -coxa_pitch.

    Matches reference one_leg.cu:9-24 (forward direction).
    """
    x, y, z = place_over_coxa_xyz(
        xyz[..., 0], xyz[..., 1], xyz[..., 2], body, coxa_pitch
    )
    return torch.stack([x, y, z], dim=-1)


def unplace_over_coxa_xyz(x, y, z, coxa_pitch):
    """Component form of :func:`unplace_over_coxa`."""
    s, c = _sincos(coxa_pitch, x)
    return x * c - z * s, y, x * s + z * c


def unplace_over_coxa(xyz: torch.Tensor, coxa_pitch) -> torch.Tensor:
    """Rotate a *displacement vector* back from coxa to world orientation.

    Matches ``place_over_coxa<Reverse=true>`` (one_leg.cu:9-24): only the
    pitch rotation is undone; the body shift is not re-applied because the
    quantity being transformed is a displacement, not a position.
    """
    x, y, z = unplace_over_coxa_xyz(
        xyz[..., 0], xyz[..., 1], xyz[..., 2], coxa_pitch
    )
    return torch.stack([x, y, z], dim=-1)


def coxa_angle_flipped(x, y):
    """Coxa yaw required to point at (x, y), computed on the +x half plane.

    Reference one_leg.cu:288-303: when x is negative (including -0.0) the
    point is mirrored through the origin before the atan2, so the returned
    angle always lies in (-pi/2, pi/2]; the evaluation then proceeds in a
    plane whose radial coordinate may be negative.
    """
    flip = torch.signbit(x)
    fx = torch.where(flip, -x, x)
    fy = torch.where(flip, -y, y)
    return torch.atan2(fy, fx)


def rot_z(x, y, angle):
    """Rotate (x, y) by +angle about z, returning (x', y', cos, sin).

    ``cancel_coxa_rotation(p, a)`` in the reference (one_leg.cu:146-156)
    rotates by -a; call this with ``-a`` for that behaviour.  The returned
    cos/sin pair is of the *applied* angle, for later ``unrot_z``.
    """
    s, c = _sincos(angle, x)
    return x * c - y * s, x * s + y * c, c, s


def cancel_coxa_rotation(x, y, coxa_angle):
    """Rotate into the coxa-aligned vertical plane (one_leg.cu:146-156)."""
    s, c = _sincos(coxa_angle, x)
    # rotation by -coxa_angle
    return x * c + y * s, -x * s + y * c, c, s


def restore_coxa_rotation(x, y, c, s):
    """Inverse of :func:`cancel_coxa_rotation` given its cached cos/sin."""
    return x * c - y * s, x * s + y * c

"""Quaternion algebra (standard Hamilton convention, (w, x, y, z) order).

Functional equivalent of reference unified_math_cuda.cu.h:13-105.  Note the
reference stores quaternions in a permuted float4 layout with a non-standard
axis-angle constructor (unified_math_cuda.cu.h:48-57 puts sin(a/2) in the
scalar slot); we deliberately use the textbook convention
``q = (cos(a/2), sin(a/2) * axis)`` — every consumer in this framework is
written against it and validated geometrically, not against the reference's
internal layout.

All functions broadcast over leading axes; quaternions are ``[..., 4]``
float32 tensors, vectors ``[..., 3]``.  Results live on the device of the
inputs (numpy or Python inputs give CPU tensors).  Products and sums are
float32 in the written order; every transcendental (``sin``, ``cos``,
``arcsin``, ``arctan2``) is :mod:`trig32`'s, the JAX
package's float32 values as elementwise tensor arithmetic, so the results
equal the JAX package's bit for bit and do not depend on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import trig32

IDENTITY = np.array([1.0, 0.0, 0.0, 0.0], np.float32)

_HALF_PI = float(np.float32(math.pi / 2))


def _f32(a, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def from_axis_angle(axis, angle) -> torch.Tensor:
    """Unit quaternion rotating by ``angle`` about ``axis`` (normalized)."""
    angle = _f32(angle, like=axis)
    axis = _f32(axis, like=angle)
    half = angle / 2.0
    s, c = trig32.sincos(half)
    n = trig32.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    u = axis / n
    ones = torch.ones_like(u[..., 0])
    w = (c * ones)[..., None]
    xyz = u * (s * ones)[..., None]
    return torch.cat([w.expand(xyz.shape[:-1] + (1,)), xyz], dim=-1)


def multiply(q1, q2) -> torch.Tensor:
    """Hamilton product ``q1 * q2``."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def invert(q) -> torch.Tensor:
    """Quaternion inverse (conjugate / squared norm)."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=torch.float32,
                        device=q.device)
    return (q * sign) / n2


def _cross(a, b) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def rotate(q, v) -> torch.Tensor:
    """Rotate vector(s) ``v`` by quaternion(s) ``q``."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    # v' = v + 2w (u x v) + 2 u x (u x v)
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def inv_rotate(q, v) -> torch.Tensor:
    return rotate(invert(q), v)


def from_rpy(roll, pitch, yaw) -> torch.Tensor:
    """Quaternion for extrinsic x-y-z (roll, pitch, yaw) rotations.

    Same composition order as reference octree_util.cu.h:164-172
    ``RPYtoQuat``: yaw * pitch * roll.
    """
    roll = _f32(roll)
    pitch = _f32(pitch, like=roll)
    yaw = _f32(yaw, like=roll)
    roll, pitch, yaw = torch.broadcast_tensors(roll, pitch, yaw)
    s, c = trig32.sincos(torch.stack([roll, pitch, yaw]) / 2)
    z = torch.zeros_like(roll)
    qx = torch.stack([c[0], s[0], z, z], dim=-1)
    qy = torch.stack([c[1], z, s[1], z], dim=-1)
    qz = torch.stack([c[2], z, z, s[2]], dim=-1)
    return multiply(qz, multiply(qy, qx))


def _pitch(sinp):
    """The pitch of :func:`to_rpy` from its ``sinp``."""
    return torch.where(
        torch.abs(sinp) >= 1,
        torch.sign(sinp) * _HALF_PI,
        trig32.asin(torch.clamp(sinp, -1.0, 1.0)),
    )


def to_rpy(q) -> torch.Tensor:
    """Roll-pitch-yaw ``[..., 3]`` from quaternion (unified_math:59-83 intent)."""
    w, x, y, z = (q[..., i] for i in range(4))
    sinr = 2.0 * (w * x + y * z)
    cosr = 1.0 - 2.0 * (x * x + y * y)
    roll = trig32.atan2(sinr, cosr)
    pitch = _pitch(2.0 * (w * y - z * x))
    siny = 2.0 * (w * z + x * y)
    cosy = 1.0 - 2.0 * (y * y + z * z)
    yaw = trig32.atan2(siny, cosy)
    return torch.stack([roll, pitch, yaw], dim=-1)


def frame_quats(frame_yaw):
    """``(qz, qz^-1)``, the rotations into the frames yawed by
    ``frame_yaw`` (``[..., 4]`` each, on ``frame_yaw``'s device; numpy or
    Python input gives CPU tensors).  They depend only on the leg, so code
    that builds tables makes them once a robot and passes them to
    :func:`pitch_in_frames`."""
    frame_yaw = _f32(frame_yaw)
    axis = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                        device=frame_yaw.device)
    qz = from_axis_angle(axis, -frame_yaw)
    return qz, invert(qz)


def pitch_in_frames(q, qz, qz_inv) -> torch.Tensor:
    """:func:`pitch_in_frame` with the frames of :func:`frame_quats`: the
    pitch of ``qz * q * qz^-1``, computed as :func:`to_rpy` does."""
    q_leg = multiply(multiply(qz, q), qz_inv)
    w, x, y, z = (q_leg[..., i] for i in range(4))
    return _pitch(2.0 * (w * y - z * x))


def pitch_in_frame(q, frame_yaw) -> torch.Tensor:
    """Pitch component of ``q`` expressed in a frame yawed by ``frame_yaw``.

    Used by the orientation layer (semantics of reference
    one_leg_global.cu:48-60 ``rotate_leg_data``): conjugate the body
    orientation into the leg-azimuth frame and extract its pitch.  At the
    identity quaternion the result is exactly 0 for every ``frame_yaw``.
    """
    return pitch_in_frames(q, *frame_quats(_f32(frame_yaw, like=q)))

"""The moon terrain, generated on the device from seeds.

The reference's flagship terrain (maps.py:190-297, as the port's
``terrain.moon_ground`` writes it): a lattice over ``x_range`` x
``y_range`` with 50 random sphere craters and domes, a big crater, a cliff
and two rocks, then coarse (x300 mm) fractal Perlin relief, heights
saturated at ``saturate_z``, then fine (x30 mm) relief.  Two seeds drive it:
``relief_seed`` draws the craters and the coarse relief, ``detail_seed`` the
fine relief; with ``detail_seed=None`` the fine relief continues the relief
seed's stream, which is the port's ``moon_ground(seed=relief_seed)``.

The heights are float64 tensor arithmetic on ``device`` in the order of the
port's native crater loop and Perlin blend; only the gradient lattices
(at most a few thousand angles) are drawn on the host, and their sines and
cosines come from Python's ``math`` so that they are the same on every
host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_f64 = torch.float64


def _gradients(rng: np.random.Generator, res) -> np.ndarray:
    theta = rng.uniform(0.0, 2.0 * np.pi, size=(res[0] + 1, res[1] + 1))
    return np.array([[[math.cos(t), math.sin(t)] for t in row]
                     for row in theta], np.float64)


def _perlin(shape, res, rng, device) -> torch.Tensor:
    """One Perlin layer ``[nx, ny]``: the sqrt(2)-normalised blend of the
    four lattice corners with the quintic fade, corners in the order
    (0, 0), (0, 1), (1, 0), (1, 1)."""
    if shape[0] % res[0] or shape[1] % res[1]:
        raise ValueError(f"shape {shape} not a multiple of res {res}")
    grad = torch.from_numpy(_gradients(rng, res)).to(device)
    c0, c1 = shape[0] // res[0], shape[1] // res[1]
    i = torch.arange(shape[0], device=device)
    j = torch.arange(shape[1], device=device)
    i0, j0 = i // c0, j // c1
    u = (i % c0).to(_f64) / c0
    v = (j % c1).to(_f64) / c1
    fu = u * u * u * (u * (6.0 * u - 15.0) + 10.0)
    fv = v * v * v * (v * (6.0 * v - 15.0) + 10.0)
    acc = torch.zeros(shape, dtype=_f64, device=device)
    for di in (0, 1):
        wi = (fu if di else 1.0 - fu)[:, None]
        for dj in (0, 1):
            wj = (fv if dj else 1.0 - fv)[None, :]
            g = grad[(i0 + di)[:, None], (j0 + dj)[None, :]]
            acc = acc + wi * wj * (g[..., 0] * (u - di)[:, None]
                                   + g[..., 1] * (v - dj)[None, :])
    return math.sqrt(2.0) * acc


def _fractal(shape, res, rng, octaves, persistence, lacunarity, device):
    total = None
    for o in range(octaves):
        layer = persistence ** o * _perlin(
            shape, (res[0] * lacunarity ** o, res[1] * lacunarity ** o), rng,
            device)
        total = layer if total is None else total + layer
    return total


def _landmarks():
    """Rows ``(cx, cy, cz, radius, down)`` of the big crater, the cliff and
    the two rocks."""
    return np.asarray([[-2000.0, -3000.0, 300.0, 3000.0, 1.0],
                       [2000.0, 4000.0, -800.0, 4000.0, 0.0],
                       [1500.0, 0.0, -150.0, 1000.0, 0.0],
                       [1500.0, -1000.0, -150.0, 700.0, 0.0]])


def moon_ground(shape, x_range, y_range, n_craters: int, relief_seed: int,
                detail_seed, saturate_z: float, device) -> torch.Tensor:
    """``[nx * ny, 3]`` float32 footholds in mm on ``device``, x-outer
    (row ``i * ny + j`` is ``(x_i, y_j, z_ij)``)."""
    nx, ny = int(shape[0]), int(shape[1])
    rng = np.random.default_rng(relief_seed)
    # numpy's linspace values, so that the lattice is the port's bit for bit
    xs = torch.from_numpy(np.linspace(*x_range, nx)).to(device)
    ys = torch.from_numpy(np.linspace(*y_range, ny)).to(device)
    cr = rng.random((n_craters, 4))
    cr[:, 0] = cr[:, 0] * 4000 - 2000
    cr[:, 1] = cr[:, 1] * 4000 - 2000
    cr[:, 2] = cr[:, 2] * 300 - 400
    cr[:, 3] = cr[:, 3] * 300 + 200
    spheres = np.concatenate(
        [np.concatenate([cr, (cr[:, 2] > 0).astype(np.float64)[:, None]],
                        axis=1), _landmarks()])
    X = xs[:, None].expand(nx, ny)
    Y = ys[None, :].expand(nx, ny)
    zz = torch.zeros((nx, ny), dtype=_f64, device=device)
    for cx, cy, cz, r, down in spheres.tolist():
        dx = X - cx
        dy = Y - cy
        dz = zz - cz
        xy2 = dx * dx + dy * dy
        inside = xy2 + dz * dz <= r * r
        cap = torch.clamp(r * r - xy2, min=0.0)
        delta = torch.sqrt(cap) + (dz if down > 0.5 else -dz)
        zz = torch.where(inside, zz - delta if down > 0.5 else zz + delta, zz)
    zz = zz + _fractal((nx, ny), (8, 4), rng, 5, 0.35, 2, device) * 300.0
    zz = torch.where(zz > saturate_z, torch.full_like(zz, saturate_z), zz)
    fine_rng = rng if detail_seed is None else np.random.default_rng(
        detail_seed)
    zz = zz + _fractal((nx, ny), (32, 16), fine_rng, 3, 0.2, 2, device) * 30.0
    pts = torch.stack([X.reshape(-1), Y.reshape(-1), zz.reshape(-1)], dim=-1)
    return pts.to(torch.float32)

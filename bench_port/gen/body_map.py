"""The body-position map of a map cell: the reference's voxel lattice.

before.py:24-61 samples body positions on a lattice of ``voxel`` mm over
the terrain's x and y extent and its z extent plus ``z_above`` mm, in
numpy's ``arange`` from each minimum (the maximum left out) and
``meshgrid``'s default ``xy`` order, as float32.  The port's ``cli
prepare`` writes the same lattice (``numpy_input_b``); this is the
benchmark's own copy of the rule, so that the inputs do not depend on the
program.
"""

from __future__ import annotations

import numpy as np


def _axes(terrain: np.ndarray, voxel: float, z_above: float) -> tuple:
    t = np.asarray(terrain, np.float32)
    return (np.arange(t[:, 0].min(), t[:, 0].max(), voxel),
            np.arange(t[:, 1].min(), t[:, 1].max(), voxel),
            np.arange(t[:, 2].min(), t[:, 2].max() + z_above, voxel))


def voxel_map(terrain: np.ndarray, voxel: float, z_above: float) -> np.ndarray:
    """``[B, 3]`` float32 body positions over ``[N, 3]`` float32 terrain."""
    X, Y, Z = np.meshgrid(*_axes(terrain, voxel, z_above))
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)


def lattice_shape(terrain: np.ndarray, voxel: float, z_above: float) -> tuple:
    """``(ny, nx, nz)``: :func:`voxel_map`'s positions reshaped to this are
    the lattice, y outermost and z fastest."""
    xs, ys, zs = _axes(terrain, voxel, z_above)
    return ys.size, xs.size, zs.size

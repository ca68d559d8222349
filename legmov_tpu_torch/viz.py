"""Result rendering: reachability silhouettes and distance-field images.

Functional re-derivation of the reference's ``after.py`` report stage:
slice the 3-D query grid at y~0 (or a z cut), render the boolean
reachability image, the distance-norm viridis image with the workspace-edge
contour (norm < pix/2) and a quiver of -displacement vectors, and estimate
the reachable volume.  Uses matplotlib with the Agg backend (file output
only), imported when an image is rendered.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib is imported by the two render functions only, so the
    CLI and :func:`reachable_volume_m3` work on machines without it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def pyplot_or_none():
    """:func:`_pyplot`, or None where matplotlib does not import (the
    viewers then compute all the same and say that no image was written)."""
    try:
        return _pyplot()
    except ImportError:
        return None


def slice_mask(targets: np.ndarray, axis: int = 1, cut: float = 0.0) -> np.ndarray:
    """Mask of the grid points on the slice plane nearest to ``cut`` from
    above (after.py:216-224 ``closest_to_0`` selection)."""
    vals = targets[:, axis]
    above = vals[vals >= cut]
    if above.size == 0:
        closest = vals.max()
    else:
        closest = above.min()
    return vals == closest


def _as_image(xy: np.ndarray, values: np.ndarray):
    """Scatter-on-grid -> dense 2-D image + extent (bool_grid_image intent)."""
    xs = np.unique(xy[:, 0])
    ys = np.unique(xy[:, 1])
    ix = np.searchsorted(xs, xy[:, 0])
    iy = np.searchsorted(ys, xy[:, 1])
    img = np.full((ys.size, xs.size), np.nan, np.float64)
    img[iy, ix] = values
    extent = (xs.min(), xs.max(), ys.min(), ys.max())
    return img, extent


def render_reachability(
    targets: np.ndarray,
    reach: np.ndarray,
    path: str,
    axis: int = 1,
    cut: float = 0.0,
    title: str | None = None,
) -> None:
    """Boolean reachable-region image on a slice (after.py:150-199)."""
    plt = _pyplot()
    sel = slice_mask(targets, axis, cut)
    plane_axes = [a for a in range(3) if a != axis]
    xy = targets[sel][:, plane_axes]
    img, extent = _as_image(xy, reach[sel].astype(float))
    plt.figure(figsize=(7, 6))
    plt.imshow(
        img, origin="lower", extent=extent, cmap="Greens", vmin=0, vmax=1.3
    )
    plt.xlabel("x (mm)")
    plt.ylabel("z (mm)" if axis == 1 else "y (mm)")
    if title:
        plt.title(title)
    plt.savefig(path, bbox_inches="tight", dpi=150)
    plt.close()


def render_distance(
    targets: np.ndarray,
    dist_vec: np.ndarray,
    path: str,
    axis: int = 1,
    cut: float = 0.0,
    saturate: float = 200.0,
    pix_size: float = 5.0,
    quiver: bool = True,
    title: str | None = None,
) -> None:
    """Distance-norm image + edge contour + quiver (after.py:200-283)."""
    plt = _pyplot()
    sel = slice_mask(targets, axis, cut)
    plane_axes = [a for a in range(3) if a != axis]
    xy = targets[sel][:, plane_axes]
    norm = np.minimum(np.linalg.norm(dist_vec[sel], axis=-1), saturate)
    img, extent = _as_image(xy, norm)
    edge = norm < max(pix_size / 2, 1.0)

    plt.figure(figsize=(7, 6))
    plt.imshow(img, origin="lower", extent=extent, cmap="viridis")
    plt.colorbar(label="distance to edge (mm)")
    eimg, _ = _as_image(xy, edge.astype(float))
    plt.contour(
        np.nan_to_num(eimg),
        levels=[0.5],
        extent=extent,
        colors="white",
        linewidths=0.8,
    )
    if quiver:
        step = max(1, xy.shape[0] // 800)
        v = dist_vec[sel][:, plane_axes]
        plt.quiver(
            xy[::step, 0],
            xy[::step, 1],
            -v[::step, 0],
            -v[::step, 1],
            color="black",
            width=0.002,
            scale_units="xy",
            scale=1.0,
        )
    plt.xlabel("x (mm)")
    plt.ylabel("z (mm)" if axis == 1 else "y (mm)")
    if title:
        plt.title(title)
    plt.savefig(path, bbox_inches="tight", dpi=150)
    plt.close()


def reachable_volume_m3(reach: np.ndarray, pix_size: float) -> float:
    """Reachable-volume estimate from a dense grid (after.py:284-319)."""
    return float(reach.sum()) * pix_size**3 / 1e9

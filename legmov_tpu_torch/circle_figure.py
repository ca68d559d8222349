"""Workspace circle-decomposition figure (circleIllu.py equivalent).

Renders the in-plane circles (inner, outer, fromabove+-, winglet+-), the
corner points and the reachable silhouette of a leg: the publication
figure the reference builds in circleIllu.py, and a visual debugging aid
for the workspace tables.  The silhouette is ops/plane.py
``plane_validate`` over an 800 x 800 femur-frame grid on ``--device``
(tensor operations: this figure has no kernel).

Run: ``python -m legmov_tpu_torch.circle_figure [--device cpu]
[--leg m2|moonbot] [--out build/circles.png]``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg
from legmov_tpu_torch.models.workspace import build_workspace
from legmov_tpu_torch.ops.plane import plane_validate
from legmov_tpu_torch.viz import pyplot_or_none

SIDE = 800  # silhouette pixels per axis


def figure_data(leg, device) -> dict:
    """What the figure draws: ``lim`` (the half extent, mm), ``valid``
    ``[SIDE, SIDE]`` bool (x-major), ``circles`` (the unique circles as
    ``(cx, cy, r, attract)``), ``corners [10, 2]`` and ``corner_valid``."""
    dev = resolve_device(device)
    ws = build_workspace(leg)
    lim = float(np.asarray(leg.femur_length + leg.tibia_length)) * 1.3
    xs = np.linspace(-lim, lim, SIDE, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    valid = plane_validate(torch.from_numpy(X.ravel()).to(dev),
                           torch.from_numpy(Y.ravel()).to(dev), ws)
    circles, seen = [], set()
    for r in range(2):
        for e in range(2):
            for s in range(4):
                cx = float(ws.circle_x[r, e, s])
                cy = float(ws.circle_y[r, e, s])
                rad = float(ws.circle_r[r, e, s])
                key = (round(cx, 3), round(cy, 3), round(rad, 3))
                if key in seen or rad < 1e-3:
                    continue
                seen.add(key)
                circles.append((cx, cy, rad, bool(ws.circle_attract[r, e, s])))
    return {"lim": lim, "valid": valid.cpu().numpy().reshape(X.shape),
            "circles": circles, "corners": np.asarray(ws.corner_xy),
            "corner_valid": np.asarray(ws.corner_valid)}


def draw(data: dict, leg_name: str, out: str) -> bool:
    """The figure, or False where matplotlib does not import."""
    plt = pyplot_or_none()
    if plt is None:
        return False
    lim = data["lim"]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(data["valid"].T, origin="lower", extent=(-lim, lim, -lim, lim),
              cmap="Greens", alpha=0.5, vmin=0, vmax=1.6)
    theta = np.linspace(0, 2 * np.pi, 256)
    for cx, cy, rad, att in data["circles"]:
        ax.plot(cx + rad * np.cos(theta), cy + rad * np.sin(theta),
                "-" if att else "--", lw=1.2)
        ax.plot(cx, cy, "k+", ms=6)
    corners, cval = data["corners"], data["corner_valid"]
    ax.plot(corners[cval, 0], corners[cval, 1], "ro", ms=5,
            label="corner points")
    ax.plot(corners[~cval, 0], corners[~cval, 1], "rx", ms=5, alpha=0.4)
    ax.set_xlabel("radial (mm, femur frame)")
    ax.set_ylabel("vertical (mm)")
    ax.set_title(f"{leg_name} leg — circle decomposition "
                 "(solid: attractive, dashed: repulsive; green: reachable)")
    ax.legend(loc="lower left")
    ax.set_aspect("equal")
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch.circle_figure")
    ap.add_argument("--leg", choices=("m2", "moonbot"), default="m2")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="build/circles.png")
    args = ap.parse_args(argv)
    leg = {"m2": get_m2_leg, "moonbot": get_moonbot_leg}[args.leg]()
    data = figure_data(leg, args.device)
    print(f"{args.leg}: {len(data['circles'])} circles, "
          f"{int(data['corner_valid'].sum())} valid corners, reachable "
          f"share of the {SIDE} x {SIDE} grid {data['valid'].mean():.4f}")
    if draw(data, args.leg, args.out):
        print("wrote", args.out)
    else:
        print("images not written: no matplotlib")
    return data


if __name__ == "__main__":
    main()

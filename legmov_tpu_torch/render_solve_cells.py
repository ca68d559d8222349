"""Render a hierarchical-solve result (valid cells over the terrain).

Companion to ``cli solve``: loads the terrain (``numpy_input_t*.bin``) and
the solve output (``out_valid_cells_*.bin``) from a data directory and
draws the top-down map, terrain height as the base image and the valid
body-pose cell centres on top, beside the reference's octree-demo product
(``extractValidAsArray`` centres, octree_util.cu:155-180).  Reads files and
draws: no device.  Needs matplotlib.

Run: ``python -m legmov_tpu_torch.render_solve_cells [--dir data]
[--out build/solve_cells.png]``.
"""

from __future__ import annotations

import argparse
import os

from legmov_tpu_torch import io as lio
from legmov_tpu_torch.viz import pyplot_or_none


def pyplot():
    """matplotlib's pyplot on the Agg backend; raises, saying so, where
    matplotlib does not import."""
    plt = pyplot_or_none()
    if plt is None:
        raise RuntimeError("this viewer draws with matplotlib, which does "
                           "not import here")
    return plt


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch.render_solve_cells")
    ap.add_argument("--dir", default="data")
    ap.add_argument("--out", default="build/solve_cells.png")
    args = ap.parse_args(argv)
    plt = pyplot()
    terrain = lio.load_points(os.path.join(args.dir, "numpy_input_t"))
    cells = lio.load_points(os.path.join(args.dir, "out_valid_cells_"))

    fig, ax = plt.subplots(figsize=(9, 6))
    sc = ax.scatter(terrain[:, 0], terrain[:, 1], c=terrain[:, 2], s=1,
                    cmap="terrain", alpha=0.6, rasterized=True)
    plt.colorbar(sc, ax=ax, label="terrain z (mm)")
    if cells.shape[0]:
        ax.scatter(cells[:, 0], cells[:, 1], c="red", s=4, alpha=0.8,
                   label=f"valid body cells ({cells.shape[0]})")
        ax.legend(loc="upper right")
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_title("hierarchical positionability: valid body-pose cells")
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    plt.savefig(args.out, dpi=140, bbox_inches="tight")
    plt.close(fig)
    print("wrote", args.out, f"({cells.shape[0]} valid cells)")
    return cells.shape[0]


if __name__ == "__main__":
    main()

"""Quick-look viewer for raw binary dumps (reference vizu.py equivalent).

Renders the first ``rows x cols`` values of a raw array file as an image:
``python -m legmov_tpu_torch.quick_view out_reachability.bin --shape 141
161 --dtype uint8 [--out build/quick_view.png]`` (or any 2-D slice of a
float dump).  Reads a file and draws: no device.  Needs matplotlib.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from legmov_tpu_torch.render_solve_cells import pyplot


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch.quick_view")
    ap.add_argument("path")
    ap.add_argument("--shape", type=int, nargs=2, required=True)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--out", default="build/quick_view.png")
    args = ap.parse_args(argv)
    plt = pyplot()
    data = np.fromfile(args.path, dtype=np.dtype(args.dtype))
    n = args.shape[0] * args.shape[1]
    if data.size < n:
        raise ValueError(f"{args.path} holds {data.size} values, fewer than "
                         f"the {n} of --shape {args.shape[0]} {args.shape[1]}")
    img = data[:n].reshape(args.shape)
    fig = plt.figure(figsize=(8, 6))
    plt.imshow(img.T, origin="lower", cmap="viridis")
    plt.colorbar()
    plt.title(args.path)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    plt.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print("wrote", args.out)
    return img


if __name__ == "__main__":
    main()

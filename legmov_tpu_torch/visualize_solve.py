"""Positionability map visualization (after.py robot_reach equivalent).

For a terrain pointcloud, the 2-D map of feasible body positions at a fixed
clearance above the surface: terrain height as the base image, feasible
candidate poses on top, the equivalent of the reference's
``robot_reach.npy`` product (after.py:284-319).

The poses are a regular xy lattice riding a coarse max-height raster of the
terrain (``--grid-pitch``), identity orientation, ``--clearance`` mm above
it.  On the card feasibility goes through the dense-table fused solver
(ops/cuda_multileg.py ``make_fused_grid_solver`` over ``pad_grid_soa``):
one K3 launch a step, with ``top_k`` = the number of neighbour offsets, so
every occupied neighbour cell is scanned and the bits are the exhaustive
path's (``overflow`` is all False, and checked).  With ``--device cpu`` it
is the plain ops/grid.py ``grid_reachable_legs``.  ``--chunk`` poses a
solver call.

Run: ``python -m legmov_tpu_torch.visualize_solve [--device cpu]
[--points 1000000] [--legs 6] [--out build/positionability_map.png]``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.map_bench import terrain_at
from legmov_tpu_torch.models.robot import HEX_MOUNTS, QUAD_MOUNTS, make_robot
from legmov_tpu_torch.ops import cuda_multileg
from legmov_tpu_torch.ops.grid import (
    build_grid,
    cell_size_for,
    grid_reachable_legs,
    neighbor_offsets,
)
from legmov_tpu_torch.ops.quaternion import IDENTITY
from legmov_tpu_torch.viz import pyplot_or_none


def body_lattice(terrain: np.ndarray, pitch: float, clearance: float):
    """``(xs, ys, Z, body)``: the lattice axes, the max-height raster
    ``Z [xs, ys]`` (NaN where no terrain point falls, for display) and the
    ``[xs * ys, 3]`` float32 body positions, ``clearance`` above the raster
    (empty cells take the raster's median)."""
    xs = np.arange(terrain[:, 0].min(), terrain[:, 0].max(), pitch)
    ys = np.arange(terrain[:, 1].min(), terrain[:, 1].max(), pitch)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    hx = ((terrain[:, 0] - terrain[:, 0].min()) / pitch).astype(int)
    hy = ((terrain[:, 1] - terrain[:, 1].min()) / pitch).astype(int)
    H = np.full((xs.size + 1, ys.size + 1), -np.inf)
    np.maximum.at(H, (np.minimum(hx, xs.size), np.minimum(hy, ys.size)),
                  terrain[:, 2])
    Z = H[: xs.size, : ys.size]
    empty = ~np.isfinite(Z)
    fill = np.median(Z[~empty]) if (~empty).any() else 0.0
    Zf = np.where(empty, fill, Z)
    body = np.stack(
        [X.ravel(), Y.ravel(), Zf.ravel() + clearance], -1
    ).astype(np.float32)
    return xs, ys, np.where(empty, np.nan, Z), body


def make_solver(grid, robot, k: int, offsets: np.ndarray, kernel: bool):
    """``run(body [P, 3], quats [P, 4]) -> (legs [P, L], quorum [P],
    overflow [P] or None)`` over the bucket table ``grid``: K3 through the
    fused solver (``kernel``, on the card) or the plain
    ``grid_reachable_legs``."""
    if not kernel:
        def run(b, q):
            return (*grid_reachable_legs(b, q, grid, robot, k=k,
                                         offsets=offsets), None)
        return run
    offs = torch.from_numpy(np.asarray(offsets, np.int64)).to(
        grid.points.device)
    comps, cap = cuda_multileg.pad_grid_soa(grid)
    fn = cuda_multileg.make_fused_grid_solver(robot, cap)

    def run(b, q):
        return fn(b, q, *comps, grid.counts, grid.origin, grid.cell_size,
                  offs, top_k=int(offs.shape[0]), k=k, dims=grid.dims)
    return run


def feasible(run, body: np.ndarray, chunk: int, device):
    """``(feasible [P] bool, legs [P, L] bool)``: ``run`` over ``body`` in
    chunks of ``chunk`` poses at the identity orientation; raises where a
    chunk overflows."""
    feas, legs = [], []
    for s in range(0, body.shape[0], chunk):
        bp = torch.from_numpy(body[s:s + chunk]).to(device)
        quats = torch.as_tensor(IDENTITY, dtype=torch.float32,
                                device=device).expand(bp.shape[0], 4)
        got, quorum, overflow = run(bp, quats)
        if overflow is not None and bool(overflow.any()):
            raise RuntimeError("fused solver overflow with top_k = every "
                               "neighbour offset")
        feas.append(quorum.cpu().numpy())
        legs.append(got.cpu().numpy())
    return np.concatenate(feas), np.concatenate(legs)


def render(xs, ys, Z, F, title: str, out: str) -> bool:
    """The two-panel map, or False where matplotlib does not import."""
    plt = pyplot_or_none()
    if plt is None:
        return False
    ext = (xs.min(), xs.max(), ys.min(), ys.max())
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(13, 6))
    im = a1.imshow(Z.T, origin="lower", cmap="terrain", extent=ext)
    plt.colorbar(im, ax=a1, label="terrain z (mm)")
    a1.set_title("terrain height")
    a2.imshow(Z.T, origin="lower", cmap="gray", extent=ext)
    a2.imshow(np.where(F.T, 1.0, np.nan), origin="lower", cmap="Greens",
              extent=ext, alpha=0.6, vmin=0, vmax=1.3)
    a2.set_title(title)
    for a in (a1, a2):
        a.set_xlabel("x (mm)")
        a.set_ylabel("y (mm)")
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch.visualize_solve")
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--legs", type=int, choices=(4, 6), default=6)
    ap.add_argument("--clearance", type=float, default=180.0)
    ap.add_argument("--grid-pitch", type=float, default=100.0)
    ap.add_argument("--subdiv", type=int, default=2)
    ap.add_argument("--k", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="cuda (default: K3 through the fused solver) or cpu "
                    "(grid_reachable_legs)")
    ap.add_argument("--out", default="build/positionability_map.png")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    terrain = terrain_at(args.points)
    robot = make_robot(HEX_MOUNTS if args.legs == 6 else QUAD_MOUNTS)
    k = args.k or args.legs
    reach = cell_size_for(robot)
    cell = reach / args.subdiv
    grid = build_grid(terrain, cell, device=dev)
    offsets = neighbor_offsets(cell, reach)
    xs, ys, Z, body = body_lattice(terrain, args.grid_pitch, args.clearance)

    run = make_solver(grid, robot, k, offsets, kernel=dev.type == "cuda")
    t0 = time.perf_counter()
    feas, legs = feasible(run, body, args.chunk, dev)
    wall = time.perf_counter() - t0
    print(f"{body.shape[0]} poses over {terrain.shape[0]} footholds: "
          f"feasible fraction {feas.mean():.4f} ({int(feas.sum())} poses), "
          f"{wall:.3f} s on {dev.type}")
    title = (f"{args.legs}-leg stance feasible (k={k}, clearance "
             f"{args.clearance:.0f} mm): {feas.mean():.1%} of candidates")
    if render(xs, ys, Z, feas.reshape(xs.size, ys.size), title, args.out):
        print("wrote", args.out)
    else:
        print("images not written: no matplotlib")
    return {"body": body, "feasible": feas, "legs": legs, "seconds": wall,
            "footholds": terrain.shape[0]}


if __name__ == "__main__":
    main()

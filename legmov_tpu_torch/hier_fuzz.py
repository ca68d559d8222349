"""Randomized equivalence fuzz for the hierarchical solver's fused paths.

    python -m legmov_tpu_torch.hier_fuzz [--trials 6] [--seed 0]
        [--device cpu]

Each trial draws a ring of footholds, a robot, a quorum, a solver box (half
of them small enough that every level samples orientations) and the rule,
and holds ``solve_positionability(backend="auto")`` to
``backend="torch"`` (the eager ``_eval_cells``): the terminal cells and
their flags must be equal.  On the card (the default) "auto" launches the
kernels (K2's cell driver on identity levels, the CSR cell kernels on
orientation-active ones); ``--device cpu`` runs their plain versions.  The
draws are those of the JAX package's ``tools/hier_fuzz.py``, so a failing
seed reproduces in either tool.  Any mismatch prints FAIL with the seed and
exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from legmov_tpu_torch.config import SolverConfig, resolve_device
from legmov_tpu_torch.models.hier_solver import solve_positionability
from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg
from legmov_tpu_torch.models.robot import HEX_MOUNTS, QUAD_MOUNTS, make_robot


def draw_trial(seed: int) -> dict:
    """Every random choice of the trial of ``seed``, in the JAX tool's
    order."""
    rng = np.random.default_rng(seed)
    mounts = QUAD_MOUNTS if rng.random() < 0.7 else HEX_MOUNTS
    m2 = rng.random() < 0.5
    robot = make_robot(mounts, get_m2_leg if m2 else get_moonbot_leg)
    k = int(rng.integers(1, len(mounts) + 1))
    # half the trials use boxes small enough to activate rotations
    if rng.random() < 0.5:
        box, min_box, depth = 60.0, 25.0, 2
    else:
        box, min_box, depth = 400.0, 100.0, 2
    n = int(rng.integers(16, 64))
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    radius = rng.uniform(250, 400)
    fh = np.stack(
        [radius * np.cos(ang) + rng.normal(0, 30, n),
         radius * np.sin(ang) + rng.normal(0, 30, n),
         rng.uniform(-160, -90, n)], -1,
    ).astype(np.float32)
    cfg = SolverConfig(
        box_center=(0.0, 0.0, 0.0), box_size=(box,) * 3,
        min_box=(min_box,) * 3, max_depth=depth,
        legs_for_stability=k,
    )
    shared = bool(rng.random() < 0.5)
    return dict(seed=seed, mounts=mounts, leg="m2" if m2 else "moonbot",
                robot=robot, k=k, box=box, min_box=min_box, depth=depth,
                footholds=fh, cfg=cfg, shared=shared)


def run_trial(d: dict, device, solve=solve_positionability):
    """``(equal, line)`` of trial ``d``: the eager solve against the fused
    one; ``solve`` stands in for ``solve_positionability`` (a test plants a
    fault through it)."""
    kw = dict(chunk=32, cell_batch=64, shared_foothold=d["shared"],
              device=device)
    a = solve(d["footholds"], d["robot"], d["cfg"], backend="torch", **kw)
    b = solve(d["footholds"], d["robot"], d["cfg"], backend="auto", **kw)
    same = (
        a.centers.shape == b.centers.shape
        and (a.centers == b.centers).all()
        and (a.valid == b.valid).all()
        and (a.edge == b.edge).all()
    )
    rot = d["box"] / 2 < d["cfg"].enable_rot_below
    line = (f"{'OK ' if same else 'FAIL'} seed={d['seed']} "
            f"legs={len(d['mounts'])} k={d['k']} box={d['box']:g} rot={rot} "
            f"shared={d['shared']} cells={a.centers.shape[0]} "
            f"valid={int(a.valid.sum())}")
    return bool(same), line


def main(argv=None, solve=solve_positionability) -> int:
    """Run the trials; returns the exit code (1 if any trial failed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the kernels) needs a card; cpu runs their "
                    "plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else "cpu")
    bad = 0
    for trial in range(args.trials):
        same, line = run_trial(draw_trial(args.seed + trial), dev, solve)
        print(line, flush=True)
        bad += not same
    print(f"{args.trials - bad}/{args.trials} trials exact")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

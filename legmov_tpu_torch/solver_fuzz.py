"""Randomized equivalence fuzz for the map-scale positionability solvers.

    python -m legmov_tpu_torch.solver_fuzz [--trials 20] [--seed 0]
        [--device cpu]

Each trial draws a terrain (a uniform slab, clusters, or a slab with a
hole), a robot (quadruped or hexapod, M2 or moonbot legs), a quorum, the
cell subdivision, a pose batch with random orientations, a window and a
round schedule, and holds every map solver to the exhaustive
ops/grid.py ``grid_reachable_legs_topk`` over every neighbour cell:

* the CSR solver (K3) and the csr-dma solver (K4's round kernel): leg bits
  and quorum exact;
* the csr-dma solver under ``decide="quorum"``: quorum exact, leg bits a
  subset;
* the fused and the adaptive dense-table solvers (K3 over table rows): leg
  bits and quorum exact.

The draws are those of the JAX package's ``tools/solver_fuzz.py`` (the same
numpy calls in the same order), so a failing seed reproduces in either
tool; the port has no counterpart of its super step, which is drawn and
not used, nor of its dense-table cap (every trial runs the dense solvers).
On the card (the default) the solvers launch their kernels, which is the
JAX package's ``tools/onchip_fuzz.py`` job; ``--device cpu`` runs their
plain versions.  Any mismatch prints FAIL with the seed and exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg
from legmov_tpu_torch.models.robot import HEX_MOUNTS, QUAD_MOUNTS, make_robot
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.ops.csr_grid import (
    ball_columns,
    build_csr_grid,
    make_csr_dma_solver,
    make_csr_solver,
)
from legmov_tpu_torch.ops.cuda_multileg import (
    make_adaptive_grid_solver,
    make_fused_grid_solver,
    pad_grid_soa,
)
from legmov_tpu_torch.ops.grid import (
    build_grid,
    cell_size_for,
    grid_reachable_legs_topk,
    neighbor_offsets,
)


def random_terrain(rng, n):
    kind = rng.integers(0, 3)
    if kind == 0:  # uniform slab
        fh = rng.uniform(-1500, 1500, (n, 3)).astype(np.float32)
        fh[:, 2] = rng.uniform(-200, -80, n)
    elif kind == 1:  # clusters
        c = rng.uniform(-1200, 1200, (8, 3)).astype(np.float32)
        c[:, 2] = rng.uniform(-200, -100, 8)
        idx = rng.integers(0, 8, n)
        fh = c[idx] + rng.normal(0, 120, (n, 3)).astype(np.float32)
    else:  # slab with a hole
        fh = rng.uniform(-1500, 1500, (n, 3)).astype(np.float32)
        fh[:, 2] = rng.uniform(-220, -60, n)
        fh = fh[~((np.abs(fh[:, 0]) < 500) & (fh[:, 1] > 0))]
    return np.ascontiguousarray(fh, np.float32)


def draw_trial(seed: int) -> dict:
    """Every random choice of the trial of ``seed``, in the JAX tool's
    order."""
    rng = np.random.default_rng(seed)
    hexapod = rng.random() < 0.5
    m2 = rng.random() < 0.5
    mounts = HEX_MOUNTS if hexapod else QUAD_MOUNTS
    robot = make_robot(mounts, get_m2_leg if m2 else get_moonbot_leg)
    L = len(mounts)
    k = int(rng.integers(1, L + 1))
    subdiv = int(rng.integers(1, 4))
    footholds = random_terrain(rng, int(rng.integers(2000, 20000)))
    P = int(rng.integers(2, 7)) * 8
    body = np.stack(
        [rng.uniform(-1200, 1200, P), rng.uniform(-1200, 1200, P),
         rng.uniform(20, 150, P)], -1,
    ).astype(np.float32)
    rpy = rng.uniform(-0.25, 0.25, (P, 3)).astype(np.float32)
    window = int(rng.choice([128, 256, 512, 1024]))
    rounds = (
        (int(rng.integers(1, 6)), 1.0),
        (int(rng.integers(4, 16)), float(rng.choice([0.5, 0.25]))),
        (0, float(rng.choice([0.125, 0.25]))),
    )
    if rng.random() < 0.5:
        # widening tail ladder: extra unbounded tails must stay exact
        # whether or not anything is left undecided when they run
        rounds = rounds + ((0, min(1.0, rounds[-1][1] * 4)),)
    super_step = int(rng.choice([4, 8, 16]))
    return dict(seed=seed, legs=L, leg="m2" if m2 else "moonbot",
                mounts=mounts, robot=robot, k=k, subdiv=subdiv,
                footholds=footholds, poses=P, body=body, rpy=rpy,
                window=window, rounds=rounds, super_step=super_step)


def run_trial(d: dict, dev: torch.device, wrap=None) -> tuple[bool, str]:
    """Hold every solver to the exhaustive path on trial ``d``; ``wrap(name,
    solver)``, when given, stands in for each solver (a test plants a fault
    through it).  Returns (all exact, the trial's line)."""
    wrap = wrap or (lambda name, solver: solver)
    robot, k, rounds, window = d["robot"], d["k"], d["rounds"], d["window"]
    reach = cell_size_for(robot)
    cell = reach / d["subdiv"]
    fh = d["footholds"]
    body = torch.from_numpy(d["body"]).to(dev)
    rpy = d["rpy"]
    quats = quat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]).to(dev)
    offs = neighbor_offsets(cell, reach)
    g = build_grid(fh, cell, device=dev)
    legs_t, q_t, _ = grid_reachable_legs_topk(
        body, quats, g, robot, offs, top_k=int(offs.shape[0]), k=k)
    legs_t, q_t = legs_t.cpu().numpy(), q_t.cpu().numpy()

    csr = build_csr_grid(fh, cell, device=dev)
    cols = torch.as_tensor(ball_columns(offs), device=dev)
    csr_args = (body, quats, csr.xs, csr.ys, csr.zs, csr.starts, csr.origin,
                cols)
    csr_kw = dict(cell_size=csr.cell_size, k=k, dims=csr.dims)
    (gx, gy, gz), cap = pad_grid_soa(g)
    offs_d = torch.as_tensor(offs, device=dev)
    dense_args = (body, quats, gx, gy, gz, g.counts, g.origin, g.cell_size,
                  offs_d)
    dense_kw = dict(top_k=int(offs.shape[0]), k=k, dims=g.dims)
    runs = {
        "csr": (make_csr_solver(robot, window=window, rounds=rounds),
                csr_args, csr_kw),
        "dma": (make_csr_dma_solver(robot, window=window, rounds=rounds),
                csr_args, csr_kw),
        "quorum_mode": (make_csr_dma_solver(robot, window=window,
                                            rounds=rounds, decide="quorum"),
                        csr_args, csr_kw),
        "fused": (make_fused_grid_solver(robot, cap), dense_args, dense_kw),
        "adaptive": (make_adaptive_grid_solver(robot, cap, rounds=rounds),
                     dense_args, dense_kw),
    }
    ok = {}
    overflow = False
    for name, (solver, args, kw) in runs.items():
        legs, q, over = wrap(name, solver)(*args, **kw)
        legs, q = legs.cpu().numpy(), q.cpu().numpy()
        if name == "quorum_mode":
            ok[name] = bool((q == q_t).all() and not (legs & ~legs_t).any())
        else:
            ok[name] = bool((legs == legs_t).all() and (q == q_t).all())
        if name == "csr":
            overflow = bool(over)
    good = all(ok.values())
    line = (f"{'OK ' if good else 'FAIL'} seed={d['seed']} legs={d['legs']} "
            f"k={k} subdiv={d['subdiv']} F={fh.shape[0]} P={d['poses']} "
            f"win={window} rounds={rounds} feas={int(q_t.sum())}/"
            f"{d['poses']} " + " ".join(f"{n}={v}" for n, v in ok.items())
            + f" csr_overflow={overflow} cap={cap}")
    return good, line


def main(argv=None, wrap=None) -> int:
    """Run the trials; returns the exit code (1 if any trial failed).
    ``wrap`` is passed to :func:`run_trial`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the kernels) needs a card; cpu runs their "
                    "plain versions")
    ap.add_argument("--max-footholds", type=int, default=0,
                    help="keep the first N footholds of each drawn terrain "
                    "(0 = all); the draws are unchanged")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else "cpu")
    bad = 0
    for trial in range(args.trials):
        d = draw_trial(args.seed + trial)
        if args.max_footholds:
            d["footholds"] = d["footholds"][:args.max_footholds]
        good, line = run_trial(d, dev, wrap)
        print(line, flush=True)
        bad += not good
    print(f"{args.trials - bad}/{args.trials} trials exact")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

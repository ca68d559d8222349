"""Multi-rank scaling of the sharded pose sweep (parallel/).

    python -m legmov_tpu_torch.scaling_bench [--max-ranks 2] [--poses 4096]
        [--footholds 8192] [--reps 5] [--device cpu]

Times ``sharded_positionable`` (M2 quadruped, quorum 3) on 1, 2, 4, ...
ranks up to ``--max-ranks``, each count a world of its own (new processes),
and prints one JSON line a count with the median wall of ``--reps`` solves
after a warm-up, poses/s and the efficiency against one rank
(``t_1 / (n t_n)``), then a last line with the platform and a note.  The
JAX package's ``tools/scaling_bench.py`` measures the same on a device mesh
(BASELINE.json config 5: ">= 85% scaling efficiency to 2+ hosts").

Ranks take ``cuda:{rank % cards}``: with fewer cards than ranks they share
one, and the efficiency printed then measures contention for that card, not
scaling.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.robot import get_m2_robot
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.parallel import make_mesh, sharded_positionable
from legmov_tpu_torch.parallel.multihost import run_ranks


def inputs(poses: int, footholds: int):
    """``(body, quats, footholds)``: the draws of ``tools/scaling_bench.py``
    (seed 0)."""
    rng = np.random.default_rng(0)
    body = rng.uniform(-300, 300, (poses, 3)).astype(np.float32)
    rpy = rng.uniform(-0.2, 0.2, (poses, 3)).astype(np.float32)
    quats = quat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]).cpu().numpy()
    fh = rng.uniform(-600, 600, (footholds, 3)).astype(np.float32)
    return body, np.asarray(quats, np.float32), fh


def time_ranks(poses: int, footholds: int, reps: int, device=None) -> dict:
    """One rank's part (the target of each spawned rank): the median wall of
    ``reps`` sharded solves after a warm-up, each started together on every
    rank and ended when the gathered quorum is on the rank's device."""
    mesh = make_mesh(points_axis=1, devices=device)
    body, quats, fh = inputs(poses, footholds)
    fn = sharded_positionable(mesh, k=3)
    robot = get_m2_robot()

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        if mesh.size > 1:
            dist.barrier(group=mesh.host_group)

    feasible = int(fn(body, quats, fh, robot).sum())
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn(body, quats, fh, robot)
        sync()
        ts.append(time.perf_counter() - t0)
    return {"seconds": statistics.median(ts), "feasible": feasible}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-ranks", type=int, default=2)
    ap.add_argument("--poses", type=int, default=4096)
    ap.add_argument("--footholds", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where each rank computes; cuda needs a card")
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else "cpu"
    resolve_device(device)
    results = []
    base = None
    n = 1
    while n <= args.max_ranks:
        res = run_ranks(time_ranks, n, args.poses, args.footholds, args.reps,
                        device, device=device)
        t = res[0]["seconds"]
        if len({r["feasible"] for r in res}) != 1:
            raise SystemExit(f"ranks disagree on the quorum at {n} ranks")
        base = t if base is None else base
        results.append({"ranks": n, "seconds": t,
                        "poses_per_s": args.poses / t,
                        "scaling_efficiency": base / t / n,
                        "feasible": res[0]["feasible"]})
        print(json.dumps(results[-1]), flush=True)
        n *= 2
    if device is None:
        cards = torch.cuda.device_count()
        platform = f"gpu: {cards} x {torch.cuda.get_device_name(0)}"
        note = (None if cards >= args.max_ranks else
                f"{args.max_ranks} ranks share {cards} card(s): the "
                "efficiency measures contention for the card, not scaling")
    else:
        platform = "cpu"
        note = ("ranks share one host's cores (one thread each): the "
                "efficiency checks the layout, not scaling")
    print(json.dumps({"platform": platform, "results": results,
                      "note": note}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

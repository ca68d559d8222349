"""Walls of another tree of this package and this one, in turns.

    python -m legmov_tpu_torch.solve_pairs --other build/parent_tree

``--other`` is a directory that holds another ``legmov_tpu_torch/`` (for
instance ``git archive <commit> legmov_tpu_torch | tar -x -C
build/parent_tree``).  The script prepares a terrain directory once, builds
both trees' kernels with a small solve each, then runs each case of
``--cases`` in the order other, this, this, other, each run in a fresh
process, and prints one line a run:

* ``deep``: the depth-7 moon solve (``--box 5000 --depth 8 --min-box 20
  --profile``), m2 quadruped at k = 4 under each rule and the m2 hexapod
  under the shared rule at k = 4 and k = 3: the wall, cells / valid / edge
  and host synchronisations of the JSON line, and ``dispatch_s`` /
  ``fetch_s`` summed over the levels without orientation sampling and at
  the deepest level;
* ``dense``: the quarter-box solve with dense candidates (``--box 1250
  --depth 6 --min-box 20 --candidates dense``) under each rule, whose
  orientation-active levels run K5: the same fields;
* ``map``: ``cli map`` (the default ``csr-dma`` solver, K4) over the
  prepared body candidates: the wall, poses/s, feasible candidates and K4
  launches;
* ``map-csr``: ``cli map --solver csr`` (K3): the same, with K3 launches;
* ``tables``: ``oriented_tables`` at ``cli map``'s pose chunk (2,048
  poses, the identity and seeded orientations, m2 quadruped): milliseconds
  a call between CUDA events and on the host clock, median of 20.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

DEEP = ("--leg", "m2", "--legs", "4", "--k", "4", "--box", "5000", "--depth",
        "8", "--min-box", "20", "--profile")
DENSE = ("--leg", "m2", "--legs", "4", "--k", "4", "--box", "1250",
         "--depth", "6", "--min-box", "20", "--profile", "--candidates",
         "dense")


SHAPES = (("per-leg", ("--legs", "4", "--k", "4", "--mode", "per-leg")),
          ("shared", ("--legs", "4", "--k", "4", "--mode", "shared")),
          ("hexapod 4-of-6", ("--legs", "6", "--k", "4", "--mode", "shared")),
          ("hexapod 3-of-6", ("--legs", "6", "--k", "3", "--mode", "shared")))

#: run in a fresh process of each tree: the time of ``oriented_tables`` a
#: ``cli map`` chunk (what the code of both trees offers alike)
TABLES = r"""
import json, statistics, time
import numpy as np, torch
from legmov_tpu_torch.models.leg import get_m2_leg
from legmov_tpu_torch.models.robot import QUAD_MOUNTS, make_robot
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.ops.cuda_multileg import oriented_tables
robot = make_robot(QUAD_MOUNTS, leg_fn=get_m2_leg)
dev = torch.device("cuda")
rng = np.random.default_rng(13)
body = torch.from_numpy(rng.uniform(-300, 300, (2048, 3)).astype(np.float32))
rpy = rng.uniform(-0.1, 0.1, (2048, 3)).astype(np.float32)
out = {}
for name, q in (("identity", torch.tensor([1.0, 0, 0, 0]).repeat(2048, 1)),
                ("seeded", quat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]))):
    b, q = body.to(dev), q.to(dev)
    for _ in range(3):
        oriented_tables(b, q, robot)
    ev, wall = [], []
    for _ in range(20):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        oriented_tables(b, q, robot)
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(e0.elapsed_time(e1))
    out[name] = (statistics.median(ev), statistics.median(wall))
print(json.dumps(out))
"""


def cli(tree: str, *args: str) -> str:
    return subprocess.run(
        [sys.executable, "-m", "legmov_tpu_torch.cli", *args], cwd=tree,
        check=True, capture_output=True, text=True).stdout


def tables(tree: str) -> dict:
    return json.loads(subprocess.run(
        [sys.executable, "-c", TABLES], cwd=tree, check=True,
        capture_output=True, text=True).stdout.strip().splitlines()[-1])


def summary(out: str) -> dict:
    """The JSON line and the per-level split of one ``--profile`` run."""
    lines = out.strip().splitlines()
    levels = [l for l in lines if l.startswith("[hier] depth=")]

    def field(name, l):
        return float(re.search(name + r"=([0-9.]+)", l).group(1))

    ident = [l for l in levels if "rot=False" in l]
    return dict(json.loads(lines[-1]),
                identity_dispatch_s=sum(field("dispatch_s", l) for l in ident),
                identity_fetch_s=sum(field("fetch_s", l) for l in ident),
                deepest_dispatch_s=field("dispatch_s", levels[-1]),
                deepest_fetch_s=field("fetch_s", levels[-1]))


def solve_line(mode: str, name: str, s: dict) -> str:
    return (f"{mode} {name} wall {s['seconds']} cells/valid/edge "
            f"{s['cells']} {s['valid']} {s['edge']} host_syncs "
            f"{s['host_syncs']} identity dispatch_s "
            f"{s['identity_dispatch_s']:.3f} fetch_s "
            f"{s['identity_fetch_s']:.3f} deepest dispatch_s "
            f"{s['deepest_dispatch_s']:.3f} fetch_s "
            f"{s['deepest_fetch_s']:.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other legmov_tpu_torch/")
    ap.add_argument("--cases", default="deep,dense,map,map-csr,tables",
                    help="comma-separated cases to run: deep, dense, map, "
                    "map-csr, tables")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"other": os.path.abspath(args.other), "this": this}
    turns = ("other", "this", "this", "other")
    with tempfile.TemporaryDirectory(prefix="legmov_pairs_") as d:
        cli(this, "prepare", "--dir", d, "--pix-size", "20")
        for tree in trees.values():  # builds each tree's kernels
            cli(tree, "solve", "--dir", d, "--leg", "m2", "--box", "300",
                "--depth", "1")
        for case, extra, shapes in (("deep", DEEP, SHAPES),
                                    ("dense", DENSE, SHAPES[:2])):
            if case not in cases:
                continue
            for mode, shape in shapes:
                for name in turns:
                    s = summary(cli(trees[name], "solve", "--dir", d, *extra,
                                    *shape))
                    print(f"{case} " + solve_line(mode, name, s), flush=True)
        for case, solver, key in (("map", "csr-dma", "csr_window"),
                                  ("map-csr", "csr", "multileg")):
            if case not in cases:
                continue
            for name in turns:
                j = json.loads(cli(trees[name], "map", "--dir", d, "--leg",
                                   "m2", "--solver", solver).strip()
                               .splitlines()[-1])
                print(f"map --solver {solver} {name} wall {j['seconds']} "
                      f"poses/s {j['poses_per_s']} feasible {j['feasible']} "
                      f"{key} launches {j[key + '_launches']}", flush=True)
        if "tables" in cases:
            for name in turns:
                t = tables(trees[name])
                print(f"tables {name} oriented_tables a cli map chunk "
                      + ", ".join(f"{k} {ev:.3f} ms events {wall:.3f} ms wall"
                                  for k, (ev, wall) in t.items()),
                      flush=True)


if __name__ == "__main__":
    main()

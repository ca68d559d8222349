"""Walls of another tree of this package and this one, in turns.

    python -m legmov_tpu_torch.solve_pairs --other build/parent_tree

``--other`` is a directory that holds another ``legmov_tpu_torch/`` (for
instance ``git archive <commit> legmov_tpu_torch | tar -x -C
build/parent_tree``).  The script prepares a terrain directory once, builds
both trees' kernels with a small solve each, then runs each case of
``--cases`` in the order other, this, this, other, each run in a fresh
process, and prints one line a run:

* ``deep``: the depth-7 moon solve (m2 quadruped, k = 4, ``--box 5000
  --depth 8 --min-box 20 --profile``) under each rule: the wall, cells /
  valid / edge and host synchronisations of the JSON line, and
  ``dispatch_s`` / ``fetch_s`` summed over the levels without orientation
  sampling and at the deepest level;
* ``dense``: the quarter-box solve with dense candidates (``--box 1250
  --depth 6 --min-box 20 --candidates dense``) under each rule, whose
  orientation-active levels run K5: the same fields;
* ``map``: ``cli map --solver csr`` over the prepared body candidates
  (K3): the wall, poses/s, feasible candidates and K3 launches.
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


def cli(tree: str, *args: str) -> str:
    return subprocess.run(
        [sys.executable, "-m", "legmov_tpu_torch.cli", *args], cwd=tree,
        check=True, capture_output=True, text=True).stdout


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
    ap.add_argument("--cases", default="deep,dense,map",
                    help="comma-separated cases to run: deep, dense, map")
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
        for case, extra in (("deep", DEEP), ("dense", DENSE)):
            if case not in cases:
                continue
            for mode in ("per-leg", "shared"):
                for name in turns:
                    s = summary(cli(trees[name], "solve", "--dir", d, *extra,
                                    "--mode", mode))
                    print(f"{case} " + solve_line(mode, name, s), flush=True)
        if "map" in cases:
            for name in turns:
                j = json.loads(cli(trees[name], "map", "--dir", d, "--leg",
                                   "m2", "--solver", "csr").strip()
                               .splitlines()[-1])
                print(f"map --solver csr {name} wall {j['seconds']} poses/s "
                      f"{j['poses_per_s']} feasible {j['feasible']} K3 "
                      f"launches {j['multileg_launches']}", flush=True)


if __name__ == "__main__":
    main()

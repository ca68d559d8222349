"""Read the numbers that ``correct`` compares, for many seeds in one
process: the program's readings (the lower end of each limit) and, with
``--control``, the control's (the upper end).

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--requests N] [--control]

Per seed it makes the cell's inputs as a run does, sends ``N`` requests
(default: every terrain of the cell's pool once), judges them with the
cell's own check and the run's own verdict, and prints one JSON line: the
readings and ``correct``, with ``--control`` the control's readings and
``correct`` on the same sample (the reference on bfloat16 inputs in the
program's place), and each request's wall and the program's counts.  It
is a tool for setting limits; runs of the benchmark never call it.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def bf16(t):
    import torch

    return t.to(torch.bfloat16).to(torch.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_port/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    m = harness.load_manifest(ROOT)
    _, cfg, traffic = harness.cell_files(m, args.workload, ROOT)
    kind = importlib.import_module("bench_port.kinds." + traffic["kind"])
    n = args.requests or int(traffic["pool"])
    limits = traffic["check"]["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        d = kind.CellRunner(cfg, traffic, seed, "cuda", harness.Spans())
        t0 = time.perf_counter()
        d.setup()
        d.request(-1, keep=False)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        walls = []
        for i in range(n):
            t0 = time.perf_counter()
            d.request(i)
            walls.append(time.perf_counter() - t0)
        d.release()
        torch.cuda.empty_cache()
        done = list(range(n))
        t0 = time.perf_counter()
        checks, counts, notes = d.check(done, [0], want_counts=True)
        check_s = time.perf_counter() - t0
        line = dict(seed=seed, checks=checks,
                    correct=harness.judge(checks, limits, 0),
                    setup_s=setup, walls=walls,
                    check_s=check_s, counts=counts, notes=notes,
                    per_request=[{k: v for k, v in r.items() if k != "stats"}
                                 for r in d.per_request])
        if args.control:
            t0 = time.perf_counter()
            control = d.check(done, [0], want_counts=False, control=bf16)[0]
            line["control"] = control
            line["control_correct"] = harness.judge(control, limits, 0)
            line["control_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

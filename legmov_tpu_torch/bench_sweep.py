"""N-sweep benchmark: ns a point against batch size, CSV + plot.

The reference's sweep protocol (bench.cpp:52-181 + setting_bench.h:8-18):
the pixel pitch swept 0.04 -> 50 doubling each step, grids over x in
[-100, 601], y = 0, z in [-100, 51] (the reference's ``z_start = XMin``
quirk at bench.cpp:118 is kept so the point counts match its committed
CSVs: 72 ... 66,160,650, eleven sizes), an inclusive float32-accumulating
arange, and CSV rows ``N;ns_per_point``, ONE ROW PER REPEAT (SubSamples,
bench.cpp:121-171), so the reference's ``benchIllu.py`` aggregation (N >
10,000, per-N 5-95th percentile, mean; ``bench_report``) applies unchanged.
Sizes whose CSV already holds ``--reps`` rows are skipped, so an
interrupted sweep resumes where it stopped.  M2 leg.

``--impl`` picks the compute mode:

* ``kernel``: K1 and K2's point driver (ops/cuda_kernels.py, SoA) on the
  card.  CSVs ``rgpu.csv`` / ``dgpu.csv``, the reference's names.
* ``plain``: the plain tensor path (ops/reachability.py, ops/distance.py,
  the workspace tables built once a size on the device) on ``--device``.
  CSVs ``rtorch_<cuda|cpu>.csv`` / ``dtorch_<cuda|cpu>.csv``.  On the CPU
  this is the port's CPU sweep, with PyTorch's threads.
* ``oracle``: the strict-fp32 scalar twin (oracle/numpy_ref.py), the
  reference's ``apply_reach_cpu`` / ``apply_dist_cpu``
  (one_leg_global.cu:132-147), host code.  CSVs ``rcpu.csv`` /
  ``dcpu.csv``.  A per-point Python loop: for N > ``--cpu-point-cap`` a rep
  times a fixed-seed uniform subsample of the grid (the true N labels the
  row; ns a point is the subsample's mean).
* ``ik``: the LM-IK baseline (oracle/ik_oracle.py), the reference's RBDL
  mode (rbdl_benchmark.cpp:18-111), host code, reach only, minimum pitch
  0.4 (MinPixRBDL, setting_bench.h:10).  CSV ``ik.csv``.

Timing.  On the card a rep is ``launch_iters(N, impl)`` calls enqueued
back to back between two CUDA events, divided by the calls and by N; the
calls grow as N shrinks (2**28 / N, at least 4, at most 200 kernel calls
or 10 plain ones), because events around one launch count 30-50 us of host
launch time, all of a kernel launch at 72 points (a plain call is a
millisecond of launches at any N).  The reference timed one launch between events
(cross_compiled.cu:58-65).  On the CPU a rep is one call timed with
``time.perf_counter``.  Each size is called once untimed first on the
card.  ``device.json`` beside the CSVs names the machine of every CSV:
the card's name and power limit (``nvidia-smi``), PyTorch's and CUDA's
versions, or the CPU's model and PyTorch's thread count; a CSV made on
another machine is refused.

``--impl kernel`` needs the card; ``plain`` runs on ``--device``;
``oracle`` and ``ik`` are host code.  Like every entry point of the port
the sweep raises without a card unless it is given ``--device cpu``.

Run: ``python -m legmov_tpu_torch.bench_sweep [--impl kernel] [--reps 25]
[--out build/sweep]``, then ``python -m legmov_tpu_torch.bench_report``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.leg import get_m2_leg
from legmov_tpu_torch.profiling import cpu_model, device_label
from legmov_tpu_torch.viz import pyplot_or_none

MIN_PIX_IK = 0.4


def ref_arange(start: float, end: float, step: float) -> np.ndarray:
    """bench.cpp:21-27 arange: inclusive end, float32 accumulation."""
    out = []
    v = np.float32(start)
    step = np.float32(step)
    while v <= np.float32(end):
        out.append(float(v))
        v = np.float32(v + step)
    return np.asarray(out, np.float32)


def ref_pitches(min_pix: float = 0.04, max_pix: float = 50.0) -> list:
    p, out = min_pix, []
    while p <= max_pix:
        out.append(p)
        p *= 2.0
    return out


def ref_grid(pix: float) -> np.ndarray:
    """One sweep grid, loop order x-outer / z-inner like generate3DGrid."""
    xs = ref_arange(-100.0, 601.0, pix)
    ys = np.zeros(1, np.float32)
    zs = ref_arange(-100.0, 51.0, pix)  # z_start = XMin (bench.cpp:118)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)


def grid_size(pix: float) -> int:
    """Points of ``ref_grid(pix)``, without building it."""
    return (ref_arange(-100.0, 601.0, pix).size
            * ref_arange(-100.0, 51.0, pix).size)


def rows_in_csv(path: str, n: int) -> int:
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for line in f if line.startswith(f"{n};"))


#: most calls a rep on the card, by impl
MAX_CALLS = {"kernel": 200, "plain": 10}


def launch_iters(n: int, impl: str = "kernel") -> int:
    """Calls a rep enqueues on the card: 2**28 / N, clipped to [4,
    ``MAX_CALLS[impl]``]."""
    return int(np.clip((1 << 28) // max(n, 1), 4, MAX_CALLS[impl]))


def csv_name(impl: str, which: str, device: torch.device) -> str:
    if impl == "kernel":
        return "rgpu.csv" if which == "reach" else "dgpu.csv"
    if impl == "plain":
        return f"{which[0]}torch_{device.type}.csv"
    if impl == "oracle":
        return "rcpu.csv" if which == "reach" else "dcpu.csv"
    return "ik.csv"


def machine(impl: str, device: torch.device) -> dict:
    """What ``device.json`` records for a CSV of this impl."""
    if impl in ("kernel", "plain") and device.type == "cuda":
        return {"device": "cuda", "label": device_label(device),
                "name": torch.cuda.get_device_name(device),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "timing": f"CUDA events around launch_iters(N, {impl!r}) "
                          "calls"}
    if impl == "plain":
        label, threads = device_label(device), torch.get_num_threads()
    else:  # numpy host code in one Python thread
        label, threads = f"cpu: {cpu_model()}, 1 thread", 1
    return {"device": "cpu", "label": label, "cpu_model": cpu_model(),
            "threads": threads, "torch": torch.__version__,
            "timing": "time.perf_counter around one call"}


def record_machine(out: str, name: str, info: dict) -> None:
    """Enter ``info`` for the CSV ``name`` in ``out/device.json``; raises
    where that CSV already holds rows of another machine."""
    path = os.path.join(out, "device.json")
    known = {}
    if os.path.exists(path):
        with open(path) as f:
            known = json.load(f)
    old = known.get(name)
    if (old is not None and old.get("label") != info["label"]
            and os.path.exists(os.path.join(out, name))):
        raise SystemExit(f"{os.path.join(out, name)} holds rows made on "
                         f"{old['label']}, not {info['label']}: sweep into "
                         "another --out")
    known[name] = info
    with open(path, "w") as f:
        json.dump(known, f, indent=2)


def evaluator(impl: str, which: str, leg, device: torch.device, pts):
    """A no-argument call evaluating ``pts`` (numpy ``[N, 3]``) the
    ``impl`` way, its inputs already where it computes."""
    if impl == "kernel":
        from legmov_tpu_torch.ops import cuda_kernels as ck

        comps = [torch.from_numpy(np.ascontiguousarray(pts[:, i])).to(device)
                 for i in range(3)]
        if which == "reach":
            k = ck.make_reachability_kernel(leg)
        else:
            k = ck.make_distance_kernel(leg)
        return lambda: k.soa(*comps)
    if impl == "plain":
        from legmov_tpu_torch.models.workspace import (
            build_workspace,
            workspace_tensors,
        )
        from legmov_tpu_torch.ops.distance import distance_ws
        from legmov_tpu_torch.ops.reachability import reachability_ws

        ws = workspace_tensors(build_workspace(leg), device)
        p = torch.from_numpy(pts).to(device)
        fn = reachability_ws if which == "reach" else distance_ws
        return lambda: fn(p, ws)
    if impl == "oracle":
        from legmov_tpu_torch.oracle.numpy_ref import (
            oracle_distance,
            oracle_reachability,
        )

        fn = oracle_reachability if which == "reach" else oracle_distance
        return lambda: fn(pts, leg)
    from legmov_tpu_torch.oracle.ik_oracle import ik_reachability

    return lambda: ik_reachability(pts, leg)


def time_reps(fn, n: int, reps: int, device: torch.device,
              impl: str = "kernel") -> tuple:
    """``(ns a point for each rep, calls a rep)``."""
    if device.type != "cuda":
        rows = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            rows.append((time.perf_counter() - t0) / n * 1e9)
        return rows, 1
    iters = launch_iters(n, impl)
    fn()  # untimed: the first call of a size
    rows = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        rows.append(e0.elapsed_time(e1) * 1e6 / iters / n)
    return rows, iters


def sweep(args, device: torch.device) -> dict:
    """Run the sweep of ``args``; returns ``csv name -> [{"n", "iters",
    "ns"}]`` for the sizes timed in this run."""
    leg = get_m2_leg()
    on = device if args.impl in ("kernel", "plain") else torch.device("cpu")
    results = {}
    # smallest grid first: fast feedback before the large grids
    pitches = sorted(ref_pitches(args.min_pix, args.max_pix), reverse=True)
    for which in args.kernels.split(","):
        if args.impl == "ik" and which != "reach":
            continue
        name = csv_name(args.impl, which, device)
        csv_path = os.path.join(args.out, name)
        record_machine(args.out, name, machine(args.impl, device))
        for pix in pitches:
            n = grid_size(pix)
            if n > args.max_points:
                continue
            have = rows_in_csv(csv_path, n)
            if have >= args.reps:
                print(f"[{which}] N={n}: {have} rows present, skip",
                      flush=True)
                continue
            pts = ref_grid(pix)
            rows = []
            if args.impl == "oracle" and n > args.cpu_point_cap:
                for rep in range(args.reps - have):
                    sel = np.random.default_rng(1000 + rep).choice(
                        n, args.cpu_point_cap, replace=False)
                    fn = evaluator(args.impl, which, leg, on, pts[sel])
                    rows += time_reps(fn, args.cpu_point_cap, 1, on)[0]
                iters = 1
            else:
                fn = evaluator(args.impl, which, leg, on, pts)
                rows, iters = time_reps(fn, n, args.reps - have, on,
                                        args.impl)
            with open(csv_path, "a") as f:
                for ns in rows:
                    f.write(f"{n};{ns}\n")
            results.setdefault(name, []).append(
                {"n": n, "iters": iters, "ns": rows})
            sub = (", subsampled" if args.impl == "oracle"
                   and n > args.cpu_point_cap else "")
            print(f"[{which}] pix={pix:<8g} N={n:<10d} "
                  f"best={min(rows):.4f} med={float(np.median(rows)):.4f} "
                  f"ns/pt ({len(rows)} rows, {iters} calls a row{sub})",
                  flush=True)
            del pts, fn
    return results


def plot(out: str, ref: str | None) -> None:
    """``out/sweep.png`` from every CSV there (and the reference's GPU
    CSVs under ``ref/pc`` where given); a printed line where matplotlib
    does not import."""
    plt = pyplot_or_none()
    if plt is None:
        print("plot skipped: no matplotlib")
        return
    from legmov_tpu_torch.bench_report import curve, labels, load_csv

    fig = plt.figure(figsize=(7, 5))
    for name, label in labels(out).items():
        rows = load_csv(os.path.join(out, name))
        if rows:
            plt.loglog(*curve(rows), "o-", ms=3, label=label)
    for name, label in (("rgpu.csv", "reachability (GTX 1080 Ti)"),
                        ("dgpu.csv", "distance (GTX 1080 Ti)")):
        rows = load_csv(os.path.join(ref, "pc", name)) if ref else {}
        if rows:
            plt.loglog(*curve(rows), "s--", lw=0.8, label=label)
    plt.xlabel("points per batch")
    plt.ylabel("ns / point")
    plt.title("legmov_tpu_torch throughput against batch size")
    plt.grid(True, which="both", lw=0.3)
    plt.legend(fontsize=7)
    plt.savefig(os.path.join(out, "sweep.png"), dpi=150, bbox_inches="tight")
    plt.close(fig)
    print("wrote", os.path.join(out, "sweep.png"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch.bench_sweep")
    ap.add_argument("--out", default="build/sweep")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--kernels", default="reach,dist",
                    help="comma list of reach,dist")
    ap.add_argument("--min-pix", type=float, default=0.04)
    ap.add_argument("--max-pix", type=float, default=50.0)
    ap.add_argument("--max-points", type=int, default=1 << 27)
    ap.add_argument("--impl", choices=("kernel", "plain", "oracle", "ik"),
                    default="kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where `plain` computes")
    ap.add_argument("--cpu-point-cap", type=int, default=10_000,
                    help="oracle impl: most points timed a rep (larger "
                    "grids are uniformly subsampled, see the docstring)")
    ap.add_argument("--ref", default=None,
                    help="the reference's bdata directory, whose pc/ GPU "
                    "CSVs the plot overlays")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.impl == "kernel" and device.type != "cuda":
        raise SystemExit("--impl kernel runs on the card; --impl plain "
                         "--device cpu is the CPU sweep")
    if args.impl == "ik":
        args.min_pix = max(args.min_pix, MIN_PIX_IK)
    os.makedirs(args.out, exist_ok=True)
    results = sweep(args, device)
    plot(args.out, args.ref)
    return results


if __name__ == "__main__":
    main()

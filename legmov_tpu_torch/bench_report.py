"""Benchmark aggregation and comparison report (benchIllu.py equivalent).

Aggregates ``N;ns_per_point`` CSVs exactly like the reference's
benchIllu.py:254-322 (keep N > 10,000; per-N 5-95th percentile filter;
mean), over the port's sweep (``python -m legmov_tpu_torch.bench_sweep``,
``--ours``, each CSV labelled with the machine its ``device.json`` names)
and, where ``--ref`` names the reference's ``bdata`` directory, its
committed ``pc`` and ``jetson`` CSVs.  Prints one aggregated line a series
and the speed-ups of the card's kernels over the GTX 1080 Ti and of the
CPU rows over the i5-12600K (single thread); where ``--ref`` has no CSVs
those come from ``BASELINE.md``'s aggregated figures.  Draws the log-log
curves and a bar chart where matplotlib imports.  Reads CSVs: no device.

Run: ``python -m legmov_tpu_torch.bench_report [--ours build/sweep]
[--ref <reference bdata>] [--out build/sweep/report.png]``.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from legmov_tpu_torch.viz import pyplot_or_none

#: BASELINE.md:16-19, aggregated from the reference's pc CSVs (ns a point)
BASELINE_NS = {
    ("GTX 1080 Ti", "reach"): 0.403,
    ("GTX 1080 Ti", "dist"): 1.437,
    ("i5-12600K", "reach"): 47.1,
    ("i5-12600K", "dist"): 273.3,
}

#: the port's CSVs (bench_sweep names) -> (series name, kind, compared with)
OURS = {
    "rgpu.csv": ("K1 reach", "reach", "GTX 1080 Ti"),
    "dgpu.csv": ("K2 dist", "dist", "GTX 1080 Ti"),
    "rtorch_cuda.csv": ("plain reach", "reach", None),
    "dtorch_cuda.csv": ("plain dist", "dist", None),
    "rtorch_cpu.csv": ("plain reach", "reach", "i5-12600K"),
    "dtorch_cpu.csv": ("plain dist", "dist", "i5-12600K"),
    "rcpu.csv": ("oracle twin reach", "reach", "i5-12600K"),
    "dcpu.csv": ("oracle twin dist", "dist", "i5-12600K"),
    "ik.csv": ("LM-IK oracle", "reach", None),
}

#: the reference's committed CSVs under --ref -> (series name, machine, kind)
REFERENCE = {
    os.path.join("pc", "rgpu.csv"): ("GTX 1080 Ti reach", "GTX 1080 Ti",
                                     "reach"),
    os.path.join("pc", "dgpu.csv"): ("GTX 1080 Ti dist", "GTX 1080 Ti",
                                     "dist"),
    os.path.join("jetson", "rgpu.csv"): ("Jetson reach", None, None),
    os.path.join("jetson", "dgpu.csv"): ("Jetson dist", None, None),
    os.path.join("pc", "rcpu.csv"): ("i5-12600K reach (1 thread)",
                                     "i5-12600K", "reach"),
    os.path.join("pc", "dcpu.csv"): ("i5-12600K dist (1 thread)",
                                     "i5-12600K", "dist"),
    os.path.join("pc", "rbdl.csv"): ("RBDL LM-IK", None, None),
}


def load_csv(path: str) -> dict[int, list[float]]:
    rows = defaultdict(list)
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            n_s, ns_s = line.split(";")
            rows[int(float(n_s))].append(float(ns_s))
    return rows


def aggregate(rows: dict[int, list[float]], min_n: int = 10_000) -> float:
    """benchIllu.py:254-322: N > min_n, 5-95th pct filter per N, mean."""
    vals = []
    for n, samples in rows.items():
        if n <= min_n:
            continue
        s = np.asarray(samples)
        if s.size >= 3:
            lo, hi = np.percentile(s, [5, 95])
            s = s[(s >= lo) & (s <= hi)]
        vals.extend(s.tolist())
    return float(np.mean(vals)) if vals else float("nan")


def curve(rows: dict[int, list[float]]):
    ns = sorted(rows)
    return np.array(ns), np.array([np.mean(rows[n]) for n in ns])


def labels(ours: str) -> dict:
    """CSV name -> series label for the port's CSVs that ``ours`` holds,
    each with the machine its ``device.json`` entry names."""
    path = os.path.join(ours, "device.json")
    machines = {}
    if os.path.exists(path):
        with open(path) as f:
            machines = json.load(f)
    out = {}
    for name, (series, _, _) in OURS.items():
        if os.path.exists(os.path.join(ours, name)):
            where = machines.get(name, {}).get("label", "machine not recorded")
            out[name] = f"{series} ({where})"
    return out


def report(ours: str, ref: str | None) -> dict:
    """``{"series": label -> (rows, aggregate), "lines": [...]}``: the
    aggregated line of each series and the speed-up lines."""
    series = {}
    for name, label in labels(ours).items():
        rows = load_csv(os.path.join(ours, name))
        series[label] = (rows, aggregate(rows))
    ref_ns = {}
    for rel, (label, mach, kind) in REFERENCE.items():
        rows = load_csv(os.path.join(ref, rel)) if ref else {}
        if rows:
            series[label] = (rows, aggregate(rows))
            if mach is not None:
                ref_ns[mach, kind] = (series[label][1], f"{ref}/{rel}")
    lines = [f"{'series':<72} {'ns/point (aggregated)':>22}"]
    lines += [f"{label:<72} {agg:>22.4f}" for label, (_, agg) in series.items()]
    for name, label in labels(ours).items():
        _, kind, mach = OURS[name]
        agg = series[label][1]
        if mach is None or not np.isfinite(agg):
            continue
        base, src = ref_ns.get((mach, kind), (BASELINE_NS[mach, kind],
                                              "BASELINE.md"))
        lines.append(f"speed-up of {label} over {mach} ({kind}, "
                     f"{base:.4g} ns/pt from {src}): {base / agg:.2f}x")
    return {"series": series, "lines": lines}


def draw(series: dict, out: str) -> bool:
    """The curves and the bar chart, or False where matplotlib does not
    import."""
    plt = pyplot_or_none()
    if plt is None:
        return False
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(13, 5))
    for label, (rows, _) in series.items():
        if rows:
            a1.loglog(*curve(rows), "o-", ms=3, lw=1, label=label)
    a1.set_xlabel("points per batch")
    a1.set_ylabel("ns / point")
    a1.grid(True, which="both", lw=0.3)
    a1.legend(fontsize=6)
    keys = [k for k, (_, agg) in series.items() if np.isfinite(agg)]
    a2.bar(range(len(keys)), [series[k][1] for k in keys])
    a2.set_yscale("log")
    a2.set_xticks(range(len(keys)))
    a2.set_xticklabels(keys, rotation=30, ha="right", fontsize=6)
    a2.set_ylabel("ns / point (aggregated)")
    a2.grid(True, axis="y", lw=0.3)
    fig.suptitle("legmov_tpu_torch against the reference CUDA baselines")
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch.bench_report")
    ap.add_argument("--ours", default="build/sweep",
                    help="the port's sweep CSVs and their device.json")
    ap.add_argument("--ref", default=None,
                    help="the reference's bdata directory (pc/, jetson/)")
    ap.add_argument("--out", default="build/sweep/report.png")
    args = ap.parse_args(argv)
    res = report(args.ours, args.ref)
    for line in res["lines"]:
        print(line)
    if draw(res["series"], args.out):
        print("wrote", args.out)
    else:
        print("images not written: no matplotlib")
    return res


if __name__ == "__main__":
    main()

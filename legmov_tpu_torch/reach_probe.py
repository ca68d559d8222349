"""Reachability kernel beside its memory floor, on the card.

    python -m legmov_tpu_torch.reach_probe [--points 16777216] [--rounds 4]

The counterpart of ``tools/reach_kernel_probe.py``'s attribution run.  It
builds ``bench.py``'s grid at ``--points`` points (:func:`make_grid`, this
package's own copy), then in each round times, in turns, K1 (the
reachability kernel ``legmov_reach_kernel`` of the m2 leg, SoA entry) and
K7 (``legmov_io_only_kernel``: K1's input and output with no geometry, the
memory floor of K1's access pattern), each as the median of 20 launches
between CUDA events after 3 warm-ups.  It prints ns per point for each and
K1's time over the floor's, on lines that name the card and its power
limit, and a summary over the rounds (median, min).

Not carried over from the tool: its ``block_rows`` and ``parallel``
variants (grid knobs of the TPU compiler, which the CUDA launch does not
have) and the full-form K1 (``interval_valid=False``).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.leg import get_m2_leg
from legmov_tpu_torch.ops import cuda_kernels as ck

#: bytes a point both kernels must move: x, y, z in, one byte out
BYTES_PER_POINT = 13


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """float32 ``linspace`` in the JAX package's arithmetic:
    ``start * (1 - t) + stop * t`` with ``t = i / (num - 1)``, the stop
    appended (where XLA fuses the multiply-add the JAX grid can differ in
    the last bit)."""
    t = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    out = (np.float32(start) * (np.float32(1) - t)
           + np.float32(stop) * t).astype(np.float32)
    return np.concatenate([out, np.asarray([stop], np.float32)])


def make_grid(n: int) -> np.ndarray:
    """``bench.py``'s grid: ``[side^2 * nz, 3]`` float32 points over the
    reference bench envelope (x in [-100, 601], y in [-400, 401], z in
    [-350, 51]), ``side`` the cube root of ``n``."""
    side = max(2, round(n ** (1.0 / 3.0)))
    nz = max(2, n // (side * side))
    axes = (_linspace(-100.0, 601.0, side), _linspace(-400.0, 401.0, side),
            _linspace(-350.0, 51.0, nz))
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches, each between
    two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def probe(points: int, rounds: int, device=None, say=print) -> dict:
    """Time K1 and the io-only floor in turns, ``rounds`` times, on
    bench.py's grid of ``points`` points on the card; returns the per-round
    milliseconds and their summary."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the probe times kernels on the card")
    grid = make_grid(points)
    n = grid.shape[0]
    comps = tuple(torch.from_numpy(np.ascontiguousarray(grid[:, i])).to(dev)
                  for i in range(3))
    kr = ck.make_reachability_kernel(get_m2_leg())
    fns = {"K1": lambda: kr.soa(*comps),
           "io_only": lambda: ck.io_only_kernel(*comps)}
    card = card_line()
    history = {name: [] for name in fns}
    for r in range(rounds):
        for name, fn in fns.items():
            history[name].append(median_ms(fn))
        k1, io = history["K1"][-1], history["io_only"][-1]
        say(f"[{card}] round {r}: K1 {k1:.4f} ms {k1 * 1e6 / n:.5f} ns/pt, "
            f"io-only {io:.4f} ms {io * 1e6 / n:.5f} ns/pt, K1 / floor "
            f"{k1 / io:.3f}")
    out = {"points": n, "card": card,
           "bound_ms": n * BYTES_PER_POINT / 3.35e12 * 1e3}
    for name, h in history.items():
        out[name] = {"ms": statistics.median(h), "min_ms": min(h),
                     "rounds_ms": h}
    k1, io = out["K1"]["ms"], out["io_only"]["ms"]
    out["k1_over_floor"] = k1 / io
    say(f"[{card}] {n} points, median of {rounds} rounds: K1 {k1:.4f} ms "
        f"({k1 * 1e6 / n:.5f} ns/pt), io-only floor {io:.4f} ms "
        f"({io * 1e6 / n:.5f} ns/pt), K1 / floor {k1 / io:.3f}; bytes "
        f"bound {out['bound_ms']:.4f} ms ({BYTES_PER_POINT} B/pt at 3.35 "
        "TB/s)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=1 << 24)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    probe(args.points, args.rounds)


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and nothing else beyond the repository: it
builds every ``legmov_tpu_torch/csrc/*.cu`` from source (one ``nvcc`` each,
started together), drives the port's paths through their entry points,
checks the results, holds each CUDA kernel against its plain PyTorch version
on the card, and times the kernels at the sizes the paths use with CUDA
events.  Any failed phase ends the run with a non-zero exit code; there is
no CPU path.

Phases: 1 build; 2 ``cli prepare`` -> ``cli evaluate`` for both shipped legs
on the default 5 mm query grid; 3 the single-leg kernels against their plain
versions (grids, random points, views, and a mixed set whose every 32
consecutive points span K1's four configurations, valid and invalid
queries and both of K2's dual-finish winners), and K1's generic instance
(parameter blocks with the first or every interval collapse cleared)
against its plain version and the instance the legs take, bit for bit;
4 their times (on the grids and the mixed sets, also queued back to back
behind a sleep; K1's generic instance in turns); 5 ``cli map`` on the prepared directory (both CSR
solvers, the orientation sweep, the plain versions); 6 the map solve at
10.24 M footholds (hexapod, 32,768 poses, both CSR builds, one chunk held
against the plain versions and the exhaustive path, the packed orientation
sweep against the serial one); in phases 5 and 6 the CSR round kernel (K4)
against its plain version on every round of a chunk in both decide modes
and both z-clip settings, the chunk's rounds timed in turns with the step
form and its eager queue and at 1-16 warps a pose, the chunk's solve under
PyTorch's sync debug mode "error" and its aten operations counted before
and after the round kernel; 7 the multi-leg kernel and K4's step form alone
against their plain versions (ragged shapes, legs found before the launch,
rows found on their first candidates), their times, and the round kernel's
time on every round of phase 6's chunk beside each round's bound; 8 ``cli solve`` on the
prepared directory (the depth-7 moon solve under both rules, the chunk-major
per-leg evaluator (K6c) on a batch of it, and K6c's flags against K6a's
on every batch of the per-leg solve's deepest level with the two timed in
turns over all of them, two hexapod solves, and reduced solves
whose CSR and dense candidates and whose environment switches must agree;
the deep solves' identity levels run one K2 cell-kernel launch a batch, read
the device nowhere in their dispatch, and print their ``dispatch_s``);
9 the gates of the solve on samples of real batches of its deepest level,
quadruped and hexapod (every cell kernel form against its plain version,
counters included, against the dense item kernel and against the eager
evaluator; K6c against its plain version on every 8th cell of the whole
per-leg batch);
10 the item kernel, its cell driver (special batches, phase 10's
batch and the largest batch of each dense solve of phase 8, each timed in
turns with the item kernel's chunk loop that it replaced) and the three cell
kernels alone: special values (K6c also over 54 orientations), and their
times on real batches;
11 K2's cell kernel on real batches of identity levels 2-6 of the deep
solves and on special ones: against its plain version and against the
eager loop with K2's point kernel that it replaced, bit for bit, and its
time in turns with that loop and beside its bound; 12 the reach probe
(``python -m legmov_tpu_torch.reach_probe``): K1 and its io-only floor K7
in turns at 16,777,216 points, K7 against its plain version bit for bit;
13 tables built on the card against the same tables built on the CPU, bit
for bit (ops/trig32.py's functions, the quaternions, ``oriented_tables``
of the three test robots, K5's level rows), and ``oriented_tables``' time
per ``cli map`` chunk; 14 ``cli evaluate --adaptive`` on the 18,081,287-point
2.8 mm query grid beside the dense ``evaluate`` (reachability equal on every
point, the exact band equal to dense K2 bit for bit, painted vectors within
their cells); 15 ``python -m legmov_tpu_torch.map_bench`` with the
dense-table solvers (``fused``, ``adaptive``) beside ``csr-dma`` on the same
2,048 poses at 1 M and 10.24 M points (equal legs and quorum, a K3 step of
each against its plain version, ``decide quorum`` equal to csr-dma's).
16 the parallel layer (legmov_tpu_torch/parallel/) with its ranks as new
processes sharing cuda:0 over gloo: the dry run (``dryrun.dryrun_cases``) at
2 and 4 ranks, every sharded result equal to the unsharded call bit for bit
on every rank, each path's kernels launched; the depth-7 moon solve of phase
8 with ``mesh=`` over 2 ranks under both rules, equal to phase 8's record
bit for bit with 8 host synchronisations and 8 collectives on each rank;
``multihost_dryrun`` (small and ``--scale``) and ``scaling_bench`` at 1 and
2 ranks, each wall beside the single-rank one (ranks on one card measure
contention, not scaling); 17 ``solver_fuzz`` (12 trials) and ``hier_fuzz``
(8 trials) on the card, every trial line printed, 0 FAIL; 18 the viewers
and the N-sweep, each through its ``python -m`` entry point:
``ref_image_check`` at tibia 135 and 160 (the landmarks equal to
``bdata/refcheck*/landmarks.json``, K1 and K2 on both slices equal to their
plain versions bit for bit), ``live_view`` headless at 1920 x 1080 (60
frames, its fps, one K2 launch a frame, the middle frame equal to the plain
version's bit for bit), ``visualize_solve`` at its defaults (K3 through the
fused dense-table solver over 3,200 poses and 1,048,576 footholds, its mask
equal to ``grid_reachable_legs`` on the card, no overflow),
``circle_figure`` for both legs (the card's validity grid equal to the
CPU's), and ``bench_sweep`` (K1 and K2 over the reference protocol's 11
sizes up to 66,160,650 points, the plain path on the card and on the CPU,
the oracle twin and the LM-IK baseline capped small) with ``bench_report``
over its CSVs (speed-ups over ``BASELINE.md``'s GTX 1080 Ti and
i5-12600K figures).  Whether matplotlib is present, and so whether images
were written, is printed.
Phase 6 also holds the native host runtime's CSR sort and bucket table to
their numpy versions and the device CSR build to the host one, element for
element.  Phase 8 also holds each deep solve's
``host_syncs`` to what PyTorch's sync debug mode counts over the whole
``cli solve`` (one packed fetch a level), and runs the per-leg solve again
at an eighth of its cell batch: the count does not grow with the deepest
level's batches.

``--phases 1,8,9,10,11`` runs a subset (1 is always run; ``--phases
1,16,17`` is a short look at the parallel layer and the fuzzers, ``--phases
1,18`` at the viewers and the sweep); ``--quick``
cuts phase 8's deep solves (and phase 16's) to a quarter of the box, for a
first look at a new
kernel; ``--against`` (an earlier ``cell_kernels.cu``, phase 10) and
``--against-multileg`` (an earlier ``multileg_kernels.cu``, phases 5 and 7)
time another build's kernels in turns with this tree's on the same inputs
(K6c's walk and counters differ from earlier builds': against one, its three
flag words are compared; K6b's leg counters, words 5, 8 and 9, may only fall
against a build without the per-element reach balls, its other seven words
are compared; the other kernels' ten words);
``--against-leg`` (an earlier ``leg_kernels.cu``, with nvcc flags if any)
does so for K1 and K2 in phases 4, 11 and 12, and phase 3 holds that
build's K1 and K2 outputs to this tree's bit for bit.
Phase 10 also counts K5's bound over every batch of the two dense solves.

Output, in order: the card's name and power limit, one line per phase, one
JSON line ``{"kernels": [...]}`` and, last, one JSON line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import hashlib
import importlib.util
import io
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False (this script has no CPU path)")

from legmov_tpu_torch import cli, get_m2_leg, get_moonbot_leg, viz
from legmov_tpu_torch import io as lio
from legmov_tpu_torch import map_bench, reach_probe
from legmov_tpu_torch.config import SolverConfig
from legmov_tpu_torch.models import hier_solver as hs
from legmov_tpu_torch.models.pipeline import (
    multirot_positionable,
    multirot_positionable_packed,
    sweep_orientations,
)
from legmov_tpu_torch.models.robot import HEX_MOUNTS, QUAD_MOUNTS, make_robot
from legmov_tpu_torch.ops import _build, cuda_kernels as ck
from legmov_tpu_torch.ops import csr_cell_eval as cce
from legmov_tpu_torch.ops import cuda_multileg as cm
from legmov_tpu_torch.ops import cuda_multileg_dist as cmd
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.ops import trig32
from legmov_tpu_torch import native
from legmov_tpu_torch import dryrun, hier_fuzz, profiling, solver_fuzz
from legmov_tpu_torch import (bench_report, bench_sweep, circle_figure,
                              live_view, ref_image_check,
                              visualize_solve)
from legmov_tpu_torch.profiling import kernel_clock
from legmov_tpu_torch.models import adaptive_field as af
from legmov_tpu_torch.ops.csr_grid import (
    ball_columns,
    build_csr_grid,
    build_csr_grid_device,
    csr_sort_numpy,
    make_csr_dma_solver,
    suggest_rounds,
    suggest_window,
    suggest_zclip,
)
from legmov_tpu_torch.ops.grid import (
    bucket_grid_numpy,
    build_grid,
    cell_size_for,
    neighbor_offsets,
)
from legmov_tpu_torch.ops.positionability import reachable_legs
from legmov_tpu_torch.ops.distance import distance_ws
from legmov_tpu_torch.ops.reachability import reachability_ws
from legmov_tpu_torch.models.workspace import build_workspace
from legmov_tpu_torch.oracle import oracle_distance, oracle_reachability

DEV = torch.device("cuda")
LEGS = {"moonbot": get_moonbot_leg, "m2": get_m2_leg}

# Published peaks of one H100 SXM: device memory rate and fp32 rate outside
# the tensor cores.  The bound of a kernel is the larger of its bytes over
# the first and its fp32 operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
REACH_BYTES_PER_POINT = 13  # three f32 read, one byte written
DIST_BYTES_PER_POINT = 25   # three f32 read, one byte + three f32 written

# distance contract of the repository (tests/test_distance.py)
NORM_RTOL, NORM_ATOL = 5e-4, 2e-2
COMP_ATOL, COMP_RTOL, COMP_SHARE = 2e-2, 2e-4, 0.995

N_REACH = 1 << 24        # headline reachability grid, 256^3
N_DIST = 161 ** 3        # headline distance grid, 4,173,281 points
SWEEP_NX, SWEEP_NZ = 17526, 3775  # top of the upstream sweep: 66,160,650


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# inputs, made on the card from fixed seeds
# ---------------------------------------------------------------------------

def cube_grid(n):
    """SoA grid over the leg's surroundings with about ``n`` points: the
    envelope of the reference bench grids (x -100..601, y -400..401,
    z -350..51), x-major."""
    side = max(2, round(n ** (1.0 / 3.0)))
    nz = max(2, n // (side * side))
    x = torch.linspace(-100.0, 601.0, side, device=DEV)
    y = torch.linspace(-400.0, 401.0, side, device=DEV)
    z = torch.linspace(-350.0, 51.0, nz, device=DEV)
    X, Y, Z = torch.meshgrid(x, y, z, indexing="ij")
    return X.reshape(-1).clone(), Y.reshape(-1).clone(), Z.reshape(-1).clone()


def sweep_grid():
    """The largest grid of the upstream sweep protocol: the y = 0 plane,
    x -100..601, z -100..51, 17526 x 3775 = 66,160,650 points."""
    x = torch.linspace(-100.0, 601.0, SWEEP_NX, device=DEV)
    z = torch.linspace(-100.0, 51.0, SWEEP_NZ, device=DEV)
    X, Z = torch.meshgrid(x, z, indexing="ij")
    X, Z = X.reshape(-1).clone(), Z.reshape(-1).clone()
    return X, torch.zeros_like(X), Z


def random_points(n, seed):
    """Seeded uniform(-650, 650) points with 32 rows of NaN/inf/0 mixed in."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-650, 650, (n, 3)).astype(np.float32)
    p[:32] = np.array([np.nan, np.inf, -np.inf, 0.0], np.float32)[
        np.random.default_rng(3).integers(0, 4, (32, 3))
    ]
    return torch.from_numpy(p).to(DEV)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def same_bits(a, b):
    """Floats equal bit for bit, NaN payloads aside."""
    return ((a == b) | (torch.isnan(a) & torch.isnan(b)))


def compare_reach(tag, got, want):
    bad = int((got != want).sum())
    say(f"  K1 {tag}: n={got.numel()} mismatches={bad}")
    check(got.dtype == torch.bool and got.shape == want.shape,
          f"K1 {tag}: wrong type or shape")
    check(bad == 0, f"K1 {tag}: {bad} boolean mismatches against the plain version")
    return bad


def compare_dist(tag, got, want, gate=True):
    """``got``/``want`` = (ok, vec [N, 3]).  Returns (ok mismatches, worst
    finite |difference| of the vectors)."""
    ok_g, v_g = got
    ok_w, v_w = want
    bad = int((ok_g != ok_w).sum())
    n = ok_g.numel()
    if n == 0:
        say(f"  K2 {tag}: n=0")
        return 0, 0.0
    exact = float(same_bits(v_g, v_w).all(dim=-1).float().mean())
    diff = (v_g - v_w).abs()
    finite = torch.isfinite(diff)
    worst = float(diff[finite].max()) if bool(finite.any()) else 0.0
    norms_ok = bool(torch.isclose(
        torch.linalg.vector_norm(v_g, dim=-1),
        torch.linalg.vector_norm(v_w, dim=-1),
        rtol=NORM_RTOL, atol=NORM_ATOL, equal_nan=True).all())
    comp = ((diff <= COMP_ATOL + COMP_RTOL * v_w.abs()) | same_bits(v_g, v_w))
    share = float(comp.all(dim=-1).float().mean())
    say(f"  K2 {tag}: n={n} ok_mismatches={bad} vectors_bit_equal={exact:.6f} "
        f"max_abs_err={worst:.3e} norms_within_tol={norms_ok} "
        f"component_share={share:.6f}")
    if gate:
        check(bad == 0, f"K2 {tag}: {bad} ok mismatches against the plain version")
        check(norms_ok, f"K2 {tag}: norms outside rtol {NORM_RTOL} atol {NORM_ATOL}")
        check(share > COMP_SHARE, f"K2 {tag}: component share {share}")
    return bad, worst


def plain_reach(kr, x, y, z):
    return ck.reachability_kernel_plain(x, y, z, kr.consts)


def plain_dist(kd, x, y, z):
    ok, dx, dy, dz = ck.distance_kernel_plain(x, y, z, kd.consts)
    return ok, torch.stack([dx, dy, dz], dim=-1)


# ---------------------------------------------------------------------------
# the single-leg kernels through their C launchers, of this build or of an
# earlier leg_kernels.cu (--against-leg)
# ---------------------------------------------------------------------------

def bind_leg_library(lib):
    """This build's argument types for the launchers a library built from a
    ``leg_kernels.cu`` has."""
    for name, argtypes in ck.signatures().items():
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = argtypes
    return lib


def leg_builds(specs):
    """The builds of ``--against-leg``: each a ``leg_kernels.cu``,
    optionally followed by nvcc flags.  [(label, lib)]"""
    if not specs:
        return []
    say("phase 1: the builds of --against-leg")
    parts = [spec.split() for spec in specs]
    return alternatives([p[0] for p in parts], bind_leg_library,
                        [tuple(p[1:]) for p in parts])


def _stride(x):
    return x.stride(0) if x.numel() > 1 else 1


def reach_call(lib, comps, params):
    """One launch of ``lib``'s K1 on three ``[N]`` components; returns the
    booleans."""
    x, y, z = comps
    n = x.numel()
    out = torch.empty(n, dtype=torch.bool, device=DEV)
    if n == 0:
        return out
    err = lib.legmov_reachability(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), _stride(x), out.data_ptr(),
        n, ctypes.byref(params), ck._stream())
    check(err == 0, f"legmov_reachability: CUDA error {err}")
    return out


def dist_call(lib, comps, params):
    """One launch of ``lib``'s K2 point kernel on three ``[N]`` components;
    returns ``(ok, vec [N, 3])``."""
    x, y, z = comps
    n = x.numel()
    ok = torch.empty(n, dtype=torch.bool, device=DEV)
    vec = torch.empty((3, n), dtype=torch.float32, device=DEV)
    if n == 0:
        return ok, vec.T
    err = lib.legmov_distance(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), _stride(x), ok.data_ptr(),
        vec[0].data_ptr(), vec[1].data_ptr(), vec[2].data_ptr(), 1, n,
        ctypes.byref(params), ck._stream())
    check(err == 0, f"legmov_distance: CUDA error {err}")
    return ok, vec.T


def leg_params(leg):
    """K1's and K2's parameter blocks for ``leg``, each carrying its
    constants (``.consts``)."""
    rc, dc = ck.reach_consts(leg), ck.dist_consts(leg)
    rp, dp = ck.reach_params(rc), ck.dist_params(dc)
    rp.consts, dp.consts = rc, dc
    return rp, dp


def generic_params(rc, cleared):
    """K1's parameter block for the constants ``rc`` with the interval
    collapse of its first circle (``cleared`` "first") or of every circle
    ("all") cleared: the launcher then takes the generic instance, whose
    full interval test gives the collapsed test's bits where the collapse
    is legal.  Carries its constants (``.consts``)."""
    n = len(rc.collapse)
    off = (False,) * (1 if cleared == "first" else n)
    c = rc._replace(collapse=off + rc.collapse[len(off):])
    p = ck.reach_params(c)
    p.consts = c
    return p


def same_dist(a, b):
    """Two K2 outputs ``(ok, vec)`` hold the same bits."""
    return bool(torch.equal(a[0], b[0])) and all_bits_equal(a[1], b[1])


def queued_ms(fn, reps=50, warmup=3):
    """Milliseconds a launch of ``fn`` holds the card: ``reps`` launches
    queued back to back between two CUDA events behind a sleep kernel that
    outlasts the host's time to enqueue them all, so that the card runs
    them without a gap whatever the wrapper's host time (events around one
    launch on an idle stream, as :func:`time_cuda` takes them, also count
    the wrapper's host time before the kernel starts).  The sleep is made
    longer until it outlasts the enqueueing (four tries, then the reading
    is marked host-bound)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(4):
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if s.elapsed_time(a) > host_ms:
            return a.elapsed_time(b) / reps
        cycles *= 4
    say(f"  queued_ms: the host took {host_ms:.2f} ms to enqueue {reps} "
        "launches, longer than the sleep: this reading is host-bound")
    return a.elapsed_time(b) / reps


def in_turns(other, this, rounds=2):
    """``rounds`` x (other, this, this, other), each :func:`queued_ms`;
    returns (other ms, this ms, other / this, the readings)."""
    t = []
    for _ in range(rounds):
        t += [queued_ms(other), queued_ms(this), queued_ms(this),
              queued_ms(other)]
    o = statistics.median(t[0::4] + t[3::4])
    h = statistics.median(t[1::4] + t[2::4])
    return o, h, o / h, t


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def sass_mix(so):
    """Each kernel of library ``so``: its SASS instructions and the ten
    most frequent opcodes (``cuobjdump -sass``)."""
    cuobjdump = os.path.join(os.path.dirname(_build._find_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        say("  sass: not measured (no cuobjdump beside nvcc)")
        return
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True).stdout
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_.]+)", block)
        mix = collections.Counter(o.split(".")[0] for o in ops)
        say(f"  sass {block.split()[0]}: {len(ops)} instructions; "
            + ", ".join(f"{k} {v}" for k, v in mix.most_common(10)))


def phase_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    # a one-point launch forces the build and proves the library loads
    kr = ck.make_reachability_kernel(get_m2_leg())
    one = torch.zeros(1, device=DEV)
    kr.soa(one, one, one)
    torch.cuda.synchronize()
    libs = [os.path.relpath(_build.library_path(n)) for n in _build.sources()]
    say(f"phase 1: built {', '.join(libs)} with one nvcc each, started "
        f"together, in {_build.build_seconds:.1f} s (set-up, not timed below)")
    for name in _build.sources():
        check(os.path.exists(_build.library_path(name)), f"{name} not built")
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line:
                say("  ptxas:", line.split("function")[1].strip())
            if "registers" in line or "spill" in line.lower() and "0 bytes spill" not in line:
                say("  ptxas:", line.strip())
    # the instruction mix of every kernel, as the card runs it
    for name in ("leg_kernels", "cell_kernels", "multileg_kernels"):
        sass_mix(_build.library_path(name))
    # what the card holds of each cell kernel at once, as it is launched
    # (K6b's shared memory grows with the window; the solver's is 2048)
    occ = {"distance_cells": ck.dist_cells_occupancy()}
    o = occ["distance_cells"]
    say(f"  K2 cell kernel: {o['registers']} registers and {o['local_bytes']} "
        f"B of local memory a thread, {o['threads']} threads and "
        f"{o['shared_bytes']} B of shared memory a block, "
        f"{o['blocks_per_sm']} blocks = {o['warps_per_sm']} warps resident an "
        "SM")
    for form in cmd.KERNEL_FORMS:
        for L in (4, 6):
            # the cell driver's shared memory grows with the orientations
            o = cmd.occupancy(form, L, 27 if form.startswith("item_cells")
                              else 2048)
            occ.setdefault(form, o)
            say(f"  {KERNEL_IDS[form]} ({L} legs): {o['registers']} registers "
                f"and {o['local_bytes']} B of local memory a thread, "
                f"{o['threads']} threads and {o['shared_bytes']} B of shared "
                f"memory a block, {o['blocks_per_sm']} blocks = "
                f"{o['warps_per_sm']} warps resident an SM")
    return smi, occ


def phase_cli(tmp):
    """The main path, through the CLI's entry points, at the default 5 mm
    query grid (141 x 161 x 141 = 3,200,841 points), both shipped legs."""
    # first the 20 mm grid, whose moonbot fraction the repository documents
    small = os.path.join(tmp, "data20")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["prepare", "--dir", small, "--pix-size", "20"])
        cli.main(["evaluate", "--dir", small, "--leg", "moonbot"])
    frac20 = buf.getvalue().split("reachable fraction:")[1].strip()
    say(f"phase 2: moonbot on the 20 mm grid: reachable fraction {frac20}")
    check(frac20 == "0.0703", "moonbot reachable fraction on the 20 mm grid "
          f"is {frac20}, not 0.0703")

    data = os.path.join(tmp, "data")
    ck.reachability_kernel.launches = 0
    ck.distance_kernel.launches = 0
    t0 = time.perf_counter()
    cli.main(["prepare", "--dir", data, "--pix-size", "5"])
    t_prepare = time.perf_counter() - t0
    grid = lio.load_points(os.path.join(data, "dist_input_t"))
    comps = tuple(torch.from_numpy(np.ascontiguousarray(grid[:, i])).to(DEV)
                  for i in range(3))
    results = {}
    for name in LEGS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with kernel_clock(("reachability", "distance")) as recs, \
                contextlib.redirect_stdout(buf):
            cli.main(["evaluate", "--dir", data, "--leg", name])
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        sys.stdout.write(out)
        leg = LEGS[name]()
        report_clock(f"cli evaluate {name}", recs, {
            "reachability": reach_bound(leg),
            "distance": dist_bound(leg, comps)})
        reach = lio.load_bools(os.path.join(data, "out_reachability.bin"))
        dist = lio.load_points(os.path.join(data, "out_dist_x"))
        results[name] = (out, reach, dist, wall)
    launches = {"reachability": ck.reachability_kernel.launches,
                "distance": ck.distance_kernel.launches}
    del comps
    n = grid.shape[0]
    check(n == 141 * 161 * 141, f"query grid has {n} points")
    for name, (out, reach, dist, wall) in results.items():
        check(reach.shape == (n,), f"{name}: out_reachability.bin length {reach.shape}")
        check(dist.shape == (n, 3), f"{name}: out_dist_x*.bin length {dist.shape}")
        check(np.isfinite(dist).all(), f"{name}: non-finite distance vectors")
        frac = out.split("reachable fraction:")[1].strip()
        vol = viz.reachable_volume_m3(reach, 5.0)
        say(f"phase 2: {name}: reachable fraction {frac}, reachable volume "
            f"{vol:.4f} m^3, evaluate wall {wall*1e3:.1f} ms (file I/O, host "
            f"<-> device copies and both kernels; prepare took {t_prepare:.1f} s)")
        # the repository's own check: the strict-fp32 scalar oracle on a
        # seeded sample of the grid, drawn half from the reachable points
        leg = LEGS[name]()
        rng = np.random.default_rng(7)
        idx = np.concatenate([
            rng.choice(n, 600, replace=False),
            rng.choice(np.flatnonzero(reach), 600, replace=False),
        ])
        want = oracle_reachability(grid[idx], leg)
        check(np.array_equal(reach[idx], want),
              f"{name}: reachability differs from the oracle on "
              f"{int((reach[idx] != want).sum())} of {idx.size} sampled points")
        ok_o, vec_o = oracle_distance(grid[idx], leg)
        check(np.array_equal(reach[idx], ok_o), f"{name}: oracle ok differs")
        np.testing.assert_allclose(
            np.linalg.norm(dist[idx], axis=1), np.linalg.norm(vec_o, axis=1),
            rtol=NORM_RTOL, atol=NORM_ATOL)
        comp = np.all(np.abs(dist[idx] - vec_o)
                      <= COMP_ATOL + COMP_RTOL * np.abs(vec_o), axis=-1)
        check(comp.mean() > COMP_SHARE,
              f"{name}: oracle component share {comp.mean()}")
        say(f"  {name}: {idx.size} sampled points agree with the scalar oracle "
            f"(booleans equal, norms within tolerance, component share "
            f"{comp.mean():.4f})")
    # 0.0745 is what the JAX package's CLI prints for this grid and leg
    check(results["moonbot"][0].split("reachable fraction:")[1].strip() == "0.0745",
          "moonbot reachable fraction on the 5 mm grid is not 0.0745")
    check(launches["reachability"] == 2 and launches["distance"] == 2,
          f"the CLI path did not launch each kernel once per evaluate: {launches}")
    say(f"phase 2: kernel launches on the main path: {launches}")
    return launches, grid, results


def phase_compare(cli_grid, cli_results, others=()):
    """Every kernel against its plain version, on the card; K1's generic
    instance and the builds of ``others`` (``--against-leg``)
    against this build's, bit for bit.  Returns K1's mismatching booleans
    and K2's worst finite vector difference against the plain version."""
    worst = {"reachability": 0, "distance": 0.0}
    lib = ck._library()
    pts = random_points(1_000_000, 11)
    cols = tuple(pts[:, i].contiguous() for i in range(3))
    bench = cube_grid(N_REACH)
    check(bench[0].numel() == N_REACH, "bench grid size")
    gx, gy, gz = (torch.from_numpy(np.ascontiguousarray(cli_grid[:, i])).to(DEV)
                  for i in range(3))
    for name, make_leg in LEGS.items():
        leg = make_leg()
        kr = ck.make_reachability_kernel(leg)
        kd = ck.make_distance_kernel(leg)
        rp, dp = leg_params(leg)
        say(f"phase 3: {name}")

        # the shapes the main path gave the kernels: the CLI's own outputs
        _, reach_cli, dist_cli, _ = cli_results[name]
        want_r = plain_reach(kr, gx, gy, gz)
        worst["reachability"] += compare_reach(
            "cli-grid", torch.from_numpy(reach_cli).to(DEV), want_r)
        want_d = plain_dist(kd, gx, gy, gz)
        # (evaluate writes the distance vectors, not the distance kernel's
        # ok bits, so only the vectors are held here)
        _, w = compare_dist(
            "cli-grid", (want_d[0], torch.from_numpy(dist_cli).to(DEV)), want_d)
        worst["distance"] = max(worst["distance"], w)

        # (a) 1 M random points with NaN/inf/0 rows, AoS and SoA entries
        got_aos = kr(pts)
        got_soa = kr.soa(*cols)
        worst["reachability"] += compare_reach(
            "random-1M aos", got_aos, plain_reach(kr, *cols))
        check(torch.equal(got_aos, got_soa), "K1: SoA and [N,3] entries differ")
        d_aos = kd(pts)
        ok_s, dx, dy, dz = kd.soa(*cols)
        d_soa = (ok_s, torch.stack([dx, dy, dz], dim=-1))
        _, w = compare_dist("random-1M aos", d_aos, plain_dist(kd, *cols))
        worst["distance"] = max(worst["distance"], w)
        check(torch.equal(d_aos[0], d_soa[0])
              and bool(same_bits(d_aos[1], d_soa[1]).all()),
              "K2: SoA and [N,3] entries differ")
        say("  SoA and [N,3] entries agree exactly (K1 and K2)")

        # the independent tensor formulation (atan2, direct circle form):
        # printed, not gated
        ws = build_workspace(leg)
        ind_r = reachability_ws(pts, ws)
        say(f"  independent ops/reachability.py vs K1: "
            f"{int((ind_r != got_aos).sum())} mismatches of {pts.shape[0]}")
        compare_dist("independent ops/distance.py (not gated)",
                     d_aos, distance_ws(pts, ws), gate=False)

        # (b) ragged sizes: views of the [N, 3] tensor (stride 3) and of the
        # SoA arrays, 16-byte aligned (offset 32) and not (offset 1)
        for n in (0, 1, 7, 129, 1000):
            sub = pts[32:32 + n]
            sc = tuple(c[32:32 + n] for c in cols)
            r = kr(sub)
            check(r.shape == (n,) and r.dtype == torch.bool, f"K1 n={n} shape")
            okn, vn = kd(sub)
            check(okn.shape == (n,) and vn.shape == (n, 3), f"K2 n={n} shape")
            if n:
                worst["reachability"] += compare_reach(
                    f"ragged n={n}", r, plain_reach(kr, *sc))
                compare_dist(f"ragged n={n}", (okn, vn), plain_dist(kd, *sc))
            for off in (32, 1):
                sv = tuple(c[off:off + n] for c in cols)
                got = kr.soa(*sv)
                worst["reachability"] += compare_reach(
                    f"ragged SoA view +{off} n={n}", got, plain_reach(kr, *sv))

        # (c) the headline bench grid
        worst["reachability"] += compare_reach(
            "bench-grid", kr.soa(*bench), plain_reach(kr, *bench))
        ok_b, dx, dy, dz = kd.soa(*bench)
        _, w = compare_dist("bench-grid", (ok_b, torch.stack([dx, dy, dz], -1)),
                            plain_dist(kd, *bench))
        worst["distance"] = max(worst["distance"], w)
        del dx, dy, dz, ok_b

        # (d) the mixed set: every 32 consecutive points span the four
        # (upper, ext) configurations, valid and invalid queries and both
        # dual-finish winners; NaN, +-inf, 0.0 and -0.0 rows first
        mixed = ck.special_rows(
            ck.mixed_points(leg, 1 << 20, 17, device=DEV))
        mc = tuple(mixed[:, i].contiguous() for i in range(3))
        worst["reachability"] += compare_reach(
            "mixed-1M", kr.soa(*mc), plain_reach(kr, *mc))
        ok_m, dx, dy, dz = kd.soa(*mc)
        _, w = compare_dist("mixed-1M", (ok_m, torch.stack([dx, dy, dz], -1)),
                            plain_dist(kd, *mc))
        worst["distance"] = max(worst["distance"], w)

        # (e) K1's generic instance and the other builds, bit for bit
        # against this build's kernels on every set above
        sets = {"cli-grid": (gx, gy, gz), "random-1M": cols,
                "random-1M aos": tuple(pts[:, i] for i in range(3)),
                "bench-grid": bench, "mixed-1M": mc,
                "SoA view +1": tuple(c[1:100_001] for c in cols)}
        gen = {c: generic_params(rp.consts, c) for c in ("first", "all")}
        for tag, comps in sets.items():
            here_r = reach_call(lib, comps, rp)
            for cleared, gp in gen.items():
                got = reach_call(lib, comps, gp)
                want = ck.reachability_kernel_plain(*comps, gp.consts)
                bad = int((got != want).sum())
                alike = int((got != here_r).sum())
                say(f"  {tag}: K1's generic instance, {cleared} collapse "
                    f"cleared: {bad} mismatches against its plain version, "
                    f"{alike} against the six-circle instance")
                check(bad == 0 and alike == 0,
                      f"{name} {tag}: K1's generic instance differs")
                worst["reachability"] += bad
            if not others:
                continue
            here_d = dist_call(lib, comps, dp)
            for label, blib in others:
                bad = int((reach_call(blib, comps, rp) != here_r).sum())
                same_d = same_dist(dist_call(blib, comps, dp), here_d)
                say(f"  {tag}: {label} == this build: K1 {bad} mismatches, "
                    f"K2 ok and vectors bit-equal {same_d}")
                check(bad == 0 and same_d,
                      f"{name} {tag}: {label} differs from this build")
            del here_d
    torch.cuda.synchronize()
    return worst


def time_cuda(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn`` over ``reps`` launches, CUDA events."""
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


def bound_ms(n, bytes_per_point, flops_per_point):
    t_bytes = n * bytes_per_point / HBM_BYTES_PER_S * 1e3
    t_ops = n * flops_per_point / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(cli_grid, others=()):
    """m2 leg, SoA entries, at the main path's sizes and on the mixed sets;
    K1's generic instance and the builds of ``others`` (``--against-leg``)
    in turns with this build's."""
    leg = get_m2_leg()
    kr = ck.make_reachability_kernel(leg)
    kd = ck.make_distance_kernel(leg)
    rp, dp = leg_params(leg)
    lib = ck._library()
    r_flops = ck.reach_flops_per_point(kr.consts)
    d_flops = ck.dist_flops_per_point(kd.consts)
    say(f"phase 4: m2 leg, SoA entries; ms: CUDA events around one launch "
        f"of the wrapper, median of 20 after 3 warm-ups; queued: 50 launches "
        f"back to back between two events, behind a sleep; fp32 operations per point: K1 "
        f"{r_flops}, K2 at most {d_flops} (its bound counts what each set "
        "needs, ck.dist_flops_needed)")
    rows = {"reachability": [], "distance": []}

    def one(kind, label, comps, plain_reps):
        n = comps[0].numel()
        if kind == "reachability":
            fn = lambda: kr.soa(*comps)
            pl = lambda: plain_reach(kr, *comps)
            b, by = bound_ms(n, REACH_BYTES_PER_POINT, r_flops)
            extra = {}
        else:
            fn = lambda: kd.soa(*comps)
            pl = lambda: plain_dist(kd, *comps)
            need = ck.dist_flops_needed(*comps, kd.consts)
            b, by = bound_ms(n, DIST_BYTES_PER_POINT, need / n)
            full, _ = bound_ms(n, DIST_BYTES_PER_POINT, d_flops)
            extra = {"flops_needed": need, "bound_full_ms": full}
        ms = time_cuda(fn)
        q = queued_ms(fn)
        plain = time_cuda(pl, warmup=1, reps=plain_reps)
        row = {"grid": label, "n": n, "ms": ms, "queued_ms": q,
               "ns_per_point": ms * 1e6 / n, "plain_ms": plain,
               "bound_ms": b, "bound_by": by, **extra}
        rows[kind].append(row)
        say(f"  {kind:12s} {label:10s} n={n:>10d}  {ms:9.4f} ms  queued "
            f"{q:.4f} ms  {row['ns_per_point']:.5f} ns/point  plain "
            f"{plain:9.2f} ms  bound {b:.4f} ms ({by})  share of bound "
            f"{b / ms:.3f} (queued {b / q:.3f})"
            + (f"; full count {extra['bound_full_ms']:.4f} ms, share "
               f"{extra['bound_full_ms'] / ms:.3f} (queued "
               f"{extra['bound_full_ms'] / q:.3f})" if extra else ""))

    def turns(kind, label, comps):
        """K1's generic instance and each other build in turns with this
        build's kernel, through the C launchers."""
        call, params = ((reach_call, rp) if kind == "reachability"
                        else (dist_call, dp))
        here = lambda: call(lib, comps, params)
        row = next(r for r in rows[kind] if r["grid"] == label)
        row["in_turns"] = {}
        builds = [(lb, o, params) for lb, o in others]
        if kind == "reachability":
            builds.insert(0, ("generic instance (every collapse cleared)",
                              lib, generic_params(rp.consts, "all")))
        for tag, blib, bparams in builds:
            o, h, ratio, t = in_turns(
                lambda: call(blib, comps, bparams), here)
            row["in_turns"][tag] = {"other_ms": o, "this_ms": h,
                                    "other_over_this": ratio, "ms": t}
            say(f"    {KERNEL_IDS[kind]} {label}, queued, in turns (other, "
                f"this, this, other) x 2: {tag} {o:.4f} ms, this build "
                f"{h:.4f} ms: other / this {ratio:.3f} ("
                + ", ".join(f"{x:.4f}" for x in t) + ")")

    cli_comps = tuple(
        torch.from_numpy(np.ascontiguousarray(cli_grid[:, i])).to(DEV)
        for i in range(3))
    one("reachability", "cli-5mm", cli_comps, 3)
    one("distance", "cli-5mm", cli_comps, 3)
    del cli_comps
    g = cube_grid(N_REACH)
    one("reachability", "bench-16M", g, 3)
    turns("reachability", "bench-16M", g)
    m = ck.mixed_points(leg, N_REACH, 19, device=DEV)
    g = tuple(m[:, i].contiguous() for i in range(3))
    del m
    one("reachability", "mixed-16M", g, 3)
    turns("reachability", "mixed-16M", g)
    g = cube_grid(1 << 22)
    check(g[0].numel() == N_DIST, "distance bench grid size")
    one("distance", "bench-4M", g, 3)
    turns("distance", "bench-4M", g)
    m = ck.mixed_points(leg, N_DIST, 23, device=DEV)
    g = tuple(m[:, i].contiguous() for i in range(3))
    del m
    one("distance", "mixed-4M", g, 3)
    turns("distance", "mixed-4M", g)
    g = sweep_grid()
    one("reachability", "sweep-66M", g, 1)
    one("distance", "sweep-66M", g, 1)

    # what `evaluate` costs around the kernels at the sweep size: pageable
    # host arrays to the card, both kernels, results back to the host
    host = tuple(c.cpu().numpy() for c in g)
    del g
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y, z = (torch.from_numpy(c).to(DEV) for c in host)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    kr.soa(x, y, z).cpu().numpy()
    t_reach = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, dx, dy, dz = kd.soa(x, y, z)
    for c in (dx, dy, dz):
        c.cpu().numpy()
    t_dist = time.perf_counter() - t0
    n = host[0].shape[0]
    k_ms = rows["reachability"][-1]["ms"] + rows["distance"][-1]["ms"]
    wall = (t_h2d + t_reach + t_dist) * 1e3
    say(f"  evaluate-shaped wall at n={n}: host->device {t_h2d*1e3:.1f} ms, "
        f"reachability incl. copy back {t_reach*1e3:.1f} ms, distance incl. "
        f"copy back {t_dist*1e3:.1f} ms; total {wall:.1f} ms of which the two "
        f"kernels are {k_ms:.2f} ms ({k_ms / wall:.4f} of the wall)")
    return rows


# ---------------------------------------------------------------------------
# map positionability: the CLI, the map-scale solve, the two kernels alone
# ---------------------------------------------------------------------------

MAP_POINTS = 10_240_000   # 3200 x 3200 moon_ground
MAP_POSES = 32768
MAP_CHUNK = 2048


def run_map(data, *extra, path_name="", keep=True, count_k4=False):
    """``cli map --dir data --leg m2 *extra`` with the launch counts set to 0
    just before and read just after: (JSON line, mask, launches, kernel ->
    summed ms).  The kernel time of the run is printed under ``cli map
    <path_name>`` (and kept for the kernels line unless ``keep`` is
    False).  ``count_k4`` counts instead what each round of K4's round
    kernel needs, and gives the bound to the kept kernel time of
    ``path_name``: the count reads the device between launches, which the
    events around a launch would take in, so it runs apart from the timed
    run."""
    cm.multileg_kernel.launches = 0
    cm.csr_window_kernel.launches = 0
    cm.csr_round_kernel.launches = 0
    k4_calls = []

    def launch(real, *a, **kw):
        return real(*a, **kw)

    buf = io.StringIO()
    with intercepted(cm, "csr_round_kernel",
                     counting_rounds(k4_calls) if count_k4 else launch), \
            kernel_clock(("multileg", "csr_window", "csr_round")) as recs, \
            contextlib.redirect_stdout(buf):
        cli.main(["map", "--dir", data, "--leg", "m2", *extra])
    torch.cuda.synchronize()
    launches = {"multileg": cm.multileg_kernel.launches,
                "csr_window": cm.csr_window_kernel.launches,
                "csr_round": cm.csr_round_kernel.launches}
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    mask = np.load(os.path.join(data, "body_feasible.npy"))
    pts = lio.load_points(os.path.join(data, "out_feasible_body_"))
    check(mask.dtype == bool and mask.shape == (line["body_candidates"],),
          "body_feasible.npy has the wrong type or shape")
    check(pts.shape == (int(mask.sum()), 3) and line["feasible"] == mask.sum(),
          "out_feasible_body_*.bin does not hold the feasible candidates")
    say(f"  cli map {' '.join(extra) or '(csr-dma)'}: candidates "
        f"{line['body_candidates']} feasible {line['feasible']} seconds "
        f"{line['seconds']} poses/s {line['poses_per_s']} window "
        f"{line['window']} host syncs {line['host_syncs']} launches K3 "
        f"{launches['multileg']} K4 round kernel {launches['csr_round']} "
        f"K4 step form {launches['csr_window']}")
    path = f"cli map {path_name}".rstrip()
    if count_k4:
        lo, hi = round_bounds(k4_calls)
        kept = PATH_TIMES["csr_round", path]
        kept.update(bound_ms=lo, bound_ms_every_missing_leg=hi)
        say(f"    K4's bound on {path}, counted on this run over its "
            f"{len(k4_calls)} rounds: the steps serving legs never found "
            f"{lo:.3f} ms, share {lo / kept['ms']:.3f} of the timed run's "
            f"{kept['ms']:.3f} ms; every step serving a leg missing at "
            f"launch {hi:.3f} ms")
        return line, mask, launches, {}
    sums = report_clock(path, recs, keep=keep)
    return line, mask, launches, sums


SUB_STRIDE = 16  # every 16th body candidate, for the slow variants


def phase_cli_map(data, others=()):
    """``cli map`` on the phase-2 directory: the default ``prepare`` (65,536
    terrain points, the 50 mm body voxel grid), quadruped m2, k = 4.  Both
    solvers run over every candidate.  The plain versions and the
    45-orientation sweep take minutes at that depth (they are launch-bound
    eager code), so they run, through the same command, on a directory that
    holds the same terrain and every 16th candidate."""
    say("phase 5: cli map on the prepared directory (m2 quadruped, k = 4)")
    j_dma, m_dma, l_dma, _ = run_map(data, path_name="(csr-dma)")
    _, m_count, _, _ = run_map(data, keep=False, path_name="(csr-dma)",
                               count_k4=True)
    check(np.array_equal(m_count, m_dma), "csr-dma: the counted run's mask "
          "differs")
    check(j_dma["host_syncs"] == 0, f"csr-dma read the device back "
          f"{j_dma['host_syncs']} times")
    # (K3's bound is counted on the dense-table solvers of phase 15 and on
    # its own in phase 7; a second, counted `--solver csr` run here took
    # 80-166 s)
    _, m_csr, l_csr, _ = run_map(data, "--solver", "csr",
                              path_name="--solver csr")
    sub = data + "_sub"
    os.makedirs(sub)
    lio.save_points(lio.load_points(os.path.join(data, "numpy_input_t")),
                    os.path.join(sub, "numpy_input_t"))
    lio.save_points(
        lio.load_points(os.path.join(data, "numpy_input_b"))[::SUB_STRIDE],
        os.path.join(sub, "numpy_input_b"))
    say(f"  the same terrain with every {SUB_STRIDE}th body candidate:")
    _, s_dma, _, _ = run_map(sub, path_name="every 16th candidate")
    _, s_plain, l_plain, _ = run_map(sub, "--backend", "torch")
    _, s_csr_plain, _, _ = run_map(sub, "--solver", "csr", "--backend",
                                   "torch")
    _, s_rot, l_rot, _ = run_map(sub, "--rot-sweep",
                              path_name="--rot-sweep, every 16th candidate")
    check(np.array_equal(m_dma, m_csr),
          f"csr-dma and csr masks differ on {int((m_dma != m_csr).sum())}")
    check(np.array_equal(s_dma, m_dma[::SUB_STRIDE]),
          "the subset's mask is not the subset of the full mask")
    check(np.array_equal(s_dma, s_plain) and np.array_equal(s_dma, s_csr_plain),
          f"kernel and plain masks differ on {int((s_dma != s_plain).sum())} "
          f"(csr-dma) / {int((s_dma != s_csr_plain).sum())} (csr)")
    check(not (s_dma & ~s_rot).any(),
          "the orientation sweep lost a candidate that stands at identity")
    check(m_dma.any() and not m_dma.all() and s_dma.any(),
          "degenerate feasible mask")
    check(not any(l_plain.values()),
          f"--backend torch launched a kernel: {l_plain}")
    check(l_dma["csr_round"] > 0 and l_dma["multileg"] == 0
          and l_dma["csr_window"] == 0,
          f"csr-dma did not go through the CSR round kernel only: {l_dma}")
    check(l_csr["multileg"] > 0 and l_csr["csr_round"] == 0
          and l_csr["csr_window"] == 0,
          f"csr did not go through the multi-leg kernel only: {l_csr}")
    check(l_rot["csr_round"] > 0, "the sweep launched no kernel")
    say(f"phase 5: masks equal across csr-dma and csr ({int(m_dma.sum())} "
        f"feasible of {m_dma.size}) and, on every {SUB_STRIDE}th candidate, "
        f"across the kernels and --backend torch for both solvers "
        f"({int(s_dma.sum())} feasible of {s_dma.size}); the sweep adds "
        f"{int(s_rot.sum() - s_dma.sum())} there")
    # `cli map --solver csr` with K3 of other builds, in turns with this
    # build's (other, this, this, other): summed K3 ms and the wall
    other_libs = alternatives(others, bind_multileg_library)
    for label, lib in other_libs:
        res = []
        for turn, use in enumerate((lib, None, None, lib)):
            name = "other" if use is not None else "this"
            with multileg_library(use):
                line, m, _, sums = run_map(
                    data, "--solver", "csr", keep=False,
                    path_name=f"--solver csr, turn {turn + 1}: {name}")
            check(np.array_equal(m, m_csr), f"{label}: K3 gives another mask")
            res.append((sums.get("multileg", 0.0), line["seconds"]))
        say(f"phase 5: cli map --solver csr, K3 of {label} against this "
            f"build in turns (other, this, this, other): K3 ms "
            + ", ".join(f"{r[0]:.1f}" for r in res) + "; wall s "
            + ", ".join(f"{r[1]}" for r in res) + "; other / this "
            f"{(res[0][0] + res[3][0]) / (res[1][0] + res[2][0]):.3f}")
    # the round kernel against its plain version on every round of the
    # first chunk of `cli map`, both decide modes and z-clip settings, and
    # that chunk's solve under sync debug mode
    terrain = lio.load_points(os.path.join(data, "numpy_input_t"))
    body = lio.load_points(os.path.join(data, "numpy_input_b"))[:MAP_CHUNK]
    robot = make_robot(QUAD_MOUNTS, leg_fn=get_m2_leg)
    reach = cell_size_for(robot)
    csr = build_csr_grid(terrain, reach / 2, device=DEV)
    cols_np = ball_columns(neighbor_offsets(reach / 2, reach))
    cols = torch.from_numpy(cols_np).to(DEV)
    window = suggest_window(csr)
    rounds = suggest_rounds(csr, cols_np, window)
    zclip = suggest_zclip(csr, window)
    b = torch.from_numpy(np.ascontiguousarray(body)).to(DEV)
    q = torch.zeros((b.shape[0], 4), device=DEV)
    q[:, 0] = 1.0
    caught, round_bad = round_gates("cli map chunk", robot, csr, cols, b, q,
                                    4, window, rounds, zclip)
    turns = round_turns("cli map chunk", caught)
    for label, lib in other_libs:
        if hasattr(lib, "legmov_csr_round"):
            round_build_turns("a cli map chunk", caught, label, lib)
    solve = make_csr_dma_solver(robot, window=window, rounds=rounds,
                                decide="quorum", zclip=zclip)
    checks = chunk_checks("cli map chunk", solve, csr, cols, b, q, 4)
    check(checks["feasible"] == int(m_dma[:b.shape[0]].sum()),
          "the chunk's solve differs from cli map's")
    return {"multileg": l_csr["multileg"], "csr_round": l_dma["csr_round"],
            "csr_window": l_dma["csr_window"], "round_bad": round_bad,
            "turns": turns, "ops": checks}


@contextlib.contextmanager
def intercepted(module, name, hook):
    """Route ``module.name`` through ``hook(real, *args, **kw)`` for the
    length of the block (its callers look it up by name at every call).  A
    kernel wrapper counts its launches through that name too, so the count
    is carried over and back."""
    real = getattr(module, name)

    def passing(*args, **kw):
        return hook(real, *args, **kw)

    counts = hasattr(real, "launches")
    if counts:
        passing.launches = real.launches
    setattr(module, name, passing)
    try:
        yield
    finally:
        setattr(module, name, real)
        if counts:
            real.launches = passing.launches


# ---------------------------------------------------------------------------
# kernel time on a path: CUDA events around every call of a C launcher
# ---------------------------------------------------------------------------

KERNEL_IDS = {"reachability": "K1", "distance": "K2",
              "distance_cells": "K2 cell kernel",
              "multileg": "K3",
              "csr_window": "K4 step form", "csr_round": "K4 round kernel",
              "item": "K5", "item_cells": "K5 cell driver",
              "item_cells_shared": "K5 cell driver (shared rule)",
              "cell_quat_major": "K6a",
              "cell_shared": "K6b", "cell_cm_perleg": "K6c"}
#: (kernel, path) -> launches, summed kernel ms, summed bound ms (or None)
PATH_TIMES = {}


def report_clock(path, recs, bounds=None, keep=True):
    """Sum the events of one path (after its last synchronisation) per
    kernel, beside the summed bound where ``bounds[kernel](records)`` gives
    one, and keep them in PATH_TIMES (unless ``keep`` is False).  Returns
    kernel -> summed ms."""
    torch.cuda.synchronize()
    parts = []
    sums = {}
    for key, rec in recs.items():
        if not rec:
            continue
        ms = sums[key] = sum(a.elapsed_time(b) for a, b, _ in rec)
        bd = bounds[key](rec) if bounds and key in bounds else None
        if keep:
            PATH_TIMES[key, path] = {"launches": len(rec), "ms": ms,
                                     "bound_ms": bd}
        parts.append(f"{KERNEL_IDS[key]} {len(rec)} launches {ms:.3f} ms "
                     + (f"(bound {bd:.3f} ms)" if bd is not None
                        else "(no bound here)"))
    if parts:
        say(f"    kernel time on {path}: " + "; ".join(parts))
    return sums


def reach_bound(leg):
    """K1's bound over its launches for ``leg``: n points each (argument
    5)."""
    flops = ck.reach_flops_per_point(ck.reach_consts(leg))
    return lambda rec: sum(bound_ms(args[5], REACH_BYTES_PER_POINT, flops)[0]
                           for _, _, args in rec)


def dist_bound(leg, comps):
    """K2's bound over its launches for ``leg``, each on the points
    ``comps`` (checked by their count, argument 9): the operations those
    points need (ck.dist_flops_needed)."""
    n = comps[0].numel()
    need = ck.dist_flops_needed(*comps, ck.dist_consts(leg))

    def bound(rec):
        check(all(args[9] == n for _, _, args in rec),
              "K2 was launched on other points than the bound counts")
        return sum(bound_ms(n, DIST_BYTES_PER_POINT, need / n)[0]
                   for _ in rec)
    return bound


def k4_need(tab, legs_in, starts, lens, masks, legs_out):
    """What one K4 launch needs, as a device tensor: (candidates, candidate x
    leg evaluations) of the steps that serve a leg not in ``legs_in`` (the
    most a walk that skips found legs can need), then the same for legs not
    in ``legs_out`` (legs never found: the least it needs)."""
    L = legs_in.shape[1]
    bit = 1 << torch.arange(L, device=DEV, dtype=torch.int32)
    served = (masks[:, :, None] & bit) != 0
    n = lens.to(torch.int64)
    out = []
    for have in (legs_in, legs_out):
        need = served & ~have[:, None, :]
        out += [(n * need.any(dim=-1)).sum(), (n * need.sum(dim=-1)).sum()]
    return torch.stack(out)


# ---------------------------------------------------------------------------
# K4's round kernel: captured rounds, replays, what a round needs
# ---------------------------------------------------------------------------

ROUND_KW = ("window", "quota", "decide", "k", "idx")


def capture_rounds(into):
    """Hook for ``cm.csr_round_kernel``: keeps each round's arguments and
    the state it starts from (legs, scanned, undone, cloned before the
    launch), then launches."""
    def hook(real, tab, rel, cols, legs, scanned, undone, xs, ys, zs, grid,
             consts, reach2, **kw):
        into.append(dict(args=(tab, rel, cols), data=(xs, ys, zs), grid=grid,
                         consts=consts, reach2=reach2,
                         kw={k: kw[k] for k in ROUND_KW if k in kw},
                         state=(legs.clone(), scanned.clone(),
                                undone.clone())))
        return real(tab, rel, cols, legs, scanned, undone, xs, ys, zs, grid,
                    consts, reach2, **kw)
    return hook


def replay_round(r, fn):
    """Captured round ``r`` through ``fn`` (``cm.csr_round_kernel``,
    ``cm.csr_round_plain`` or :func:`step_form_round`) from the state it
    started from: (legs, scanned, undone) after it."""
    state = tuple(t.clone() for t in r["state"])
    fn(*r["args"], *state, *r["data"], r["grid"], r["consts"], r["reach2"],
       **r["kw"])
    return state


def step_form_round(tab, rel, cols, legs, scanned, undone, xs, ys, zs, grid,
                    consts, reach2, *, window, quota, decide, k, idx=None):
    """One round as the csr-dma solver ran it before the round kernel: the
    queue in tensor code (``cm.round_queue``), its ``[A, S]`` step matrices
    walked by the step form on the card (``cm.csr_window_kernel``), the
    state updated as ``cm.csr_round_plain`` updates it."""
    params = cm.multileg_params(consts)
    rows = (lambda a: a) if idx is None else (lambda a: a[idx])
    rel_, legs_, scanned_ = rows(rel), rows(legs), rows(scanned)
    q = cm.round_queue(rel_, tuple(rows(c) for c in cols), legs_, scanned_,
                       grid, reach2, window=window, quota=quota,
                       decide=decide, k=k)
    tab_ = rows(tab)
    for q0 in range(0, q.q_done, cm.MAX_STEPS):
        steps = cm.steps_for(q.cs, q.cl, q.cum, q.legbits, q0,
                             min(cm.MAX_STEPS, q.q_done - q0), window)
        legs_ = cm.csr_window_kernel(tab_, legs_, *steps, xs, ys, zs, consts,
                                     params)
    scanned_ = scanned_ | (q.want & (q.cum <= q.q_done))
    still = cm.make_undecided(decide, k)(legs_, scanned_, rel_)
    for t, new in ((legs, legs_), (scanned, scanned_), (undone, still)):
        if idx is None:
            t.copy_(new)
        else:
            t.index_copy_(0, idx, new)


def round_rows(r):
    """Poses of captured round ``r``."""
    idx = r["kw"].get("idx")
    return r["args"][1].shape[0] if idx is None else idx.shape[0]


def captured_queue(r):
    """The queue of captured round ``r`` (``cm.round_queue``) and a
    function that takes a ``[P, ...]`` tensor to the round's rows."""
    idx = r["kw"].get("idx")
    rows = (lambda a: a) if idx is None else (lambda a: a[idx])
    _, rel, cols = r["args"]
    legs, scanned, _ = r["state"]
    q = cm.round_queue(rows(rel), tuple(rows(c) for c in cols), rows(legs),
                       rows(scanned), r["grid"], r["reach2"],
                       **{k: v for k, v in r["kw"].items() if k != "idx"})
    return rows, q


def round_need(r, legs_out):
    """What one round needs, as a device tensor: ``k4_need``'s two ends of
    its steps (candidates, candidate x leg evaluations, each), the wanted
    columns of its queue and their (column, leg) pairs, then what its rows
    read and write (``cm.round_bytes``): the undecided rows, the unscanned
    columns of the decided rows, the columns it marks scanned.  The
    round's queue comes from the plain version (a read of its longest
    queue when unbounded)."""
    rows, q = captured_queue(r)
    tab, rel, _ = r["args"]
    legs, scanned, _ = r["state"]
    rel_, legs_, scanned_ = rows(rel), rows(legs), rows(scanned)
    steps = cm.steps_for(q.cs, q.cl, q.cum, q.legbits, 0, q.q_done,
                         r["kw"]["window"])
    need = k4_need(rows(tab), legs_, *steps, rows(legs_out))
    need0 = rel_ & ~legs_[:, None, :]
    live = cm.make_undecided(r["kw"]["decide"], r["kw"]["k"])(
        legs_, scanned_, rel_)
    return torch.cat([need, torch.stack(
        [q.want.sum(), (need0 & q.want[:, :, None]).sum(), live.sum(),
         (~scanned_ & ~live[:, None]).sum(),
         (q.want & (q.cum <= q.q_done)).sum()])])


def round_bound(need, rows, C, L, zclip, indexed, consts):
    """The round's bound from :func:`round_need`'s counts: (from the steps
    serving legs never found: (ms, by, bytes ms, operations ms), from every
    step serving a leg missing at launch: ms)."""
    ub_p, ub_l, lb_p, lb_l, cols, col_legs, live, open_decided, new = need
    fixed = cm.round_bytes(rows, live, open_decided, cols, new, C, L, zclip,
                           indexed)
    lo = bound_of(lb_p * 12 + fixed,
                  cm.round_flops(lb_p, lb_l, cols, col_legs, consts, zclip))
    hi = bound_of(ub_p * 12 + fixed,
                  cm.round_flops(ub_p, ub_l, cols, col_legs, consts, zclip))
    return lo, hi[0]


def counting_rounds(calls):
    """Hook for ``cm.csr_round_kernel`` that launches and counts what each
    round needs (:func:`round_need`) into ``calls``; the count reads the
    device, so it runs apart from a timed run."""
    def hook(real, tab, rel, cols, legs, scanned, undone, xs, ys, zs, grid,
             consts, reach2, **kw):
        r = dict(args=(tab, rel, cols), grid=grid, reach2=reach2,
                 kw={k: kw[k] for k in ROUND_KW if k in kw},
                 state=(legs.clone(), scanned.clone(), None))
        out = real(tab, rel, cols, legs, scanned, undone, xs, ys, zs, grid,
                   consts, reach2, **kw)
        if legs.is_cuda:
            calls.append((round_need(r, legs), round_rows(r), rel.shape[1],
                          rel.shape[2], len(cols) == 5,
                          kw.get("idx") is not None, consts))
        return out
    return hook


def round_bounds(calls):
    """The summed bound of the counted rounds ``calls``: (from the steps
    serving legs never found, from every step serving a leg missing at
    launch)."""
    if not calls:
        return 0.0, 0.0
    need = torch.stack([c[0] for c in calls]).tolist()
    lo = hi = 0.0
    for n, c in zip(need, calls):
        b, h = round_bound(n, *c[1:])
        lo += b[0]
        hi += h
    return lo, hi


def round_gates(tag, robot, csr, cols, body, quats, k, window, rounds,
                zclip_default):
    """One chunk through the csr-dma solver in both decide modes and both
    z-clip settings, every round captured, and every round replayed
    through the round kernel and through its plain version: legs, scanned
    and the undecided flags bit for bit.  Returns the rounds of the
    chunk's default run (quorum, the grid's z-clip) and the mismatches."""
    bad = n = 0
    kept = None
    for decide in ("quorum", "legs"):
        for zclip in (True, False):
            sv = make_csr_dma_solver(robot, window=window, rounds=rounds,
                                     decide=decide, zclip=zclip)
            caught = []
            with intercepted(cm, "csr_round_kernel", capture_rounds(caught)):
                sv(body, quats, csr.xs, csr.ys, csr.zs, csr.starts,
                   csr.origin, cols, cell_size=csr.cell_size, k=k,
                   dims=csr.dims)
            for r in caught:
                got = replay_round(r, cm.csr_round_kernel)
                want = replay_round(r, cm.csr_round_plain)
                bad += sum(int((g != w).sum()) for g, w in zip(got, want))
            n += len(caught)
            if decide == "quorum" and zclip == zclip_default:
                kept = caught
    say(f"  {tag}: every round of a chunk of {body.shape[0]} poses in both "
        f"decide modes, z-clipping on and off ({n} rounds): round kernel == "
        f"csr_round_plain on legs, scanned and undecided flags, mismatches "
        f"{bad}")
    check(bad == 0, f"{tag}: the round kernel differs from its plain version "
          f"on {bad} bits")
    return kept, bad


class OpCount(TorchDispatchMode):
    """Counts the aten operations dispatched inside the block (views
    included), by section: inside ``section(name)`` they count under
    ``name``."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.where = ["queue and schedule"]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[self.where[-1]] += 1
        return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def section(self, name):
        self.where.append(name)
        try:
            yield
        finally:
            self.where.pop()


def chunk_ops(solve_chunk, step_form):
    """The aten operations of one chunk's solve by section: the pose
    tables (``oriented_tables``), the per-pose columns
    (``_pose_columns``) and the rest, the queue and schedule, the kernel
    wrappers' own operations included.  ``step_form`` runs each round as
    before the round kernel: the queue in tensor code and the step form
    (:func:`step_form_round`)."""
    from legmov_tpu_torch.ops import csr_grid
    count = OpCount()

    def tagged(name):
        def hook(real, *a, **kw):
            with count.section(name):
                return real(*a, **kw)
        return hook

    def before(real, *a, params=None, **kw):
        return step_form_round(*a, **kw)

    with contextlib.ExitStack() as stack:
        stack.enter_context(intercepted(csr_grid, "oriented_tables",
                                        tagged("oriented_tables")))
        stack.enter_context(intercepted(csr_grid, "_pose_columns",
                                        tagged("_pose_columns")))
        if step_form:
            stack.enter_context(intercepted(cm, "csr_round_kernel", before))
        stack.enter_context(count)
        solve_chunk()
    torch.cuda.synchronize()
    return dict(count.counts)


#: warps a pose that the round kernel is timed at, each a build of this
#: ``multileg_kernels.cu`` with ``CR_WARPS`` fixed (:func:`warp_builds`)
ROUND_WARPS = (1, 2, 4, 8, 16)
_WARP_LIBS = []


def warp_builds():
    """[(warps, library)]: this ``multileg_kernels.cu`` built once for each
    count of ``ROUND_WARPS`` (one nvcc each, started together; built once
    a run)."""
    if not _WARP_LIBS:
        src = _build.sources()["multileg_kernels"]
        libs = alternatives([src] * len(ROUND_WARPS), bind_multileg_library,
                            flags=[(f"-DCR_WARPS={w}",) for w in ROUND_WARPS])
        _WARP_LIBS.extend(zip(ROUND_WARPS, (lib for _, lib in libs)))
    return _WARP_LIBS


def round_turns(tag, rounds_):
    """The captured rounds of a chunk through the round kernel and through
    the step form with its eager queue (:func:`step_form_round`: the
    solver's rounds before the round kernel), in turns (before, kernel,
    kernel, before): each pass's host wall, ending in a synchronisation,
    and its summed kernel time (events around the C launchers).  Then the
    round kernel at each warps-a-pose count of ``ROUND_WARPS`` (a build
    each) between two passes of this build.  Returns (before / kernel wall
    ratio, its kernel-time ratio, kernel summed ms, rows)."""
    def before():
        return [replay_round(r, step_form_round) for r in rounds_]

    def kernel():
        return [replay_round(r, cm.csr_round_kernel) for r in rounds_]

    want = kernel()
    got = before()
    check(all(torch.equal(a, b) for x, y in zip(got, want)
              for a, b in zip(x, y)),
          f"{tag}: the step form and the round kernel give other rounds")
    res = []
    for fn in (before, kernel, kernel, before):
        with kernel_clock(("csr_window", "csr_round")) as recs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ms = sum(a.elapsed_time(b) for rec in recs.values() for a, b, _ in rec)
        res.append((wall, ms))
    w_b, w_k = res[0][0] + res[3][0], res[1][0] + res[2][0]
    m_b, m_k = res[0][1] + res[3][1], res[1][1] + res[2][1]
    say(f"  {tag}: {len(rounds_)} rounds ({sum(round_rows(r) for r in rounds_)}"
        f" pose rows) in turns (step form and its eager queue, round kernel, "
        f"round kernel, step form): wall ms "
        + ", ".join(f"{r[0]:.2f}" for r in res) + "; summed kernel ms "
        + ", ".join(f"{r[1]:.3f}" for r in res)
        + f"; step form / round kernel: wall {w_b / w_k:.3f}, kernel time "
        f"{m_b / m_k:.3f}")
    warps = {}
    for w, lib in [(0, None)] + warp_builds() + [(0, None)]:
        with multileg_library(lib):
            kernel()  # loads the build's kernel before it is timed
            with kernel_clock(("csr_round",)) as recs:
                out = kernel()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for x, y in zip(out, want)
                  for a, b in zip(x, y)), f"{tag}: warps={w} differs")
        warps.setdefault(w, []).append(
            sum(a.elapsed_time(b) for a, b, _ in recs["csr_round"]))
    say(f"  {tag}: round kernel summed ms by warps a pose (0 = this build, "
        f"the launcher's choice, first and last): "
        + ", ".join(f"{w}: " + "/".join(f"{v:.3f}" for v in vs)
                    for w, vs in warps.items()))
    return {"wall_ratio": w_b / w_k, "kernel_ratio": m_b / m_k,
            "kernel_ms": m_k / 2, "step_form_ms": m_b / 2,
            "wall_ms": w_k / 2, "step_form_wall_ms": w_b / 2, "turns": res,
            "warps_ms": warps}


def round_kernel_ms(r, reps=20):
    """Median milliseconds of captured round ``r`` in the round kernel,
    events around its C launcher (the wrapper's clones left out)."""
    for _ in range(3):
        replay_round(r, cm.csr_round_kernel)
    with kernel_clock(("csr_round",)) as recs:
        for _ in range(reps):
            replay_round(r, cm.csr_round_kernel)
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b, _ in recs["csr_round"])


def chunk_checks(tag, solve, csr, cols, body, quats, k):
    """One chunk's solve under PyTorch's sync debug mode "error" (a device
    read raises) up to its final fetch, with a positive control, and its
    aten operations counted before the round kernel (its rounds through
    :func:`step_form_round`) and now."""
    check(sync_check_sees_a_read(), "the sync check does not see a device "
          "read")

    def one():
        return solve(body, quats, csr.xs, csr.ys, csr.zs, csr.starts,
                     csr.origin, cols, cell_size=csr.cell_size, k=k,
                     dims=csr.dims)

    one()  # set-up: the solver copies the robot's geometry to the card once
    solve.stats["syncs"] = 0
    with no_syncs():
        out = one()
    fetched = [t.cpu() for t in out]
    check(solve.stats["syncs"] == 0, f"{tag}: syncs {solve.stats['syncs']}")
    now, was = chunk_ops(one, False), chunk_ops(one, True)
    say(f"  {tag}: the solve of a chunk of {body.shape[0]} poses ran under "
        f"sync debug mode \"error\" (a device read raises; the control read "
        f"raised), stats syncs 0; aten operations a chunk, views included: "
        f"queue and schedule "
        f"{was.get('queue and schedule', 0)} before the round kernel, "
        f"{now.get('queue and schedule', 0)} now; oriented_tables "
        f"{now.get('oriented_tables', 0)}, _pose_columns "
        f"{now.get('_pose_columns', 0)}")
    return {"before": was, "now": now,
            "feasible": int(fetched[1].sum())}


def item_cells_work(centers, footholds, legtab, L):
    """What one launch of K5's cell driver needs: (cells, footholds, (cell,
    foothold) pairs inside the elongated box as a device tensor,
    orientations, legs, bytes).  The box test in plain tensor code, the
    kernel's expressions, over foothold chunks."""
    C, F, S = centers.shape[0], footholds.shape[0], legtab.shape[0]
    e = legtab[0, 13:16]
    n = torch.zeros((), dtype=torch.int64, device=DEV)
    for lo in range(0, F, 1 << 12):
        r = footholds[None, lo:lo + (1 << 12)] - centers[:, None]
        n += ((r > -e) & (r <= e)).all(dim=-1).sum()
    n_bytes = legtab.numel() * 4 + C * 13 + F * 12 + 3 * C
    return C, F, n, S, L, n_bytes


def item_cells_every_pair(calls):
    """K5 cell driver's summed time over launches ``calls``
    (:func:`item_cells_work` each) at the card's rates for every pair in the
    box on every orientation and leg: an over-count of what decides the
    flags (the driver skips settled work), so no bound."""
    if not calls:
        return 0.0
    inb = torch.stack([c[2] for c in calls]).tolist()
    return sum(bound_of(b, cmd.item_cells_flops(C * F, n * S, n * S * L))[0]
               for (C, F, _, S, L, b), n in zip(calls, inb))


def k3_bound(need, consts, fixed, shape):
    """K3's bound for one launch from ``cm.multileg_need``'s counts (12
    bytes a candidate read, ``fixed`` bytes of tables and words) and, as
    the count before it, from every leg on every candidate: ((ms, by,
    bytes ms, operations ms), every-leg ms)."""
    P, C = shape
    every = P * C * (cm.UNROTATE_FLOPS + sum(cm.leg_flops(c) for c in consts))
    return (bound_of(int(need[0]) * 12 + fixed,
                     cm.multileg_flops(need, consts)),
            bound_of(P * C * 12 + fixed, every)[0])


def k3_bounds(calls):
    """K3's summed bound over ``calls`` [(need, leg constants, fixed bytes,
    (P, C))], one synchronisation: (from what decides each output, from
    every leg on every candidate)."""
    if not calls:
        return 0.0, 0.0
    need = torch.stack([c[0] for c in calls]).tolist()
    lo = hi = 0.0
    for n, (_, consts, fixed, shape) in zip(need, calls):
        b, every = k3_bound(n, consts, fixed, shape)
        lo += b[0]
        hi += every
    return lo, hi


def cell_bound(words, C, CH, S, legtab_numel):
    """K6's bound for one launch from its [C, 10] words: 12 bytes a chunk
    element once plus queue, table and outputs, against 39 operations per
    element of an evaluated (chunk, orientation) and 860 per leg pipeline
    on an element inside the box.  (ms, by, bytes ms, operations ms)"""
    cnt = words[:, 3:].sum(dim=0, dtype=torch.int64).tolist()
    n_bytes = (cnt[3] * 12 + C * CH * (8 + S) + legtab_numel * 4
               + C * (16 + 4 * cmd.OUT_WORDS))
    n_ops = cnt[4] * cmd.HEAD_FLOPS + cnt[6] * cmd.LEG_FLOPS
    return bound_of(n_bytes, n_ops)


def neighbourhood(terrain3, xa, ya, pos, radius):
    """The lattice points within ``radius`` of ``pos`` in x and in y."""
    i0, i1 = np.searchsorted(xa, [pos[0] - radius, pos[0] + radius])
    j0, j1 = np.searchsorted(ya, [pos[1] - radius, pos[1] + radius])
    return terrain3[i0:i1, j0:j1].reshape(-1, 3)


def phase_map_scale():
    """The map solve at full width: 10.24 M footholds, hexapod m2, k = 6."""
    say(f"phase 6: map solve, moon_ground at {MAP_POINTS} points, hexapod "
        f"m2, k = 6, {MAP_POSES} poses in chunks of {MAP_CHUNK}")
    t0 = time.perf_counter()
    terrain = map_bench.terrain_at(MAP_POINTS)
    t_terrain = time.perf_counter() - t0
    check(terrain.shape == (MAP_POINTS, 3), f"terrain {terrain.shape}")
    say(f"  terrain generated on the host in {t_terrain:.1f} s")
    robot = make_robot(HEX_MOUNTS)
    L, k = 6, 6
    reach = cell_size_for(robot)
    cell = reach / 2
    cols_np = ball_columns(neighbor_offsets(cell, reach))
    cols = torch.from_numpy(cols_np).to(DEV)

    native_row = phase_native(terrain, cell)
    t0 = time.perf_counter()
    csr_host = build_csr_grid(terrain, cell, device=DEV)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = build_csr_grid_device(*map_bench.lattice_parts(terrain), cell,
                                device=DEV)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    check(csr.dims == csr_host.dims and csr.cell_size == csr_host.cell_size
          and torch.equal(csr.origin, csr_host.origin), "CSR geometry differs")
    check(torch.equal(csr.starts, csr_host.starts), "CSR starts differ")
    # element for element: both builds keep a cell's points in input order
    for f in ("xs", "ys", "zs"):
        check(torch.equal(getattr(csr, f), getattr(csr_host, f)),
              f"CSR {f}: the device build differs from the native host "
              "build (within-cell order or values)")
    say(f"  CSR build: host (native) {t_host:.2f} s, device {t_dev:.2f} s "
        f"(starts, xs, ys and zs equal element for element); dims "
        f"{csr.dims}, {csr.xs.numel() * 12 / 1e6:.0f} MB on the card, "
        f"{cols.shape[0]} ball columns")
    del csr_host

    body, quats = map_bench.sample_poses(terrain, MAP_POSES, 180.0, seed=0)
    body_d = torch.from_numpy(body).to(DEV)
    quats_d = torch.from_numpy(quats).to(DEV)
    solve, kw = map_bench.make_solver(robot, csr, cols_np, "csr-dma", "quorum")
    say(f"  window {kw['window']} zclip {kw['zclip']} rounds {kw['rounds']}")
    first = slice(0, MAP_CHUNK)
    map_bench.solve_chunks(solve, csr, cols, body_d[first], quats_d[first], k,
                           MAP_CHUNK)  # warm-up
    solve.stats["syncs"] = 0
    cm.multileg_kernel.launches = 0
    cm.csr_window_kernel.launches = 0
    cm.csr_round_kernel.launches = 0
    legs, quorum, overflow, ms, wall = map_bench.solve_chunks(
        solve, csr, cols, body_d, quats_d, k, MAP_CHUNK)
    launches = cm.csr_round_kernel.launches
    window_launches = cm.csr_window_kernel.launches
    n_chunks = MAP_POSES // MAP_CHUNK
    check(quorum.shape == (MAP_POSES,) and legs.shape == (MAP_POSES, L),
          "solver output shapes")
    check(launches > 0 and cm.multileg_kernel.launches == 0
          and window_launches == 0,
          "the map solve did not go through the CSR round kernel only")
    check(solve.stats["syncs"] == 0, "the csr-dma solve read the device back")
    say(f"  csr-dma solve: feasible {int(quorum.sum())} of {MAP_POSES}, "
        f"overflow {overflow}, wall {wall:.3f} s = {MAP_POSES / wall:.1f} "
        f"poses/s, device {ms:.1f} ms, host synchronisations per chunk "
        f"{solve.stats['syncs'] / n_chunks:.2f}, K4 launches {launches} "
        f"({launches / n_chunks:.1f} per chunk)")

    # one chunk: kernels against their plain versions, both decide modes,
    # and both against the exhaustive path on each pose's neighbourhood
    b1, q1 = body_d[first], quats_d[first]
    results = {}
    for decide in ("quorum", "legs"):
        for backend in ("auto", "torch"):
            sv, _ = map_bench.make_solver(robot, csr, cols_np, "csr-dma",
                                          decide, backend=backend)
            t0 = time.perf_counter()
            lg, qr, ov, _, _ = map_bench.solve_chunks(sv, csr, cols, b1, q1, k,
                                                      MAP_CHUNK)
            results[decide, backend] = (lg, qr, time.perf_counter() - t0)
        check(np.array_equal(results[decide, "auto"][1],
                             results[decide, "torch"][1]),
              f"decide={decide}: quorum differs from the plain versions'")
        check(np.array_equal(results[decide, "auto"][0],
                             results[decide, "torch"][0]),
              f"decide={decide}: legs differ from the plain versions'")
    check(np.array_equal(results["quorum", "auto"][1], quorum[first]),
          "the chunk's quorum differs from the full run's")
    sv, _ = map_bench.make_solver(robot, csr, cols_np, "csr", "legs")
    cm.multileg_kernel.launches = 0
    lg_csr, qr_csr, _, _, t_csr = map_bench.solve_chunks(sv, csr, cols, b1, q1,
                                                         k, MAP_CHUNK)
    launches_csr = cm.multileg_kernel.launches
    check(np.array_equal(lg_csr, results["legs", "auto"][0]),
          "csr and csr-dma legs differ")
    say(f"  chunk of {MAP_CHUNK}: kernel == plain versions in both decide "
        f"modes (legs and quorum); csr == csr-dma; seconds: csr-dma "
        f"{results['legs', 'auto'][2]:.2f} (legs) "
        f"{results['quorum', 'auto'][2]:.2f} (quorum), plain "
        f"{results['legs', 'torch'][2]:.2f} / "
        f"{results['quorum', 'torch'][2]:.2f}, csr {t_csr:.2f} with "
        f"{launches_csr} K3 launches")

    side = map_bench.terrain_side(MAP_POINTS)
    terrain3 = torch.from_numpy(terrain).to(DEV).reshape(side, side, 3)
    _, xa, ya = map_bench.lattice_parts(terrain)
    t0 = time.perf_counter()
    want = np.zeros((MAP_CHUNK, L), bool)
    n_pts = 0
    for p in range(MAP_CHUNK):
        pts = neighbourhood(terrain3, xa, ya, body[p], reach + 1.0)
        n_pts += pts.shape[0]
        want[p] = reachable_legs(b1[p:p + 1], q1[p:p + 1], pts,
                                 robot).cpu().numpy()[0]
    t_ex = time.perf_counter() - t0
    got_l, got_q = results["legs", "auto"][0], results["quorum", "auto"][1]
    check(np.array_equal(got_l, want),
          f"legs differ from the exhaustive path on "
          f"{int((got_l != want).sum())} bits")
    check(np.array_equal(got_q, want.sum(1) >= k),
          "quorum differs from the exhaustive path")
    check(not (results["quorum", "auto"][0] & ~want).any(),
          "decide=quorum reported a leg the exhaustive path does not")
    say(f"  exhaustive path on each pose's neighbourhood "
        f"({n_pts // MAP_CHUNK} points a pose): legs and quorum equal "
        f"({int(want.sum())} leg bits, {int((want.sum(1) >= k).sum())} "
        f"feasible), {t_ex:.1f} s")
    del terrain3

    # the 45-orientation sweep on one chunk: packed loop == serial loop
    def solve_fn(b, q):
        return solve(torch.from_numpy(np.ascontiguousarray(b)).to(DEV),
                     torch.from_numpy(np.ascontiguousarray(q)).to(DEV),
                     csr.xs, csr.ys, csr.zs, csr.starts, csr.origin, cols,
                     cell_size=csr.cell_size, k=k, dims=csr.dims)[1]

    ors = sweep_orientations()
    t0 = time.perf_counter()
    f_packed, r_packed = multirot_positionable_packed(solve_fn, body[first], ors)
    t_packed = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_serial, r_serial = multirot_positionable(solve_fn, body[first], ors)
    t_serial = time.perf_counter() - t0
    check(np.array_equal(f_packed, f_serial),
          "packed and serial orientation sweeps differ")
    say(f"  45-orientation sweep on {MAP_CHUNK} poses: feasible "
        f"{int(f_packed.sum())}; packed {len(r_packed)} solver rounds "
        f"{t_packed:.2f} s = {MAP_CHUNK / t_packed:.1f} poses/s, serial "
        f"{len(r_serial)} rounds {t_serial:.2f} s; equal")

    # the kernel's share of the wall: the same solve once more with CUDA
    # events around every launch; the rest is queue building (eager tensor
    # code and its launches)
    with kernel_clock(("csr_round",)) as recs:
        _, quorum2, _, _, wall2 = map_bench.solve_chunks(
            solve, csr, cols, body_d, quats_d, k, MAP_CHUNK)
    report_clock("the 10.24 M map", recs)
    k4_ms = PATH_TIMES["csr_round", "the 10.24 M map"]["ms"]
    check(np.array_equal(quorum2, quorum), "the instrumented solve differs")
    check(len(recs["csr_round"]) == launches,
          "the instrumented solve launched another number of kernels")
    queue_share = 1.0 - k4_ms / (wall2 * 1e3)
    say(f"  instrumented solve: wall {wall2:.3f} s, the {launches} K4 "
        f"launches take {k4_ms:.1f} ms of it; queue building and the rest "
        f"of the eager code {queue_share:.3f} of the wall")
    # K4's bound on this path (what each round needs: the steps serving
    # legs never found; every step serving a leg missing at launch as the
    # other end) on a third run, since the count reads the device between
    # the launches
    k4_calls = []
    with intercepted(cm, "csr_round_kernel", counting_rounds(k4_calls)):
        _, quorum3, _, _, _ = map_bench.solve_chunks(
            solve, csr, cols, body_d, quats_d, k, MAP_CHUNK)
    check(np.array_equal(quorum3, quorum) and len(k4_calls) == launches,
          "the counted solve differs")
    lo, hi = round_bounds(k4_calls)
    PATH_TIMES["csr_round", "the 10.24 M map"].update(
        bound_ms=lo, bound_ms_every_missing_leg=hi)
    say(f"    K4's bound on the 10.24 M map: the steps serving legs never "
        f"found {lo:.3f} ms (share {lo / k4_ms:.3f} of {k4_ms:.1f} ms); "
        f"every step serving a leg missing at launch {hi:.3f} ms")
    # every round of the first chunk, both decide modes and z-clip settings:
    # round kernel == plain version; the default run's rounds in turns with
    # the step form and its eager queue; the chunk under sync debug mode
    caught, round_bad = round_gates("10.24 M chunk", robot, csr, cols, b1, q1,
                                    k, kw["window"], kw["rounds"],
                                    kw["zclip"])
    turns = round_turns("10.24 M chunk", caught)
    checks = chunk_checks("10.24 M chunk", solve, csr, cols, b1, q1, k)
    check(checks["feasible"] == int(quorum[first].sum()),
          "the chunk's solve differs from the full run's")
    return {"poses_per_s": MAP_POSES / wall, "launches": launches,
            "terrain": terrain, "native": native_row,
            "window_launches": window_launches, "round_bad": round_bad,
            "queue_share": queue_share, "wall_s": wall2, "rounds": caught,
            "csr": csr, "robot": robot, "window": kw["window"],
            "turns": turns, "ops": checks}


def phase_native(terrain, cell):
    """The native host runtime at 10.24 M points (phase 6): the CSR sort
    and the bucket table equal their numpy versions element for element,
    and two native runs equal each other; host seconds of each."""
    origin = terrain.min(axis=0)
    dims = tuple(int(d) + 1 for d in
                 np.floor((terrain - origin) / cell).astype(np.int64).max(0))
    native.library()  # built before the clock starts (set-up)
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    a = timed("csr native", lambda: native.csr_grid(terrain, origin, cell,
                                                    dims))
    b = timed("csr native", lambda: native.csr_grid(terrain, origin, cell,
                                                    dims))
    c = timed("csr numpy", lambda: csr_sort_numpy(terrain, origin, cell, dims))
    for name, x, y, z in zip(("xs", "ys", "zs", "starts"), a, b, c):
        check(np.array_equal(x, y), f"native csr_grid {name}: two runs differ")
        check(np.array_equal(x, z), f"native csr_grid {name} differs from the "
              "numpy sort")
    del a, b, c
    a = timed("bucket native", lambda: native.bucket_grid(
        terrain, origin, cell, dims, 1e9))
    b = timed("bucket native", lambda: native.bucket_grid(
        terrain, origin, cell, dims, 1e9))
    c = timed("bucket numpy", lambda: bucket_grid_numpy(
        terrain, origin, cell, dims, np.float32(1e9)))
    for name, x, y, z in zip(("table", "counts"), a, b, c):
        check(np.array_equal(x, y), f"native bucket_grid {name}: two runs "
              "differ")
        check(np.array_equal(x, z), f"native bucket_grid {name} differs from "
              "the numpy build")
    cap = a[0].shape[1]
    del a, b, c
    row = {"threads": native.num_threads(), "points": int(terrain.shape[0]),
           "dims": dims, "cap": int(cap),
           **{k.replace(" ", "_") + "_s": v for k, v in times.items()}}
    say(f"  native host runtime, {native.num_threads()} host threads, "
        f"{terrain.shape[0]} points, dims {dims}: CSR sort "
        + ", ".join(f"{t:.3f}" for t in times["csr native"])
        + f" s (numpy {times['csr numpy'][0]:.3f} s), bucket table cap {cap} "
        + ", ".join(f"{t:.3f}" for t in times["bucket native"])
        + f" s (numpy {times['bucket numpy'][0]:.3f} s); each equal to the "
        "numpy build element for element, and run to run")
    return row


def k3_call(lib, tab, g, bits0, params):
    """One launch of ``lib``'s K3 on ``tab``, ``g``, its words seeded with
    ``bits0`` (the found-legs input)."""
    bits = bits0.clone()
    err = lib.legmov_multileg(tab.data_ptr(), g[0].data_ptr(), g[1].data_ptr(),
                              g[2].data_ptr(), g[0].shape[0], g[0].shape[1],
                              bits.data_ptr(), ctypes.byref(params),
                              cm._stream())
    check(err == 0, f"legmov_multileg: CUDA error {err}")
    return bits


def k4_call(lib, tab, legs_in, st, ln, mk, xs, ys, zs, params):
    """One launch of ``lib``'s K4."""
    out = torch.empty(legs_in.shape, dtype=torch.bool, device=DEV)
    err = lib.legmov_csr_window(
        st.data_ptr(), ln.data_ptr(), mk.data_ptr(), st.shape[0], st.shape[1],
        tab.data_ptr(), legs_in.data_ptr(), xs.data_ptr(), ys.data_ptr(),
        zs.data_ptr(), out.data_ptr(), ctypes.byref(params), cm._stream())
    check(err == 0, f"legmov_csr_window: CUDA error {err}")
    return out


def phase_multileg_kernels(scale, round_bad, others=()):
    """K3 and K4 alone, against their plain versions, and their times; then
    against the builds of the sources ``others`` (earlier
    ``multileg_kernels.cu`` files), in turns."""
    robot, csr = scale["robot"], scale["csr"]
    L = 6
    k3 = cm.make_multileg_kernel(robot)
    k4 = cm.make_csr_window_kernel(robot)
    per_leg = sum(cm.leg_flops(c) for c in k3.consts)
    say(f"phase 7: hexapod m2; fp32 operations per candidate: "
        f"{cm.UNROTATE_FLOPS} + {per_leg} for the six legs")
    rng = np.random.default_rng(5)

    def poses(P):
        body = (rng.uniform(-300, 300, (P, 3)) * [1, 1, 0.3]).astype(np.float32)
        rpy = rng.uniform(-0.25, 0.25, (P, 3)).astype(np.float32)
        q = quat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]).to(DEV)
        return cm.oriented_tables(torch.from_numpy(body).to(DEV), q, robot)

    def cands(P, C, special=False, spread=600):
        c = rng.uniform(-spread, spread, (P, C, 3)).astype(np.float32)
        if special and P >= 4 and C >= 8:
            c[0, :8] = np.nan
            c[1, :8] = np.inf
            c[2] = 1e9
            c[3, ::2] = -np.inf
        return [torch.from_numpy(np.ascontiguousarray(c[..., i])).to(DEV)
                for i in range(3)]

    def none(P):
        return torch.zeros((P, L), dtype=torch.bool, device=DEV)

    bad3 = 0
    for P in (0, 1, 7, 9):
        for C in (0, 128, 1000, 1100, 2085):  # C off the tile of 4 x 256
            tab, g = poses(P), cands(P, C, special=True)
            found = torch.from_numpy(rng.random((P, L)) < 0.3).to(DEV)
            for legs_in in (none(P), found):
                got = k3(tab, *g, legs_in)
                check(got.shape == (P, L) and got.dtype == torch.bool,
                      f"K3 P={P} C={C} shape")
                bad3 += int((got != k3.plain(tab, *g, legs_in)).sum())
    # rows whose legs are all found on their first candidates: each pose's
    # first hit of each leg moved to the front
    tab, g = poses(64), cands(64, 4096)
    s_ = lambda i: tab[:, i:i + 1]
    v = cm._unrotate_plain(s_, *g)
    hits = torch.stack([cm._one_leg_plain(s_, l, c, *v)
                        for l, c in enumerate(k3.consts)], -1).cpu().numpy()
    order = []
    for p in range(64):
        first = [int(np.flatnonzero(hits[p, :, l])[0])
                 for l in range(L) if hits[p, :, l].any()]
        first = list(dict.fromkeys(first))
        taken = set(first)
        order.append(first + [c for c in range(4096) if c not in taken])
    idx = torch.tensor(order, device=DEV)
    g = [torch.gather(x, 1, idx).contiguous() for x in g]
    every = torch.ones((64, L), dtype=torch.bool, device=DEV)
    for legs_in in (none(64), every):
        bad3 += int((k3(tab, *g, legs_in) != k3.plain(tab, *g, legs_in)).sum())
    # [2048, 8192] twice: candidates within 600 mm of the poses (most legs
    # found in the first tiles) and within 3000 mm (most candidates out of
    # reach: the walk goes on far into each row)
    P3, C3 = 2048, 8192
    tab = poses(P3)
    zero = none(P3)
    p3 = cm.multileg_params(k3.consts)
    words = torch.zeros(P3, dtype=torch.int32, device=DEV)
    k3_in, rows3 = {}, {}
    for spread in (600, 3000):
        g = cands(P3, C3, special=True, spread=spread)
        got, want = k3(tab, *g, zero), k3.plain(tab, *g, zero)
        n_bad = int((got != want).sum())
        bad3 += n_bad
        # the kernel through its C launcher (the wrapper adds the found-legs
        # words in and the bits out, some small kernels a call)
        ms3 = time_cuda(lambda: k3_call(cm._library(), tab, g, words, p3))
        plain3 = time_cuda(lambda: k3.plain(tab, *g, zero), warmup=1, reps=3)
        need = cm.multileg_need(tab, *g, k3.consts, zero).tolist()
        (b3, by3, t_b, t_o), b3_hi = k3_bound(
            need, k3.consts, tab.numel() * 4 + P3 * 8, (P3, C3))
        say(f"  K3 [{P3}, {C3}], candidates within {spread} mm, NaN/inf/1e9 "
            f"rows: mismatches {n_bad}; {int(want.sum())} of {want.numel()} "
            f"bits set; a walk in candidate order needs {need[0]} reads, "
            f"{need[1]} un-rotations and {need[2:]} leg evaluations (of "
            f"{P3 * C3} each)")
        say(f"  K3 {ms3:.4f} ms  plain {plain3:.2f} ms  bound {b3:.4f} ms "
            f"({by3}; bytes {t_b:.4f}, operations {t_o:.4f}: what decides "
            f"the output)  share of bound {b3 / ms3:.3f}; every leg on every "
            f"candidate {b3_hi:.4f} ms ({b3_hi / ms3:.3f})")
        k3_in[spread] = (tab, g)
        # booleans: the largest |difference| is 1 if any bit differs
        rows3[spread] = {"n": P3 * C3, "ms": ms3, "plain_ms": plain3,
                         "bound_ms": b3, "bound_by": by3,
                         "bound_ms_every_leg": b3_hi}
    say(f"  K3 ragged P in (0, 1, 7, 9) x C in (0, 128, 1000, 1100, 2085) "
        f"with and without found legs in; 64 rows whose legs are found on "
        f"their first candidates, with no legs and every leg in; the two "
        f"[{P3}, {C3}] launches: mismatches {bad3}")
    check(bad3 == 0, f"K3: {bad3} mismatching bits against the plain version")
    row3 = dict(rows3[600], max_abs_err=float(min(bad3, 1)),
                wide_spread=rows3[3000])

    # K4: synthetic queues over an array with NaN/inf/1e9 rows
    F = 200_000
    pts = rng.uniform(-600, 600, (F, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.2 - 130
    pts[100:108] = np.nan
    pts[200:208] = np.inf
    pts[300:400] = 1e9
    fx, fy, fz = (torch.from_numpy(np.ascontiguousarray(pts[:, i])).to(DEV)
                  for i in range(3))
    bad4 = 0
    for A, S, W in ((0, 4, 128), (1, 1, 128), (7, 33, 300), (9, 5, 1000),
                    (64, 16, 1024)):
        tab = poses(A)
        lens = rng.integers(0, W + 1, (A, S)).astype(np.int32)
        starts = rng.integers(0, 500, (A, S)).astype(np.int32)
        masks = rng.integers(0, 1 << L, (A, S)).astype(np.int32)
        masks[rng.random((A, S)) < 0.2] = 0
        legs_in = torch.from_numpy(rng.random((A, L)) < 0.2).to(DEV)
        st, ln, mk = (torch.from_numpy(a).to(DEV) for a in (starts, lens, masks))
        got = k4(tab, legs_in, st, ln, mk, fx, fy, fz)
        check(got.shape == (A, L) and got.dtype == torch.bool, f"K4 A={A} shape")
        bad4 += int((got != k4.plain(tab, legs_in, st, ln, mk, fx, fy, fz)).sum())
        dead = k4(tab, legs_in, st, ln, torch.zeros_like(mk), fx, fy, fz)
        bad4 += int((dead != legs_in).sum())
    # K4's step form on the first round of a real chunk of phase 6, its
    # steps from the plain queue
    r0 = scale["rounds"][0]
    sel, q0 = captured_queue(r0)
    tab, legs_in = sel(r0["args"][0]), sel(r0["state"][0])
    st, ln, mk = cm.steps_for(q0.cs, q0.cl, q0.cum, q0.legbits, 0, q0.q_done,
                              r0["kw"]["window"])
    A, S = st.shape
    work = {}
    want = k4.plain(tab, legs_in, st, ln, mk, csr.xs, csr.ys, csr.zs, work=work)
    got = k4(tab, legs_in, st, ln, mk, csr.xs, csr.ys, csr.zs)
    bad4 += int((got != want).sum())
    say(f"  K4 step form on a real round [{A}, {S}] window {scale['window']} "
        f"({int((mk != 0).sum())} live steps, {work['points']} candidates, "
        f"{work['leg_points']} candidate-leg pairs needed), synthetic queues "
        f"with NaN/inf/1e9 rows, ragged A, all-zero masks: mismatches {bad4}; "
        f"{int(want.sum())} of {want.numel()} bits set")
    check(bad4 == 0, f"K4: {bad4} mismatching bits against the plain version")
    ms4 = time_cuda(lambda: k4(tab, legs_in, st, ln, mk, csr.xs, csr.ys, csr.zs))
    plain4 = time_cuda(
        lambda: k4.plain(tab, legs_in, st, ln, mk, csr.xs, csr.ys, csr.zs),
        warmup=1, reps=3)
    bytes4 = (work["points"] * 12 + A * S * 12 + tab.numel() * 4 + 2 * A * L)
    ops4 = (work["points"] * cm.UNROTATE_FLOPS
            + work["leg_points"] * cm.leg_flops(k4.consts[0]))
    b4, by4, t_b, t_o = bound_of(bytes4, ops4)
    say(f"  K4 step form {ms4:.4f} ms  plain {plain4:.2f} ms  bound {b4:.4f} "
        f"ms ({by4}; bytes {t_b:.4f}, operations {t_o:.4f})  share of bound "
        f"{b4 / ms4:.3f}")
    row4 = {"max_abs_err": float(min(bad4, 1)), "n": work["points"], "ms": ms4,
            "plain_ms": plain4, "bound_ms": b4, "bound_by": by4}
    # the round kernel on every round of that chunk (the first is the step
    # form's round): its time beside what the round needs, and the plain
    # version's time on the first
    rows_r = []
    for i, r in enumerate(scale["rounds"]):
        ms_r = round_kernel_ms(r)
        legs_out = replay_round(r, cm.csr_round_kernel)[0]
        need = round_need(r, legs_out).tolist()
        tab_r, rel_r, cols_r = r["args"]
        (b_r, by_r, tb_r, to_r), hi_r = round_bound(
            need, round_rows(r), rel_r.shape[1], rel_r.shape[2],
            len(cols_r) == 5, r["kw"].get("idx") is not None, r["consts"])
        rows_r.append({"round": i, "poses": round_rows(r),
                       "quota": r["kw"]["quota"], "candidates": need[2],
                       "ms": ms_r, "bound_ms": b_r, "bound_by": by_r,
                       "bound_ms_every_missing_leg": hi_r})
        say(f"  K4 round kernel, round {i} of the chunk ({round_rows(r)} "
            f"poses, quota {r['kw']['quota'] or 'none'}): {ms_r:.4f} ms; "
            f"needs {need[2]} candidates and {need[3]} candidate-leg "
            f"evaluations (serving legs never found; {need[0]} and {need[1]} "
            f"serving legs missing at launch), {need[4]} wanted columns: "
            f"bound {b_r:.4f} ms ({by_r}; bytes {tb_r:.4f}, operations "
            f"{to_r:.4f}), share {b_r / ms_r:.3f}; {hi_r:.4f} ms at the "
            f"other end")
    plain_r = time_cuda(lambda: replay_round(r0, cm.csr_round_plain),
                        warmup=1, reps=3)
    head = rows_r[0]
    # booleans: the largest |difference| is 1 if any bit differed on the
    # rounds held against the plain version in phases 5 and 6
    row_round = {"max_abs_err": float(min(round_bad, 1)),
                 "n": head["candidates"],
                 "ms": head["ms"], "plain_ms": plain_r,
                 "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                 "step_form_ms": ms4, "rounds": rows_r}
    say(f"  K4 round kernel on the step form's round: {head['ms']:.4f} ms "
        f"against the step form's {ms4:.4f} ms (which leaves the queue to "
        f"eager code); plain version {plain_r:.2f} ms")

    # the same launches of other builds, each timed in turns with this
    # build's (other, this, this, other), all through the C launchers
    k4_args = (tab, legs_in, st, ln, mk, csr.xs, csr.ys, csr.zs, p3)
    for label, lib in alternatives(others, bind_multileg_library):
        here = cm._library()
        say(f"phase 7: {label} against this build")
        cases = [(f"K3 [{P3}, {C3}] within {sp} mm",
                  lambda a=k3_in[sp]: k3_call(lib, *a, words, p3),
                  lambda a=k3_in[sp]: k3_call(here, *a, words, p3))
                 for sp in (600, 3000)]
        cases.append((f"K4 real round [{A}, {S}]",
                      lambda: k4_call(lib, *k4_args),
                      lambda: k4_call(here, *k4_args)))
        for kid, other, this in cases:
            check(torch.equal(other(), this()),
                  f"{label}: {kid} gives other words than this build's")
            t = [time_cuda(other, warmup=1), time_cuda(this, warmup=1),
                 time_cuda(this, warmup=1), time_cuda(other, warmup=1)]
            say(f"  {kid}: equal words; ms in turns: other {t[0]:.4f}, this "
                f"{t[1]:.4f}, this {t[2]:.4f}, other {t[3]:.4f}; other / "
                f"this {(t[0] + t[3]) / (t[1] + t[2]):.3f}")
        if hasattr(lib, "legmov_csr_round"):
            round_build_turns("phase 6's chunk", scale["rounds"], label, lib)
    return row3, row4, row_round


def round_build_turns(tag, rounds_, label, lib):
    """The round kernel of ``lib`` (another build) and of this build on
    every captured round of a chunk, in turns (other, this, this, other),
    summed ms of each pass (each build's kernel loaded by a launch
    first)."""
    t, outs = [], []
    for use in (lib, None):
        with multileg_library(use):
            replay_round(rounds_[0], cm.csr_round_kernel)
    for use in (lib, None, None, lib):
        with multileg_library(use), kernel_clock(("csr_round",)) as recs:
            outs.append([replay_round(r, cm.csr_round_kernel)
                         for r in rounds_])
        torch.cuda.synchronize()
        t.append(sum(a.elapsed_time(b) for a, b, _ in recs["csr_round"]))
    check(all(torch.equal(a, b) for x, y in zip(outs[0], outs[1])
              for a, b in zip(x, y)),
          f"{label}: the round kernel gives other rounds")
    say(f"  K4 round kernel of {label}, every round of {tag}: equal; summed "
        f"ms in turns: other {t[0]:.4f}, this {t[1]:.4f}, this {t[2]:.4f}, "
        f"other {t[3]:.4f}; other / this {(t[0] + t[3]) / (t[1] + t[2]):.3f}")


# ---------------------------------------------------------------------------
# the hierarchical solve: the CLI, its gates, the item and cell kernels alone
# ---------------------------------------------------------------------------

# terminal cells / valid / edge of the depth-7 moon solve (default prepare,
# m2 quadruped, k = 4, box 5000, rotation below 50 mm, 27 orientations), as
# the JAX package's solver counts them for the same terrain
SOLVE_COUNTS = {"per-leg": (348657, 334312, 327134),
                "shared": (784092, 54014, 750991)}
DEEP = ("--box", "5000", "--depth", "8", "--min-box", "20")
QUARTER = ("--box", "1250", "--depth", "6", "--min-box", "20")
SOLVE_COUNTERS = {
    "distance": (ck, "distance_kernel"),
    "distance_cells": (ck, "distance_cells_kernel"),
    "item_cells": (cmd, "item_cells_kernel"),
    "cell_quat_major": (cce, "cell_eval_quat_major"),
    "cell_shared": (cce, "cell_eval_shared"),
    "cell_cm_perleg": (cce, "cell_eval_cm_perleg"),
}
CELL_WRAPPERS = {"cell_eval_quat_major": "cell_quat_major",
                 "cell_eval_shared": "cell_shared",
                 "cell_eval_cm_perleg": "cell_cm_perleg"}
GATE_CELLS = 256     # cells of a real batch held against the plain versions
HEX_GATE_CELLS = 96  # the same on the hexapod's batch
EAGER_CELLS = 64     # of those, held against the eager evaluator


def solve_launches():
    return {n: getattr(m, f).launches for n, (m, f) in SOLVE_COUNTERS.items()}


def cells_bound(calls):
    """The K2 cell kernel's summed bound over launches ``calls`` [(C, F,
    audit, leg flops)]: the pairs each cell prefiltered and those it sent
    through the legs (the kernel's audit output of this run), against the
    bytes of the cells, the footholds and the flags."""
    if not calls:
        return 0.0
    sums = torch.stack([a.sum(dim=0) for _, _, a, _ in calls]).tolist()
    return sum(bound_of(C * 16 + F * 12,
                        ck.cells_flops(tested, run, flops))[0]
               for (C, F, _, flops), (tested, run) in zip(calls, sums))


def run_solve(data, *extra, capture=None, show_levels=False,
              sync_check=False, cells=False):
    """``cli solve --dir data --leg m2 --profile *extra`` with the launch
    counts set to 0 just before and read just after.  Returns (JSON line,
    CellRecord, launches, captured): ``capture`` names a cell-kernel wrapper
    of ops/csr_cell_eval.py whose first call's arguments are kept, with
    those of the queue build that fed it; ``cells`` keeps, per identity
    level, the arguments of the K2 cell-kernel launch with the most (cell,
    foothold) pairs; the solve's ``stats`` are kept too.  ``sync_check``
    runs the two calls of an identity level's dispatch that touch the
    device (``hier_solver._upload`` and the cell-kernel wrapper) under
    PyTorch's sync debug mode "error", so that a device read there raises,
    and counts the synchronising operations of the whole solve into
    ``kept["syncs"]``."""
    for m, f in SOLVE_COUNTERS.values():
        getattr(m, f).launches = 0
    kept = {"cells": {}}
    cell_calls = []
    k5_calls = []

    def keep_k5(real, centers, pv, footholds, legtab, consts, k, shared,
                **kw):
        out = real(centers, pv, footholds, legtab, consts, k, shared, **kw)
        if out.is_cuda and centers.shape[0]:
            k5_calls.append(item_cells_work(centers, footholds, legtab,
                                            len(consts)))
            kept.setdefault("dense_all", []).append(
                (centers, pv, footholds, legtab, consts, k, shared))
            w = centers.shape[0] * footholds.shape[0]
            if w > kept.get("dense", {}).get("pairs", -1):
                kept["dense"] = dict(pairs=w, args=(
                    centers, pv, footholds, legtab, consts, k, shared))
        return out

    def keep_record(real, *a, **kw):
        kept["record"] = real(*a, **kw)
        kept["stats"] = kw.get("stats")
        return kept["record"]

    def keep_cells(real, centers, pv, footholds, legs, level, k, shared,
                   **kw):
        # the kernel's audit output, for the bound of this run's launches
        audit = torch.empty((centers.shape[0], 2), dtype=torch.int64,
                            device=centers.device)
        with no_syncs(sync_check):
            res = real(centers, pv, footholds, legs, level, k, shared,
                       audit=audit, **kw)
        cell_calls.append((centers.shape[0], footholds.shape[0], audit,
                           legs.leg_flops))
        w = centers.shape[0] * footholds.shape[0]
        if cells and (level not in kept["cells"]
                      or w > kept["cells"][level]["pairs"]):
            kept["cells"][level] = dict(
                pairs=w, centers=centers, pv=pv, footholds=footholds,
                legs=legs, level=level, k=k, shared=shared)
        return res

    def keep_queue(real, *a, **kw):
        kept.setdefault("queue_args", (a, kw))
        return real(*a, **kw)

    def keep_call(real, *a, **kw):
        kept.setdefault("kernel_args", a)
        kept.setdefault("kernel_calls", []).append(a)
        return real(*a, **kw)

    words = {name: [] for name in CELL_WRAPPERS}

    def keep_words(name):
        def hook(real, queue, cellinfo, legtab, *a, **kw):
            res = real(queue, cellinfo, legtab, *a, **kw)
            words[name].append((res, *queue.role.shape, legtab.numel()))
            return res
        return hook

    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(intercepted(hs, "solve_positionability",
                                        keep_record))
        stack.enter_context(intercepted(ck, "distance_cells_kernel",
                                        keep_cells))
        stack.enter_context(intercepted(cmd, "item_cells_kernel", keep_k5))
        if sync_check:
            stack.enter_context(intercepted(
                hs, "_upload", lambda real, *a: no_syncs_call(real, *a)))
        if capture:
            stack.enter_context(intercepted(cce, "build_cell_queue",
                                            keep_queue))
            stack.enter_context(intercepted(cce, capture, keep_call))
        for name in CELL_WRAPPERS:
            stack.enter_context(intercepted(cce, name, keep_words(name)))
        recs = stack.enter_context(kernel_clock(
            ("distance", "distance_cells", "item_cells",
             *CELL_WRAPPERS.values())))
        stack.enter_context(contextlib.redirect_stdout(buf))
        if sync_check:
            kept["syncs"] = stack.enter_context(counting_syncs())
        cli.main(["solve", "--dir", data, "--leg", "m2", "--profile", *extra])
    torch.cuda.synchronize()
    launches = solve_launches()
    lines = buf.getvalue().strip().splitlines()
    line = json.loads(lines[-1])
    rec = kept["record"]
    reach = np.load(os.path.join(data, "robot_reach.npy"))
    pts = lio.load_points(os.path.join(data, "out_valid_cells_"))
    check(reach.shape == (line["valid"], 3) and pts.shape == reach.shape
          and np.isfinite(reach).all(),
          "robot_reach.npy / out_valid_cells_*.bin do not hold the valid cells")
    check(line["cells"] == rec.centers.shape[0]
          and line["valid"] == int(rec.valid.sum())
          and line["edge"] == int(rec.edge.sum()), "JSON line and record differ")
    for name, n in launches.items():
        check(line[name + "_launches"] == n, f"{name} launches: line and wrapper")
    say(f"  cli solve {' '.join(extra)}: cells {line['cells']} valid "
        f"{line['valid']} edge {line['edge']} max depth {line['max_depth']} "
        f"seconds {line['seconds']} host syncs {line['host_syncs']} launches "
        f"K2 {launches['distance']} K2 cell kernel "
        f"{launches['distance_cells']} K5 cell driver "
        f"{launches['item_cells']} K6a "
        f"{launches['cell_quat_major']} K6b {launches['cell_shared']} K6c "
        f"{launches['cell_cm_perleg']}")
    if show_levels:
        for l in lines:
            if l.startswith("[hier] depth="):
                say("    " + l)

    def cell_bounds(name):
        return lambda rec: sum(cell_bound(*w)[0] for w in words[name]
                               if w[1] > 0 and w[2] > 0)

    path = f"cli solve {' '.join(extra)}"
    report_clock(path, recs,
                 {"distance_cells": lambda rec: cells_bound(cell_calls),
                  **{key: cell_bounds(name)
                     for name, key in CELL_WRAPPERS.items()}})
    if k5_calls:
        # what decides the flags is counted on phase 10's batches only: on
        # every batch of a path the plain walk would take a minute
        every = item_cells_every_pair(k5_calls)
        PATH_TIMES["item_cells", path]["ms_every_pair"] = every
        say(f"    K5 cell driver: every pair in the box on every orientation "
            f"and leg would take {every:.3f} ms at the card's rates (an "
            f"over-count, no bound)")
    return line, rec, launches, kept


def same_record(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("centers", "halves", "valid", "edge", "depth"))


SYNC_MESSAGE = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def counting_syncs():
    """Record the synchronising CUDA operations of the block with PyTorch's
    sync debug mode "warn"; yields a list that holds them after the
    block."""
    found: list = []
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            found.extend(w for w in caught if SYNC_MESSAGE in str(w.message))


@contextlib.contextmanager
def no_syncs(on=True):
    """When ``on``, a synchronising CUDA operation in the block raises
    (PyTorch's sync debug mode "error")."""
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def no_syncs_call(fn, *a, **kw):
    with no_syncs():
        return fn(*a, **kw)


def sync_sites(found):
    """Where the recorded synchronising operations were called from, as
    ``file:line xN``, most frequent first."""
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in found)
    return ", ".join(f"{k} x{v}" for k, v in sites.most_common())


def syncs_are_host_syncs(tag, line, kept):
    """The solve's ``host_syncs`` (its JSON line) is what PyTorch's sync
    debug mode counted over the whole ``cli solve``: one packed fetch a
    level and nothing else."""
    n = len(kept["syncs"])
    check(n == line["host_syncs"] == line["max_depth"] + 1,
          f"{tag}: sync debug mode counted {n} synchronising operations, "
          f"host_syncs {line['host_syncs']}, {line['max_depth'] + 1} levels; "
          f"called from {sync_sites(kept['syncs'])}")


def sync_check_sees_a_read():
    """The sync counter counts a plain device read and the strict mode
    raises on one (so that their zeros mean something)."""
    with counting_syncs() as found:
        torch.zeros(1, device=DEV).cpu()
    try:
        with no_syncs():
            torch.zeros(1, device=DEV).cpu()
    except RuntimeError:
        return len(found) >= 1
    return False


def identity_levels(tag, line, la, kept):
    """The deep solve's identity levels: one K2 cell-kernel launch a batch
    and no point-kernel launch, no device read in their dispatch (the solve
    ran with ``sync_check``, under which one raises), and their
    ``dispatch_s``; the synchronising operations of the whole solve."""
    levels = kept["stats"]["per_level"]
    ident = [lv for lv in levels if not lv["rot"]]
    batches = sum(lv["batches"] for lv in ident)
    check(la["distance_cells"] == batches and la["distance"] == 0,
          f"{tag}: {la['distance_cells']} cell-kernel and {la['distance']} "
          f"point-kernel launches for {batches} identity-level batches")
    say(f"    identity levels {ident[0]['depth']}-{ident[-1]['depth']}: "
        f"{batches} batches, {la['distance_cells']} cell-kernel launches "
        f"(one a batch), 0 device reads in their dispatch; dispatch_s "
        + " / ".join(f"{lv['dispatch_s']:.4f}" for lv in ident)
        + f" (sum {sum(lv['dispatch_s'] for lv in ident):.3f} s, fetch "
        f"{sum(lv['fetch_s'] for lv in ident):.3f} s); the whole solve: "
        f"{len(kept['syncs'])} synchronising CUDA operations (sync debug "
        f"mode), host_syncs {line['host_syncs']}: the levels' fetches "
        f"({len(levels)} levels, {levels[-1]['batches']} batches at the "
        "deepest)")
    return [dict(c, depth=i) for i, c in enumerate(kept["cells"].values())]


def phase_cli_solve(data, quick):
    """``cli solve`` on the phase-2 directory (the default ``prepare``: the
    65,536-point moon terrain), m2 legs."""
    say("phase 8: cli solve on the prepared directory (m2 legs, 27 "
        "orientations below 50 mm)")
    check(sync_check_sees_a_read(), "the sync check missed a device read")
    deep = QUARTER if quick else DEEP
    out = {"launches": {}, "seconds": {}, "lines": {}, "cells": {}}
    for mode, wrapper in (("per-leg", "cell_eval_quat_major"),
                          ("shared", "cell_eval_shared")):
        line, rec, la, kept = run_solve(
            data, "--legs", "4", "--k", "4", *deep, "--mode", mode,
            capture=wrapper, show_levels=True, sync_check=True, cells=True)
        want = SOLVE_COUNTS[mode]
        got = (line["cells"], line["valid"], line["edge"])
        if not quick:
            check(line["max_depth"] == 7, f"{mode}: depth 7 not reached")
            check(got == want, f"{mode}: cells/valid/edge {got}, the JAX "
                  f"solver counts {want}")
        key = "cell_quat_major" if mode == "per-leg" else "cell_shared"
        other = "cell_shared" if mode == "per-leg" else "cell_quat_major"
        check(la["distance_cells"] > 0 and la[key] > 0 and la[other] == 0
              and la["cell_cm_perleg"] == 0 and la["item_cells"] == 0,
              f"{mode}: unexpected launches {la}")
        out["cells"][mode] = identity_levels(mode, line, la, kept)
        syncs_are_host_syncs(mode, line, kept)
        out.setdefault("syncs", {})[mode] = (
            len(kept["syncs"]), kept["stats"]["per_level"][-1]["batches"])
        check("kernel_args" in kept and "queue_args" in kept,
              f"{mode}: no cell-kernel batch captured")
        out[mode] = dict(record=rec, kernel_args=kept["kernel_args"],
                         queue_args=kept["queue_args"])
        if mode == "per-leg":
            out[mode]["kernel_calls"] = kept["kernel_calls"]
            out[mode]["levels"] = kept["stats"]["per_level"]
        out["launches"][key] = la[key]
        out["launches"].setdefault("distance_cells", la["distance_cells"])
        out["seconds"][mode] = line["seconds"]
        out["lines"][mode] = line
    # the count does not grow with the deepest level's batches: the per-leg
    # solve again at an eighth of its cell batch
    if not quick:
        line, _, _, kept = run_solve(
            data, "--legs", "4", "--k", "4", *deep, "--mode", "per-leg",
            "--csr-cell-chunk", "4096", sync_check=True)
        got = (line["cells"], line["valid"], line["edge"])
        check(got == SOLVE_COUNTS["per-leg"],
              f"per-leg at --csr-cell-chunk 4096: cells/valid/edge {got}")
        syncs_are_host_syncs("per-leg at --csr-cell-chunk 4096", line, kept)
        n, batches = len(kept["syncs"]), kept["stats"]["per_level"][-1][
            "batches"]
        check(n == out["syncs"]["per-leg"][0]
              and batches > out["syncs"]["per-leg"][1],
              f"per-leg: {n} synchronisations over {batches} deepest-level "
              f"batches against {out['syncs']['per-leg']}")
        say(f"  per-leg at --csr-cell-chunk 4096: {batches} batches at the "
            f"deepest level (was {out['syncs']['per-leg'][1]}), {n} "
            "synchronising operations (unchanged), the same cells")
    # the chunk-major per-leg form is no default of the solver: it is reached
    # through the evaluator factory.  Drive it that way on the whole captured
    # batch of the per-leg solve, whose flags the quat-major form gave.
    b = unpack_batch(out, "per-leg")
    robot = make_robot(QUAD_MOUNTS)
    evs = {cm_: cce.make_csr_cell_eval(
        robot, k=b["k"], n_quats=b["legtab"].shape[0], shared=False,
        window=b["window"], chunk_major=cm_) for cm_ in (True, False)}
    args = (b["centers"], b["cellinfo"][:, 3] > 0.5, b["legtab"], b["elong"],
            b["rmounts"], b["reach_l"], b["r_cell"], b["xs"], b["ys"], b["zs"],
            b["starts"], b["origin"])
    kw = dict(cell_size=b["q_kw"]["cell_size"], dims=b["q_kw"]["dims"],
              q_steps=b["queue"].role.shape[1])
    cce.cell_eval_cm_perleg.launches = 0
    t0 = time.perf_counter()
    got = evs[True](*args, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["launches"]["cell_cm_perleg"] = cce.cell_eval_cm_perleg.launches
    want = evs[False](*args, **kw)
    check(evs[True].form == "cm_perleg" and evs[False].form == "quat_major",
          "the factory picked another form")
    check(not bool(got[3]) and all(torch.equal(g, w) for g, w in
                                   zip(got[:3], want[:3])),
          "chunk-major per-leg flags differ from the quat-major ones")
    say(f"  make_csr_cell_eval(shared=False, chunk_major=True) on the first "
        f"batch of the per-leg solve's deepest level: {b['centers'].shape[0]} "
        f"cells, valid {int(got[0].sum())} edge {int(got[1].sum())} leaf "
        f"{int(got[2].sum())}, equal to the quat-major form's; {dt:.3f} s, "
        f"launches K6c {out['launches']['cell_cm_perleg']}")
    out["cm_every_batch"] = cm_every_batch(out["per-leg"])
    # the shared rule on the hexapod: 4 of 6 legs on one foothold (no cell
    # of this terrain is valid under it: legs mounted 60 degrees apart do not
    # meet on one foothold four at a time), and 3 of 6
    for k in ("4", "3"):
        line, rec, la, kept = run_solve(
            data, "--legs", "6", "--k", k, *deep, "--mode", "shared",
            capture="cell_eval_shared", show_levels=True, sync_check=True,
            cells=True)
        check(la["cell_shared"] > 0 and line["edge"] > 0
              and line["cells"] > line["edge"], f"hexapod solve: {line}")
        out["cells"]["hex" + k] = identity_levels(f"hexapod k={k}", line, la,
                                                  kept)
        syncs_are_host_syncs(f"hexapod k={k}", line, kept)
        out["syncs"]["hex" + k] = (
            len(kept["syncs"]), kept["stats"]["per_level"][-1]["batches"])
        out["seconds"]["hex" + k] = line["seconds"]
        out["lines"]["hex" + k] = line
        out["hex" + k] = dict(record=rec, kernel_args=kept["kernel_args"],
                              queue_args=kept["queue_args"])
    # CSR candidates against dense candidates: the whole solve on a quarter
    # of the box, whose deepest level is orientation-active; the dense runs
    # put the item kernel on the CLI's path
    out["dense"] = {}
    for mode in ("per-leg", "shared"):
        args = ("--legs", "4", "--k", "4", *QUARTER, "--mode", mode)
        _, r_csr, _, _ = run_solve(data, *args)
        l_dense, r_dense, la, kept = run_solve(data, *args, "--candidates",
                                               "dense")
        check(same_record(r_csr, r_dense),
              f"{mode}: CSR and dense candidates give different cells")
        check(la["item_cells"] > 0 and la["cell_quat_major"] == 0
              and la["cell_shared"] == 0,
              f"{mode}: --candidates dense launches {la}")
        out["launches"]["item_cells"] = (out["launches"].get("item_cells", 0)
                                         + la["item_cells"])
        # the batch of the dense solve with the most (cell, foothold) pairs,
        # and every batch
        out["dense"][mode] = kept["dense"]["args"]
        out.setdefault("dense_all", {})[mode] = kept["dense_all"]
        out.setdefault("dense_path", {})[mode] = "cli solve " + " ".join(
            (*args, "--candidates", "dense"))
        say(f"  {mode}: CSR == dense candidates on the quarter box "
            f"({l_dense['cells']} cells, {l_dense['valid']} valid, "
            f"{l_dense['edge']} edge)")
        for name, value, form in (("LEGMOV_CSR_QUAT_MAJOR", "1",
                                   "cell_quat_major"),
                                  ("LEGMOV_CSR_CHUNK_MASKS", "0", None)):
            os.environ[name] = value
            try:
                _, r_env, la, _ = run_solve(data, *args)
            finally:
                del os.environ[name]
            check(same_record(r_csr, r_env), f"{mode}: {name}={value} gives "
                  "different cells")
            check(form is None or la[form] > 0, f"{mode}: {name} launches {la}")
        say(f"  {mode}: LEGMOV_CSR_QUAT_MAJOR=1 and LEGMOV_CSR_CHUNK_MASKS=0 "
            "give the same cells")
    # the check still sees a read after the solves (it is no warn-once)
    check(sync_check_sees_a_read(), "the sync check missed a device read "
          "after the solves")
    return out


def batch_of(k_args):
    """A captured cell-kernel call's arguments as a batch (``balls``: the
    shared-rule kernel's per-element reach balls, None for the others)."""
    queue, cellinfo, legtab, xs, ys, zs, consts, k = k_args[:8]
    # cell_eval_quat_major takes `shared` before `window`
    window = k_args[9] if isinstance(k_args[8], bool) else k_args[8]
    balls = next((a for a in k_args[8:] if isinstance(a, cce.Balls)), None)
    return dict(queue=queue, cellinfo=cellinfo, legtab=legtab, xs=xs, ys=ys,
                zs=zs, consts=consts, k=k, window=window, balls=balls)


def perleg_flags(words, cellinfo):
    """The three flag words of a per-leg cell kernel as its caller reads
    them: valid with parent-valid ORed in, edge, and the leaf word (0).
    The walks stop at different points, so a kernel's own valid word may
    leave out a cell whose parent is valid."""
    return torch.stack([(words[:, 0] > 0) | (cellinfo[:, 3] > 0.5),
                        words[:, 1] > 0, words[:, 2] > 0])


def cm_every_batch(run):
    """K6c against K6a on every batch that K6a evaluated in the per-leg
    solve (its deepest level), through the C launchers: the flags as the
    caller reads them, then the summed kernel time of all the batches in
    turns (K6a, K6c, K6c, K6a, after one warm-up pass each), beside the
    summed bound of each walk."""
    lib = cmd.library()
    calls = run["kernel_calls"]
    rot = [lv for lv in run["levels"] if lv["rot"]]
    bs = [batch_of(a) for a in calls]
    params = [cmd.item_params(b["consts"], b["k"]) for b in bs]
    words = {form: [torch.zeros((b["queue"].role.shape[0], cmd.OUT_WORDS),
                                dtype=torch.int32, device=DEV) for b in bs]
             for form in ("quat_major", "cm_perleg")}

    def one(form):
        """ms of each batch, one pass"""
        torch.cuda.synchronize()
        evs = []
        for b, p, o in zip(bs, params, words[form]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            cells_call(lib, form, b["queue"], b, p, out=o)
            e1.record()
            evs.append((e0, e1))
        torch.cuda.synchronize()
        return [a.elapsed_time(z) for a, z in evs]

    one("quat_major")
    one("cm_perleg")
    bad = sum(int((perleg_flags(a, b["cellinfo"])
                   != perleg_flags(c, b["cellinfo"])).sum())
              for a, c, b in zip(words["quat_major"], words["cm_perleg"], bs))
    cells = sum(b["queue"].role.shape[0] for b in bs)
    check(len(bs) == sum(lv["batches"] for lv in rot),
          f"{len(bs)} K6a batches captured, the orientation-active levels "
          f"ran {sum(lv['batches'] for lv in rot)}")
    check(bad == 0, f"K6c's flags differ from K6a's on {bad} of the per-leg "
          "solve's deepest-level flags")
    per = [one("quat_major"), one("cm_perleg"), one("cm_perleg"),
           one("quat_major")]
    t = [sum(x) for x in per]
    bounds = {form: [cell_bound(w, *b["queue"].role.shape,
                                b["legtab"].numel())[0]
                     for w, b in zip(words[form], bs)]
              for form in words}
    bound = {form: sum(v) for form, v in bounds.items()}
    ratio = (t[1] + t[2]) / (t[0] + t[3])
    first = [x[0] for x in per]
    # where the work goes: the leg pipelines on elements inside the box
    # (word 9) of the cells whose parent is valid (edge is their only open
    # flag) and of the others
    split = {form: [0, 0] for form in words}
    n_pv = 0
    for i, b in enumerate(bs):
        pv = b["cellinfo"][:, 3] > 0.5
        n_pv += int(pv.sum())
        for form in words:
            w = words[form][i][:, 9].to(torch.int64)
            split[form][0] += int(w[pv].sum())
            split[form][1] += int(w[~pv].sum())
    say(f"  K6c against K6a on every batch K6a ran in the per-leg solve "
        f"({len(bs)} batches, {cells} cells, orientation-active depths "
        f"{[lv['depth'] for lv in rot]}): flags as the caller reads them "
        f"equal, mismatches {bad}; summed kernel ms in turns (K6a, K6c, "
        f"K6c, K6a): {t[0]:.3f}, {t[1]:.3f}, {t[2]:.3f}, {t[3]:.3f}; K6c / "
        f"K6a {ratio:.3f}; summed bound K6a {bound['quat_major']:.3f} ms, "
        f"K6c {bound['cm_perleg']:.3f} ms (its own walk); the first batch "
        f"({bs[0]['queue'].role.shape[0]} cells) in those turns: "
        + ", ".join(f"{x:.3f}" for x in first)
        + f" ms, K6c / K6a {(first[1] + first[2]) / (first[0] + first[3]):.3f},"
        f" bounds K6a {bounds['quat_major'][0]:.4f} ms, K6c "
        f"{bounds['cm_perleg'][0]:.4f} ms; leg pipelines inside the box, "
        f"K6a / K6c: {n_pv} cells with a valid parent "
        f"{split['quat_major'][0]} / {split['cm_perleg'][0]}, the other "
        f"{cells - n_pv} {split['quat_major'][1]} / "
        f"{split['cm_perleg'][1]}")
    return {"batches": len(bs), "cells": cells, "k6a_ms": [t[0], t[3]],
            "k6c_ms": [t[1], t[2]], "k6c_over_k6a": ratio,
            "k6a_bound_ms": bound["quat_major"],
            "k6c_bound_ms": bound["cm_perleg"],
            "first_batch_ms_in_turns": first,
            "first_batch_bounds_ms": [bounds["quat_major"][0],
                                      bounds["cm_perleg"][0]],
            "cells_parent_valid": n_pv,
            "pipelines_k6a_k6c": [split["quat_major"], split["cm_perleg"]]}


def unpack_batch(solve, mode):
    """The captured first batch of the deepest level of ``mode``'s solve."""
    (centers, elong, rmounts, reach_l, r_cell, starts, origin), q_kw = \
        solve[mode]["queue_args"]
    return dict(batch_of(solve[mode]["kernel_args"]), centers=centers,
                elong=elong, rmounts=rmounts, reach_l=reach_l, r_cell=r_cell,
                starts=starts, origin=origin, q_kw=q_kw)


def footholds_near(terrain, centers, expand):
    lo = centers.min(axis=0) - expand
    hi = centers.max(axis=0) + expand
    return terrain[np.all((terrain >= lo) & (terrain <= hi), axis=1)]


def phase_solve_gates(solve, terrain):
    """The solve's gates on the card, per rule, on ``GATE_CELLS`` cells of
    the first batch of the deepest level of phase 8's solves: the quadruped
    under its two rules, then the hexapod (six leg bits a role byte, 21 result
    bits an item, the 1024-float table row) on fewer cells."""
    quats = torch.from_numpy(hs.orientation_samples(SolverConfig())).to(DEV)
    S = quats.shape[0]
    out = {"plain_ms": {}, "sample_ms": {}}
    quad, hexa = make_robot(QUAD_MOUNTS), make_robot(HEX_MOUNTS)
    for mode, batch, robot, shared, n_gate in (
            ("per-leg", "per-leg", quad, False, GATE_CELLS),
            ("shared", "shared", quad, True, GATE_CELLS),
            ("hexapod shared", "hex3", hexa, True, HEX_GATE_CELLS),
            ("hexapod per-leg", "hex3", hexa, False, HEX_GATE_CELLS)):
        reach = hs._total_reach(robot)
        b = unpack_batch(solve, batch)
        k, window = b["k"], b["window"]
        C, CH, _ = b["queue"].role.shape
        rng = np.random.default_rng(17)
        rows = torch.from_numpy(
            np.sort(rng.choice(C, min(n_gate, C), replace=False))).to(DEV)
        centers = b["centers"][rows].contiguous()
        pv = b["cellinfo"][rows, 3] > 0.5
        rec = solve[batch]["record"]
        half = rec.halves[rec.depth == rec.depth.max()][0]
        parent_half = 2.0 * half
        say(f"phase 9: {mode} rule, {rows.numel()} cells of a batch of {C} "
            f"(queue width {CH}, window {window}, half {half[0]:.4f} mm)")

        def flags(chunk_major, plain, masks=True):
            ev = cce.make_csr_cell_eval(
                robot, k=k, n_quats=S, shared=shared, window=window,
                chunk_major=chunk_major, audit=True, chunk_masks=masks,
                plain=plain)
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            v, e, l, over, counts = ev(
                centers, pv, b["legtab"], b["elong"], b["rmounts"],
                b["reach_l"], b["r_cell"], b["xs"], b["ys"], b["zs"],
                b["starts"], b["origin"], cell_size=b["q_kw"]["cell_size"],
                dims=b["q_kw"]["dims"], q_steps=CH)
            z.record()
            z.synchronize()
            check(not bool(over), "queue truncated")
            return torch.stack([v, e, l]), counts, a.elapsed_time(z), ev.form

        base = None
        # the rule's own form first; the quadruped's K6c is held to its plain
        # version on a sample of the whole batch below, and to K6a on every batch of the
        # solve in phase 8
        for chunk_major in ((shared, not shared) if mode != "per-leg"
                            else (False,)):
            got, cnt, ms, form = flags(chunk_major, plain=False)
            want, cnt_p, ms_p, _ = flags(chunk_major, plain=True)
            bad = int((got != want).sum()) + int((cnt != cnt_p).sum())
            say(f"  {form}: kernel == plain version on flags and all 7 "
                f"counters: mismatches {bad}; counters "
                f"{cnt.sum(dim=0).tolist()}; queue build + kernel "
                f"{ms:.2f} ms, queue build + plain version {ms_p:.1f} ms")
            check(bad == 0, f"{mode} {form}: {bad} mismatches against the "
                  "plain version")
            out["plain_ms"][form, mode] = ms_p
            out["sample_ms"][form, mode] = ms
            if base is None:
                base = got
                say(f"    flags: valid {int(got[0].sum())} edge "
                    f"{int(got[1].sum())} leaf {int(got[2].sum())}")
            check(torch.equal(got, base), f"{mode}: {form} flags differ from "
                  "the rule's own form")
        got, _, _, _ = flags(shared, plain=False, masks=False)
        check(torch.equal(got, base), f"{mode}: chunk_masks=False flags differ")
        # the dense item kernel and its plain version on the same cells
        fh = footholds_near(terrain, centers.cpu().numpy(),
                            parent_half + np.float32(reach))
        fh_d = torch.from_numpy(fh).to(DEV)
        dense = {}
        for plain in (False, True):
            ev = cmd.make_cell_eval_rot(robot, k=k, plain=plain)
            dense[plain] = torch.stack(ev(
                centers, pv, half, parent_half, fh_d, quats, k=k, margin=0.0,
                reach=reach, shared=shared))
        check(torch.equal(dense[False], dense[True]),
              f"{mode}: item kernel and its plain version differ")
        check(torch.equal(dense[False], base),
              f"{mode}: CSR and dense flags differ on "
              f"{int((dense[False] != base).sum())}")
        # the eager evaluator on some of them
        few = slice(0, EAGER_CELLS)
        eager = torch.stack(hs._eval_cells(
            centers[few], pv[few], half, parent_half, fh_d, quats, robot, k=k,
            margin=0.0, reach=reach, chunk=4096, use_rot=True, shared=shared))
        check(torch.equal(eager, base[:, few]),
              f"{mode}: eager evaluator differs on "
              f"{int((eager != base[:, few]).sum())} flags")
        say(f"  chunk_masks=False, the other kernel form, the dense item "
            f"kernel (and its plain version) over {fh.shape[0]} footholds: "
            f"same flags; eager _eval_cells on {EAGER_CELLS} of the cells: "
            f"same flags")
    out["cm_whole"] = cm_whole_batch(unpack_batch(solve, "per-leg"))
    return out


CM_STRIDE = 8  # every 8th cell of the batch: the plain version's sample


def cm_whole_batch(b):
    """K6c on the whole captured per-leg batch, held against its plain
    version on all ten words of every ``CM_STRIDE``-th cell (a cell's words
    do not depend on the other cells).  The whole batch took the plain
    version 30-35 s; the sample keeps phase 9 and the run in their time."""
    q, ci = b["queue"], b["cellinfo"]
    C = q.role.shape[0]
    tail = (b["legtab"], b["xs"], b["ys"], b["zs"], b["consts"], b["k"])
    got = cce.cell_eval_cm_perleg(q, ci, *tail, b["window"])
    s = torch.arange(0, C, CM_STRIDE, device=got.device)
    t0 = time.perf_counter()
    want = cce.cell_eval_cm_perleg_plain(
        cce.CellQueue(q.cst[s], q.cln[s], q.role[s], q.tot[s], q.over),
        ci[s], *tail)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    bad = int((got[s] != want).sum())
    say(f"  K6c on the whole per-leg batch ({C} cells), every {CM_STRIDE}th "
        f"cell ({s.numel()}) against its plain version on all ten words: "
        f"mismatches {bad}; the plain version {dt:.1f} s")
    check(bad == 0, f"K6c: {bad} mismatching words against its plain "
          "version on the sampled cells of the per-leg batch")
    return {"cells": int(s.numel()), "batch_cells": C, "stride": CM_STRIDE,
            "mismatches": bad, "plain_s": dt}


def bound_of(n_bytes, n_ops):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_FLOPS_PER_S * 1e3
    return (t_b, "bytes", t_b, t_o) if t_b >= t_o else (t_o, "operations",
                                                        t_b, t_o)


def phase_cell_kernels(solve, gates, terrain, others=()):
    """K5 and K6a/K6b/K6c alone: special values, and their times; then
    against the builds of the sources ``others`` (earlier
    ``cell_kernels.cu`` files)."""
    robot = make_robot(QUAD_MOUNTS)
    L = 4
    reach = hs._total_reach(robot)
    quats = torch.from_numpy(hs.orientation_samples(SolverConfig())).to(DEV)
    S = quats.shape[0]
    rows_out = {}
    say(f"phase 10: m2 quadruped; fp32 operations per (item, candidate): "
        f"{cmd.HEAD_FLOPS} for the head + {cmd.LEG_FLOPS} per leg on a "
        f"candidate inside the elongated box")

    # K5 at [27 x 1024 items, 2048 shared candidates]
    b = unpack_batch(solve, "per-leg")
    k = b["k"]
    rec = solve["per-leg"]["record"]
    half = rec.halves[rec.depth == rec.depth.max()][0]
    parent_half = 2.0 * half
    n_cells = min(1024, b["centers"].shape[0])
    centers = b["centers"][:n_cells].contiguous()
    pv = b["cellinfo"][:n_cells, 3] > 0.5
    k5 = cmd.make_multileg_distance_kernel(robot, k=k)
    blocks = torch.as_tensor(cmd.leg_blocks(quats.cpu().numpy(), robot),
                             device=DEV)
    tab = cmd.tables_from_blocks(
        blocks, torch.arange(S, device=DEV).repeat(n_cells),
        quats.repeat(n_cells, 1), centers.repeat_interleave(S, dim=0),
        pv.repeat_interleave(S), half, parent_half, 0.0, reach)
    c_np = centers.cpu().numpy()
    fh = footholds_near(terrain, c_np, parent_half + np.float32(reach))
    mid = (c_np.min(axis=0) + c_np.max(axis=0)) / 2
    fh = fh[np.argsort(np.linalg.norm(fh[:, :2] - mid[:2], axis=1),
                       kind="stable")][:2048]
    fh = np.concatenate([fh, np.full((2048 - fh.shape[0], 3), 1e9,
                                     np.float32)])
    g = [torch.from_numpy(np.ascontiguousarray(fh[None, :, i])).to(DEV)
         for i in range(3)]
    work = {}
    want = k5.plain(tab, *g, work=work)
    got = k5(tab, *g)
    bad5 = int((got != want).sum())
    # special values, per-item candidate rows, ragged shapes
    rng = np.random.default_rng(23)
    for P in (0, 1, 7, 27):
        for C in (0, 1, 300):
            c = (c_np[0] + rng.uniform(-900, 900, (P, C, 3))).astype(np.float32)
            if P >= 4 and C >= 8:
                c[0, :8] = np.nan
                c[1, :8] = np.inf
                c[2] = 1e9
                c[3, ::2] = -np.inf
            gi = [torch.from_numpy(np.ascontiguousarray(c[..., i])).to(DEV)
                  for i in range(3)]
            r = k5(tab[:P].contiguous(), *gi)
            check(r.shape == (P, 3 * L + 3) and r.dtype == torch.bool,
                  f"K5 P={P} C={C} shape")
            bad5 += int((r != k5.plain(tab[:P].contiguous(), *gi)).sum())
    say(f"  K5 [{tab.shape[0]} items, 2048 shared candidates] "
        f"({work['pre_pairs']} of {work['pairs']} pairs inside the elongated "
        f"box), and P in (0, 1, 7, 27) x C in (0, 1, 300) per-item rows with "
        f"NaN/inf/1e9: mismatches {bad5}; {int(want.sum())} of "
        f"{want.numel()} bits set")
    check(bad5 == 0, f"K5: {bad5} mismatching bits against the plain version")
    ms5 = time_cuda(lambda: k5(tab, *g))
    plain5 = time_cuda(lambda: k5.plain(tab, *g), warmup=1, reps=3)
    bytes5 = tab.numel() * 4 + 3 * 2048 * 4 + tab.shape[0] * 4
    ops5 = (work["pairs"] * cmd.HEAD_FLOPS
            + work["pre_pairs"] * L * cmd.LEG_FLOPS)
    b5, by5, t_b, t_o = bound_of(bytes5, ops5)
    say(f"  K5 {ms5:.4f} ms  plain {plain5:.2f} ms  bound {b5:.4f} ms ({by5}; "
        f"bytes {t_b:.4f}, operations {t_o:.4f})  share of bound "
        f"{b5 / ms5:.3f}")
    rows_out["item"] = {"max_abs_err": float(min(bad5, 1)), "n": work["pairs"],
                        "ms": ms5, "plain_ms": plain5, "bound_ms": b5,
                        "bound_by": by5}
    k5_in = (tab, g, cmd.item_params(k5.consts, k))
    del got, want
    rows_out["item_cells"], k5c_in = phase_item_cells(
        solve, robot, k, quats, blocks, centers, pv, half, parent_half, reach,
        torch.from_numpy(np.ascontiguousarray(fh)).to(DEV))

    # K6: special values and a dead queue on the sampled cells, then the
    # times on the whole captured batches
    forms = (
        ("cell_quat_major", "per-leg", "quat_major",
         lambda q, b, xs: cce.cell_eval_quat_major(
             q, b["cellinfo"], b["legtab"], xs, b["ys"], b["zs"], b["consts"],
             b["k"], False, b["window"]),
         lambda q, b, xs: cce.cell_eval_quat_major_plain(
             q, b["cellinfo"], b["legtab"], xs, b["ys"], b["zs"], b["consts"],
             b["k"], False)),
        ("cell_shared", "shared", "shared",
         lambda q, b, xs: cce.cell_eval_shared(
             q, b["cellinfo"], b["legtab"], xs, b["ys"], b["zs"], b["consts"],
             b["k"], b["window"], b["balls"]),
         lambda q, b, xs: cce.cell_eval_shared_plain(
             q, b["cellinfo"], b["legtab"], xs, b["ys"], b["zs"], b["consts"],
             b["k"], balls=b["balls"])),
        ("cell_cm_perleg", "per-leg", "cm_perleg",
         lambda q, b, xs: cce.cell_eval_cm_perleg(
             q, b["cellinfo"], b["legtab"], xs, b["ys"], b["zs"], b["consts"],
             b["k"], b["window"]),
         lambda q, b, xs: cce.cell_eval_cm_perleg_plain(
             q, b["cellinfo"], b["legtab"], xs, b["ys"], b["zs"], b["consts"],
             b["k"])),
        # K6a's shared-rule branch (LEGMOV_CSR_QUAT_MAJOR=1) on the shared
        # rule's batch
        ("cell_quat_major_shared", "shared", "quat_major",
         lambda q, b, xs: cce.cell_eval_quat_major(
             q, b["cellinfo"], b["legtab"], xs, b["ys"], b["zs"], b["consts"],
             b["k"], True, b["window"]),
         lambda q, b, xs: cce.cell_eval_quat_major_plain(
             q, b["cellinfo"], b["legtab"], xs, b["ys"], b["zs"], b["consts"],
             b["k"], True)),
    )
    for name, mode, form, kern, plain in forms:
        b = unpack_batch(solve, mode)
        q = b["queue"]
        C, CH, _ = q.role.shape
        # a small set of cells, over footholds with NaN / inf / 1e9 rows
        few = torch.arange(0, C, max(1, C // 32), device=DEV)[:32]
        small = dict(b, cellinfo=b["cellinfo"][few].contiguous())
        qs = cce.CellQueue(q.cst[few].contiguous(), q.cln[few].contiguous(),
                           q.role[few].contiguous(), q.tot[few].contiguous(),
                           q.over)
        xs_bad = b["xs"].clone()
        hit = qs.cst[:, 0].to(torch.int64)
        last = xs_bad.numel() - 1
        xs_bad[hit[0::3]] = float("nan")
        xs_bad[torch.clamp(hit[1::3] + 1, max=last)] = float("inf")
        xs_bad[torch.clamp(hit[2::3] + 2, max=last)] = 1e9
        bad = int((kern(qs, small, xs_bad) != plain(qs, small, xs_bad)).sum())
        dead = cce.CellQueue(qs.cst, torch.zeros_like(qs.cln),
                             torch.zeros_like(qs.role),
                             torch.zeros_like(qs.tot), q.over)
        bad += int(kern(dead, small, b["xs"]).abs().sum())
        bad += int(plain(dead, small, b["xs"]).abs().sum())
        if form == "cm_perleg":
            bad += cm_wide(qs, small, kern, plain, xs_bad)
        res = kern(q, b, b["xs"])
        cnt = res[:, 3:].sum(dim=0, dtype=torch.int64).tolist()
        say(f"  {name} ({form}) on {few.numel()} cells with NaN/inf/1e9 "
            f"footholds and on an all-dead queue: mismatches {bad}")
        check(bad == 0, f"{name}: {bad} mismatches against the plain version")
        # how unevenly the work falls on the batch's cells
        per_cell = res[:, 9].to(torch.float64)
        tot = q.tot.to(torch.float64)
        mean = float(per_cell.mean())
        say(f"  {name}: leg pipelines inside the box a cell: mean {mean:.1f}, "
            f"99th percentile {float(per_cell.quantile(0.99)):.0f}, max "
            f"{float(per_cell.max()):.0f} (max / mean "
            f"{float(per_cell.max()) / max(mean, 1e-9):.1f}); queue chunks a "
            f"cell: mean {float(tot.mean()):.2f}, max {int(q.tot.max())}")
        ms = time_cuda(lambda: kern(q, b, b["xs"]))
        # the queue build that feeds the kernel, on the same batch (the
        # role bytes differ between the rules, not between a rule's forms)
        q_args, q_kw = solve[mode]["queue_args"]
        ms_q = time_cuda(lambda: cce.build_cell_queue(*q_args, **q_kw),
                         warmup=1, reps=5)
        bd, by, t_b, t_o = cell_bound(res, C, CH, S, b["legtab"].numel())
        say(f"  {name} on a real batch of {C} cells (queue width {CH}, window "
            f"{b['window']}): chunks {cnt[0]}, (chunk, orientation) items "
            f"{cnt[1]}, leg pipelines {cnt[2]}; elements {cnt[3]} / {cnt[4]} "
            f"/ {cnt[5]}, leg pipelines on elements inside the box {cnt[6]}")
        if (form, mode) in gates["plain_ms"]:
            plain_ms, plain_cells = gates["plain_ms"][form, mode], GATE_CELLS
            sample = (f"on {GATE_CELLS} cells with the queue build: kernel "
                      f"{gates['sample_ms'][form, mode]:.2f} ms, plain "
                      f"version {plain_ms:.1f} ms")
        else:  # K6c: its plain version on phase 9's sample of the batch
            plain_ms = gates["cm_whole"]["plain_s"] * 1e3
            plain_cells = gates["cm_whole"]["cells"]
            sample = (f"plain version on {plain_cells} cells of the batch "
                      f"{plain_ms:.1f} ms")
        say(f"  {name} {ms:.4f} ms  bound {bd:.4f} ms ({by}; bytes "
            f"{t_b:.4f}, operations {t_o:.4f})  share of bound "
            f"{bd / ms:.3f}; queue build of the batch {ms_q:.2f} ms; "
            + sample)
        rows_out[name] = {
            "max_abs_err": float(min(bad, 1)), "n": cnt[6], "ms": ms,
            "plain_ms": plain_ms, "plain_cells": plain_cells, "cells": C,
            "bound_ms": bd,
            "bound_by": by, "queue_build_ms": ms_q,
            "work_max_over_mean": float(per_cell.max()) / max(mean, 1e-9)}

    # when asked: the same kernels of other builds on the same inputs, each
    # timed in turns with this build's (other, this, this, other), all
    # through the C launchers
    if others:
        batches = {"per-leg": unpack_batch(solve, "per-leg"),
                   "shared": unpack_batch(solve, "shared")}
        for label, lib in alternatives(others, bind_cell_library):
            compare_builds(label, lib, cmd.library(), batches, k5_in,
                           k5c_in)
    return rows_out


def cm_wide(qs, small, kern, plain, xs):
    """K6c over 54 orientations (the level's 27 twice over: a lane keeps
    orientations q and q + 32): the flags of the 27, and the plain
    version's ten words on 8 of the cells.  Returns the mismatches."""
    wide = cce.CellQueue(qs.cst, qs.cln,
                         torch.cat([qs.role, qs.role], dim=2).contiguous(),
                         qs.tot, qs.over)
    b2 = dict(small, legtab=torch.cat([small["legtab"]] * 2).contiguous())
    ci = small["cellinfo"]
    bad = int((perleg_flags(kern(wide, b2, xs), ci)
               != perleg_flags(kern(qs, small, xs), ci)).sum())
    e = slice(0, 8)
    q8 = cce.CellQueue(*(t[e].contiguous() for t in wide[:4]), wide.over)
    b8 = dict(b2, cellinfo=ci[e].contiguous())
    bad += int((kern(q8, b8, xs) != plain(q8, b8, xs)).sum())
    say(f"  cell_cm_perleg over {wide.role.shape[2]} orientations: flags "
        f"equal to the {qs.role.shape[2]} orientations' on {ci.shape[0]} "
        f"cells, ten words equal to the plain version's on 8: mismatches "
        f"{bad}")
    return bad


def form_before(c, p, f, lt, consts, k, shared, params):
    """K5's form before its cell driver, as the dense solver ran it: the
    item kernel once per window of 2048 footholds over every (cell,
    orientation) item, its lanes ORed and folded in eager code."""
    S, L = lt.shape[0], len(consts)
    tab = cmd.item_rows(c, p, lt)
    lanes = torch.zeros((tab.shape[0], 3 * L + 3), dtype=torch.bool,
                        device=c.device)
    fx, fy, fz = (f[:, i].contiguous()[None, :] for i in range(3))
    for lo in range(0, f.shape[0], 2048):
        g = [x[:, lo:lo + 2048].contiguous() for x in (fx, fy, fz)]
        lanes |= cmd.multileg_distance_kernel(tab, *g, consts, k, params)
    return cmd.fold_item_lanes(lanes, p, S, k, shared)


def pass_turns(old, new):
    """Two lists of calls (every batch of a solve, each form) in turns:
    old, new, new, old, each turn one pass over its list after a warm-up
    pass of each: (summed kernel ms: CUDA events around each call of the
    item form's and the cell driver's C launchers; wall ms: host clock from
    a synchronise before the pass to one after it)."""
    def one(calls):
        torch.cuda.synchronize()
        with kernel_clock(("item", "item_cells")) as recs:
            t0 = time.perf_counter()
            for fn in calls:
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return (sum(a.elapsed_time(b) for r in recs.values()
                    for a, b, _ in r), wall)
    one(old)
    one(new)
    return [one(old), one(new), one(new), one(old)]


def batch_turns(old, new, reps=3):
    """``old`` and ``new`` (calls that evaluate one batch) in turns: old,
    new, new, old; each turn the median of ``reps`` runs after a warm-up
    of (summed kernel ms: CUDA events around each call of the item form's
    and the cell driver's C launchers; wall ms: host clock from a
    synchronise to a synchronise)."""
    def one(fn):
        ks, ws = [], []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            with kernel_clock(("item", "item_cells")) as recs:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            if i:
                ks.append(sum(a.elapsed_time(b) for r in recs.values()
                              for a, b, _ in r))
                ws.append(wall)
        return statistics.median(ks), statistics.median(ws)
    return [one(old), one(new), one(new), one(old)]


def phase_item_cells(solve, robot, k, quats, blocks, centers, pv, half,
                     parent_half, reach, fh):
    """K5's cell driver against its plain version and against the solver's
    form before it (the item kernel over foothold windows of 2048, its
    lanes folded in eager code) on special batches, on phase 10's batch
    (``centers`` x the 2048 footholds ``fh``) and on the largest batch of
    each quarter-box ``--candidates dense`` solve of phase 8; times in
    turns with that form beside the bound."""
    consts = cmd.dist_leg_constants(robot)
    params = cmd.item_params(consts, k)
    L = len(consts)
    legtab = cmd.level_table(blocks, quats, half, parent_half, 0.0, reach)

    def old(c, p, f, lt, shared, k=k):
        return form_before(c, p, f, lt, consts, k, shared, params)

    def new(c, p, f, lt, shared, k=k):
        return cmd.item_cells_kernel(c, p, f, lt, consts, k, shared,
                                     params=params)

    def plain(c, p, f, lt, shared, k=k):
        return cmd.item_cells_plain(c, p, f, lt, consts, k, shared)

    # special batches on 64 of the cells
    few, pvf = centers[:64].contiguous(), pv[:64].contiguous()
    odd = fh[:1500].clone()
    odd[0:3] = float("nan")
    odd[3:6, 1] = float("inf")
    odd[6:9, 2] = -float("inf")
    odd[9:40] = 1e9
    f1000 = fh[:1000].contiguous()
    cases = [("1,000 footholds (off the tile of 256)", few, pvf, f1000,
              legtab),
             ("NaN/inf/1e9 footholds", few, pvf, odd, legtab),
             ("no footholds", few, pvf, fh[:0], legtab),
             ("one orientation (S = 1)", few, pvf, f1000,
              legtab[:1].contiguous()),
             ("every parent valid", few, torch.ones_like(pvf), f1000, legtab),
             ("one cell", few[:1].contiguous(), pvf[:1].contiguous(), f1000,
              legtab)]
    bad = 0
    for shared in (False, True):
        for label, c, p, f, lt in cases:
            got = new(c, p, f, lt, shared)
            check(got.shape == (3, c.shape[0]) and got.dtype == torch.bool,
                  f"K5 cell driver {label}: shape")
            bad += int((got != plain(c, p, f, lt, shared)).sum())
    say(f"  K5 cell driver on special batches of {few.shape[0]} cells "
        f"({'; '.join(c[0] for c in cases)}), both rules, S = "
        f"{legtab.shape[0]} unless said: mismatches {bad} against the plain "
        "version")

    def turns(tag, c, p, f, lt, shared, kk):
        nonlocal bad
        got, want = new(c, p, f, lt, shared, kk), old(c, p, f, lt, shared, kk)
        n_bad = int((got != want).sum())
        bad += n_bad
        t = batch_turns(lambda: old(c, p, f, lt, shared, kk),
                        lambda: new(c, p, f, lt, shared, kk))
        C, F, n, S, _, nb = item_cells_work(c, f, lt, L)
        n = int(n)
        # the bound from what decides the flags (a walk of the plain
        # item's bits); beside it the count of every pair in the box
        need = cmd.item_cells_need(c, p, f, lt, consts, kk, shared).tolist()
        bd, by, t_b, t_o = bound_of(nb, cmd.item_cells_flops(*need))
        every = bound_of(nb, cmd.item_cells_flops(C * F, n * S, n * S * L))[0]
        new_ms = (t[1][0] + t[2][0]) / 2
        old_ms = (t[0][0] + t[3][0]) / 2
        say(f"  K5 {tag}: {C} cells x {F} footholds, {n} (cell, foothold) "
            f"pairs in the box, S = {S}; flags {got.sum(dim=1).tolist()}, "
            f"mismatches against the form before {n_bad}; kernel ms in "
            f"turns: before {t[0][0]:.3f}, cell driver {t[1][0]:.3f}, "
            f"{t[2][0]:.3f}, before {t[3][0]:.3f} (before / driver "
            f"{old_ms / new_ms:.3f}); batch wall ms {t[0][1]:.2f}, "
            f"{t[1][1]:.2f}, {t[2][1]:.2f}, {t[3][1]:.2f}")
        say(f"    what decides the flags: {need[0]} box tests, {need[1]} "
            f"un-rotations, {need[2]} leg pipelines; bound {bd:.4f} ms "
            f"({by}), share {bd / new_ms:.3f} (before {bd / old_ms:.3f}); "
            f"every pair in the box on every orientation and leg "
            f"{every:.4f} ms")
        return {"tag": tag, "cells": C, "footholds": F, "pairs_in_box": n,
                "quats": S, "ms": new_ms, "form_before_ms": old_ms,
                "wall_ms": (t[1][1] + t[2][1]) / 2,
                "form_before_wall_ms": (t[0][1] + t[3][1]) / 2,
                "turns": t, "need": need, "bound_ms": bd, "bound_by": by,
                "bound_ms_every_pair": every}

    batches = [(f"{'shared' if sh else 'per-leg'} rule on phase 10's batch",
                (centers, pv, fh, legtab, sh, k)) for sh in (False, True)]
    for mode in ("per-leg", "shared"):
        c, p, f, lt, cs, kk, sh = solve["dense"][mode]
        batches.append((f"real batch of the quarter-box --candidates dense "
                        f"{mode} solve", (c, p, f, lt, sh, kk)))
    rows = [turns(tag, *a) for tag, a in batches]
    # every batch of each quarter-box dense solve, both forms in turns
    solves = []
    for mode in ("per-leg", "shared"):
        calls = solve["dense_all"][mode]
        run_old = [lambda a=a: old(a[0], a[1], a[2], a[3], a[6], a[5])
                   for a in calls]
        run_new = [lambda a=a: new(a[0], a[1], a[2], a[3], a[6], a[5])
                   for a in calls]
        n_bad = sum(int((x() != y()).sum()) for x, y in zip(run_old, run_new))
        bad += n_bad
        t = pass_turns(run_old, run_new)
        new_ms, old_ms = (t[1][0] + t[2][0]) / 2, (t[0][0] + t[3][0]) / 2
        say(f"  K5 every batch of the quarter-box --candidates dense {mode} "
            f"solve ({len(calls)} batches, {sum(a[0].shape[0] for a in calls)} "
            f"cells): mismatches against the form before {n_bad}; summed "
            f"kernel ms in turns: before {t[0][0]:.1f}, cell driver "
            f"{t[1][0]:.1f}, {t[2][0]:.1f}, before {t[3][0]:.1f} (before / "
            f"driver {old_ms / new_ms:.3f}); summed wall ms {t[0][1]:.1f}, "
            f"{t[1][1]:.1f}, {t[2][1]:.1f}, {t[3][1]:.1f}")
        solves.append({"solve": mode, "batches": len(calls), "ms": new_ms,
                       "form_before_ms": old_ms,
                       "wall_ms": (t[1][1] + t[2][1]) / 2,
                       "form_before_wall_ms": (t[0][1] + t[3][1]) / 2,
                       "turns": t})
    # K5's bound on each dense solve's path: what decides the flags of every
    # batch (a walk of the plain item's bits), counted apart from the timed
    # runs
    for mode, row in zip(("per-leg", "shared"), solves):
        calls = solve["dense_all"][mode]
        need = torch.stack([cmd.item_cells_need(*a) for a in calls]).tolist()
        bd = sum(bound_of(item_cells_work(a[0], a[2], a[3], L)[5],
                          cmd.item_cells_flops(*n))[0]
                 for a, n in zip(calls, need))
        path = solve["dense_path"][mode]
        kept = PATH_TIMES.get(("item_cells", path))
        check(kept is not None and kept["launches"] == len(calls),
              f"K5: no kernel time kept for {path}")
        kept["bound_ms"] = bd
        row["path_bound_ms"] = bd
        say(f"  K5 on {path}: {kept['launches']} launches, {kept['ms']:.1f} "
            f"ms; bound from what decides the flags of every batch "
            f"{bd:.3f} ms, share {bd / kept['ms']:.3f}")
    sums = [sum(r[key] for r in solves) for key in ("form_before_ms", "ms")]
    say(f"  K5 summed over both dense solves in turns: before {sums[0]:.1f} "
        f"ms, cell driver {sums[1]:.1f} ms (before / driver "
        f"{sums[0] / sums[1]:.3f})")
    check(bad == 0, f"K5 cell driver: {bad} mismatching flags")
    plain_ms = time_cuda(lambda: plain(centers, pv, fh, legtab, False),
                         warmup=0, reps=1)
    head = rows[0]
    return {"max_abs_err": float(min(bad, 1)),
            "n": head["cells"] * head["footholds"], "ms": head["ms"],
            "plain_ms": plain_ms, "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "form_before_ms": head["form_before_ms"],
            "batches": rows, "dense_solves": solves}, (params, batches)


def bind_multileg_library(lib):
    """Argument types for a library built from a ``multileg_kernels.cu``,
    as this build's have them."""
    here = cm._library()
    for name in ("legmov_multileg", "legmov_csr_window", "legmov_csr_round"):
        if hasattr(lib, name):  # an earlier build has no round kernel
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = getattr(here, name).argtypes
    return lib


@contextlib.contextmanager
def multileg_library(lib):
    """The multi-leg wrappers launch the kernels of ``lib`` inside the
    block (this build's when ``lib`` is None)."""
    saved = cm._library()
    if lib is not None:
        cm._bound = lib
    try:
        yield
    finally:
        cm._bound = saved


def bind_cell_library(lib):
    """Argument types for a library built from a ``cell_kernels.cu``; an
    earlier one may lack ``legmov_cell_occupancy``."""
    for name, argtypes in cmd.signatures().items():
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = argtypes
    return lib


def alternatives(sources, bind, flags=None):
    """Build each source with the package's nvcc flags (and its entry of
    ``flags``, when given), one nvcc each, started together, into the build
    directory, print what ptxas says of its kernels and their instruction
    mix, and bind it with ``bind``.  [(label, lib)]"""
    nvcc = _build._find_nvcc()
    os.makedirs(_build.build_dir(), exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for src, more in zip(sources, flags or [()] * len(sources)):
        with open(src, "rb") as f:
            h = hashlib.sha256(f.read())
        h.update(" ".join(more).encode())
        so = os.path.join(_build.build_dir(),
                          f"compare_{h.hexdigest()[:16]}.so")
        label = " ".join((src, *more))
        procs.append((label, so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *more, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = []
    for label, so, proc in procs:
        o, e = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on {label}:\n{o}\n{e}")
        say(f"  built {label} in {time.perf_counter() - t0:.1f} s")
        for line in (o + e).splitlines():
            if "Compiling entry" in line:
                say("    ptxas:", line.split("function")[1].strip())
            if "registers" in line or ("spill" in line.lower()
                                       and "0 bytes spill" not in line):
                say("    ptxas:", line.strip())
        sass_mix(so)
        out.append((label, bind(ctypes.CDLL(so))))
    return out


def cells_call(lib, form, q, b, params, shared=False, out=None):
    """One launch of a cell kernel of ``lib`` on a captured batch (into
    ``out`` when given: every cell's words are written)."""
    C, CH, S = q.role.shape
    if out is None:
        out = torch.zeros((C, cmd.OUT_WORDS), dtype=torch.int32, device=DEV)
    ptrs = [t.data_ptr() for t in (q.cst, q.cln, q.role, q.tot, b["cellinfo"],
                                   b["legtab"], b["xs"], b["ys"], b["zs"],
                                   out)]
    tail = [C, CH, S, b["window"]] + ([int(shared)] if form == "quat_major"
                                      else [])
    err = getattr(lib, "legmov_cell_" + form)(*ptrs, *tail,
                                              ctypes.byref(params),
                                              cmd.stream())
    check(err == 0, f"legmov_cell_{form}: CUDA error {err}")
    return out


def item_cells_call(lib, params, c, p, f, lt, shared, k):
    """One launch of the K5 cell driver of ``lib`` on a batch."""
    flags = torch.empty((3, c.shape[0]), dtype=torch.bool, device=DEV)
    scratch = torch.zeros(c.shape[0] * (lt.shape[0] + 1), dtype=torch.int32,
                          device=DEV)
    fp = f.data_ptr()
    err = lib.legmov_item_cells(
        lt.data_ptr(), lt.shape[0], c.data_ptr(), p.data_ptr(), c.shape[0],
        fp, fp + 4, fp + 8, 3, f.shape[0], int(shared), flags.data_ptr(),
        scratch.data_ptr(), ctypes.byref(params), cmd.stream())
    check(err == 0, f"legmov_item_cells: CUDA error {err}")
    return flags


def item_call(lib, tab, g, params):
    bits = torch.zeros(tab.shape[0], dtype=torch.int32, device=DEV)
    err = lib.legmov_item(tab.data_ptr(), g[0].data_ptr(), g[1].data_ptr(),
                          g[2].data_ptr(), tab.shape[0], g[0].shape[1], 1,
                          bits.data_ptr(), ctypes.byref(params), cmd.stream())
    check(err == 0, f"legmov_item: CUDA error {err}")
    return bits


def compare_builds(label, lib, here, batches, k5_in, k5c_in):
    """K5 (both forms, the cell driver where ``lib`` has one), K6a, K6b and
    K6c of ``lib`` against this build's (``here``) on the same inputs: equal
    outputs, then times in turns (other, this, this, other), CUDA events,
    median of 20 launches each (K6c: of 5)."""
    say(f"phase 10: {label} against this build")
    # the last entry: K6a's `shared` argument, or a cell-driver batch
    cases = [(f"K5 cell driver, {tag}", None, "item_cells", a)
             for tag, a in (k5c_in[1] if hasattr(lib, "legmov_item_cells")
                            else [])]
    cases += [("K5", None, "item", False),
             ("K6a", "per-leg", "quat_major", False),
             ("K6b", "shared", "shared", False),
             ("K6a shared branch", "shared", "quat_major", True),
             ("K6c", "per-leg", "cm_perleg", False)]
    for kid, mode, form, extra in cases:
        if form == "item_cells":
            other = lambda: item_cells_call(lib, k5c_in[0], *extra)
            this = lambda: item_cells_call(here, k5c_in[0], *extra)
        elif form == "item":
            tab, g, params = k5_in
            other = lambda: item_call(lib, tab, g, params)
            this = lambda: item_call(here, tab, g, params)
        else:
            b = batches[mode]
            q = b["queue"]
            params = cmd.item_params(b["consts"], b["k"])
            if form == "shared":
                # K6b as the solve runs it: with the per-element reach
                # balls, which an earlier build does not read
                params = cce.ball_params(params, b["balls"])
            other = lambda: cells_call(lib, form, q, b, params, extra)
            this = lambda: cells_call(here, form, q, b, params, extra)
        if form == "shared":
            # the flags and the chunk and item counters are the earlier
            # build's; the leg passes, their elements and the pipelines can
            # only fall
            o, t = other(), this()
            kept = [0, 1, 2, 3, 4, 6, 7]
            check(torch.equal(o[:, kept], t[:, kept])
                  and bool((t[:, [5, 8, 9]] <= o[:, [5, 8, 9]]).all()),
                  f"{label}: {kid} gives other flags or more work than this "
                  "build's")
            say(f"  {kid}: leg pipelines on elements inside the box "
                f"{int(o[:, 9].sum())} (other) against {int(t[:, 9].sum())} "
                "(this, with the per-element balls)")
        elif form == "cm_perleg":
            # the walk and its counters change by design: the flags only
            ci = batches[mode]["cellinfo"]
            check(torch.equal(perleg_flags(other(), ci),
                              perleg_flags(this(), ci)),
                  f"{label}: {kid} gives other flags than this build's")
        else:
            check(torch.equal(other(), this()),
                  f"{label}: {kid} gives other words than this build's")
        reps = 5 if form == "cm_perleg" else 20
        t = [time_cuda(other, warmup=1, reps=reps),
             time_cuda(this, warmup=1, reps=reps),
             time_cuda(this, warmup=1, reps=reps),
             time_cuda(other, warmup=1, reps=reps)]
        same = "flags" if form in ("cm_perleg", "shared") else "words"
        say(f"  {kid}: equal {same}; "
            f"ms in turns: other {t[0]:.4f}, this "
            f"{t[1]:.4f}, this {t[2]:.4f}, other {t[3]:.4f}; other / this "
            f"{(t[0] + t[3]) / (t[1] + t[2]):.3f}")


# ---------------------------------------------------------------------------
# K2's cell kernel on the identity levels
# ---------------------------------------------------------------------------

IDENTITY_DEPTHS = range(2, 7)   # the captured levels phase 11 holds
CELL_SOLVES = {"per-leg": "quadruped per-leg", "shared": "quadruped shared",
               "hex4": "hexapod 4-of-6 shared", "hex3": "hexapod 3-of-6 shared"}


def cells_launch(lib, b, audit=None):
    """One launch of ``lib``'s K2 cell kernel on a captured batch ``b``,
    through the C launcher (``audit``, when given, is zeroed first)."""
    C = b["centers"].shape[0]
    f = b["footholds"]
    flags = torch.empty((3, C), dtype=torch.bool, device=DEV)
    scratch = b["legs"].scratch_on(DEV, C)
    if audit is not None:
        audit.zero_()
    args = ck.cell_args(b["legs"], b["level"], b["k"], b["shared"])
    err = lib.legmov_distance_cells(
        b["centers"].data_ptr(), b["pv"].data_ptr(), C, f.data_ptr(),
        f.data_ptr() + 4, f.data_ptr() + 8, 3, f.shape[0],
        b["legs"].params_on(DEV).data_ptr(), len(b["legs"].params),
        flags.data_ptr(), scratch.data_ptr(),
        None if audit is None else audit.data_ptr(), ctypes.byref(args),
        ck._stream())
    check(err == 0, f"legmov_distance_cells: CUDA error {err}")
    return flags


def pre_counts(b):
    """Per cell, the footholds inside its elongated box: the plain
    version's prefilter, summed over the footholds."""
    c, f = b["centers"], b["footholds"]
    e0, e1, e2 = b["level"].elong
    out = torch.zeros(c.shape[0], dtype=torch.int64, device=DEV)
    for lo in range(0, f.shape[0], 8192):
        v = f[None, lo:lo + 8192] - c[:, None]
        out += ((v[..., 0] > -e0) & (v[..., 0] <= e0) & (v[..., 1] > -e1)
                & (v[..., 1] <= e1) & (v[..., 2] > -e2)
                & (v[..., 2] <= e2)).sum(dim=1)
    return out


def plain_flags(b, dist=None, chunk=512):
    return ck.distance_cells_plain(b["centers"], b["pv"], b["footholds"],
                                   b["legs"], b["level"], b["k"], b["shared"],
                                   chunk=chunk, dist=dist)


SPECIAL_CELLS = 128  # cells of a real batch that the special batches keep


def special_batches(b):
    """The first cells of a real batch over the footholds near them (the
    solver's batch subset for those cells), made special: NaN, +-inf and
    1e9 rows among the footholds; no footholds; one tile of footholds (the
    launch that does not split a cell's footholds); every parent valid; the
    other crossing branch (box test against sphere test)."""
    c = b["centers"][:SPECIAL_CELLS].contiguous()
    fh = b["footholds"].cpu().numpy()
    near = footholds_near(fh, c.cpu().numpy(),
                          np.asarray(b["level"].elong, np.float32))
    b = dict(b, centers=c, pv=b["pv"][:SPECIAL_CELLS].contiguous(),
             footholds=torch.from_numpy(near).to(DEV))
    f = b["footholds"].clone()
    bad = torch.tensor([[float("nan"), 0, 0], [0, float("inf"), 0],
                        [0, 0, -float("inf")], [1e9, 1e9, 1e9]], device=DEV)
    f[3::7] = bad.repeat(f[3::7].shape[0] // 4 + 1, 1)[:f[3::7].shape[0]]
    lv = b["level"]
    return {"nan-inf-1e9": dict(b, footholds=f.contiguous()),
            "no footholds": dict(b, footholds=f[:0].contiguous()),
            "one tile of footholds": dict(
                b, footholds=b["footholds"][:200].contiguous()),
            "every parent valid": dict(b, pv=torch.ones_like(b["pv"])),
            f"big_cell={not lv.big_cell}": dict(
                b, level=lv._replace(big_cell=not lv.big_cell))}


def phase_identity_cells(solve, others=()):
    """K2's cell kernel on the largest batch (by cell x foothold pairs) of
    each identity level 2-6 of phase 8's four deep solves, and on special
    batches: flags against the plain version and against the form it
    replaced (the eager loop launching K2's point kernel per foothold chunk
    and leg), its audit against the plain prefilter, its time in turns with
    that form and beside its bound, and in turns with the cell kernel of
    each build of ``others`` (``--against-leg``).  Returns the rows and the
    mismatching flags counted over every batch."""
    lib = ck._library()
    k2_params = {}

    def k2(x, y, z, consts):  # K2's point kernel, as the old loop called it
        p = k2_params.setdefault(id(consts), ck.dist_params(consts))
        return ck.distance_kernel(x, y, z, consts, p)

    say("phase 11: K2's cell kernel on real identity-level batches; CUDA "
        "events, median of 10 launches, in turns with one run of the eager "
        "form (kernel, eager, kernel)")
    rows = []
    total_bad = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for tag, name in CELL_SOLVES.items():
        for b in solve["cells"][tag][IDENTITY_DEPTHS.start:
                                     IDENTITY_DEPTHS.stop]:
            C, F = b["centers"].shape[0], b["footholds"].shape[0]
            audit = torch.empty((C, 2), dtype=torch.int64, device=DEV)
            got = cells_launch(lib, b, audit)
            t0 = time.perf_counter()
            plain = plain_flags(b, chunk=4096)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            # the eager loop with K2 between two timings of the cell kernel;
            # its one run is also the one compared
            t = [time_cuda(lambda: cells_launch(lib, b), 1, 10)]
            ev[0].record()
            old = plain_flags(b, dist=k2)
            ev[1].record()
            ev[1].synchronize()
            t.append(ev[0].elapsed_time(ev[1]))
            t.append(time_cuda(lambda: cells_launch(lib, b), 1, 10))
            ms, pr4_ms = (t[0] + t[2]) / 2, t[1]
            pre = pre_counts(b)
            bad = int((got != plain).sum()) + int((old != plain).sum())
            total_bad += bad
            check(bad == 0, f"{name} depth {b['depth']}: {bad} flags differ "
                  "between the cell kernel, its plain version and the eager "
                  "loop with K2")
            check(torch.equal(audit[:, 1], pre)
                  and bool((audit[:, 0] == F).all()),
                  f"{name} depth {b['depth']}: the audit is not the plain "
                  "prefilter's count")
            n_in = int(pre.sum())
            bd, by, _, _ = bound_of(C * 16 + F * 12, ck.cells_flops(
                C * F, n_in, b["legs"].leg_flops))
            row = dict(solve=tag, depth=b["depth"], cells=C, footholds=F,
                       pairs=C * F, pairs_in_box=n_in,
                       big_cell=b["level"].big_cell, ms=ms,
                       pr4_form_ms=pr4_ms, plain_s=plain_s, bound_ms=bd,
                       bound_by=by)
            for label, olib in others:
                check(torch.equal(cells_launch(olib, b), got),
                      f"{name} depth {b['depth']}: {label} gives other flags")
                o, h, ratio, tt = in_turns(lambda: cells_launch(olib, b),
                                          lambda: cells_launch(lib, b))
                row.setdefault("in_turns", {})[label] = {
                    "other_ms": o, "this_ms": h, "other_over_this": ratio,
                    "ms": tt}
                say(f"    {label}: flags equal; queued, in turns (other, "
                    f"this, this, other) x 2: {o:.4f} ms against this "
                    f"build's {h:.4f} ms: other / this {ratio:.3f}")
            rows.append(row)
            say(f"  {name} depth {b['depth']}: {C} cells x {F} footholds, "
                f"{n_in} pairs in the box, big_cell {b['level'].big_cell}; "
                f"flags equal (valid {int(got[0].sum())} edge "
                f"{int(got[1].sum())} leaf {int(got[2].sum())}); ms in turns: "
                f"cell kernel {t[0]:.4f}, eager loop with K2 {t[1]:.3f}, cell "
                f"kernel {t[2]:.4f}: {pr4_ms / ms:.1f}x; bound {bd:.4f} ms "
                f"({by}), share {bd / ms:.3f}; plain version {plain_s:.2f} s")
    # the special batches, from a real batch of each quadruped rule
    for tag in ("per-leg", "shared"):
        base = solve["cells"][tag][min(5, len(solve["cells"][tag]) - 1)]
        for label, b in special_batches(base).items():
            plain = plain_flags(b, chunk=4096)
            bad = sum(int((f != plain).sum()) for f in (
                cells_launch(lib, b), plain_flags(b, dist=k2)))
            total_bad += bad
            say(f"  {CELL_SOLVES[tag]} depth {base['depth']}, its first "
                f"{b['centers'].shape[0]} cells over {b['footholds'].shape[0]} "
                f"footholds, {label}: cell kernel == plain version == eager "
                f"loop with K2: mismatches {bad}")
            check(bad == 0, f"{tag} {label}: {bad} mismatching flags")
    tot = {k: sum(r[k] for r in rows) for k in ("ms", "pr4_form_ms",
                                                 "bound_ms")}
    say(f"phase 11: {len(rows)} real batches, {total_bad} mismatching flags; "
        f"summed cell kernel {tot['ms']:.3f} ms against the eager loop's "
        f"{tot['pr4_form_ms']:.1f} ms and a bound of {tot['bound_ms']:.4f} ms")
    for label, _ in others:
        o = sum(r["in_turns"][label]["other_ms"] for r in rows)
        h = sum(r["in_turns"][label]["this_ms"] for r in rows)
        say(f"phase 11: {label} against this build, summed over the "
            f"{len(rows)} batches, queued in turns: {o:.4f} ms against "
            f"{h:.4f} ms: other / this {o / h:.3f}")
    return rows, total_bad


def phase_reach_probe(others=()):
    """K7, the io-only floor of tools/reach_kernel_probe.py, through the
    probe's own function (``python -m legmov_tpu_torch.reach_probe``) at
    16,777,216 points, timed in turns with K1; then held against its plain
    version bit for bit on the same grid with NaN, inf and zero-sum rows,
    on an unaligned view and a ragged length; then K7, K1 and the K1 of
    each build of ``others`` (``--against-leg``) queued, in turns."""
    say("phase 12: the reach probe: K1 and its io-only floor (K7) in turns, "
        f"{N_REACH} points of bench.py's grid, median of 20 launches a round")
    ck.io_only_kernel.launches = 0
    res = reach_probe.probe(N_REACH, 4, say=lambda line: say("  " + line))
    launches = ck.io_only_kernel.launches
    check(launches > 0, "the probe launched no io-only kernel")
    g = reach_probe.make_grid(N_REACH)
    g[:1024] = np.nan
    g[1024:2048, 0] = np.inf
    g[2048:3072, 1] = -np.inf
    g[3072:4096] = [np.inf, -np.inf, 1.0]
    g[4096:8192, 2] = -(g[4096:8192, 0] + g[4096:8192, 1])
    g[8192:9216] = [-0.0, 0.0, -0.0]
    comps = tuple(torch.from_numpy(np.ascontiguousarray(g[:, i])).to(DEV)
                  for i in range(3))
    bad = 0
    for cut in (slice(None), slice(1, None), slice(0, N_REACH - 3),
                slice(5, 4103)):
        part = tuple(c[cut] for c in comps)
        bad += int((ck.io_only_kernel(*part)
                    != ck.io_only_plain(*part)).sum())
    check(bad == 0, f"io-only kernel: {bad} bits differ from its plain "
          "version")
    plain_ms = time_cuda(lambda: ck.io_only_plain(*comps))
    k1, io = res["K1"]["ms"], res["io_only"]["ms"]
    say(f"  io-only == plain version on {N_REACH} points with NaN/inf/zero-"
        f"sum rows, an unaligned view and ragged lengths (0 of "
        f"{4 * N_REACH} bits differ); plain {plain_ms:.4f} ms; bound "
        f"{res['bound_ms']:.4f} ms (bytes): K7 at {res['bound_ms'] / io:.3f}"
        f" of it; K1 {k1:.4f} ms, the floor {io / k1:.3f} of K1 "
        f"({launches} io-only launches by the probe)")
    # the same grid, queued: the card's time a launch, without the
    # wrappers' host time that events around one launch also count
    g = reach_probe.make_grid(N_REACH)
    pc = tuple(torch.from_numpy(np.ascontiguousarray(g[:, i])).to(DEV)
               for i in range(3))
    lib = ck._library()
    rp, _ = leg_params(get_m2_leg())
    floor = lambda: ck.io_only_kernel(*pc)
    here = lambda: reach_call(lib, pc, rp)
    fl, k1q, _, t = in_turns(floor, here)
    say(f"  queued, in turns (K7, K1, K1, K7) x 2: K7 {fl:.4f} ms, K1 "
        f"{k1q:.4f} ms: K1 / floor {k1q / fl:.3f}; K7 at "
        f"{res['bound_ms'] / fl:.3f} of the bound, K1 at "
        f"{res['bound_ms'] / k1q:.3f} (" + ", ".join(f"{x:.4f}" for x in t)
        + ")")
    other_rows = {}
    for label, olib in others:
        o, h, ratio, t = in_turns(lambda: reach_call(olib, pc, rp), here)
        other_rows[label] = {"other_ms": o, "this_ms": h,
                             "other_over_this": ratio,
                             "other_over_floor": o / fl, "ms": t}
        say(f"  queued, in turns with this K1 (other, this, this, other) x "
            f"2: {label} {o:.4f} ms ({o / fl:.3f} of the floor), this K1 "
            f"{h:.4f} ms ({h / fl:.3f}): other / this {ratio:.3f}")
    return {"launches": launches, "max_abs_err": float(bad), "n": N_REACH,
            "ms": io, "plain_ms": plain_ms, "bound_ms": res["bound_ms"],
            "bound_by": "bytes", "k1_ms": k1,
            "k1_over_floor": res["k1_over_floor"],
            "queued_ms": fl, "k1_queued_ms": k1q,
            "k1_over_floor_queued": k1q / fl, "k1_in_turns": other_rows,
            "rounds_ms": res["io_only"]["rounds_ms"],
            "k1_rounds_ms": res["K1"]["rounds_ms"]}


def all_bits_equal(a, b):
    """Whether two float32 tensors hold the same bits everywhere (signed
    zeros apart, NaN against NaN), wherever each lives."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def phase_tables():
    """Tables built on the card equal those built on the CPU, bit for bit:
    ops/trig32.py's functions on 10^6 seeded inputs each, the quaternion
    functions, ``oriented_tables`` of cli map's pose chunk (identity and
    seeded orientations) for the three robots the tests use, and K5's
    level rows; and ``oriented_tables``' time per cli map chunk."""
    say("phase 13: tables on the card == tables on the CPU, bit for bit")
    rng = np.random.default_rng(13)
    n = 1_000_000
    x = np.concatenate([
        rng.uniform(-4 * np.pi, 4 * np.pi, n // 2),
        rng.choice([-1, 1], n // 2) * 10.0 ** rng.uniform(-6, 38, n // 2),
        [0.0, -0.0, np.nan, np.inf, -np.inf, 0.75, 120.0, 1e-40]],
    ).astype(np.float32)
    y = rng.uniform(-2, 2, x.shape[0]).astype(np.float32)
    a = rng.uniform(-1, 1, x.shape[0]).astype(np.float32)
    for name, fn, args in (
            ("sincos", lambda t: torch.stack(trig32.sincos(t)), (x,)),
            ("atan2", trig32.atan2, (y, x)), ("asin", trig32.asin, (a,)),
            ("sqrt", trig32.sqrt, (np.abs(x),))):
        cpu = fn(*(torch.from_numpy(v) for v in args))
        dev = fn(*(torch.from_numpy(v).to(DEV) for v in args))
        check(all_bits_equal(dev, cpu), f"trig32.{name}: card != CPU")
    rpy = rng.uniform(-0.5, 0.5, (2048, 3)).astype(np.float32)
    q_cpu = quat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    q_dev = quat.from_rpy(*(torch.from_numpy(rpy[:, i].copy()).to(DEV)
                            for i in range(3)))
    check(all_bits_equal(q_dev, q_cpu), "from_rpy: card != CPU")
    robots = {"quad_moonbot": make_robot(QUAD_MOUNTS, leg_fn=get_moonbot_leg),
              "quad_m2": make_robot(QUAD_MOUNTS, leg_fn=get_m2_leg),
              "hex_m2": make_robot(HEX_MOUNTS, leg_fn=get_m2_leg)}
    body = torch.from_numpy(
        rng.uniform(-300, 300, (2048, 3)).astype(np.float32))
    ident = torch.tensor([1.0, 0, 0, 0]).repeat(2048, 1)
    times = {}
    for name, robot in robots.items():
        for qname, q in (("identity", ident), ("seeded", q_cpu)):
            want = cm.oriented_tables(body, q, robot)
            got = cm.oriented_tables(body.to(DEV), q.to(DEV), robot)
            check(all_bits_equal(got, want),
                  f"oriented_tables {name} {qname}: card != CPU")
        qs = q_cpu[:27]
        blocks = cmd.leg_blocks(qs.numpy(), robot)
        args = ((20.0,) * 3, (40.0,) * 3, 0.0, 711.0)
        want = cmd.level_table(torch.as_tensor(blocks), qs, *args)
        got = cmd.level_table(torch.as_tensor(blocks).to(DEV), qs.to(DEV),
                              *args)
        check(all_bits_equal(got, want), f"level_table {name}: card != CPU")
        # the time per cli map chunk (2,048 poses, the identity)
        b_d, q_d = body.to(DEV), ident.to(DEV)
        ms = time_cuda(lambda: cm.oriented_tables(b_d, q_d, robot))
        walls = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cm.oriented_tables(b_d, q_d, robot)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        times[name] = (ms, statistics.median(walls))
    say("  trig32 sin/cos/atan2/asin/sqrt on 10^6 inputs each, from_rpy, "
        "oriented_tables (identity and seeded, 2,048 poses) and K5's level "
        "rows of the three robots: card == CPU")
    for name, (ms, wall) in times.items():
        say(f"  oriented_tables per cli map chunk (2,048 poses, {name}): "
            f"{ms:.3f} ms between CUDA events, {wall:.3f} ms host wall "
            "(median of 20)")
    return times


ADAPTIVE_PIX = "2.8"  # 251 x 287 x 251 query points
ADAPTIVE_N = 251 * 287 * 251  # 18,081,287, the JAX package's record grid
ADAPTIVE_JAX_EVALS = 664_163  # that record's evaluations (RESULTS.md:206-214)


def phase_adaptive(tmp):
    """``cli evaluate --adaptive`` at 18,081,287 points (m2 leg): the dense
    evaluate first, then the adaptive one, both through the CLI.  Gates:
    reachability equal to dense K1's on every point; the exact band's
    distances equal to dense K2's bits; every painted vector passes its
    cell's certification test, and the norm difference to dense stays under
    200 mm everywhere and 25 mm at the median (tests/test_cli.py)."""
    say(f"phase 14: cli evaluate --adaptive on the {ADAPTIVE_PIX} mm query "
        f"grid ({ADAPTIVE_N} points), m2 leg")
    data = os.path.join(tmp, "data_adaptive")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["prepare", "--dir", data, "--pix-size", ADAPTIVE_PIX])
    t_prep = time.perf_counter() - t0
    grid = lio.load_points(os.path.join(data, "dist_input_t"))
    n = grid.shape[0]
    check(n == ADAPTIVE_N, f"the {ADAPTIVE_PIX} mm grid has {n} points")
    leg = get_m2_leg()
    comps = tuple(torch.from_numpy(np.ascontiguousarray(grid[:, i])).to(DEV)
                  for i in range(3))
    ck.reachability_kernel.launches = 0
    ck.distance_kernel.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with kernel_clock(("reachability", "distance")) as recs, \
            contextlib.redirect_stdout(buf):
        cli.main(["evaluate", "--dir", data, "--leg", "m2"])
    wall_dense = time.perf_counter() - t0
    dense_launches = (ck.reachability_kernel.launches,
                      ck.distance_kernel.launches)
    check(dense_launches == (1, 1), f"dense evaluate launched {dense_launches}")
    report_clock(f"cli evaluate m2, {n} points (dense)", recs, {
        "reachability": reach_bound(leg), "distance": dist_bound(leg, comps)})
    del comps
    reach_d = lio.load_bools(os.path.join(data, "out_reachability.bin"))
    dist_d = lio.load_points(os.path.join(data, "out_dist_x"))

    got, k2_in = {}, []

    def keep_field(real, *a, **kw):
        got["field"] = real(*a, **kw)
        return got["field"]

    def keep_k2(real, x, y, z, consts, *a, **kw):
        out = real(x, y, z, consts, *a, **kw)
        k2_in.append((x.contiguous(), y.contiguous(), z.contiguous()))
        return out

    ck.reachability_kernel.launches = 0
    ck.distance_kernel.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with intercepted(af, "adaptive_distance_field", keep_field), \
            intercepted(ck, "distance_kernel", keep_k2), \
            kernel_clock(("distance",)) as recs, \
            contextlib.redirect_stdout(buf):
        cli.main(["evaluate", "--dir", data, "--leg", "m2", "--adaptive"])
    wall_ad = time.perf_counter() - t0
    k2_launches = ck.distance_kernel.launches
    check(k2_launches > 0 and ck.reachability_kernel.launches == 0,
          f"the adaptive evaluate launched K2 {k2_launches} times and K1 "
          f"{ck.reachability_kernel.launches} times")
    out = buf.getvalue()
    sys.stdout.write(out)
    consts = ck.dist_consts(leg)

    def k2_bound(rec):
        check(len(rec) == len(k2_in), "K2's records and inputs differ")
        return sum(bound_ms(x.numel(), DIST_BYTES_PER_POINT,
                            ck.dist_flops_needed(x, y, z, consts)
                            / x.numel())[0] for x, y, z in k2_in)

    sums = report_clock(f"cli evaluate --adaptive m2, {n} points", recs,
                        {"distance": k2_bound})
    f = got["field"]
    reach_a = lio.load_bools(os.path.join(data, "out_reachability.bin"))
    dist_a = lio.load_points(os.path.join(data, "out_dist_x"))
    bad = int((reach_a != reach_d).sum())
    check(bad == 0, f"adaptive reachability differs from dense K1 on {bad} "
          "points")
    check(np.array_equal(f.reachable, reach_a), "the written reachability "
          "is not the field's")
    ex = f.exact_mask
    same = dist_a[ex].view(np.int32) == dist_d[ex].view(np.int32)
    check(bool(same.all()), f"the exact band differs from dense K2 on "
          f"{int((~same).sum())} components")
    # a painted vector is its certified cell centre's: its norm clears the
    # cell's half-diagonal plus the 1 mm margin (the certification test, in
    # the field's float32 arithmetic); beside the dense vector it differs by
    # up to about the cell's size (tests/test_cli.py's max and median; the
    # displacement is not 1-Lipschitz everywhere, so the half-diagonal
    # itself is no bound and the points beyond it are counted)
    lo, hi = grid.min(axis=0), grid.max(axis=0)
    root_half = np.maximum(hi - lo, 1e-3) / 2 + 1e-3
    rad = np.array([float(np.linalg.norm((root_half / (1 << d)).astype(
        np.float32))) for d in range(9)])
    thr = np.array([np.float32(r + 1.0) for r in rad], np.float32)
    painted = ~ex
    depth_p = f.depth[painted]
    norm_p = np.linalg.norm(dist_a[painted], axis=1)
    check(bool((depth_p >= 0).all() and (norm_p >= thr[depth_p]).all()),
          "a painted vector fails its cell's certification test")
    dn = np.abs(np.linalg.norm(dist_a, axis=1) - np.linalg.norm(dist_d, axis=1))
    beyond = int((dn[painted] > rad[depth_p]).sum())
    check(dn.max() < 200.0, f"painted distances: max {dn.max()}")
    check(np.median(dn) < 25.0, f"painted distances: median {np.median(dn)}")
    evals = f.evals
    frac = float(ex.mean())
    k2 = PATH_TIMES["distance", f"cli evaluate --adaptive m2, {n} points"]
    say(f"  adaptive: {evals} evaluations ({evals / n:.4f} of N; the JAX "
        f"package's record counts {ADAPTIVE_JAX_EVALS}), exact fraction "
        f"{frac:.4f}, {f.device_reads} device reads (one a level, one for "
        f"the band), reachability equal to dense K1 on all {n} points, the "
        f"exact band's {int(ex.sum())} vectors equal to dense K2 bit for "
        f"bit, painted vectors certified (|norm difference| to dense: max "
        f"{dn.max():.3f} mm, median {np.median(dn):.3f} mm; {beyond} painted "
        f"points beyond their cell's half-diagonal)")
    say(f"  walls: prepare {t_prep:.1f} s, dense evaluate {wall_dense:.3f} s, "
        f"adaptive evaluate {wall_ad:.3f} s; K2 on the adaptive path "
        f"{k2_launches} launches, {sums['distance']:.3f} ms (bound "
        f"{k2['bound_ms']:.3f} ms)")
    return {"n": n, "evals": evals, "exact_fraction": frac,
            "device_reads": f.device_reads, "painted_beyond_half_diagonal":
            beyond, "max_norm_difference_mm": float(dn.max()), "wall_dense_s": wall_dense,
            "wall_adaptive_s": wall_ad, "k2_launches": k2_launches,
            "k2_ms": sums["distance"], "k2_bound_ms": k2["bound_ms"]}


DENSE_POINTS = (1_000_000, 10_240_000)
DENSE_POSES = 2048


def dense_run(terrain_of, points, solver, decide, reps, count_k3=False):
    """``python -m legmov_tpu_torch.map_bench --points N --poses 2048
    --solver S --decide D --reps R`` (terrain generated once a size), with
    the launch counts set to 0 just before and read just after.  Returns
    the JSON line, the last pass's (legs, quorum, overflow), the launches,
    the launch records, the first K3 step (inputs and output) and, with
    ``count_k3``, what decides each K3 launch."""
    passes, first, k3_calls = [], {}, []

    def keep_chunks(real, *a, **kw):
        out = real(*a, **kw)
        passes.append(out)
        return out

    def keep_k3(real, tab, gx, gy, gz, legs_in, consts, *a, **kw):
        out = real(tab, gx, gy, gz, legs_in, consts, *a, **kw)
        on_dev = out.device.type == DEV.type
        if on_dev and "step" not in first and gx.numel():
            first["step"] = (tab.clone(), gx.clone(), gy.clone(), gz.clone(),
                             legs_in.clone(), consts, out.clone())
        if count_k3 and on_dev and out.numel():
            k3_calls.append((cm.multileg_need(tab, gx, gy, gz, consts,
                                              legs_in), consts,
                             tab.numel() * 4 + gx.shape[0] * 8, gx.shape))
        return out

    cm.multileg_kernel.launches = 0
    cm.csr_round_kernel.launches = 0
    buf = io.StringIO()
    with intercepted(map_bench, "terrain_at", terrain_of), \
            intercepted(map_bench, "run_chunks", keep_chunks), \
            intercepted(cm, "multileg_kernel", keep_k3), \
            kernel_clock(("multileg", "csr_round")) as recs, \
            contextlib.redirect_stdout(buf):
        map_bench.main(["--points", str(points), "--poses", str(DENSE_POSES),
                        "--solver", solver, "--decide", decide, "--reps",
                        str(reps)])
    torch.cuda.synchronize()
    launches = {"multileg": cm.multileg_kernel.launches,
                "csr_round": cm.csr_round_kernel.launches}
    lines = buf.getvalue().strip().splitlines()
    line = json.loads(lines[-1])
    check(len(passes) == reps + 1, f"{solver}: {len(passes)} passes")
    return (line, passes[-1][:3], launches, recs, first.get("step"), k3_calls,
            lines[:-1])


def k3_step_equals_plain(step, rows=128):
    """One gathered K3 step of a solver against the plain version, in row
    blocks (the rows are independent)."""
    tab, gx, gy, gz, legs_in, consts, out = step
    bad = 0
    for lo in range(0, gx.shape[0], rows):
        sl = slice(lo, lo + rows)
        want = cm.multileg_kernel_plain(tab[sl], gx[sl], gy[sl], gz[sl],
                                        consts, legs_in[sl])
        bad += int((want != out[sl]).sum())
    return bad, tuple(gx.shape)


def phase_dense_tables(terrain10):
    """map_bench's dense-table solvers (``fused``, ``adaptive``) beside
    ``csr-dma`` on the same 2,048 poses at 1 M and 10.24 M points (hexapod
    m2, quorum of all legs), each through ``python -m
    legmov_tpu_torch.map_bench``.  Gates: under ``--decide legs`` the three
    give the same legs and quorum where no overflow is reported; one
    gathered K3 step of each dense solver equals the plain version; under
    ``--decide quorum`` the adaptive solver's quorum equals csr-dma's."""
    say(f"phase 15: map_bench dense-table solvers against csr-dma, hexapod "
        f"m2, k = 6, {DENSE_POSES} poses, at {DENSE_POINTS} points")
    terrains = {map_bench.terrain_side(MAP_POINTS): terrain10}

    def terrain_of(real, n):
        side = map_bench.terrain_side(n)
        if side not in terrains:
            terrains[side] = real(n)
        return terrains[side]

    rows = {}
    for points in DENSE_POINTS:
        res = {}
        for solver in ("fused", "adaptive", "csr-dma"):
            line, out, launches, recs, step, _, notes = dense_run(
                terrain_of, points, solver, "legs", 3)
            path = f"map_bench --solver {solver}, {line['terrain_points']} " \
                "points"
            sums = report_clock(path, recs)
            kern = "csr_round" if solver == "csr-dma" else "multileg"
            other = "multileg" if solver == "csr-dma" else "csr_round"
            check(launches[kern] > 0 and launches[other] == 0,
                  f"{solver} at {points}: launches {launches}")
            res[solver] = dict(line=line, out=out, launches=launches,
                               ms=sums.get(kern, 0.0), step=step,
                               notes=notes, path=path)
        n_pts = res["fused"]["line"]["terrain_points"]
        (lf, qf, of), (la, qa, oa), (lc, qc, oc) = (
            res[s]["out"] for s in ("fused", "adaptive", "csr-dma"))
        # adaptive and csr-dma are exact whatever their overflow says (the
        # safety round); fused is exact where top_k held every occupied cell
        check(np.array_equal(la, lc) and np.array_equal(qa, qc),
              f"{n_pts} points: adaptive and csr-dma legs differ on "
              f"{int((la != lc).sum())} bits")
        check(not of, f"{n_pts} points: the fused solver overflowed top_k")
        check(np.array_equal(lf, lc) and np.array_equal(qf, qc),
              f"{n_pts} points: fused and csr-dma legs differ on "
              f"{int((lf != lc).sum())} bits")
        steps = {}
        for solver in ("fused", "adaptive"):
            bad, shape = k3_step_equals_plain(res[solver]["step"])
            check(bad == 0, f"{solver} at {n_pts}: a K3 step differs from "
                  f"the plain version on {bad} bits")
            steps[solver] = shape
            res[solver]["step"] = None
        # K3's bound from what decides each launch, counted on a run of one
        # timed pass (the counts read the device between launches); the
        # timed run's four passes are the same solve, twice the count's two
        for solver in ("fused", "adaptive"):
            _, out, _, _, _, calls, _ = dense_run(terrain_of, points, solver,
                                                  "legs", 1, count_k3=True)
            check(np.array_equal(out[0], res[solver]["out"][0]),
                  f"{solver}: the counted run differs")
            lo3, hi3 = k3_bounds(calls)
            kept = PATH_TIMES["multileg", res[solver]["path"]]
            kept.update(bound_ms=2 * lo3, bound_ms_every_leg=2 * hi3)
            res[solver]["bound_ms"] = 2 * lo3
            say(f"    K3's bound on {res[solver]['path']}: what decides each "
                f"launch's output {2 * lo3:.3f} ms (share "
                f"{2 * lo3 / kept['ms']:.3f} of {kept['ms']:.3f} ms); every "
                f"leg on every candidate {2 * hi3:.3f} ms")
        quorum = {}
        for solver in ("adaptive", "csr-dma"):
            _, out, _, _, _, _, _ = dense_run(terrain_of, points, solver,
                                              "quorum", 1)
            quorum[solver] = out
        check(np.array_equal(quorum["adaptive"][1], quorum["csr-dma"][1]),
              f"{n_pts} points, decide quorum: adaptive and csr-dma quorum "
              "differ")
        check(np.array_equal(quorum["adaptive"][1], qc),
              f"{n_pts} points: the quorum of decide quorum and decide legs "
              "differ")
        check(not (quorum["adaptive"][0] & ~lc).any(),
              "decide quorum reported a leg that decide legs does not")
        for solver in ("fused", "adaptive", "csr-dma"):
            r, line = res[solver], res[solver]["line"]
            extra = (f", dense table {line['dense_table_mb']} MB on the card,"
                     f" top_k {line['top_k']}" if "dense_table_mb" in line
                     else f", CSR {line['csr_device_mb']} MB on the card")
            say(f"  {n_pts} points, {solver} (decide legs): "
                f"{line['value']} poses/s, feasible {line['feasible_poses']}"
                f", overflow {line['overflow']}, wall {line['solve_wall_s']} s"
                f", device {line['solve_device_ms']} ms, host syncs a chunk "
                f"{line['host_syncs_per_chunk']}, kernel launches a chunk "
                f"{line['kernel_launches_per_chunk']}{extra}")
        say(f"  {n_pts} points: legs and quorum equal across fused, adaptive "
            f"and csr-dma ({int(qc.sum())} feasible of {qc.size}); one K3 "
            f"step of each dense solver == plain ({steps}); decide quorum: "
            f"adaptive == csr-dma quorum")
        rows[n_pts] = {s: {k: v for k, v in res[s].items()
                           if k not in ("out", "step", "notes")}
                       for s in res}
    return rows


# ---------------------------------------------------------------------------
# phases 16 and 17: the parallel layer and the fuzzers
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
#: kernels each new path must launch
DRYRUN_KERNELS = ("reachability", "distance", "distance_cells", "multileg",
                  "csr_round", "item_cells", "cell_quat_major", "cell_shared")
MESH_KERNELS = {"per-leg": ("distance_cells", "cell_quat_major"),
                "shared": ("distance_cells", "cell_shared")}
FUZZ_KERNELS = {"solver_fuzz": ("multileg", "csr_round"),
                "hier_fuzz": ("distance_cells", "cell_quat_major",
                              "cell_shared")}


def rank_paths(path, res, names):
    """Launches and summed kernel ms of the cases ``names`` of a
    ``dryrun.spawn`` result, summed over its ranks, kept in PATH_TIMES."""
    sums = {}
    for r in res:
        for name in names:
            case = r["cases"][name]
            for key, n in case["launches"].items():
                v = sums.setdefault(key, {"launches": 0, "ms": 0.0,
                                          "bound_ms": None})
                v["launches"] += n
                v["ms"] += case["kernel_ms"].get(key, 0.0)
    for key, v in sums.items():
        PATH_TIMES[key, path] = v
    say(f"    kernel time on {path} (summed over {len(res)} ranks): "
        + "; ".join(f"{KERNEL_IDS[k]} {v['launches']} launches "
                    f"{v['ms']:.3f} ms" for k, v in sorted(sums.items())))
    return sums


def run_module(*argv, timeout=600):
    """``python -m <argv>`` from the repository's root; its output lines
    are printed, and a non-zero exit fails the run."""
    t0 = time.perf_counter()
    # a session of its own: at the time limit the module and every process
    # it started are stopped together
    p = subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
    for line in (out + err).strip().splitlines():
        say("    " + line)
    check(p.returncode == 0, f"python -m {' '.join(argv)} exited "
          f"{p.returncode}")
    return out, time.perf_counter() - t0


def phase_parallel(terrain, deep, phase8, smi):
    """The parallel layer on the card, with its ranks as new processes
    sharing cuda:0 over gloo."""
    say("phase 16: the parallel layer (legmov_tpu_torch/parallel/), ranks "
        "on cuda:0 over gloo: they share one card, so this checks the "
        "splits, the collectives and the bits with the real kernels, not "
        f"multi-card scaling ({smi})")
    robot = make_robot(QUAD_MOUNTS)
    box, depth, min_box = (float(deep[1]), int(deep[3]), float(deep[5]))
    cfg = dict(box_center=tuple(np.median(terrain, axis=0).tolist()),
               box_size=(box,) * 3, max_depth=depth, min_box=(min_box,) * 3,
               enable_rot_below=50.0, legs_for_stability=4)
    modes = ("per-leg", "shared")
    single = {}
    if phase8 is None:
        # phase 8 did not run: the single-rank solves run here
        for mode in modes:
            t0 = time.perf_counter()
            rec = hs.solve_positionability(
                terrain, robot, SolverConfig(**cfg), cell_batch=1024,
                shared_foothold=mode == "shared")
            single[mode] = (rec, time.perf_counter() - t0)
    else:
        single = phase8
    cases = [dict(name=f"mesh solve {mode}", kind="solve", footholds=terrain,
                  robot=robot, cfg=cfg, single=False,
                  kw=dict(cell_batch=1024, shared_foothold=mode == "shared"))
             for mode in modes]
    t0 = time.perf_counter()
    res = dryrun.spawn(dryrun.dryrun_cases(2) + cases, 2, clock=True)
    say(f"  dryrun --ranks 2 and the mesh solves: {time.perf_counter() - t0:.1f}"
        " s with the spawn of 2 ranks")
    for line in dryrun.summary(res):
        say("    " + line)
    names = [c["name"] for c in dryrun.dryrun_cases(2)]
    sums = rank_paths("python -m legmov_tpu_torch.dryrun --ranks 2", res, names)
    for key in DRYRUN_KERNELS:
        check(sums.get(key, {}).get("launches", 0) > 0,
              f"dryrun --ranks 2: {key} was launched no time")
    want = SOLVE_COUNTS
    for mode in modes:
        name = f"mesh solve {mode}"
        rec, t_single = single[mode]
        for r in res:
            case = r["cases"][name]
            info = case["info"]
            got = case["values"][0]
            check(all(np.array_equal(g, getattr(rec, f))
                      for g, f in zip(got, dryrun.RECORD)),
                  f"{name}: rank {r['rank']}'s record differs from the "
                  "single-rank solve's")
            check(info["host_syncs"] == info["levels"]
                  and info["collectives"] == info["levels"],
                  f"{name}: rank {r['rank']}: {info}")
            if deep == DEEP:
                check(info["levels"] == 8 and info["host_syncs"] == 8,
                      f"{name}: rank {r['rank']}: {info['host_syncs']} host "
                      "syncs, not 8")
                check((info["cells"], info["valid"], info["edge"])
                      == want[mode], f"{name}: counts {info}")
        walls = [r["cases"][name]["sharded_s"] for r in res]
        say(f"  {name} over 2 ranks ({' '.join(deep)}): cells "
            f"{info['cells']} valid {info['valid']} edge {info['edge']}, "
            f"equal to the single-rank record bit for bit on both ranks; "
            f"host syncs {[r['cases'][name]['info']['host_syncs'] for r in res]}"
            f", collectives {[r['cases'][name]['info']['collectives'] for r in res]}"
            f"; wall {max(walls):.3f} s (ranks {', '.join(f'{w:.3f}' for w in walls)})"
            f" beside {t_single:.3f} s single-rank"
            + (" (phase 8)" if phase8 is not None else ""))
        sums = rank_paths(f"cli solve {' '.join(deep)} --mode {mode}, mesh of "
                          "2 ranks", res, [name])
        for key in MESH_KERNELS[mode]:
            check(sums.get(key, {}).get("launches", 0) > 0,
                  f"{name}: {key} was launched no time")
    res = None
    t0 = time.perf_counter()
    res4 = dryrun.spawn(dryrun.dryrun_cases(4), 4, clock=True)
    say(f"  dryrun --ranks 4: {time.perf_counter() - t0:.1f} s with the spawn "
        "of 4 ranks")
    for line in dryrun.summary(res4):
        say("    " + line)
    sums = rank_paths("python -m legmov_tpu_torch.dryrun --ranks 4", res4,
                      list(res4[0]["cases"]))
    for key in DRYRUN_KERNELS:
        check(sums.get(key, {}).get("launches", 0) > 0,
              f"dryrun --ranks 4: {key} was launched no time")
    for extra, limit in (((), 120), (("--scale",), 300)):
        out, wall = run_module("legmov_tpu_torch.multihost_dryrun", *extra,
                               timeout=limit)
        check("MULTIHOST OK" in out, "multihost_dryrun did not end OK")
        say(f"  multihost_dryrun {' '.join(extra)}: {wall:.1f} s with its two "
            "processes")
    # 256 poses: the plain path builds every pose's workspace tables with
    # launches of their own, host-bound on the card
    out, wall = run_module("legmov_tpu_torch.scaling_bench", "--max-ranks",
                           "2", "--poses", "256", "--reps", "3", timeout=300)
    runs = json.loads(out.strip().splitlines()[-1])["results"]
    check([r["ranks"] for r in runs] == [1, 2]
          and runs[0]["feasible"] == runs[1]["feasible"],
          f"scaling_bench: {runs}")
    say(f"  scaling_bench: {wall:.1f} s; 1 rank {runs[0]['seconds']:.4f} s, "
        f"2 ranks on the one card {runs[1]['seconds']:.4f} s (contention, not "
        "scaling)")


def phase_fuzz():
    """Both fuzzers in this process, on the card: every trial line."""
    say("phase 17: the solver fuzzers on the card (kernels against the "
        "exhaustive path and the eager evaluator)")
    for name, mod, argv in (("solver_fuzz", solver_fuzz, ("--trials", "12")),
                            ("hier_fuzz", hier_fuzz, ("--trials", "8"))):
        zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with kernel_clock() as recs, contextlib.redirect_stdout(buf):
            rc = mod.main(list(argv))
        wall = time.perf_counter() - t0
        launches = profiling.launch_counts()
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            say("    " + line)
        check(rc == 0 and not any(l.startswith("FAIL") for l in lines),
              f"{name}: a trial failed")
        path = f"python -m legmov_tpu_torch.{name} {' '.join(argv)}"
        report_clock(path, recs)
        for key in FUZZ_KERNELS[name]:
            check(launches[key] > 0 and launches[key] == len(recs[key]),
                  f"{name}: {key} launches {launches[key]}")
        say(f"  {name}: {lines[-1]} in {wall:.1f} s; launches "
            + json.dumps({k: n for k, n in launches.items() if n}))


#: tibia length -> the committed landmarks of ref_image_check
REFCHECK = {135.0: "bdata/refcheck/landmarks.json",
            160.0: "bdata/refcheck_hist/landmarks.json"}
LIVE_FRAMES = 60  # live_view's default, at its default 1920 x 1080
VIEW_POINTS = 1_000_000  # visualize_solve's default terrain
#: bench_sweep runs of phase 18, each with its own reps and largest size
SWEEP_RUNS = (
    ("--impl", "kernel", "--reps", "5"),
    ("--impl", "plain", "--device", "cuda", "--reps", "2",
     "--max-points", "16544544"),
    ("--impl", "plain", "--device", "cpu", "--reps", "3",
     "--max-points", "1034152"),
    ("--impl", "oracle", "--device", "cpu", "--reps", "2",
     "--max-points", "16166", "--cpu-point-cap", "200"),
    ("--impl", "ik", "--device", "cpu", "--reps", "2",
     "--max-points", "10560"),
)
SWEEP_SIZES = [72, 280, 1035, 4110, 16166, 64664, 258656, 1034152, 4136608,
               16544544, 66160650]


def zero_counts():
    for m, f in profiling.COUNTERS.values():
        getattr(m, f).launches = 0


def quiet(fn, *a):
    """``fn(*a)`` with its output kept; the lines are printed indented."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a)
    for line in buf.getvalue().strip().splitlines():
        say("    " + line)
    return out


def dist_need_bound(inputs):
    """K2's summed bound over launches on ``inputs`` [(x, y, z, consts)],
    in launch order: the operations those points need."""
    def bound(rec):
        check(len(rec) == len(inputs), "K2's records and inputs differ")
        return sum(bound_ms(x.numel(), DIST_BYTES_PER_POINT,
                            ck.dist_flops_needed(x, y, z, c) / x.numel())[0]
                   for x, y, z, c in inputs)
    return bound


def phase_ref_image_check(tmp, smi):
    """``python -m legmov_tpu_torch.ref_image_check`` at tibia 135 and 160:
    the landmarks equal to the committed records, K1's and K2's outputs on
    both slices equal to their plain versions on the card bit for bit."""
    for tibia, record in REFCHECK.items():
        leg = get_m2_leg()
        argv = ["--out", os.path.join(tmp, f"refcheck_{tibia:g}")]
        if tibia != float(leg.tibia_length):
            leg = leg._replace(tibia_length=np.float32(tibia))
            argv += ["--tibia", f"{tibia:g}"]
        zero_counts()
        with kernel_clock(("reachability", "distance")) as recs:
            report, arrays = quiet(ref_image_check.main, argv)
        launches = profiling.launch_counts()
        with open(os.path.join(REPO, record)) as f:
            want = json.load(f)
        with open(os.path.join(argv[1], "landmarks.json")) as f:
            got = json.load(f)
        check(got == report and got["tibia_length"] == tibia
              and want.get("tibia_length", tibia) == tibia,
              f"ref_image_check tibia {tibia:g}: {got}")
        for name in ("side", "top"):
            check(got[name] == want[name], f"ref_image_check tibia {tibia:g}, "
                  f"{name}: {got[name]} against {record}'s {want[name]}")
        inputs, bad = [], 0
        for name, (pts, reach, vec) in arrays.items():
            x, y, z = (torch.from_numpy(np.ascontiguousarray(pts[:, i])).to(DEV)
                       for i in range(3))
            dc = ck.dist_consts(leg)
            inputs.append((x, y, z, dc))
            want_r = ck.reachability_kernel_plain(x, y, z, ck.reach_consts(leg))
            _, dx, dy, dz = ck.distance_kernel_plain(x, y, z, dc)
            bad += int((torch.from_numpy(reach).to(DEV) != want_r).sum())
            bad += int((~same_bits(torch.from_numpy(vec).to(DEV),
                                   torch.stack([dx, dy, dz], -1))).sum())
        check(bad == 0, f"ref_image_check tibia {tibia:g}: {bad} elements "
              "differ from the plain versions")
        check(launches["reachability"] == 2 == len(recs["reachability"])
              and launches["distance"] == 2 == len(recs["distance"]),
              f"ref_image_check: launches {launches}")
        report_clock(f"python -m legmov_tpu_torch.ref_image_check "
                     f"{' '.join(argv[2:])}".strip(), recs,
                     {"reachability": reach_bound(leg),
                      "distance": dist_need_bound(inputs)})
        say(f"  ref_image_check tibia {tibia:g} ({smi}): landmarks equal to "
            f"{record} on side and top (side notch {got['side'].get('notch_xz')}"
            f", areas {got['side']['area_mm2']:g} / {got['top']['area_mm2']:g}"
            f" mm^2); K1 and K2 on both slices ({arrays['side'][0].shape[0]} "
            f"and {arrays['top'][0].shape[0]} points) equal to their plain "
            "versions bit for bit")


def phase_live_view(tmp, smi):
    """``python -m legmov_tpu_torch.live_view`` headless at its defaults:
    the fps, K2 launched once a frame (the warm one included), the middle
    frame equal to the plain version's on the card bit for bit."""
    argv = ["--out", os.path.join(tmp, "live_view")]
    zero_counts()
    res = quiet(live_view.main, argv)
    check(res["launches"] == LIVE_FRAMES + 1 == ck.distance_kernel.launches,
          f"live_view: {ck.distance_kernel.launches} K2 launches for "
          f"{LIVE_FRAMES} frames and the warm one")
    # the same run under the clock, for the path's kernel time
    leg = get_m2_leg()
    frame = live_view.make_frame_fn(leg, 1920, 1080, 0.5, DEV)
    cuts = np.linspace(-400, 400, LIVE_FRAMES).astype(np.float32)
    zero_counts()
    with kernel_clock(("distance",)) as recs:
        quiet(live_view.main, argv)
    dc = ck.dist_consts(leg)
    inputs = [(*frame.points(c, True), dc) for c in [cuts[0], *cuts]]
    report_clock("python -m legmov_tpu_torch.live_view (1920 x 1080, 60 "
                 "frames, a second run under the clock)", recs,
                 {"distance": dist_need_bound(inputs)})
    inputs = None
    mid = cuts[len(cuts) // 2]
    for axis_is_z in (True, False):
        got, want = frame(mid, axis_is_z), frame.plain(mid, axis_is_z)
        bad = int((~same_bits(got, want)).sum())
        check(bad == 0, f"live_view: the middle frame differs from the plain "
              f"version's on {bad} pixels (axis_is_z {axis_is_z})")
    say(f"  live_view: {res['fps']:.1f} fps at 1920 x 1080 (2,073,600 points "
        f"a frame), {LIVE_FRAMES} frames in {res['seconds']:.4f} s on {smi}; "
        f"K2 launches {res['launches']} = the frames and the warm one; the "
        f"middle frame (cut {mid:g} mm, both axes) equal to the plain "
        "version's bit for bit")
    return res


def phase_visualize_solve(smi):
    """``python -m legmov_tpu_torch.visualize_solve`` at its defaults: K3's
    feasible mask equal to ``grid_reachable_legs`` on the card, bit for
    bit, no overflow (the solver raises on one), K3's launches and summed
    ms."""
    zero_counts()
    with kernel_clock(("multileg",)) as recs:
        res = quiet(visualize_solve.main, [])
    launches = cm.multileg_kernel.launches
    check(launches > 0 and launches == len(recs["multileg"]),
          f"visualize_solve: K3 launches {launches}")
    sums = report_clock("python -m legmov_tpu_torch.visualize_solve "
                        "(1,048,576 footholds, hexapod, k = 6, 3,200 poses)",
                        recs)
    terrain = map_bench.terrain_at(VIEW_POINTS)
    robot = make_robot(HEX_MOUNTS)
    reach = cell_size_for(robot)
    grid = build_grid(terrain, reach / 2, device=DEV)
    offsets = neighbor_offsets(reach / 2, reach)
    body = res["body"]
    _, _, _, lattice = visualize_solve.body_lattice(terrain, 100.0, 180.0)
    check(body.shape == (3200, 3) and np.array_equal(body, lattice),
          f"visualize_solve: {body.shape[0]} poses")
    t0 = time.perf_counter()
    want, legs = visualize_solve.feasible(
        visualize_solve.make_solver(grid, robot, 6, offsets, kernel=False),
        body, 1024, DEV)
    t_plain = time.perf_counter() - t0
    bad = int((want != res["feasible"]).sum())
    bad_legs = int((legs != res["legs"]).sum())
    check(bad == 0 and bad_legs == 0, f"visualize_solve: K3's mask differs "
          f"from grid_reachable_legs on {bad} poses, its leg bits on "
          f"{bad_legs}")
    say(f"  visualize_solve ({smi}): {body.shape[0]} poses over "
        f"{res['footholds']} footholds, {int(res['feasible'].sum())} feasible "
        f"({res['feasible'].mean():.4f}), mask and leg bits equal to "
        f"grid_reachable_legs on the card bit for bit ({t_plain:.3f} s), 0 overflow with top_k = "
        f"{offsets.shape[0]} offsets; wall {res['seconds']:.3f} s under the "
        f"clock, K3 {launches} launches {sums['multileg']:.3f} ms")
    return res


def phase_circle_figure(smi):
    """``python -m legmov_tpu_torch.circle_figure`` for both legs: the
    validity grid on the card equal to the CPU's, the same circles."""
    for name in ("m2", "moonbot"):
        data = quiet(circle_figure.main, ["--leg", name, "--out", os.devnull])
        cpu = circle_figure.figure_data(LEGS[name](), "cpu")
        check(np.array_equal(data["valid"], cpu["valid"])
              and data["circles"] == cpu["circles"],
              f"circle_figure {name}: the card's grid or circles differ "
              "from the CPU's")
        say(f"  circle_figure {name} ({smi}): the {circle_figure.SIDE}^2 "
            "validity grid on the card equal to the CPU's, "
            f"{len(data['circles'])} circles")


def sweep_flops(which, n):
    """K1's or K2's operations a point on the sweep grid of ``n`` points
    (m2 leg): K1's count is the same for every point, K2's what these
    points need (``ck.dist_flops_needed``, on the card in slices)."""
    leg = get_m2_leg()
    if which == "reach":
        return ck.reach_flops_per_point(ck.reach_consts(leg))
    pix = next(p for p in bench_sweep.ref_pitches()
               if bench_sweep.grid_size(p) == n)
    pts = bench_sweep.ref_grid(pix)
    dc, need = ck.dist_consts(leg), 0
    for lo in range(0, n, 1 << 24):
        x, y, z = (torch.from_numpy(np.ascontiguousarray(
            pts[lo:lo + (1 << 24), i])).to(DEV) for i in range(3))
        need += ck.dist_flops_needed(x, y, z, dc)
    return need / n


def phase_sweep(tmp, smi):
    """``python -m legmov_tpu_torch.bench_sweep``: K1 and K2 over the
    reference protocol's 11 sizes, the plain path on the card and on the
    CPU, the oracle twin and the LM-IK baseline capped small, then
    ``bench_report`` over the directory."""
    out = os.path.join(tmp, "sweep")
    for argv in SWEEP_RUNS:
        zero_counts()
        t0 = time.perf_counter()
        res = quiet(bench_sweep.main, [*argv, "--out", out])
        wall = time.perf_counter() - t0
        launches = profiling.launch_counts()
        say(f"  bench_sweep {' '.join(argv)}: {wall:.1f} s")
        if argv[1] != "kernel":
            continue
        for which, key, csv, per_pt in (
                ("reach", "reachability", "rgpu.csv", REACH_BYTES_PER_POINT),
                ("dist", "distance", "dgpu.csv", DIST_BYTES_PER_POINT)):
            rows = res[csv]
            check([r["n"] for r in rows] == SWEEP_SIZES,
                  f"bench_sweep {which}: sizes {[r['n'] for r in rows]}")
            check(launches[key] == sum(r["iters"] * len(r["ns"]) + 1
                                       for r in rows),
                  f"bench_sweep {which}: {launches[key]} launches")
            flops = {r["n"]: sweep_flops(which, r["n"]) for r in rows}
            PATH_TIMES[key, "python -m legmov_tpu_torch.bench_sweep --impl "
                       "kernel (the 11 sizes; ms over the timed reps)"] = {
                "launches": launches[key],
                "ms": sum(sum(r["ns"]) * r["n"] * r["iters"] for r in rows)
                / 1e6,
                "bound_ms": sum(bound_ms(r["n"], per_pt, flops[r["n"]])[0]
                                * r["iters"] * len(r["ns"]) for r in rows)}
            say(f"    {KERNEL_IDS[key]} ns a point, median of "
                f"{len(rows[0]['ns'])} reps, at the 11 sizes ({smi}): "
                + ", ".join(f"{r['n']}: {statistics.median(r['ns']):.4f}"
                            for r in rows))
    rep = quiet(bench_report.main, ["--ours", out, "--out",
                                    os.path.join(out, "report.png")])
    check(any(line.startswith("speed-up of K1 reach") for line in rep["lines"])
          and any(line.startswith("speed-up of K2 dist")
                  for line in rep["lines"]),
          "bench_report printed no speed-up of the kernels")
    say(f"  bench_report: the lines above; the card {smi}, the host CPU "
        f"{profiling.cpu_model()} ({torch.get_num_threads()} threads)")


def phase_viewers_and_sweep(smi):
    """Phase 18: the viewers and the N-sweep, each through its entry point,
    with the launch counts set to 0 just before and read just after."""
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    say(f"phase 18: the viewers (ref_image_check, live_view, visualize_solve,"
        f" circle_figure) and the N-sweep (bench_sweep, bench_report) on "
        f"{smi}; matplotlib "
        + ("present: images written" if have_mpl else
           "absent: no image written, every number computed all the same"))
    with tempfile.TemporaryDirectory(prefix="legmov_smoke_") as tmp:
        phase_ref_image_check(tmp, smi)
        live = phase_live_view(tmp, smi)
        phase_visualize_solve(smi)
        phase_circle_figure(smi)
        phase_sweep(tmp, smi)
    return live


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18",
                    help="comma-separated phases to run (1 always runs; 3 "
                    "and 4 need 2, 7 needs 6, 9, 10 and 11 need 8)")
    ap.add_argument("--quick", action="store_true",
                    help="phase 8's deep solves on a quarter of the box")
    ap.add_argument("--against", action="append", default=[],
                    metavar="CELL_KERNELS_CU",
                    help="phase 10 also times the kernels built from this "
                    "source (an earlier cell_kernels.cu), in turns with "
                    "this tree's; repeatable")
    ap.add_argument("--against-leg", action="append", default=[],
                    metavar="LEG_KERNELS_CU",
                    help="phases 4, 11 and 12 also time K1, K2's point and "
                    "cell kernels built from this source (an earlier "
                    "leg_kernels.cu, optionally followed by nvcc flags in "
                    "the same argument), in turns with this tree's, and "
                    "phase 3 holds their outputs to this tree's bit for "
                    "bit; repeatable")
    ap.add_argument("--against-multileg", action="append", default=[],
                    metavar="MULTILEG_KERNELS_CU",
                    help="phases 5 and 7 also time K3 (on `cli map --solver "
                    "csr` and alone) and K4 (alone) built from this source "
                    "(an earlier multileg_kernels.cu), in turns with this "
                    "tree's; repeatable")
    args = ap.parse_args(argv)
    on = {int(p) for p in args.phases.split(",")} | {1}
    whole = on >= set(range(1, 19)) and not args.quick

    t_start = time.perf_counter()
    clock = [t_start]

    def took(n):
        now = time.perf_counter()
        say(f"phase {n} took {now - clock[0]:.1f} s (run at {now - t_start:.1f} "
            "s)")
        clock[0] = now

    smi, occupancy = phase_device_and_build()
    leg_others = leg_builds(args.against_leg)
    took(1)
    launches = map_launches = worst = rows = row3 = row4 = row_round = None
    solve = gates = cell_rows = ident_rows = ident_bad = scale = None
    with tempfile.TemporaryDirectory(prefix="legmov_smoke_") as tmp:
        data = os.path.join(tmp, "data")
        if 2 in on:
            launches, cli_grid, cli_results = phase_cli(tmp)
            took(2)
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["prepare", "--dir", data, "--pix-size", "20"])
        if 5 in on:
            map_launches = phase_cli_map(data, args.against_multileg)
            took(5)
        if 8 in on:
            solve = phase_cli_solve(data, args.quick)
            took(8)
        terrain = lio.load_points(os.path.join(data, "numpy_input_t"))
    if 3 in on:
        worst = phase_compare(cli_grid, cli_results, leg_others)
        took(3)
    if 4 in on:
        rows = phase_timing(cli_grid, leg_others)
        took(4)
    cli_grid = cli_results = None
    torch.cuda.empty_cache()
    if 9 in on:
        gates = phase_solve_gates(solve, terrain)
        took(9)
    if 10 in on:
        cell_rows = phase_cell_kernels(solve, gates, terrain, args.against)
        took(10)
    if 11 in on:
        ident_rows, ident_bad = phase_identity_cells(solve, leg_others)
        took(11)
    solve_launches_ = solve["launches"] if solve else None
    cm_turns = solve["cm_every_batch"] if solve else None
    phase8 = ({mode: (solve[mode]["record"], solve["seconds"][mode])
               for mode in ("per-leg", "shared")} if solve else None)
    solve = None
    torch.cuda.empty_cache()
    if 6 in on:
        scale = phase_map_scale()
        took(6)
    if 7 in on:
        row3, row4, row_round = phase_multileg_kernels(
            scale, scale["round_bad"] + (map_launches or {}).get("round_bad", 0),
            args.against_multileg)
        took(7)
    probe = None
    if 12 in on:
        probe = phase_reach_probe(leg_others)
        took(12)
    if 13 in on:
        phase_tables()
        took(13)
    adaptive = dense = None
    if 14 in on:
        with tempfile.TemporaryDirectory(prefix="legmov_smoke_") as tmp:
            adaptive = phase_adaptive(tmp)
        took(14)
    if 15 in on:
        if scale is not None:
            terrain10 = scale.pop("terrain")
            for key in ("csr", "rounds"):  # free the card for the tables
                scale.pop(key)
        else:
            terrain10 = map_bench.terrain_at(MAP_POINTS)
        torch.cuda.empty_cache()
        dense = phase_dense_tables(terrain10)
        took(15)
    terrain10 = None
    torch.cuda.empty_cache()
    if 16 in on:
        phase_parallel(terrain, QUARTER if args.quick else DEEP, phase8, smi)
        took(16)
    if 17 in on:
        phase_fuzz()
        took(17)
    if 18 in on:
        phase_viewers_and_sweep(smi)
        took(18)

    say(smi)
    if not whole:
        say(f"phases {sorted(on)}{' (quick)' if args.quick else ''} passed; "
            "the kernels line and the ok line need the whole run")
        return

    def entry(kind, name, line, headline):
        r = next(x for x in rows[kind] if x["grid"] == headline)
        return {
            "name": name, "route": "cuda",
            "source": "legmov_tpu_torch/csrc/leg_kernels.cu",
            "replaces": f"legmov_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[kind],
            # K1's booleans: 1.0 if any mismatched (the run then fails)
            "max_abs_err": (float(min(worst[kind], 1))
                            if kind == "reachability" else worst[kind]),
            "n": r["n"], "ms": r["ms"], "queued_ms": r["queued_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "sizes": rows[kind],
        }

    def map_entry(name, replaces, n_launches, row, **more):
        return {
            "name": name, "route": "cuda",
            "source": "legmov_tpu_torch/csrc/multileg_kernels.cu",
            "replaces": replaces, "launches": n_launches, **row,
            "library_ms": None, **more,
        }

    def cell_entry(name, key, replaces, n_launches, **more):
        return {
            "name": name, "route": "cuda",
            "source": "legmov_tpu_torch/csrc/cell_kernels.cu",
            "replaces": replaces, "launches": n_launches, **cell_rows[key],
            "library_ms": None, "occupancy": occupancy[key], **more,
        }

    def on_paths(key):
        return {"paths": {path: v for (k, path), v in PATH_TIMES.items()
                          if k == key}}

    for name in ("multileg", "csr_round"):
        check(map_launches[name] > 0,
              f"the {name} kernel was launched no time on the map path")
    for name, n in solve_launches_.items():
        check(n > 0, f"the {name} kernel was launched no time on the solve "
              "path")
    # K2's cell kernel: the headline is the per-leg solve's batch with the
    # most pairs inside the elongated box
    head = max((r for r in ident_rows if r["solve"] == "per-leg"),
               key=lambda r: r["pairs_in_box"])
    cells_entry = {
        "name": "legmov_dist_cells_kernel", "route": "cuda",
        "source": "legmov_tpu_torch/csrc/leg_kernels.cu",
        "replaces": "legmov_tpu/ops/pallas_kernels.py:588",
        "launches": solve_launches_["distance_cells"],
        "max_abs_err": float(min(ident_bad, 1)),
        "n": head["pairs_in_box"], "ms": head["ms"],
        "plain_ms": head["plain_s"] * 1e3, "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "pr4_form_ms": head["pr4_form_ms"], "occupancy":
        occupancy["distance_cells"], "batches": ident_rows,
        **on_paths("distance_cells")}
    check(probe["launches"] > 0, "the io-only kernel was launched no time "
          "by the probe")
    io_entry = {
        "name": "legmov_io_only_kernel", "route": "cuda",
        "source": "legmov_tpu_torch/csrc/leg_kernels.cu",
        "replaces": "tools/reach_kernel_probe.py:57", **probe,
        "library_ms": None,
        "paths": {"python -m legmov_tpu_torch.reach_probe": {
            "launches": probe["launches"]}}}
    say(json.dumps({"kernels": [
        entry("reachability", "legmov_reach_kernel", 245, "bench-16M")
        | {"io_only_floor_ms": probe["ms"], "probe_ms": probe["k1_ms"],
           "over_floor": probe["k1_over_floor"],
           "over_floor_queued": probe["k1_over_floor_queued"]}
        | on_paths("reachability"),
        entry("distance", "legmov_dist_kernel", 588, "bench-4M",
              ) | {"forms": ["legmov_dist_kernel",
                               "legmov_dist_cells_kernel"],
                   "adaptive_evaluate": adaptive}
        | on_paths("distance"),
        cells_entry,
        map_entry("legmov_multileg_kernel",
                  "legmov_tpu/ops/pallas_multileg.py:394",
                  map_launches["multileg"], row3, dense_tables=dense,
                  **on_paths("multileg")),
        # the step form: since the round kernel took over the csr-dma
        # solver's rounds it is on no path (as K5's item form)
        map_entry("legmov_csr_window_kernel",
                  "legmov_tpu/ops/csr_grid.py:735",
                  map_launches["csr_window"] + scale["window_launches"], row4,
                  forms=["legmov_csr_window_kernel",
                         "legmov_csr_round_kernel"]),
        map_entry("legmov_csr_round_kernel",
                  "legmov_tpu/ops/csr_grid.py:735",
                  map_launches["csr_round"], row_round,
                  launches_map_scale=scale["launches"],
                  native_host_runtime=scale["native"],
                  map_scale_poses_per_s=scale["poses_per_s"],
                  map_scale_queue_share=scale["queue_share"],
                  in_turns={"cli map chunk": map_launches["turns"],
                            "10.24 M chunk": scale["turns"]},
                  aten_ops={"cli map chunk": map_launches["ops"],
                            "10.24 M chunk": scale["ops"]},
                  **on_paths("csr_round")),
        # the item form ([P, W] items x candidate rows): since the cell
        # driver took over the dense solve it is on no path (as K6c)
        cell_entry("legmov_item_kernel", "item",
                   "legmov_tpu/ops/pallas_multileg_dist.py:533", 0,
                   forms=["legmov_item_kernel", "legmov_item_cells_kernel"]),
        cell_entry("legmov_item_cells_kernel", "item_cells",
                   "legmov_tpu/ops/pallas_multileg_dist.py:533",
                   solve_launches_["item_cells"],
                   forms=["legmov_item_cells_kernel",
                          "legmov_item_cells_shared_kernel"],
                   occupancy_shared_rule=occupancy["item_cells_shared"],
                   **on_paths("item_cells")),
        cell_entry("legmov_cell_quat_major_kernel", "cell_quat_major",
                   "legmov_tpu/ops/csr_cell_eval.py:1192",
                   solve_launches_["cell_quat_major"],
                   **on_paths("cell_quat_major")),
        cell_entry("legmov_cell_shared_kernel", "cell_shared",
                   "legmov_tpu/ops/csr_cell_eval.py:1166",
                   solve_launches_["cell_shared"], **on_paths("cell_shared")),
        cell_entry("legmov_cell_cm_perleg_kernel", "cell_cm_perleg",
                   "legmov_tpu/ops/csr_cell_eval.py:1166",
                   solve_launches_["cell_cm_perleg"],
                   per_leg_solve_in_turns=cm_turns,
                   whole_batch_against_plain=gates["cm_whole"]),
        io_entry,
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Command-line pipeline: prepare -> evaluate -> report, solve and map.

The equivalent of the reference's ``LAUNCH.bash`` workflow (before.py ->
./cuda -> after.py) and of the ``cuda`` binary's ``main()``
(several_leg.cpp:17-224), as one CLI:

* ``prepare``  — generate terrain + body-candidate voxel grid + query grid,
  write the reference's ``.bin`` SoA files (before.py semantics);
* ``evaluate`` — read the query grid, run reachability + distance on the
  card, write ``out_reachability.bin`` / ``out_dist_x{x,y,z}.bin`` and print
  ms / ns-per-point like several_leg.cpp:151-155 (``--adaptive``: the
  adaptive field of models/adaptive_field.py; ``--backend oracle|ik``: the
  host-code audit backends);
* ``report``   — render the reachability / distance images and the
  reachable-volume estimate (after.py semantics);
* ``solve``    — hierarchical (octree-rule) positionability solve over the
  prepared terrain (models/hier_solver.py);
* ``map``      — flat body-pose feasibility map over the prepared body
  candidates (the CSR streaming solvers, ops/csr_grid.py).

Run as ``python -m legmov_tpu_torch.cli <command> [options]``.  ``evaluate``,
``solve`` and ``map`` compute on the CUDA card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from legmov_tpu_torch import io as lio

LEGS = ("moonbot", "m2")


def _get_leg(name: str, azimuth: float = 0.0):
    from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg

    return {"moonbot": get_moonbot_leg, "m2": get_m2_leg}[name](azimuth)


def cmd_prepare(args) -> None:
    from legmov_tpu_torch.terrain import moon_ground

    os.makedirs(args.dir, exist_ok=True)
    terrain = moon_ground(seed=args.seed)
    np.save(os.path.join(args.dir, "map.npy"), terrain)
    lio.save_points(terrain, os.path.join(args.dir, "numpy_input_t"))
    print("map shape:", terrain.shape)

    # body-candidate voxel grid over the map extent + 350 mm of height
    # (before.py:24-61)
    vox = args.voxel
    xs = np.arange(terrain[:, 0].min(), terrain[:, 0].max(), vox)
    ys = np.arange(terrain[:, 1].min(), terrain[:, 1].max(), vox)
    zs = np.arange(terrain[:, 2].min(), terrain[:, 2].max() + 350, vox)
    X, Y, Z = np.meshgrid(xs, ys, zs)
    body = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    lio.save_points(body, os.path.join(args.dir, "numpy_input_b"))
    print("body samples shape:", body.shape)

    # reachability/distance query grid (before.py:65-99 WHOLE3D)
    pix = args.pix_size
    xs = np.arange(-100, 601, pix)
    ys = np.arange(-400, 401, pix)
    zs = np.arange(-500, 201, pix)
    X, Y, Z = np.meshgrid(xs, ys, zs)
    grid = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    lio.save_points(grid, os.path.join(args.dir, "dist_input_t"))
    print("reachability shape:", grid.shape)


def cmd_evaluate(args) -> None:
    import torch

    from legmov_tpu_torch.config import resolve_device

    leg = _get_leg(args.leg)
    comps = lio.load_components(os.path.join(args.dir, "dist_input_t"))
    n = comps[0].shape[0]
    if n == 0:
        raise SystemExit("no dist_input_t{x,y,z}.bin found; run prepare first")

    backend = args.backend
    if backend in ("oracle", "ik"):
        # the reference main()'s ComputeMode switch (several_leg.cpp:
        # 143-148: GPUMode / CPUMode / RBDLMode) — the strict-fp32 scalar
        # CPU twin and the LM-IK baseline as product backends for
        # end-to-end cross-checks on user data.  Both are host code
        # (~30-300 us/point); meant for audit runs.
        t0 = time.perf_counter()
        pts = np.stack(comps, axis=-1)
        if backend == "oracle":
            from legmov_tpu_torch.oracle.numpy_ref import (
                oracle_distance,
                oracle_reachability,
            )

            reach = oracle_reachability(pts, leg)
            _, vec = oracle_distance(pts, leg)
            vec_comps = (vec[:, 0], vec[:, 1], vec[:, 2])
        else:
            from legmov_tpu_torch.oracle.ik_oracle import ik_reachability

            # like the reference's RBDLMode, the LM-IK baseline produces
            # reachability only
            reach = ik_reachability(pts, leg)
            vec_comps = None
        dt = time.perf_counter() - t0
        lio.save_bools(reach, os.path.join(args.dir, "out_reachability.bin"))
        if vec_comps is not None:
            for comp, ax in zip(vec_comps, "xyz"):
                lio.save_array(comp,
                               os.path.join(args.dir, f"out_dist_x{ax}.bin"))
        else:
            print("ik backend: reachability only (no distance outputs), "
                  "matching the reference's RBDLMode")
        print(f"{backend}: {n} points in {dt:.2f} s "
              f"({dt / n * 1e9:.0f} ns/point, host CPU)")
        print(f"reachable fraction: {float(reach.mean()):.4f}")
        return

    dev = resolve_device(args.device)
    if backend == "auto":
        backend = "cuda" if dev.type == "cuda" else "torch"
    if backend == "cuda" and dev.type != "cuda":
        raise SystemExit("--backend cuda needs --device cuda")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.adaptive:
        _evaluate_adaptive(args, leg, comps, backend, dev)
        return
    if backend == "cuda":
        # fused SoA kernels: the .bin protocol is already SoA, so no
        # layout conversion happens anywhere on this path
        from legmov_tpu_torch.ops.cuda_kernels import (
            make_distance_kernel,
            make_reachability_kernel,
        )

        kr = make_reachability_kernel(leg)
        kd = make_distance_kernel(leg)
        x, y, z = (torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                   for c in comps)
        sync()

        t0 = time.perf_counter()
        reach = kr.soa(x, y, z).cpu().numpy()
        t_reach = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok, dx, dy, dz = kd.soa(x, y, z)
        vec_comps = (dx.cpu().numpy(), dy.cpu().numpy(), dz.cpu().numpy())
        t_dist = time.perf_counter() - t0
    else:
        from legmov_tpu_torch.ops.distance import distance
        from legmov_tpu_torch.ops.reachability import reachability

        pts = torch.from_numpy(np.stack(comps, axis=-1)).to(dev)
        sync()
        t0 = time.perf_counter()
        reach = reachability(pts, leg).cpu().numpy()
        t_reach = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok, vec = distance(pts, leg)
        vec = vec.cpu().numpy()
        t_dist = time.perf_counter() - t0
        vec_comps = (vec[:, 0], vec[:, 1], vec[:, 2])

    lio.save_bools(reach, os.path.join(args.dir, "out_reachability.bin"))
    for comp, ax in zip(vec_comps, "xyz"):
        lio.save_array(comp, os.path.join(args.dir, f"out_dist_x{ax}.bin"))
    print(
        f"reachability: {n} points in {t_reach*1e3:.2f} ms "
        f"({t_reach/n*1e9:.3f} ns/point incl. host transfer)"
    )
    print(
        f"distance: {n} points in {t_dist*1e3:.2f} ms "
        f"({t_dist/n*1e9:.3f} ns/point incl. host transfer)"
    )
    frac = float(reach.mean()) if n else 0.0
    print(f"reachable fraction: {frac:.4f}")


def _evaluate_adaptive(args, leg, comps, backend, dev) -> None:
    """``evaluate --adaptive``: the adaptive multi-resolution evaluation (the
    reference's recursive_kernel/apply_recurs product path,
    one_leg_global.cu:168-251, cross_compiled.cu:81-139).  Reachability is
    exact everywhere; distance is exact on the boundary band's points and a
    cell-centre paint in certified cells (the reference's fillOutKernel,
    octree_util.cu:9-26).  ``cuda`` evaluates every batch with the distance
    kernel, ``torch`` with its plain version on ``dev``."""
    import torch

    from legmov_tpu_torch.models.adaptive_field import adaptive_distance_field
    from legmov_tpu_torch.ops import cuda_kernels as ck

    dist_fn = None  # the distance kernel
    if backend == "torch":
        consts = ck.dist_consts(leg)

        def dist_fn(p):
            ok, dx, dy, dz = ck.distance_kernel_plain(
                p[:, 0], p[:, 1], p[:, 2], consts)
            return ok, torch.stack([dx, dy, dz], dim=-1)
    from legmov_tpu_torch import native

    n = comps[0].shape[0]
    pts = native.soa_to_aos(*comps)  # the field takes [N, 3] points
    t0 = time.perf_counter()
    f = adaptive_distance_field(pts, leg, max_depth=args.adaptive_depth,
                                dist_fn=dist_fn, device=dev)
    t_all = time.perf_counter() - t0
    n23 = n ** (2.0 / 3.0)
    print(
        f"adaptive: {n} points, {f.evals} exact distance evals "
        f"(N^(2/3)={n23:.0f}, evals/N^(2/3)={f.evals / n23:.2f}, "
        f"evals/N={f.evals / n:.4f}), exact-distance fraction "
        f"{float(f.exact_mask.mean()):.4f}, {t_all:.2f} s total"
    )
    print(f"adaptive: {f.device_reads} device reads ({backend} on {dev})")
    lio.save_bools(f.reachable,
                   os.path.join(args.dir, "out_reachability.bin"))
    for comp, ax in zip(native.aos_to_soa(f.distance), "xyz"):
        lio.save_array(comp, os.path.join(args.dir, f"out_dist_x{ax}.bin"))
    print(f"reachable fraction: {float(f.reachable.mean()):.4f}")


def cmd_report(args) -> None:
    from legmov_tpu_torch.viz import (
        reachable_volume_m3,
        render_distance,
        render_reachability,
    )

    targets = lio.load_points(os.path.join(args.dir, "dist_input_t"))
    reach = lio.load_bools(os.path.join(args.dir, "out_reachability.bin"))
    dist = lio.load_points(os.path.join(args.dir, "out_dist_x"))
    render_reachability(
        targets, reach, os.path.join(args.dir, "reachability_result.png")
    )
    render_distance(
        targets,
        dist,
        os.path.join(args.dir, "distance_result.png"),
        pix_size=args.pix_size,
    )
    np.save(os.path.join(args.dir, "leg0_reach.npy"), reach)
    vol = reachable_volume_m3(reach, args.pix_size)
    print(f"reachable volume: {vol:.4f} m^3")
    print("wrote reachability_result.png, distance_result.png, leg0_reach.npy")


def cmd_solve(args) -> None:
    """Hierarchical positionability solve over the prepared terrain: writes
    the valid terminal cells as ``out_valid_cells_*.bin`` +
    ``robot_reach.npy`` and prints one JSON line."""
    from legmov_tpu_torch.config import SolverConfig, resolve_device
    from legmov_tpu_torch.models.hier_solver import solve_positionability
    from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg
    from legmov_tpu_torch.models.robot import (
        HEX_MOUNTS,
        QUAD_MOUNTS,
        make_robot,
    )
    from legmov_tpu_torch.ops import csr_cell_eval as cce
    from legmov_tpu_torch.ops import cuda_kernels as ck
    from legmov_tpu_torch.ops import cuda_multileg_dist as cmd

    terrain = lio.load_points(os.path.join(args.dir, "numpy_input_t"))
    if terrain.shape[0] == 0:
        raise SystemExit("no terrain; run prepare first")
    dev = resolve_device(args.device)
    if args.backend == "cuda" and dev.type != "cuda":
        raise SystemExit("--backend cuda needs --device cuda")
    leg_fn = {"moonbot": get_moonbot_leg, "m2": get_m2_leg}[args.leg]
    mounts = HEX_MOUNTS if args.legs == 6 else QUAD_MOUNTS
    robot = make_robot(mounts, leg_fn=leg_fn)
    cfg = SolverConfig(
        box_center=tuple(np.median(terrain, axis=0).tolist()),
        box_size=(args.box, args.box, args.box),
        max_depth=args.depth,
        min_box=(args.min_box,) * 3,
        enable_rot_below=args.rot_below,
        legs_for_stability=args.k,
    )
    counters = {
        "distance_launches": ck.distance_kernel,
        "distance_cells_launches": ck.distance_cells_kernel,
        "item_cells_launches": cmd.item_cells_kernel,
        "cell_quat_major_launches": cce.cell_eval_quat_major,
        "cell_shared_launches": cce.cell_eval_shared,
        "cell_cm_perleg_launches": cce.cell_eval_cm_perleg,
    }
    before = {name: fn.launches for name, fn in counters.items()}
    stats: dict = {}
    t0 = time.perf_counter()
    res = solve_positionability(
        terrain, robot, cfg, shared_foothold=(args.mode == "shared"),
        cell_batch=args.cell_batch, backend=args.backend,
        candidates=args.candidates, csr_window=args.csr_window,
        csr_cell_chunk=args.csr_cell_chunk, device=dev,
        profile=args.profile, stats=stats,
    )
    dt = time.perf_counter() - t0
    valid = res.centers[res.valid]
    lio.save_points(valid, os.path.join(args.dir, "out_valid_cells_"))
    np.save(os.path.join(args.dir, "robot_reach.npy"), valid)
    print(
        json.dumps(
            {
                "cells": int(res.centers.shape[0]),
                "valid": int(res.valid.sum()),
                "edge": int(res.edge.sum()),
                "max_depth": int(res.depth.max()) if res.depth.size else 0,
                "seconds": round(dt, 3),
                "device": str(dev),
                "host_syncs": int(stats["host_syncs"]),
                **{name: fn.launches - before[name]
                   for name, fn in counters.items()},
            }
        )
    )


def cmd_map(args) -> None:
    """Flat body-pose feasibility map over the prepared candidates.

    The reference's dense multi-leg elimination surface
    (several_leg.cu ``eliminateUnreachable``/``agregateReachability``
    over the before.py body voxel grid) at map scale: every body
    candidate from ``numpy_input_b`` is tested for >= k reachable legs
    against the terrain footholds, through a CSR streaming solver
    (ops/csr_grid.py).  Writes the feasible candidates as
    ``out_feasible_body_*.bin`` + ``body_feasible.npy`` (bool mask)."""
    import torch

    from legmov_tpu_torch.config import resolve_device
    from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg
    from legmov_tpu_torch.models.robot import (
        HEX_MOUNTS,
        QUAD_MOUNTS,
        make_robot,
    )
    from legmov_tpu_torch.ops import cuda_multileg
    from legmov_tpu_torch.ops.csr_grid import (
        ball_columns,
        build_csr_grid,
        make_csr_dma_solver,
        make_csr_solver,
        suggest_rounds,
        suggest_window,
        suggest_zclip,
    )
    from legmov_tpu_torch.ops.grid import cell_size_for, neighbor_offsets

    terrain = lio.load_points(os.path.join(args.dir, "numpy_input_t"))
    body = lio.load_points(os.path.join(args.dir, "numpy_input_b"))
    if terrain.shape[0] == 0 or body.shape[0] == 0:
        raise SystemExit("no terrain/body candidates; run prepare first")
    dev = resolve_device(args.device)
    backend = args.backend
    if backend == "cuda" and dev.type != "cuda":
        raise SystemExit("--backend cuda needs --device cuda")
    # the wrappers launch the kernels for CUDA tensors and run their plain
    # versions for CPU tensors; "torch" asks for the plain versions anywhere
    solver_backend = "torch" if backend == "torch" else "auto"

    leg_fn = {"moonbot": get_moonbot_leg, "m2": get_m2_leg}[args.leg]
    mounts = HEX_MOUNTS if args.legs == 6 else QUAD_MOUNTS
    robot = make_robot(mounts, leg_fn=leg_fn)

    reach = cell_size_for(robot)
    cell = reach / args.subdiv
    offs = neighbor_offsets(cell, reach)
    csr = build_csr_grid(terrain, cell, device=dev)
    cols_np = ball_columns(offs)
    cols = torch.from_numpy(cols_np).to(dev)
    window = args.window or suggest_window(csr)
    rounds = suggest_rounds(csr, cols_np, window)
    kw = dict(window=window, rounds=rounds, decide="quorum",
              backend=solver_backend)
    if args.solver == "csr-dma":
        kw["zclip"] = suggest_zclip(csr, window)
        make_fn = make_csr_dma_solver
    else:
        make_fn = make_csr_solver
    solver = make_fn(robot, **kw)
    launches0 = (cuda_multileg.multileg_kernel.launches,
                 cuda_multileg.csr_round_kernel.launches)

    def solve_fn(bb, qq):
        _, quorum, _ = solver(
            torch.from_numpy(np.ascontiguousarray(bb, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(qq, np.float32)).to(dev),
            csr.xs, csr.ys, csr.zs, csr.starts, csr.origin, cols,
            cell_size=csr.cell_size, k=args.k, dims=csr.dims,
        )
        return quorum

    P = body.shape[0]
    chunk = min(args.pose_chunk, P)
    feasible = np.zeros(P, bool)
    ident = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (chunk, 1))
    t0 = time.perf_counter()
    for lo in range(0, P, chunk):
        hi = min(lo + chunk, P)
        b = body[lo:hi]
        if hi - lo < chunk:  # pad the tail: one batch shape throughout
            b = np.concatenate(
                [b, np.full((chunk - (hi - lo), 3), 1e9, np.float32)]
            )
        if args.rot_sweep:
            from legmov_tpu_torch.models.pipeline import multirot_positionable

            got, _ = multirot_positionable(solve_fn, b)
        else:
            got = solve_fn(b, ident).cpu().numpy()
        feasible[lo:hi] = got[: hi - lo]
    dt = time.perf_counter() - t0

    lio.save_points(body[feasible],
                    os.path.join(args.dir, "out_feasible_body_"))
    np.save(os.path.join(args.dir, "body_feasible.npy"), feasible)
    print(json.dumps({
        "body_candidates": int(P),
        "feasible": int(feasible.sum()),
        "terrain_points": int(terrain.shape[0]),
        "legs": args.legs,
        "k": args.k,
        "orientations": 45 if args.rot_sweep else 1,
        "seconds": round(dt, 3),
        "poses_per_s": round(P / max(dt, 1e-9), 1),
        "device": str(dev),
        "solver": args.solver,
        "window": int(window),
        "host_syncs": int(solver.stats["syncs"]),
        "multileg_launches":
            cuda_multileg.multileg_kernel.launches - launches0[0],
        "csr_round_launches":
            cuda_multileg.csr_round_kernel.launches - launches0[1],
    }))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="legmov_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prepare", help="generate terrain + grids -> .bin files")
    p.add_argument("--dir", default="data")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--voxel", type=float, default=50.0)
    p.add_argument("--pix-size", type=float, default=5.0)
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("evaluate", help="run reachability+distance kernels")
    p.add_argument("--dir", default="data")
    p.add_argument("--leg", choices=LEGS, default="m2")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute; cuda needs a card (there is no "
                   "silent CPU path)")
    p.add_argument("--backend",
                   choices=("auto", "cuda", "torch", "oracle", "ik"),
                   default="auto",
                   help="compute mode (several_leg.cpp:143-148 "
                   "ComputeMode): auto = the fused CUDA kernels on a card / "
                   "plain tensor path on the CPU; torch = plain tensor path "
                   "on --device; oracle = strict-fp32 scalar twin and ik = "
                   "LM-IK baseline (reachability only, like RBDLMode), both "
                   "host code by definition and never a fallback")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive multi-resolution evaluation "
                   "(recursive_kernel equivalent): exact reachability "
                   "at ~O(N^(2/3)) distance evaluations, each level's batch "
                   "through the distance kernel (its plain version with "
                   "--backend torch)")
    p.add_argument("--adaptive-depth", type=int, default=8,
                   help="max refinement depth of the adaptive octree")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("report", help="render result images")
    p.add_argument("--dir", default="data")
    p.add_argument("--pix-size", type=float, default=5.0)
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("solve", help="hierarchical positionability solve")
    p.add_argument("--dir", default="data")
    p.add_argument("--leg", choices=LEGS, default="m2")
    p.add_argument("--legs", type=int, choices=(4, 6), default=4,
                   help="leg count: 4 = QUAD_MOUNTS (settings.h:42), "
                   "6 = HEX_MOUNTS")
    p.add_argument("--box", type=float, default=5000.0)
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--min-box", type=float, default=100.0,
                   help="per-axis minimum cell half-extent (settings.h:17 "
                   "MIN_BOX); below enable-rot-below/2 the orientation "
                   "sweep activates for the refined cells")
    p.add_argument("--rot-below", type=float, default=50.0,
                   help="orientation sampling activates for cells smaller "
                   "than this (settings.h:33 EnableRotBelow)")
    p.add_argument("--k", type=int, default=4,
                   help="legs-for-stability quorum (settings.h:46)")
    p.add_argument(
        "--mode",
        choices=("shared", "per-leg"),
        default="per-leg",
        help="shared = reference octree rule (k legs on one foothold); "
        "per-leg = each leg may use its own foothold",
    )
    p.add_argument("--cell-batch", type=int, default=1024,
                   help="cells per dispatch on identity (non-rot) levels")
    p.add_argument("--csr-window", type=int, default=0,
                   help="CSR cell-evaluator chunk size in elements (0 = the "
                   "reference implementation's per-mode default: 2048 "
                   "shared / 1024 per-leg)")
    p.add_argument("--csr-cell-chunk", type=int, default=0,
                   help="cell batch size for the CSR deep levels (0 = the "
                   "reference implementation's per-mode default: 16384 "
                   "shared / 32768 per-leg)")
    p.add_argument("--candidates", choices=("auto", "dense", "csr"),
                   default="auto",
                   help="candidates of the orientation-active levels: csr = "
                   "per-cell CSR chunk queues, dense = per-batch subsets "
                   "through the fused item kernel; auto = csr unless "
                   "--backend torch")
    p.add_argument("--profile", action="store_true",
                   help="print the solve's record when it ends: a [hier] "
                   "line a level (cells, batches, dispatch and fetch "
                   "seconds, the host seconds of each program span), a "
                   "[hier-audit] line a CSR level (the kernels' seven work "
                   "counters) and the host synchronisations")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute; cuda needs a card (there is no "
                   "silent CPU path)")
    p.add_argument("--backend", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the fused CUDA kernels on a card / their "
                   "plain versions on the CPU; torch = the eager evaluator "
                   "on --device")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser(
        "map", help="flat body-pose feasibility map (CSR streaming solve)"
    )
    p.add_argument("--dir", default="data")
    p.add_argument("--leg", choices=LEGS, default="m2")
    p.add_argument("--legs", type=int, choices=(4, 6), default=4,
                   help="mount count (4 = quad like the reference robot)")
    p.add_argument("--k", type=int, default=4,
                   help="legs-for-stability quorum (settings.h:46)")
    p.add_argument("--subdiv", type=int, default=2,
                   help="grid cells per leg reach")
    p.add_argument("--window", type=int, default=0,
                   help="CSR candidate window (0 = auto from column density)")
    p.add_argument("--pose-chunk", type=int, default=2048)
    p.add_argument("--solver", choices=("csr-dma", "csr"),
                   default="csr-dma",
                   help="csr-dma = one launch of the CSR round kernel a "
                   "round (queues built on the card, windows read in "
                   "place); csr = gathered windows into the multi-leg "
                   "kernel")
    p.add_argument("--rot-sweep", action="store_true",
                   help="accept a candidate if ANY of the 3x3x5 "
                   "orientation sweep stands (multi_rot_estimator "
                   "semantics) instead of identity orientation only")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute; cuda needs a card (there is no "
                   "silent CPU path)")
    p.add_argument("--backend", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="auto = the fused CUDA kernels on a card / their "
                   "plain versions on the CPU; torch = the plain versions "
                   "on --device")
    p.set_defaults(fn=cmd_map)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

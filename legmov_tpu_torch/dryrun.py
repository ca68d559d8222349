"""Multi-rank dry run of the sharded solvers (legmov_tpu_torch/parallel/).

    python -m legmov_tpu_torch.dryrun --ranks N [--device cpu]

Spawns N ranks that form one process group and a ``(N / a, a)`` mesh, with
``a = 2`` for an even N > 1, as the JAX package's ``__graft_entry__.py``
``dryrun_multichip`` lays its devices out.  Every rank runs every sharded
function at that dry run's shapes (from its seed): reachability (K1) and
distance (K2's point driver) with the points over every rank; positionable
with the points-axis OR; the bucket-grid positionable; the CSR solver (K3),
the csr-dma solver (K4's round kernel) and csr-dma under
``decide="quorum"``, whose quorums must agree; one two-orientation
``multirot_positionable`` round over the sharded quorum solver; one level
of cells through ``sharded_cell_eval`` and ``sharded_csr_cell_eval``; and the
hierarchical solve with ``mesh=`` on both rules.  Each result is held to the
unsharded call on the same device bit for bit; any difference, or any rank
that fails, ends the run with a non-zero exit.

Ranks take their card (``cuda:{rank % cards}``) unless ``--device cpu``.
With more ranks than cards they share one over gloo: that checks the
splits, the collectives and the results with the real kernels, not how the
work scales over cards.  ``dryrun_multichip``'s partner ``entry()`` is a
compile check for ``jax.jit``; nothing is compiled ahead here, so it has no
counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from legmov_tpu_torch.config import SolverConfig, resolve_device
from legmov_tpu_torch.models.hier_solver import (
    _eval_cells,
    _total_reach,
    make_fast_cell_eval,
    orientation_samples,
    solve_positionability,
)
from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg
from legmov_tpu_torch.models.pipeline import multirot_positionable
from legmov_tpu_torch.models.robot import get_m2_robot
from legmov_tpu_torch.ops import cuda_kernels as ck
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.ops.csr_grid import (
    ball_columns,
    build_csr_grid,
    make_csr_dma_solver,
    make_csr_solver,
)
from legmov_tpu_torch.ops.grid import (
    build_grid,
    cell_size_for,
    grid_reachable_legs,
    neighbor_offsets,
)
from legmov_tpu_torch.ops.positionability import positionable
from legmov_tpu_torch.parallel import (
    make_mesh,
    sharded_cell_eval,
    sharded_csr_cell_eval,
    sharded_csr_positionable,
    sharded_distance,
    sharded_grid_positionable,
    sharded_positionable,
    sharded_reachability,
)
from legmov_tpu_torch.parallel.multihost import run_ranks

LEGS = {"m2": get_m2_leg, "moonbot": get_moonbot_leg}
RECORD = ("centers", "halves", "valid", "edge", "depth")
_f32 = np.float32


def _rpy_quats(rpy) -> np.ndarray:
    q = quat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    return np.asarray(q.cpu().numpy(), _f32)


def points_axis_for(ranks: int) -> int:
    return 2 if ranks % 2 == 0 and ranks > 1 else 1


def dryrun_cases(ranks: int) -> list[dict]:
    """The cases of the dry run on ``ranks`` ranks: the shapes and draws of
    ``__graft_entry__.py`` ``dryrun_multichip(ranks)``."""
    pa = points_axis_for(ranks)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-400, 400, (128 * ranks, 3)).astype(_f32)
    robot = get_m2_robot()
    n_poses, n_foot = 8 * (ranks // pa), 64 * pa
    body = rng.uniform(-100, 100, (n_poses, 3)).astype(_f32)
    quats = _rpy_quats(rng.uniform(-0.2, 0.2, (n_poses, 3)).astype(_f32))
    fh = rng.uniform(-500, 500, (n_foot, 3)).astype(_f32)
    bp = rng.uniform(-300, 300, (8 * ranks, 3)).astype(_f32)
    bq = np.broadcast_to(quats[:1], (8 * ranks, 4)).copy()
    fh_h = fh.copy()
    fh_h[:, 2] = rng.uniform(-180, -100, n_foot)
    cfg = dict(box_center=(0.0, 0.0, 0.0), box_size=(600.0, 600.0, 150.0),
               min_box=(80.0, 80.0, 80.0), max_depth=2, legs_for_stability=2,
               enable_rot_below=200.0, angle_samples=(2, 1, 1))
    dma = dict(window=256, rounds=((2, 1.0), (0, 0.5)))
    csr = dict(kind="csr_positionable", body=bp, quats=bq, footholds=fh,
               robot=robot, k=3)
    cells = rng.uniform(-250, 250, (64, 3)).astype(_f32)
    cells[:, 2] = rng.uniform(-40, 40, 64)
    pv = rng.random(64) < 0.25
    return [
        dict(name="reachability", kind="reachability", points=pts, leg="m2"),
        dict(name="distance", kind="distance", points=pts, leg="m2"),
        dict(name="positionable", kind="positionable", body=body,
             quats=quats, footholds=fh, robot=robot, k=3),
        dict(name="grid positionable", kind="grid_positionable", body=bp,
             quats=bq, footholds=fh, robot=robot, k=3),
        dict(csr, name="csr", solver="csr", window=256),
        dict(csr, name="csr-dma", solver="csr-dma", same_as="csr", **dma),
        dict(csr, name="csr-dma quorum", solver="csr-dma", decide="quorum",
             same_as="csr", **dma),
        dict(csr, name="multirot", kind="multirot", decide="quorum",
             orientations=_rpy_quats(np.asarray(
                 [[0.0, 0.0, 0.0], [0.1, -0.1, 0.2]], _f32)), **dma),
        *(dict(name=f"cells {ev}", kind="cells", evaluator=ev, centers=cells,
               parent_valid=pv, half=(37.5, 37.5, 37.5),
               parent_half=(75.0, 75.0, 75.0), footholds=fh_h, robot=robot,
               k=2, shared=True, angle_samples=(3, 1, 1))
          for ev in ("eager", "fast", "rot", "csr")),
        *(dict(name=f"solve {rule}", kind="solve", footholds=fh_h,
               robot=robot, cfg=cfg,
               kw=dict(chunk=128, cell_batch=64, shared_foothold=shared,
                       candidates="csr", csr_window=128, csr_cell_chunk=64))
          for rule, shared in (("shared", True), ("per-leg", False))),
    ]


# ---------------------------------------------------------------------------
# the cases, as each rank runs them
# ---------------------------------------------------------------------------

def _on(dev, a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dev, dtype)


def _point_case(mesh, c, timed):
    leg = LEGS[c["leg"]]()
    if c["kind"] == "reachability":
        sharded, kernel = sharded_reachability, ck.make_reachability_kernel
    else:
        sharded, kernel = sharded_distance, ck.make_distance_kernel
    with timed("sharded"):
        got = sharded(mesh)(c["points"], leg)
    with timed("single"):
        want = kernel(leg)(_on(mesh.device, c["points"]))
    return got, want, {}


def _positionable_case(mesh, c, timed):
    with timed("sharded"):
        got = sharded_positionable(mesh, k=c["k"])(
            c["body"], c["quats"], c["footholds"], c["robot"])
    dev = mesh.device
    with timed("single"):
        want = positionable(_on(dev, c["body"]), _on(dev, c["quats"]),
                            _on(dev, c["footholds"]), c["robot"], k=c["k"])
    return got, want, {}


def _grid_case(mesh, c, timed):
    reach = cell_size_for(c["robot"])
    grid = build_grid(c["footholds"], reach / 2, device=mesh.device)
    offs = neighbor_offsets(reach / 2, reach)
    with timed("sharded"):
        got = sharded_grid_positionable(mesh, k=c["k"])(
            c["body"], c["quats"], grid, c["robot"], offs)
    with timed("single"):
        want = grid_reachable_legs(_on(mesh.device, c["body"]),
                                   _on(mesh.device, c["quats"]), grid,
                                   c["robot"], k=c["k"], offsets=offs)[1]
    return got, want, {}


def _csr_solver(mesh, c):
    reach = cell_size_for(c["robot"])
    csr = build_csr_grid(c["footholds"], reach / 2, device=mesh.device)
    cols = torch.as_tensor(ball_columns(neighbor_offsets(reach / 2, reach)),
                           device=mesh.device)
    kw = dict(window=c["window"], decide=c.get("decide", "legs"))
    if "rounds" in c:
        kw["rounds"] = c["rounds"]
    make = (make_csr_solver if c.get("solver", "csr-dma") == "csr"
            else make_csr_dma_solver)
    solver = make(c["robot"], **kw)
    args = (csr.xs, csr.ys, csr.zs, csr.starts, csr.origin)

    def single(b, q):
        return solver(_on(mesh.device, b), _on(mesh.device, q), *args, cols,
                      cell_size=csr.cell_size, k=c["k"], dims=csr.dims)[1]

    sharded = sharded_csr_positionable(mesh, solver, cols, csr.cell_size,
                                       csr.dims, k=c["k"])
    return (lambda b, q: sharded(b, q, *args)), single


def _csr_case(mesh, c, timed):
    sharded, single = _csr_solver(mesh, c)
    with timed("sharded"):
        got = sharded(c["body"], c["quats"])
    with timed("single"):
        want = single(c["body"], c["quats"])
    return got, want, {}


def _multirot_case(mesh, c, timed):
    sharded, single = _csr_solver(mesh, c)
    with timed("sharded"):
        got, per_round = multirot_positionable(sharded, c["body"],
                                               c["orientations"])
    with timed("single"):
        want, want_rounds = multirot_positionable(single, c["body"],
                                                  c["orientations"])
    if per_round != want_rounds:
        raise AssertionError(f"multirot rounds {per_round} != {want_rounds}")
    return torch.from_numpy(got), torch.from_numpy(want), {
        "per_round": per_round}


def _cells_case(mesh, c, timed):
    """One level's cells through ``sharded_cell_eval`` (the eager evaluator,
    K2's cell driver, K5's cell driver) or ``sharded_csr_cell_eval`` (the
    CSR cell kernels), against the evaluator alone."""
    from legmov_tpu_torch.ops import csr_cell_eval as cce
    from legmov_tpu_torch.ops.cuda_multileg_dist import make_cell_eval_rot

    dev, robot, k = mesh.device, c["robot"], c["k"]
    qs = orientation_samples(SolverConfig(angle_samples=c["angle_samples"]))
    half = np.asarray(c["half"], _f32)
    parent_half = np.asarray(c["parent_half"], _f32)
    reach = _total_reach(robot)
    centers, pv = _on(dev, c["centers"]), _on(dev, c["parent_valid"],
                                              torch.bool)
    if c["evaluator"] != "csr":
        ev = {"eager": _eval_cells, "fast": make_fast_cell_eval(robot),
              "rot": make_cell_eval_rot(robot, k=k)}[c["evaluator"]]
        use_rot = c["evaluator"] != "fast"
        quats = _on(dev, qs if use_rot else qs[:1])
        kw = dict(k=k, margin=0.0, reach=reach, chunk=32, use_rot=use_rot,
                  shared=c["shared"])
        args = (half, parent_half, _on(dev, c["footholds"]), quats, robot)
        with timed("sharded"):
            got = sharded_cell_eval(mesh, ev)(c["centers"], c["parent_valid"],
                                              *args, **kw)
        with timed("single"):
            want = ev(centers, pv, *args, **kw)
        return torch.stack(got), torch.stack(want), {}
    csr = build_csr_grid(c["footholds"], reach, device=dev)
    ev = cce.make_csr_cell_eval(robot, k=k, n_quats=qs.shape[0],
                                shared=c["shared"], window=128)
    rmounts, reach_l, r_cell = cce.ball_mask_params(
        torch.from_numpy(qs), robot, half, 0.0)
    tables = (_on(dev, cce.level_tables(qs, half, parent_half, robot, 0.0,
                                        reach)),
              _on(dev, parent_half + _f32(reach)), rmounts.to(dev),
              reach_l.to(dev), r_cell, csr.xs, csr.ys, csr.zs, csr.starts,
              csr.origin)
    kw = dict(cell_size=csr.cell_size, dims=csr.dims)
    with timed("sharded"):
        got = sharded_csr_cell_eval(mesh, ev)(c["centers"], c["parent_valid"],
                                              *tables, **kw)
    with timed("single"):
        want = ev(centers, pv, *tables, **kw)
    if bool(got[3]) or bool(want[3]):
        raise AssertionError("CSR cell queue overflow")
    return torch.stack(got[:3]), torch.stack(want[:3]), {}


def _solve_case(mesh, c, timed):
    cfg = SolverConfig(**c["cfg"])
    stats: dict = {}
    with timed("sharded"):
        rec = solve_positionability(c["footholds"], c["robot"], cfg,
                                    mesh=mesh, stats=stats, **c["kw"])
    info = {"host_syncs": stats["host_syncs"],
            "collectives": stats["collectives"], "levels": stats["levels"],
            "cells": int(rec.centers.shape[0]), "valid": int(rec.valid.sum()),
            "edge": int(rec.edge.sum()),
            "max_depth": int(rec.depth.max()) if rec.depth.size else 0}
    got = [np.asarray(getattr(rec, f)) for f in RECORD]
    if not c.get("single", True):
        return got, None, info
    with timed("single"):
        one = solve_positionability(c["footholds"], c["robot"], cfg,
                                    device=mesh.device, **c["kw"])
    return got, [np.asarray(getattr(one, f)) for f in RECORD], info


CASES = {"reachability": _point_case, "distance": _point_case,
         "positionable": _positionable_case,
         "grid_positionable": _grid_case, "csr_positionable": _csr_case,
         "multirot": _multirot_case, "cells": _cells_case,
         "solve": _solve_case}


def _host(x) -> list[np.ndarray]:
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _host(v)]
    if isinstance(x, torch.Tensor):
        return [x.cpu().numpy()]
    return [np.asarray(x)]


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bytes, element for element."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def run_cases(cases: list[dict], points_axis: int, device=None,
              strict: bool = True, clock: bool = False) -> dict:
    """Every case on this rank's mesh (the target of each spawned rank).

    Returns this rank's results, per case: whether the sharded result
    equals the unsharded one bit for bit (``values``: the two as numpy
    arrays), the walls of the sharded and the unsharded call
    (``sharded_s``, ``single_s``, each ended by a synchronisation), the
    kernels' launches made by the sharded call alone (with ``clock``, their
    summed kernel ms from CUDA events too: ``kernel_ms``), and the
    collectives and host<->device copies of the mesh.  ``strict`` raises at
    the first difference."""
    from legmov_tpu_torch import profiling

    mesh = make_mesh(points_axis=points_axis, devices=device)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    out = {"rank": mesh.rank, "shape": mesh.shape, "coords": mesh.coords,
           "device": str(mesh.device), "cases": {}}
    # the device's context and the first collective before any clock runs
    torch.zeros(1, device=mesh.device).sum().item()
    if mesh.size > 1:
        dist.barrier(group=mesh.host_group)
    for c in cases:
        rec = dict(launches={}, kernel_ms={}, sharded_s=0.0, single_s=0.0)

        @contextlib.contextmanager
        def timed(part):
            """Time the block (the case's sharded call, or the unsharded
            one it is held to); for the sharded call count its launches,
            and with ``clock`` sum its kernels' times."""
            before = profiling.launch_counts()
            sync()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                recs = (stack.enter_context(profiling.kernel_clock())
                        if clock and part == "sharded" else {})
                yield
                sync()
            rec[part + "_s"] += time.perf_counter() - t0
            if part != "sharded":
                return
            for name, n in profiling.launch_counts().items():
                if n > before[name]:
                    rec["launches"][name] = n - before[name]
            for name, v in (profiling.clock_sums(recs) if recs else {}).items():
                rec["kernel_ms"][name] = v["ms"]

        stats_before = dict(mesh.stats)
        got, want, info = CASES[c["kind"]](mesh, c, timed)
        got = _host(got)
        want = None if want is None else _host(want)
        equal = want is None or (len(got) == len(want) and all(
            same_bits(a, b) for a, b in zip(got, want)))
        if strict and not equal:
            raise AssertionError(f"rank {mesh.rank}: {c['name']}: the "
                                 "sharded result differs from the "
                                 "unsharded call")
        rec.update(equal=equal, values=(got, want), info=info,
                   collectives=mesh.stats["collectives"]
                   - stats_before["collectives"],
                   copies=mesh.stats["copies"] - stats_before["copies"])
        out["cases"][c["name"]] = rec
    by_name = {c["name"]: c for c in cases}
    for c in cases:
        if "same_as" in c:
            a = out["cases"][c["name"]]["values"][0]
            b = out["cases"][by_name[c["same_as"]]["name"]]["values"][0]
            if strict and not all(same_bits(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{c['name']} differs from "
                                     f"{c['same_as']}")
    out["stats"] = dict(mesh.stats)
    return out


def spawn(cases, ranks: int, device=None, points_axis: int | None = None,
          strict: bool = True, clock: bool = False,
          timeout: float = 600.0) -> list[dict]:
    """Run ``cases`` on ``ranks`` new processes (parallel/multihost.py
    ``run_ranks``); every rank's :func:`run_cases` result, in rank order."""
    pa = points_axis_for(ranks) if points_axis is None else points_axis
    return run_ranks(run_cases, ranks, cases, pa, device, strict, clock,
                     device=device, timeout=timeout)


def summary(res: list[dict]) -> list[str]:
    """One line a case of a :func:`spawn` result: equal on every rank, the
    slowest rank's sharded wall beside rank 0's unsharded wall, the
    collectives and copies a rank made, and the launches summed over the
    ranks."""
    out = []
    for name, case in res[0]["cases"].items():
        launches: dict = {}
        for r in res:
            for k, n in r["cases"][name]["launches"].items():
                launches[k] = launches.get(k, 0) + n
        equal = all(r["cases"][name]["equal"] for r in res)
        out.append(
            f"{name}: {'equal' if equal else 'DIFFERENT'} on {len(res)} "
            f"ranks; sharded {max(r['cases'][name]['sharded_s'] for r in res) * 1e3:.1f}"
            f" ms, unsharded {case['single_s'] * 1e3:.1f} ms; "
            f"{case['collectives']} collectives and {case['copies']} copies a "
            f"rank; launches {json.dumps(launches)}"
            + (f" {json.dumps(case['info'])}" if case["info"] else ""))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where each rank computes; cuda needs a card")
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else "cpu"
    resolve_device(device)
    t0 = time.perf_counter()
    res = spawn(dryrun_cases(args.ranks), args.ranks, device)
    wall = time.perf_counter() - t0
    for line in summary(res):
        print(line)
    where = (torch.cuda.get_device_name(0) if device is None
             else "the CPU")
    print(f"dryrun ok: {args.ranks} ranks, mesh {tuple(res[0]['shape'])} on "
          f"{where}, {wall:.1f} s with the spawn")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

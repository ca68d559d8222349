"""Hierarchical body-pose positionability solver.

Replacement for the reference's CUDA octree with dynamic parallelism
(several_leg_octree.cu:241-377 ``branchKernel`` + ``validity_child``,
octree_util.cu.h ``CreateChildBox``): instead of device-side recursion and
in-kernel ``cudaMalloc`` of child nodes, the tree is expanded host-side,
breadth-first, one level at a time — every level is a dense ``[C, 3]`` array
of cell centers with one uniform half-extent (all cells of a level share it
because splitting is per-axis regular), and cell feasibility is evaluated on
the device in batches.

Cell semantics (validity_child, several_leg_octree.cu:19-151):

* a cell is **valid** if its parent was valid, or some (foothold,
  orientation) pair gives >= ``legs_for_stability`` legs that can reach
  that foothold from the cell center;
* a cell is **on the edge** if for some pair, more than
  ``leg_count - legs_for_stability`` legs have a workspace-boundary
  displacement vector that crosses the cell (the reachable-set boundary
  passes through the cell) — those cells get refined;
* a cell is a **valid leaf** when some pair is valid and not edge;
* orientation sampling only activates for cells smaller than
  ``enable_rot_below`` (settings.h:33); larger cells use the middle sample
  with an edge margin of ``enable_rot_below / 3``;
* footholds further than parent-half + total leg reach from the cell are
  ignored entirely (the elongated-box prefilter,
  several_leg_octree.cu:76-82).

Note: the reference's "middle-first" angle reordering has an off-by
expression (``(ind + ind/2) % n`` at octree_util.cu.h:190 maps [0,1,2] ->
[0,1,0], duplicating the minimum sample); we implement the evident intent
``(ind + n/2) % n`` so index 0 is the middle of each range (the identity
orientation for symmetric ranges).

Evaluators, all with the contract of :func:`_eval_cells`:

* :func:`_eval_cells` — eager tensor code on ``distance_oriented``'s
  arithmetic, any device (``backend="torch"``);
* :func:`make_fast_cell_eval` — identity-orientation levels on K2's cell
  kernel (ops/cuda_kernels.py ``distance_cells_kernel``), one launch a
  batch;
* ops/cuda_multileg_dist.py ``make_cell_eval_rot`` — orientation-active
  levels on K5's cell driver (``item_cells_kernel``) over the batch's dense
  footholds, one launch a batch;
* ops/csr_cell_eval.py ``make_csr_cell_eval`` — orientation-active levels
  on the CSR cell-evaluation kernels.

A kernel wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; nothing here falls back from one to the other.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from legmov_tpu_torch.config import SolverConfig, resolve_device
from legmov_tpu_torch.models.leg import LegDimensions
from legmov_tpu_torch.models.robot import leg_count, leg_of
from legmov_tpu_torch.models.workspace import workspace_tensors
from legmov_tpu_torch.ops import cuda_kernels as ck
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.ops.distance import distance_ws
from legmov_tpu_torch.ops.orientation import (
    _as_leg0,
    _undo_leg0,
    oriented_workspace_items,
)
from legmov_tpu_torch.spans import phase

_f32 = np.float32


def orientation_samples(cfg: SolverConfig) -> np.ndarray:
    """``[S, 4]`` quaternions of the roll/pitch/yaw sample grid.

    Middle-first ordering per axis (flat index 0 = all-middle = identity
    for symmetric ranges), axis decode order roll -> pitch -> yaw like
    ``QuaternionFromAngleIndex`` (octree_util.cu.h:184-198).
    """
    per_axis = []
    for ax in range(3):
        n = cfg.angle_samples[ax]
        amin, amax = cfg.angle_min_max[ax]
        inds = (np.arange(n) + n // 2) % n
        x = inds / max(n - 1, 1)
        per_axis.append((1 - x) * amin + x * amax)
    # flat index decodes roll fastest (octree_util.cu.h:186-189)
    S = cfg.total_angle_samples
    rpy = np.zeros((S, 3))
    for idx in range(S):
        rem = idx
        for ax in range(3):
            n = cfg.angle_samples[ax]
            rpy[idx, ax] = per_axis[ax][rem % n]
            rem //= n
    q = quat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    return np.asarray(q.cpu().numpy(), _f32)


def _total_reach(robot: LegDimensions) -> float:
    return float(
        np.max(
            np.asarray(robot.body)
            + np.asarray(robot.coxa_length)
            + np.asarray(robot.femur_length)
            + np.asarray(robot.tibia_length)
        )
    )


def _upload(dev: torch.device, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Host arrays as tensors on ``dev``, of their own dtypes and shapes.
    On a card they travel in one pinned buffer and one asynchronous copy, so
    the host does not wait for the device (the caching host allocator keeps
    the buffer until the copy has run)."""
    arrays = [np.asarray(a, order="C") for a in arrays]  # 0-d stays 0-d
    if dev.type != "cuda":
        return [torch.from_numpy(a).to(dev) for a in arrays]
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // 16) * 16
    host = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    on_dev = host.to(dev, non_blocking=True)
    return [on_dev[o:o + a.nbytes]
            .view(torch.from_numpy(a.reshape(-1)[:0]).dtype).view(a.shape)
            for a, o in zip(arrays, offs)]


def _eval_cells(
    centers: torch.Tensor,  # [C, 3]
    parent_valid: torch.Tensor,  # [C] bool
    half,  # [3] cell half-extent (level constant)
    parent_half,  # [3]
    footholds: torch.Tensor,  # [F, 3], may be padded with far sentinels
    quats: torch.Tensor,  # [S, 4]
    robot: LegDimensions,  # stacked [L]
    k: int,
    margin: float,
    reach: float,
    chunk: int,
    use_rot: bool,
    shared: bool = True,
    workspaces=None,
):
    """Per-cell (valid, edge, valid_leaf) flags for one level.

    ``shared=True`` reproduces the reference octree's validity — >= k legs
    must reach the SAME foothold (several_leg_octree.cu:91-116, a very
    strict criterion that is near-unsatisfiable for k = leg_count).
    ``shared=False`` uses the thrust pipeline's physically-meaningful rule —
    each leg may use its own foothold (any-over-footholds per leg, then
    count legs; several_leg.cu:633-697).

    The candidate axis is walked in windows of ``chunk`` footholds; a last
    shorter window is evaluated too.  ``workspaces``, when given, is
    ``oriented_workspace_items(quats[:S], robot)`` kept by the caller.
    """
    dev = centers.device
    C = centers.shape[0]
    L = leg_count(robot)
    S = quats.shape[0] if use_rot else 1
    q = quats[:S].to(torch.float32)
    if workspaces is None:
        workspaces = oriented_workspace_items(q, robot)
    legs = [leg_of(robot, l) for l in range(L)]
    # the level constants on the host (ops/cuda_kernels.py cell_level):
    # convexRadius (settings.h:34) picks the per-cell-size branch of the
    # boundary-crossing test (several_leg_octree.cu:96-105), and the
    # inactive-rotation margin widens the cell box on every axis, matching
    # the reference's ``zerobox.topOffset + margin`` intent
    lv = ck.cell_level(half, parent_half, margin, reach)
    elong, hm = _upload(dev, np.asarray(lv.elong, _f32),
                        np.asarray(lv.hm, _f32))
    big_cell, h2m = lv.big_cell, lv.h2m

    any_valid = torch.zeros(C, dtype=torch.bool, device=dev)
    any_edge = torch.zeros(C, dtype=torch.bool, device=dev)
    any_leaf = torch.zeros(C, dtype=torch.bool, device=dev)
    leg_any = torch.zeros((S, L, C), dtype=torch.bool, device=dev)
    leg_cert = torch.zeros((S, L, C), dtype=torch.bool, device=dev)
    leg_poss = torch.zeros((S, L, C), dtype=torch.bool, device=dev)

    F = footholds.shape[0]
    for lo in range(0, F, chunk):
        fh_c = footholds[lo:lo + chunk]
        vect = fh_c[None, :, :] - centers[:, None, :]  # [C, Fc, 3]
        # elongated-box prefilter (asymmetric bounds like isInBox,
        # octree_util.cu.h:153-159)
        pre = torch.all((vect > -elong) & (vect <= elong), dim=-1)  # [C, Fc]
        for si in range(S):
            qi = q[si]
            reach_count = torch.zeros(pre.shape, dtype=torch.int32, device=dev)
            cross_count = torch.zeros(pre.shape, dtype=torch.int32, device=dev)
            for l in range(L):
                # ops/orientation.py distance_oriented, with the oriented
                # workspace built once per (orientation, leg)
                p0, cs = _as_leg0(vect, qi, legs[l].body_angle)
                ok, vec = distance_ws(p0, workspaces[si * L + l])
                dv = _undo_leg0(vec, cs, qi)
                # boundary-crossing test on the displacement vector
                # (several_leg_octree.cu:96-105)
                if big_cell:
                    cross = torch.all((dv > -hm) & (dv <= hm), dim=-1)
                else:
                    cross = torch.sum(dv * dv, dim=-1) < h2m
                okp, crp = ok & pre, cross & pre
                reach_count += okp
                cross_count += crp
                # per-leg-rule certainty bands: a leg is *certainly* valid
                # in the whole cell if some reachable foothold's boundary
                # vector does NOT cross the cell; *possibly* valid if some
                # foothold is reachable or boundary-crossing
                leg_any[si, l] |= okp.any(dim=-1)
                leg_cert[si, l] |= (okp & ~crp).any(dim=-1)
                leg_poss[si, l] |= (okp | crp).any(dim=-1)
            item_valid = ((reach_count >= k) | parent_valid[:, None]) & pre
            item_edge = (cross_count > (L - k)) & pre
            any_valid |= item_valid.any(dim=1)
            any_edge |= item_edge.any(dim=1)
            any_leaf |= (item_valid & ~item_edge).any(dim=1)
    if not shared:
        # each leg may claim its own foothold: count legs with any
        # reachable foothold, per orientation; quorum over that count.
        # The edge criterion is re-derived for THIS rule (not borrowed
        # from the shared-foothold crossing counts): the cell straddles
        # the quorum boundary iff the certainly-valid leg count is below
        # k while the possibly-valid count reaches it.
        counts = leg_any.sum(dim=1)  # [S, C]
        n_min = leg_cert.sum(dim=1)  # [S, C] certain lower bound
        n_max = leg_poss.sum(dim=1)  # [S, C] optimistic upper bound
        any_valid = (counts >= k).any(dim=0) | parent_valid
        any_edge = ((n_min < k) & (n_max >= k)).any(dim=0)
        any_leaf = any_valid & ~any_edge
    return any_valid, any_edge, any_leaf


def make_fast_cell_eval(robot: LegDimensions):
    """Identity-orientation ``_eval_cells`` twin on K2's cell kernel.

    Usable whenever orientation sampling is inactive (cells >=
    ``enable_rot_below``, the bulk of a full-map solve): with the identity
    quaternion the pitch shift of ``rotate_leg_data`` vanishes, so legs
    that share geometry and differ only by mount azimuth share one
    parameter block, and the azimuth yaw and the world-frame restore are
    part of the kernel (one_leg_global.cu:119-127 semantics).  One call is
    one launch on a card (ops/cuda_kernels.py ``distance_cells_kernel``),
    and the plain version on the CPU; like ``_eval_cells`` it returns
    ``(valid, edge, leaf)``, here the rows of the kernel's ``[3, C]``
    flags.  `solve_positionability` only selects this path on levels where
    ``use_rot`` is False.
    """
    legs = ck.CellLegs([leg_of(robot, i) for i in range(leg_count(robot))])

    def eval_cells(centers, parent_valid, half, parent_half, footholds,
                   quats=None, robot_=None, k: int = 1, margin: float = 0.0,
                   reach: float = 0.0, chunk: int = 512,
                   use_rot: bool = False, shared: bool = True):
        del quats, robot_, use_rot  # identity orientation by construction
        level = ck.cell_level(half, parent_half, margin, reach)
        return ck.distance_cells_kernel(centers, parent_valid, footholds,
                                        legs, level, k, shared,
                                        chunk=chunk).unbind(0)

    return eval_cells


@dataclasses.dataclass
class CellRecord:
    """Terminal cells of the hierarchical solve."""

    centers: np.ndarray  # [M, 3]
    halves: np.ndarray  # [M, 3]
    valid: np.ndarray  # [M] bool
    edge: np.ndarray  # [M] bool  (terminal edge cells at max depth)
    depth: np.ndarray  # [M] int


def _morton_order(centers: np.ndarray, half: np.ndarray) -> np.ndarray:
    """Spatial (Morton) sort permutation of cell centers, quantized by
    the cell pitch.

    Children of scattered refined parents arrive parent-ordered; batches
    sliced from that order have wide bounding boxes, which defeats the
    batch-local foothold subsetting (a batch's candidate subset covers
    its whole bbox).  Z-order curve sorting makes every batch spatially
    tight.  Cell order carries no semantics (CellRecord is an unordered
    set; level recursion only needs the refine mask)."""
    q = np.floor(
        centers / np.maximum(2.0 * half, 1e-6)[None, :]
    ).astype(np.int64)
    q -= q.min(axis=0)
    q &= (1 << 21) - 1

    def spread(x):
        x = (x | (x << 32)) & 0x1F00000000FFFF
        x = (x | (x << 16)) & 0x1F0000FF0000FF
        x = (x | (x << 8)) & 0x100F00F00F00F00F
        x = (x | (x << 4)) & 0x10C30C30C30C30C3
        x = (x | (x << 2)) & 0x1249249249249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def _split_children(
    centers: np.ndarray, half: np.ndarray, min_box: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """All children centers of ``centers`` and the child half-extent.

    Per-axis halving only while the half-extent is >= the per-axis minimum
    (CreateChildBox semantics, octree_util.cu.h:105-151).
    """
    split = half >= min_box
    offs = [(-0.5, 0.5) if s else (0.0,) for s in split]
    child_half = np.where(split, half / 2, half).astype(_f32)
    shifts = np.array(
        [(ox, oy, oz) for ox in offs[0] for oy in offs[1] for oz in offs[2]],
        _f32,
    )
    shifts = shifts * half
    children = (centers[:, None, :] + shifts[None, :, :]).reshape(-1, 3)
    return children.astype(_f32), child_half


def _env_flag(name: str, default: int) -> bool:
    return bool(int(os.environ.get(name, str(default)) or default))


def solve_positionability(
    footholds: np.ndarray,
    robot: LegDimensions,
    cfg: SolverConfig = SolverConfig(),
    chunk: int = 512,
    cell_batch: int = 1024,
    shared_foothold: bool = True,
    backend: str = "auto",
    profile: bool = False,
    candidates: str = "auto",
    csr_window: int = 0,
    csr_cell_chunk: int = 0,
    device=None,
    stats: dict | None = None,
    mesh=None,
) -> CellRecord:
    """Breadth-first hierarchical positionability solve.

    Returns the terminal cells (leaves + max-depth edge cells) with their
    validity flags; ``centers[valid]`` is the reference's
    ``extractValidAsArray`` output (octree_util.cu:155-180).

    ``shared_foothold=True`` is the reference octree criterion (>= k legs on
    one shared foothold); ``False`` lets every leg claim its own foothold
    (the thrust-pipeline criterion — use this for physically meaningful
    stances).

    ``device``: where the cells are evaluated (``None`` = the CUDA card,
    which must exist).  ``backend``: ``"auto"`` = the fused evaluators,
    whose wrappers launch their CUDA kernels on a card and run the kernels'
    plain versions on ``device="cpu"``; ``"cuda"`` = the same and the device
    must be a card; ``"torch"`` = the eager :func:`_eval_cells` on the given
    device.

    Batches of a level are DISPATCHED first and fetched afterwards (one
    packed flags tensor per level), so the host reads the device once per
    level: that is one synchronisation per level, counted in
    ``stats["host_syncs"]``.  Every level's tables and cells travel to the
    card in pinned buffers without a wait (:func:`_upload`); the level's
    fetch is the only copy the host waits for.

    ``candidates`` selects how orientation-active levels get their
    foothold candidates: ``"dense"`` = per-batch bbox subsets through the
    dense evaluator (the fused item kernel, or ``_eval_cells`` under
    ``backend="torch"``); ``"csr"`` = the CSR-streaming cell evaluator
    (ops/csr_cell_eval.py — device-resident footholds, per-CELL
    elongated-box candidate queues, decided cells skip their remaining
    orientation samples); ``"auto"`` = csr unless ``backend="torch"``.
    Flags are bit-identical across the choices.

    ``csr_window`` / ``csr_cell_chunk`` of 0 take the reference
    implementation's per-rule defaults (window 2048 and 16384 cells a batch
    for the shared rule, 1024 and 32768 for the per-leg rule); they were
    chosen on another accelerator and have not been tuned for a GPU.

    Environment switches: ``LEGMOV_CSR_QUAT_MAJOR=1`` (the quat-major kernel
    for both rules), ``LEGMOV_CSR_CHUNK_MASKS=0`` (per-slab instead of
    per-chunk role masks), ``LEGMOV_HIER_CS_FRAC`` (CSR cell size as a
    fraction of the reach).  Flags are the same under each.

    Spans (spans.py ``phase``): the solve's host steps are timed always, and
    are ``legmov.<name>`` ranges while ``torch.profiler`` records:
    ``solve`` (the call), ``solve.prepare`` (orientations, factories, the
    footholds' upload and the CSR grid), and per level ``level`` (its split
    to its unpack), ``level.split``, ``level.tables``, ``level.upload``,
    ``level.fetch`` (the packing and the one read of the device),
    ``level.unpack`` (flags, refinement and terminal cells), and per batch
    ``batch.queue_max``, ``batch.upload``, ``batch.queue``, ``batch.launch``
    (CSR levels) or ``batch.subset``, ``batch.launch`` (dense levels).

    ``stats``, when given a dict, receives ``host_syncs``, ``levels``,
    ``collectives``, ``host_s`` (the seconds of ``solve`` and
    ``solve.prepare``) and a ``per_level`` list of dicts: ``depth``,
    ``cells``, ``rot``, ``kind`` (``"csr"`` or ``"dense"``), ``batch``,
    ``batches``, ``dispatch_s`` (the level's dispatch on the host clock),
    ``fetch_s`` (its fetch and flag unpacking), ``done_s``, ``host_s`` (the
    seconds of each of the level's spans, summed over its batches), and on
    a CSR level of a single-rank solve ``audit``: the kernels' seven work
    counters (ops/csr_cell_eval.py ``AUDIT_COUNTERS``) summed over the
    level's cells, fetched with its flags.  ``profile=True`` prints these
    records when the solve ends: a ``[hier]`` line a level with its spans'
    seconds, and a ``[hier-audit]`` line a CSR level.

    ``mesh``: a parallel/sharding.py ``make_mesh`` mesh.  Every rank runs
    this host loop; a level's cells split over the ranks in contiguous
    ranges, each rank dispatches its range and reads its flags in the
    level's one fetch, and one ``all_gather`` of the packed host flags (the
    overflow words ORed) gives every rank the whole level: one collective a
    level, counted in ``stats["collectives"]``, and no extra device read.
    The record is the ``mesh=None`` record bit for bit.  The cells are
    evaluated on ``mesh.device``.
    """
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"backend must be auto, cuda or torch, got {backend!r}")
    if candidates not in ("auto", "dense", "csr"):
        raise ValueError(
            f"candidates must be auto, dense or csr, got {candidates!r}")
    if mesh is not None:
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} but the mesh computes on "
                             f"{mesh.device}")
        dev = mesh.device
    else:
        dev = resolve_device(device)
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("backend='cuda' needs a CUDA device")
    record: dict = {}
    host_s: dict = {}
    with phase("solve", host_s):
        rec = _solve(footholds, robot, cfg, chunk, cell_batch,
                     shared_foothold, backend, candidates, csr_window,
                     csr_cell_chunk, dev, mesh, record, host_s)
    record["host_s"] = host_s
    if profile:
        _print_profile(record)
    if stats is not None:
        stats.update(record)
    return rec


def _print_profile(record: dict) -> None:
    """The ``[hier]`` and ``[hier-audit]`` lines of a solve's record."""
    host_s = record["host_s"]
    print(f"[hier] prepare took {host_s['solve.prepare']:.3f}s "
          f"(factories, foothold upload, the CSR grid on the CSR path)",
          flush=True)
    for level in record["per_level"]:
        extra = (f"csr window={level['window']} maxch={level['maxch']}"
                 if level["kind"] == "csr"
                 else f"subset_mb={level['subset_mb']:.1f}")
        spans = " ".join(f"{k}={v:.3f}"
                         for k, v in level["host_s"].items())
        print(
            f"[hier] depth={level['depth']} cells={level['cells']} "
            f"batches={level['batches']} batch={level['batch']} "
            f"rot={level['rot']} {extra} "
            f"dispatch_s={level['dispatch_s']:.3f} "
            f"fetch_s={level['fetch_s']:.3f} "
            f"done at +{level['done_s']:.2f}s spans: {spans}",
            flush=True,
        )
        if "audit" in level:
            counters = " ".join(f"{k}={v}" for k, v in level["audit"].items())
            print(f"[hier-audit] depth={level['depth']} "
                  f"cells={level['cells']} {counters}", flush=True)
    print(
        f"[hier] solve took {host_s['solve']:.3f}s, "
        f"{record['host_syncs']} host synchronisations over "
        f"{record['levels']} levels",
        flush=True,
    )


def _solve(footholds, robot, cfg, chunk, cell_batch, shared_foothold,
           backend, candidates, csr_window, csr_cell_chunk, dev, mesh,
           record, host_s) -> CellRecord:
    """The body of :func:`solve_positionability` on a checked device:
    fills ``record`` with its ``stats`` and ``host_s`` with the seconds of
    ``solve.prepare``."""
    ranks, me = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    t_solve0 = time.perf_counter()
    with phase("solve.prepare", host_s):
        if not csr_window:
            csr_window = 2048 if shared_foothold else 1024
        if not csr_cell_chunk:
            csr_cell_chunk = 16384 if shared_foothold else 32768
        k = cfg.legs_for_stability
        reach = _total_reach(robot)
        quats_np = orientation_samples(cfg)
        quats, = _upload(dev, quats_np)
        min_box = np.asarray(cfg.min_box, _f32)
        S = int(quats_np.shape[0])

        fused = backend != "torch"
        fast_eval = fast_rot_eval = None
        eager_ws: dict = {}
        if fused:
            from legmov_tpu_torch.ops.cuda_multileg_dist import (
                make_cell_eval_rot,
            )

            # levels without orientation sampling evaluate the FIRST sample;
            # the single-leg distance kernel serves them when that sample is
            # the identity (symmetric ranges with odd sample counts), the
            # item kernel with that one sample otherwise
            if np.array_equal(quats_np[0], quat.IDENTITY):
                fast_eval = make_fast_cell_eval(robot)
            fast_rot_eval = make_cell_eval_rot(robot, k=k)

        def eval_dense(*a, use_rot, **kw):
            # the oriented workspaces depend on the sample set only
            if use_rot not in eager_ws:
                n = S if use_rot else 1
                eager_ws[use_rot] = [
                    workspace_tensors(ws, dev) for ws in
                    oriented_workspace_items(torch.from_numpy(quats_np[:n]),
                                             robot)]
            return _eval_cells(*a, use_rot=use_rot,
                               workspaces=eager_ws[use_rot], **kw)

        F = footholds.shape[0]
        fh = np.ascontiguousarray(footholds, dtype=_f32)
        fh_dev, = _upload(dev, fh)

        # CSR-streaming candidates for orientation-active levels: footholds
        # live on the device ONCE in cell-sorted CSR form; per-cell
        # elongated boxes stream as x-slab windows inside the kernel (no
        # per-batch subsets)
        use_csr = candidates == "csr" or (candidates == "auto" and fused)
        csr_env = None
        if use_csr and F:
            from legmov_tpu_torch.ops import csr_cell_eval as cce
            from legmov_tpu_torch.ops.csr_grid import build_csr_grid

            # ~1 reach per grid cell: 3-4 x-slabs per deep elongated box.
            # LEGMOV_HIER_CS_FRAC scales it: fatter slabs hold more points
            # per chunk at the cost of coarser slab role masks.
            cs_cell = reach * float(
                os.environ.get("LEGMOV_HIER_CS_FRAC", "1.0") or 1.0)
            # built on the host, its arrays and the cell size (a 0-d tensor
            # for build_cell_queue's divisions) up in one asynchronous copy
            csr_h = build_csr_grid(fh, cs_cell, device="cpu")
            parts = [t.numpy() for t in (csr_h.xs, csr_h.ys, csr_h.zs,
                                         csr_h.starts, csr_h.origin)]
            *arrays, cs_d = _upload(dev, *parts,
                                    np.asarray(csr_h.cell_size, _f32))
            csr = csr_h._replace(**dict(zip(("xs", "ys", "zs", "starts",
                                             "origin"), arrays)))
            csr_env = dict(csr=csr, starts_h=parts[3], origin_h=parts[4],
                           cell_size=cs_d, fns={})

    n_syncs = n_collectives = 0
    per_level: list[dict] = []
    out: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]] = []

    centers = np.asarray([cfg.box_center], _f32)
    half = np.asarray(cfg.box_size, _f32)
    parent_valid = np.zeros(1, bool)

    for depth in range(cfg.max_depth + 1):
        lv_s: dict = {}  # the level's spans: name -> host seconds
        with phase("level", lv_s):
            with phase("level.split", lv_s):
                children, child_half = _split_children(centers, half,
                                                       min_box)
                n_children = children.shape[0] // centers.shape[0]
                child_parent_valid = np.repeat(parent_valid, n_children)
                order = _morton_order(children, child_half)
                children = children[order]
                child_parent_valid = child_parent_valid[order]

            rot_active = bool(half[0] < cfg.enable_rot_below)
            margin = 0.0 if rot_active else cfg.enable_rot_below / 3.0

            C = children.shape[0]
            # this rank's contiguous range of the level's cells (all of
            # them without a mesh)
            share = -(-C // ranks)
            r_lo = min(me * share, C)
            r_hi = min(r_lo + share, C)
            level = dict(depth=depth, cells=C, rot=rot_active, host_s=lv_s)
            pending: list[tuple[int, int, torch.Tensor]] = []
            audit_parts: list[torch.Tensor] = []
            over_parts: list[torch.Tensor] = []

            # CSR-streaming path for orientation-active levels (see
            # ``candidates`` in the docstring); levels whose elongated box
            # spans more than R_CAP slabs go to the dense evaluators
            r_need = 0
            if rot_active and csr_env is not None:
                csr = csr_env["csr"]
                elong_np = (half + np.float32(reach)).astype(_f32)
                r_need = int(np.ceil(elong_np[0] / csr.cell_size)) + 1
            t_disp0 = time.perf_counter()
            if rot_active and csr_env is not None and r_need <= cce.R_CAP:
                # the chunk-major kernel for the shared rule (one stream per
                # chunk instead of S), the quat-major kernel for the per-leg
                # rule: the reference implementation's defaults.  On an H100
                # the chunk-major per-leg kernel took 1.48x the quat-major
                # kernel's time over the depth-7 per-leg solve's batches, in
                # turns (chip_smoke.py phase 8)
                chunk_major = shared_foothold and not _env_flag(
                    "LEGMOV_CSR_QUAT_MAJOR", 0)
                chunk_masks = _env_flag("LEGMOV_CSR_CHUNK_MASKS", 1)
                key = (chunk_major, chunk_masks)
                if key not in csr_env["fns"]:
                    csr_env["fns"][key] = cce.make_csr_cell_eval(
                        robot, k=k, n_quats=S, shared=shared_foothold,
                        window=csr_window, chunk_major=chunk_major,
                        audit=True, chunk_masks=chunk_masks,
                        plain=not fused)
                ev_csr = csr_env["fns"][key]
                # the level's constants, built on the host from the host
                # copy of the orientations, go up in one asynchronous copy
                with phase("level.tables", lv_s):
                    legtab_h = cce.level_tables(quats_np, child_half, half,
                                                robot, float(margin), reach)
                    rmounts_h, reach_l_h, r_cell = cce.ball_mask_params(
                        torch.from_numpy(quats_np), robot, child_half,
                        float(margin))
                with phase("level.upload", lv_s):
                    legtab, rmounts, reach_l_d, elong_d = _upload(
                        dev, legtab_h.numpy(), rmounts_h.numpy(),
                        reach_l_h.numpy(), elong_np)
                batch = max(1, min(csr_cell_chunk, r_hi - r_lo))
                level.update(kind="csr", batch=batch, window=csr_window,
                             maxch=0)
                for s in range(r_lo, r_hi, batch):
                    e = min(s + batch, r_hi)
                    with phase("batch.queue_max", lv_s):
                        maxch = cce.slab_queue_host_max(
                            children[s:e], elong_np, csr_env["starts_h"],
                            csr_env["origin_h"], csr.cell_size, csr.dims,
                            csr_window)
                    level["maxch"] = max(level["maxch"], maxch)
                    with phase("batch.upload", lv_s):
                        cells = _upload(dev, children[s:e],
                                        child_parent_valid[s:e])
                    res = ev_csr(
                        *cells, legtab, elong_d, rmounts, reach_l_d, r_cell,
                        csr.xs, csr.ys, csr.zs, csr.starts, csr.origin,
                        cell_size=csr_env["cell_size"], dims=csr.dims,
                        q_steps=maxch, phases=lv_s)
                    v, ed, lf, over, counts = res
                    pending.append((s, e - s, (v, ed, lf)))
                    over_parts.append(over.reshape(1))
                    if ranks == 1:
                        # the work counters travel in the level's one fetch
                        audit_parts.append(
                            counts.sum(dim=0, dtype=torch.int64))
            else:
                # power-of-two cell batches, so that tiny levels do not pay
                # for the full batch size
                batch = min(cell_batch,
                            1 << (max(r_hi - r_lo - 1, 1)).bit_length())
                sub_bytes = 0
                level_quats = quats if rot_active else quats[:1]
                if not fused:
                    ev = eval_dense
                elif rot_active or fast_eval is None:
                    ev = fast_rot_eval
                else:
                    ev = fast_eval
                for s in range(r_lo, r_hi, batch):
                    e = min(s + batch, r_hi)
                    # batch-local foothold subset (the octree's elongated-box
                    # pruning at batch granularity,
                    # several_leg_octree.cu:76-82): only points within the
                    # batch bbox expanded by parent_half + reach can pass the
                    # per-cell prefilter, and Morton order keeps batches
                    # spatially coherent — at deep levels this shrinks the
                    # foothold axis by orders of magnitude.
                    with phase("batch.subset", lv_s):
                        expand = half + np.float32(reach)
                        lo = children[s:e].min(axis=0) - expand
                        hi = children[s:e].max(axis=0) + expand
                        m = np.all((fh >= lo) & (fh <= hi), axis=1)
                        cells = (children[s:e], child_parent_valid[s:e])
                        if int(m.sum()) < F // 2:
                            sub = fh[m]
                            c_d, pv_d, fh_batch = _upload(dev, *cells, sub)
                            sub_bytes += sub.nbytes
                        else:
                            c_d, pv_d = _upload(dev, *cells)
                            fh_batch = fh_dev
                    with phase("batch.launch", lv_s):
                        f = ev(c_d, pv_d, child_half, half, fh_batch,
                               level_quats, robot, k=k, margin=float(margin),
                               reach=reach, chunk=chunk, use_rot=rot_active,
                               shared=shared_foothold)
                    pending.append((s, e - s, f))
                level.update(kind="dense", batch=batch,
                             subset_mb=sub_bytes / 1e6)
            t_disp = time.perf_counter() - t_disp0

            # ONE packed tensor per level, fetched after the whole level is
            # dispatched: the level's only read of the device
            t_fetch0 = time.perf_counter()
            with phase("level.fetch", lv_s):
                flat = np.zeros(0, np.int64)
                if pending:
                    packed = [torch.cat([x.reshape(-1) for _, _, f in pending
                                         for x in f]).to(torch.int64)]
                    packed += over_parts and [
                        torch.cat(over_parts).to(torch.int64)]
                    packed += audit_parts
                    flat = torch.cat(packed).cpu().numpy()
                    n_syncs += 1
            with phase("level.unpack", lv_s):
                flags = np.zeros((C, 3), bool)  # valid, edge, leaf_ok
                pos = 0
                for s, n, _ in pending:
                    flags[s:s + n] = flat[pos:pos + 3 * n].reshape(3, n).T
                    pos += 3 * n
                over = bool(flat[pos:pos + len(over_parts)].any())
                pos += len(over_parts)
                if ranks > 1:
                    from legmov_tpu_torch.parallel.sharding import (
                        gather_level,
                    )

                    flags, over = gather_level(mesh, flags[r_lo:r_hi], over,
                                               C)
                    n_collectives += 1
                if over:
                    raise RuntimeError(
                        "csr_cell_eval queue truncated: the host's slab "
                        "sizing and the device's diverged")
                valid, edge, leaf_ok = flags.T
                t_fetch = time.perf_counter() - t_fetch0
                level.update(batches=len(pending), dispatch_s=t_disp,
                             fetch_s=t_fetch,
                             done_s=time.perf_counter() - t_solve0)
                if audit_parts:
                    tot = flat[pos:].reshape(len(audit_parts), -1).sum(axis=0)
                    level["audit"] = dict(zip(cce.AUDIT_COUNTERS,
                                              map(int, tot)))

                splittable = bool(np.any(child_half >= min_box))
                refine = edge & ~leaf_ok
                last_level = depth == cfg.max_depth or not splittable
                terminal = ~refine if not last_level else np.ones(C, bool)

                if np.any(terminal):
                    n_term = int(terminal.sum())
                    out.append(
                        (
                            children[terminal],
                            np.broadcast_to(child_half, (n_term, 3)),
                            valid[terminal],
                            refine[terminal] if last_level
                            else np.zeros(n_term, bool),
                            depth,
                        )
                    )
        per_level.append(level)
        if last_level or not np.any(refine):
            break
        centers = children[refine]
        parent_valid = valid[refine]
        half = child_half

    record.update(host_syncs=n_syncs, levels=len(per_level),
                  collectives=n_collectives, per_level=per_level)
    cs = np.concatenate([o[0] for o in out])
    hs = np.concatenate([o[1] for o in out])
    vs = np.concatenate([o[2] for o in out])
    es = np.concatenate([o[3] for o in out])
    ds = np.concatenate([np.full(o[0].shape[0], o[4]) for o in out])
    return CellRecord(centers=cs, halves=hs, valid=vs, edge=es, depth=ds)

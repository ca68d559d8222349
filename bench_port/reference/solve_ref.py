"""Plain reference of the breadth-first octree positionability solve.

The program returns the terminal cells of its octree (centre, half-extent,
depth, valid and edge flags).  This module judges such a record in two
steps, from the inputs alone:

1. :func:`rebuild_tree` grows the octree again from the configuration's
   root box, level by level, splitting exactly the cells the record shows
   refined, and counts every record cell that is not a child of a refined
   cell, is duplicated, has other bits than the rebuilt centre or
   half-extent, or is missing at the last level.  This is exact and covers
   the whole record.
2. :func:`check_flags` evaluates a seeded sample of every level's cells
   (and, for each, its ancestors, whose validity a child inherits) with the
   plain cell evaluation below and counts the cells whose record disagrees:
   a terminal cell's valid flag, a refined cell that should not have been
   refined and the converse, and the last level's edge flag.

The cell evaluation is the semantics of the reference octree's
``validity_child`` (several_leg_octree.cu:19-151) as the port's plain
``_eval_cells`` writes it, over each cell's own elongated-box candidates
gathered from the footholds, on the frozen circle math of
:mod:`bench_port.reference.circles`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bench_port.reference.circles import quaternion as quat
from bench_port.reference.circles.leg import LegDimensions
from bench_port.reference.circles.orientation import (
    _as_leg0,
    _undo_leg0,
    oriented_workspace_items,
)
from bench_port.reference.circles.distance import distance_ws
from bench_port.reference.circles.robot import leg_count, leg_of
from bench_port.reference.circles.workspace import workspace_tensors

_f32 = np.float32
#: a padded candidate this far away passes no cell's prefilter
_FAR = 1e9
#: candidate elements a batch of cells evaluates at once
_BATCH_ELEMENTS = 1 << 21


def orientation_samples(angle_samples, angle_min_max) -> np.ndarray:
    """``[S, 4]`` quaternions of the roll/pitch/yaw sample grid, middle
    sample first on each axis and roll fastest (octree_util.cu.h:184-198,
    with the evident intent ``(ind + n/2) % n`` of its reordering)."""
    per_axis = []
    for ax in range(3):
        n = angle_samples[ax]
        amin, amax = angle_min_max[ax]
        inds = (np.arange(n) + n // 2) % n
        x = inds / max(n - 1, 1)
        per_axis.append((1 - x) * amin + x * amax)
    S = int(np.prod(angle_samples))
    rpy = np.zeros((S, 3))
    for idx in range(S):
        rem = idx
        for ax in range(3):
            n = angle_samples[ax]
            rpy[idx, ax] = per_axis[ax][rem % n]
            rem //= n
    q = quat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    return np.asarray(q.cpu().numpy(), _f32)


def total_reach(robot: LegDimensions) -> float:
    """The longest body-origin-to-tip distance of any leg."""
    return float(np.max(np.asarray(robot.body) + np.asarray(robot.coxa_length)
                        + np.asarray(robot.femur_length)
                        + np.asarray(robot.tibia_length)))


def split_children(centers: np.ndarray, half: np.ndarray, min_box):
    """All children of ``centers`` and the child half-extent: an axis is
    halved while its half-extent is at least the minimum
    (octree_util.cu.h:105-151 ``CreateChildBox``)."""
    min_box = np.asarray(min_box, _f32)
    split = half >= min_box
    offs = [(-0.5, 0.5) if s else (0.0,) for s in split]
    child_half = np.where(split, half / 2, half).astype(_f32)
    shifts = np.array(
        [(ox, oy, oz) for ox in offs[0] for oy in offs[1] for oz in offs[2]],
        _f32) * half
    children = (centers[:, None, :] + shifts[None, :, :]).reshape(-1, 3)
    return children.astype(_f32), child_half


class Level(NamedTuple):
    """One level of the rebuilt octree."""

    depth: int
    children: np.ndarray  # [C, 3] float32 centres
    child_half: np.ndarray  # [3] their half-extent
    half: np.ndarray  # [3] their parents' half-extent
    rot: bool  # orientation sampling active
    last: bool
    parent: np.ndarray  # [C] index into the previous level's refined cells
    terminal: np.ndarray  # [C] the record holds the cell
    rec_valid: np.ndarray  # [C] the record's flags (False where refined)
    rec_edge: np.ndarray


def _lattice_keys(centers, box_min, child_half):
    """One int64 per cell centre: its index on the level's lattice (cells
    lie at odd multiples of the half-extent from the box corner)."""
    idx = np.floor((centers.astype(np.float64) - box_min)
                   / (2.0 * child_half.astype(np.float64))).astype(np.int64)
    idx = np.clip(idx, -1, (1 << 20) - 2) + 1
    return (idx[:, 0] << 42) | (idx[:, 1] << 21) | idx[:, 2]


def rebuild_tree(record, solver: dict):
    """``(levels, mismatches)``: the octree the record's refinements
    define, from the root box of ``solver`` (the configuration's solver
    settings with ``box_center``), and the count of record cells that
    disagree with it (see the module docstring)."""
    centers = np.asarray([solver["box_center"]], _f32)
    half = np.asarray(solver["box_half"], _f32)
    min_box = np.asarray(solver["min_box"], _f32)
    box_min = centers[0].astype(np.float64) - half.astype(np.float64)
    rc, rh = np.asarray(record.centers, _f32), np.asarray(record.halves, _f32)
    rd = np.asarray(record.depth)
    rv, re = np.asarray(record.valid, bool), np.asarray(record.edge, bool)
    levels, bad = [], 0
    depth = -1
    for depth in range(int(solver["max_depth"]) + 1):
        children, child_half = split_children(centers, half, min_box)
        n_ch = children.shape[0] // centers.shape[0]
        parent = np.repeat(np.arange(centers.shape[0]), n_ch)
        last = depth == int(solver["max_depth"]) or not bool(
            np.any(child_half >= min_box))
        sel = np.nonzero(rd == depth)[0]
        kc = _lattice_keys(children, box_min, child_half)
        order = np.argsort(kc, kind="stable")
        kr = _lattice_keys(rc[sel], box_min, child_half)
        pos = np.minimum(np.searchsorted(kc[order], kr), kc.size - 1)
        found = kc[order][pos] == kr
        idx = order[pos[found]]
        hit = sel[found]
        bad += int((~found).sum()) + (idx.size - np.unique(idx).size)
        bad += int((~np.all(rc[hit] == children[idx], axis=1)).sum())
        bad += int((~np.all(rh[hit] == child_half, axis=1)).sum())
        terminal = np.zeros(children.shape[0], bool)
        terminal[idx] = True
        rec_valid = np.zeros(children.shape[0], bool)
        rec_edge = np.zeros(children.shape[0], bool)
        rec_valid[idx] = rv[hit]
        rec_edge[idx] = re[hit]
        if last:
            bad += int((~terminal).sum())
        else:
            bad += int(re[hit].sum())  # edge is reported at the last level
        levels.append(Level(depth, children, child_half, half,
                            bool(half[0] < solver["enable_rot_below"]), last,
                            parent, terminal, rec_valid, rec_edge))
        if last or terminal.all():
            break
        centers = children[~terminal]
        half = child_half
    bad += int((rd > depth).sum())
    return levels, bad


def cell_level(half, parent_half, margin: float, reach: float):
    """The level constants in float32: the elongated prefilter box
    ``parent_half + reach``, the crossing box ``half + margin`` and sphere
    ``|half|^2 + margin``, and whether the cell is big enough for the box
    test (convexRadius 100 mm, several_leg_octree.cu:96-105)."""
    h = np.asarray(half, _f32)
    ph = np.asarray(parent_half, _f32)
    m = _f32(margin)
    elong = ph + _f32(reach)
    h2 = (h[0] * h[0] + h[1] * h[1]) + h[2] * h[2]
    return elong, h + m, float(_f32(h2 + m)), bool(h2 > _f32(100.0 * 100.0))


def _gather_candidates(centers, footholds, elong):
    """``[C, F', 3]`` relative vectors of each cell's footholds inside its
    elongated box (asymmetric bounds like isInBox, octree_util.cu.h:
    153-159), padded with far points; ``F'`` is the largest count."""
    vect = footholds[None, :, :] - centers[:, None, :]
    pre = torch.all((vect > -elong) & (vect <= elong), dim=-1)
    width = max(int(pre.sum(dim=1).max()), 1) if pre.numel() else 1
    order = torch.argsort((~pre).to(torch.int8), dim=1, stable=True)
    order = order[:, :width]
    keep = torch.gather(pre, 1, order)
    got = torch.gather(vect, 1, order[..., None].expand(-1, -1, 3))
    return torch.where(keep[..., None], got, torch.full_like(got, _FAR))


class LevelFlags(NamedTuple):
    valid: np.ndarray
    edge: np.ndarray
    leaf: np.ndarray
    need: np.ndarray  # leg pipelines the inputs need per cell (see counts)


def eval_cells(centers: np.ndarray, parent_valid: np.ndarray, half,
               parent_half, footholds: torch.Tensor, quats: np.ndarray,
               robot: LegDimensions, k: int, margin: float, reach: float,
               use_rot: bool, shared: bool, quantize=None) -> LevelFlags:
    """Per-cell ``(valid, edge, leaf)`` of one level, and the leg
    pipelines the inputs need to decide each cell.

    ``shared=True`` is the reference octree's rule (>= k legs reach ONE
    foothold under one orientation, several_leg_octree.cu:91-116);
    ``shared=False`` lets each leg claim its own foothold (any over the
    footholds per leg, then count legs, several_leg.cu:633-697), with the
    edge re-derived for that rule from certain and possible leg counts.
    ``quantize``, when given, is applied to the footholds and the cell
    centres first (the control runs them through a lower precision).
    """
    dev = footholds.device
    L = leg_count(robot)
    S = quats.shape[0] if use_rot else 1
    q = torch.from_numpy(np.ascontiguousarray(quats[:S])).to(dev)
    legs = [leg_of(robot, l) for l in range(L)]
    workspaces = [workspace_tensors(ws, dev) for ws in
                  oriented_workspace_items(q.cpu(), robot)]
    elong_np, hm_np, h2m, big_cell = cell_level(half, parent_half, margin,
                                                reach)
    elong = torch.from_numpy(elong_np).to(dev)
    hm = torch.from_numpy(hm_np).to(dev)
    # a foothold farther than a leg's reach plus the crossing radius from
    # its coxa joint is neither reachable nor crossing for that leg
    cross_r = float(np.sqrt(np.sum(hm_np.astype(np.float64) ** 2)))
    ball2 = [(float(lg.coxa_length + lg.femur_length + lg.tibia_length)
              + cross_r) ** 2 for lg in legs]
    fh = footholds if quantize is None else quantize(footholds)
    cells_all = torch.from_numpy(np.ascontiguousarray(centers, _f32)).to(dev)
    if quantize is not None:
        cells_all = quantize(cells_all)
    pv_all = torch.from_numpy(np.ascontiguousarray(parent_valid)).to(dev)
    C = centers.shape[0]
    out = [np.zeros(C, bool) for _ in range(3)] + [np.zeros(C)]
    # how many candidates each cell has, to size the batches
    n_box = torch.zeros(C, dtype=torch.int64, device=dev)
    step = max(1, _BATCH_ELEMENTS // max(fh.shape[0], 1))
    for lo in range(0, C, step):
        v = fh[None] - cells_all[lo:lo + step, None]
        n_box[lo:lo + step] = torch.all((v > -elong) & (v <= elong),
                                        dim=-1).sum(dim=1)
    width = max(int(n_box.max()) if C else 1, 1)
    step = max(1, _BATCH_ELEMENTS // width)
    for lo in range(0, C, step):
        hi = min(lo + step, C)
        cells, pv = cells_all[lo:hi], pv_all[lo:hi]
        vect = _gather_candidates(cells, fh, elong)
        pre = torch.all((vect > -elong) & (vect <= elong), dim=-1)
        n = hi - lo
        any_valid = torch.zeros(n, dtype=torch.bool, device=dev)
        any_edge = torch.zeros(n, dtype=torch.bool, device=dev)
        any_leaf = torch.zeros(n, dtype=torch.bool, device=dev)
        leg_any = torch.zeros((S, L, n), dtype=torch.bool, device=dev)
        leg_cert = torch.zeros((S, L, n), dtype=torch.bool, device=dev)
        leg_poss = torch.zeros((S, L, n), dtype=torch.bool, device=dev)
        in_ball = torch.zeros((S, L, n), dtype=torch.float64, device=dev)
        decided_at = torch.full((n,), S, dtype=torch.int64, device=dev)
        for si in range(S):
            qi = q[si]
            reach_count = torch.zeros(pre.shape, dtype=torch.int32,
                                      device=dev)
            cross_count = torch.zeros(pre.shape, dtype=torch.int32,
                                      device=dev)
            for l in range(L):
                p0, cs = _as_leg0(vect, qi, legs[l].body_angle)
                ok, vec = distance_ws(p0, workspaces[si * L + l])
                dv = _undo_leg0(vec, cs, qi)
                if big_cell:
                    cross = torch.all((dv > -hm) & (dv <= hm), dim=-1)
                else:
                    cross = torch.sum(dv * dv, dim=-1) < h2m
                okp, crp = ok & pre, cross & pre
                reach_count += okp
                cross_count += crp
                leg_any[si, l] |= okp.any(dim=-1)
                leg_cert[si, l] |= (okp & ~crp).any(dim=-1)
                leg_poss[si, l] |= (okp | crp).any(dim=-1)
                dx = p0[..., 0] - float(legs[l].body)
                d2 = dx * dx + p0[..., 1] * p0[..., 1] + p0[..., 2] * p0[..., 2]
                in_ball[si, l] = ((d2 < ball2[l]) & pre).sum(dim=-1).double()
            item_valid = ((reach_count >= k) | pv[:, None]) & pre
            item_edge = (cross_count > (L - k)) & pre
            any_valid |= item_valid.any(dim=1)
            any_edge |= item_edge.any(dim=1)
            any_leaf |= (item_valid & ~item_edge).any(dim=1)
            if shared:
                # a cell is decided once all three flags are set
                done = any_valid & any_edge & any_leaf
                decided_at = torch.where(done & (decided_at == S), si + 1,
                                         decided_at)
        if shared:
            valid, edge, leaf = any_valid, any_edge, any_leaf
            pipelines = in_ball
        else:
            counts = leg_any.sum(dim=1)
            n_min = leg_cert.sum(dim=1)
            n_max = leg_poss.sum(dim=1)
            valid_o = (counts >= k) | pv[None, :]
            edge_o = (n_min < k) & (n_max >= k)
            valid = valid_o.any(dim=0)
            edge = edge_o.any(dim=0)
            leaf = valid & ~edge
            # decided once valid and edge are both set: leaf can only be
            # False from then on
            done = (torch.cumsum(valid_o.int(), 0) > 0) & (
                torch.cumsum(edge_o.int(), 0) > 0)
            decided_at = torch.where(done.any(dim=0),
                                     done.int().argmax(dim=0) + 1, S)
            # a leg whose three per-leg flags are set under an orientation
            # can be decided by one reachable, non-crossing foothold
            all3 = leg_any & leg_cert & leg_poss
            pipelines = torch.where(all3, torch.ones_like(in_ball), in_ball)
        used = (torch.arange(S, device=dev)[:, None]
                < decided_at[None, :])  # [S, n]
        need = (pipelines.sum(dim=1) * used).sum(dim=0)
        for o, t in zip(out, (valid, edge, leaf, need)):
            o[lo:hi] = t.cpu().numpy()
    return LevelFlags(*out)


def _sample(rng, n_cells: int, n: int) -> np.ndarray:
    return np.sort(rng.choice(n_cells, size=min(n, n_cells), replace=False))


class FlagCheck(NamedTuple):
    mismatches: int  # cells whose record disagrees
    evaluated: int  # cells evaluated
    deepest_cells: int  # cells of the last level
    deepest_need: float  # leg pipelines the last level needs (estimate)
    deepest_sampled: int


def evaluate_sample(levels, footholds: torch.Tensor, robot: LegDimensions,
                    solver: dict, shared: bool, rng: np.random.Generator,
                    per_level: int, deepest: int, quantize=None) -> list:
    """``[(cell indices, LevelFlags)]`` per level: a seeded sample of each
    level's cells with the ancestors whose validity they inherit,
    evaluated top-down, each cell with its evaluated parent's validity."""
    quats = orientation_samples(solver["angle_samples"],
                                solver["angle_min_max"])
    k = int(solver["legs_for_stability"])
    reach = total_reach(robot)
    want = [_sample(rng, lv.children.shape[0],
                    deepest if lv is levels[-1] else per_level)
            for lv in levels]
    refined = [np.nonzero(~lv.terminal)[0] for lv in levels]
    for d in range(len(levels) - 1, 0, -1):
        up = refined[d - 1][levels[d].parent[want[d]]]
        want[d - 1] = np.union1d(want[d - 1], up)
    out = []
    for d, lv in enumerate(levels):
        idx = want[d]
        if d == 0:
            pv = np.zeros(idx.size, bool)
        else:
            up = refined[d - 1][lv.parent[idx]]
            prev_idx, prev = out[-1]
            pv = prev.valid[np.searchsorted(prev_idx, up)]
        margin = 0.0 if lv.rot else float(solver["enable_rot_below"]) / 3.0
        out.append((idx, eval_cells(lv.children[idx], pv, lv.child_half,
                                    lv.half, footholds, quats, robot, k,
                                    margin, reach, lv.rot, shared,
                                    quantize)))
    return out


def record_claims(levels, sample) -> list:
    """``[(valid, refine)]`` per level that the record states for the
    sampled cells: a cell's valid flag, and whether it was refined (the
    last level: its edge flag)."""
    return [(lv.rec_valid[idx], lv.rec_edge[idx] if lv.last
             else ~lv.terminal[idx]) for lv, (idx, _) in zip(levels, sample)]


def check_flags(levels, footholds: torch.Tensor, robot: LegDimensions,
                solver: dict, shared: bool, rng: np.random.Generator,
                per_level: int, deepest: int, control=None) -> FlagCheck:
    """Count the sampled cells whose claims disagree with the reference
    (see the module docstring): the record's, or with ``control`` (a
    function that rounds the inputs) the control's, which is the reference
    itself on inputs through ``control`` put in the program's place on
    the same cells.  The last level's sample also gives the leg pipelines
    that level needs, scaled from the sample to all its cells."""
    args = (levels, footholds, robot, solver, shared)
    state = rng.bit_generator.state
    sample = evaluate_sample(*args, rng, per_level, deepest)
    if control is None:
        claims = record_claims(levels, sample)
    else:
        rng.bit_generator.state = state
        claims = [(g.valid, g.edge & ~g.leaf) for _, g in evaluate_sample(
            *args, rng, per_level, deepest, control)]
    bad = evaluated = 0
    for lv, (idx, f), (valid, refined) in zip(levels, sample, claims):
        refine = f.edge & ~f.leaf
        if lv.last:
            wrong = (valid != f.valid) | (refined != refine)
        else:
            wrong = np.where(refined, ~refine, (valid != f.valid) | refine)
        bad += int(wrong.sum())
        evaluated += idx.size
    idx, f = sample[-1]
    n_last = levels[-1].children.shape[0]
    scale = n_last / max(idx.size, 1)
    return FlagCheck(bad, evaluated, n_last, float(f.need.sum()) * scale,
                     int(idx.size))

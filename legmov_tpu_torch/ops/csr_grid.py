"""CSR (variable-capacity) foothold storage + windowed candidate solvers.

The fixed-capacity bucket table (ops/grid.py) pads every cell to the
terrain's densest cell: on a 10M-point moon map most of the table is
sentinel padding, and every padded slot costs full kernel work.  This
module stores footholds in CSR form — points sorted by cell id (z-fastest,
so each (x, y) cell *column* is one contiguous range), plus a ``starts``
prefix array — 12 B/point exactly, and streams candidates to the fused
multi-leg kernels in fixed-size windows of REAL points:

* the neighbor-offset ball is decomposed once into (dx, dy, dz_lo,
  dz_hi) **columns**; a pose's candidates in one column are one
  contiguous CSR slice;
* per round, each pose builds a queue over the statically nearest-first
  column order, keeping columns relevant to a still-missing leg's reach
  ball (exact per-pose relevance);
* the queue is walked in ``window`` chunks (per-pose chunk decode by prefix
  sums), so dense and sparse poses advance independently — no fixed-cap
  padding anywhere, only <= 1 partial window per column;
* pose compaction rounds and the proven-infeasible early exit come from
  ops/solve_schedule.py; results are exact whatever ``overflow`` says.

Two solvers share the queues and differ in how a window reaches a kernel:
:func:`make_csr_solver` gathers ``[A, window]`` windows with tensor indexing
and hands them to the multi-leg any-reach kernel, one launch per queue step;
:func:`make_csr_dma_solver` hands a whole round's ``[A, S]`` start / length /
leg-mask matrices to the CSR window kernel, which reads the windows in place
(ops/cuda_multileg.py).  Queue building is eager tensor code on the device;
each round reads at most one scalar (the longest queue) back to the host,
counted in ``solve.stats["syncs"]``.

Reference anchor: this replaces the octree's per-node foothold loops +
elongated-box early-outs (several_leg_octree.cu:45-131) with sorted-grid
slicing; linear z-fastest cell order gives the same contiguity Morton codes
would here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from legmov_tpu_torch.config import resolve_device
from legmov_tpu_torch.models.leg import LegDimensions
from legmov_tpu_torch.models.robot import leg_count
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.ops.cuda_multileg import (
    SENTINEL,
    make_csr_window_kernel,
    make_multileg_kernel,
    oriented_tables,
)
from legmov_tpu_torch.ops.grid import cell_indices, f32_scalar, pose_cells
from legmov_tpu_torch.ops.solve_schedule import (
    POSE_ROWS,
    make_undecided,
    robot_geometry,
    run_schedule,
    wanted,
)

#: queue steps per launch of an unbounded round (bounds the ``[A, S]``
#: matrices; the round's queue length is known, so this costs no read-back)
_MAX_STEPS = 1024

_DEFAULT_ROUNDS = ((12, 1.0), (24, 0.5), (48, 0.25), (96, 0.125), (0, 0.0625))


def _pose_columns(
    body, quats, starts, origin, columns, cell_size, dims, mount_vec, reach_l,
    with_zclip: bool = False,
):
    """Per-(pose, column) CSR ranges + per-(pose, column, leg) relevance.

    Returns ``(col_start [P, C], col_len [P, C], rel [P, C, L])`` where
    ``rel`` is the exact leg-reach-ball vs column-AABB test (a column is
    relevant to leg l iff the ball around the pose's rotated mount point
    intersects the column's clamped box) AND the column is non-empty.
    Cell indices are int64 throughout, so a far-sentinel pose (1e9) or a
    large grid cannot overflow the flat index.

    With ``with_zclip`` a fourth element is returned for per-round
    z-subrange clipping: ``(colflat [P, C], zlo [P, C], zhi [P, C],
    dxy2 [P, C, L], cz [P, L])`` — the column's flat cell base
    (z index 0), its ball-clipped z-cell bounds, each leg's squared
    horizontal distance to the column's xy-AABB, and each leg's ball
    center z (body-relative).  A leg's reachable z-range inside a
    column is ``cz +- sqrt(reach^2 - dxy2)`` (exact superset of its
    reachable footholds there), so a chunk queued for specific missing
    legs may clip the column slice to the union of their z-ranges.
    """
    nx, ny, nz = dims
    dev = body.device
    cs = float(np.float32(cell_size))
    base = pose_cells(body, origin, cell_size)  # [P, 3] int64
    columns = columns.to(torch.int64)

    cx = base[:, 0:1] + columns[None, :, 0]  # [P, C]
    cy = base[:, 1:2] + columns[None, :, 1]
    z_lo_raw = base[:, 2:3] + columns[None, :, 2]
    z_hi_raw = base[:, 2:3] + columns[None, :, 3]
    zlo = torch.clamp(z_lo_raw, 0, nz - 1)
    zhi = torch.clamp(z_hi_raw, 0, nz - 1)
    xy_ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    z_ok = (z_hi_raw >= 0) & (z_lo_raw <= nz - 1)
    ok = xy_ok & z_ok
    cxc = torch.clamp(cx, 0, nx - 1)
    cyc = torch.clamp(cy, 0, ny - 1)
    colflat = (cxc * ny + cyc) * nz  # z-index-0 cell base
    col_start = starts[colflat + zlo].to(torch.int64)  # [P, C]
    col_len = torch.where(
        ok, starts[colflat + zhi + 1].to(torch.int64) - col_start, 0)

    mounts = torch.as_tensor(mount_vec, dtype=torch.float32, device=dev)
    centers = quat.rotate(quats[:, None, :], mounts[None, :, :])  # [P, L, 3]
    f32 = torch.float32
    lo = torch.stack(
        [cxc.to(f32) * cs + origin[0] - body[:, 0:1],
         cyc.to(f32) * cs + origin[1] - body[:, 1:2],
         zlo.to(f32) * cs + origin[2] - body[:, 2:3]],
        dim=-1,
    )  # [P, C, 3]
    full = torch.full_like(lo[..., 0], cs)
    hi = lo + torch.stack([full, full, (zhi - zlo + 1).to(f32) * cs], dim=-1)
    cen = centers[:, None, :, :]
    nearest = torch.minimum(torch.maximum(cen, lo[:, :, None, :]),
                            hi[:, :, None, :])
    diff = nearest - cen
    d2 = torch.sum(diff * diff, dim=-1)
    reach2 = torch.as_tensor(np.asarray(reach_l, np.float32), device=dev) ** 2
    rel = d2 <= reach2[None, None, :]
    rel &= (col_len > 0)[:, :, None]  # [P, C, L]
    if not with_zclip:
        return col_start, col_len, rel
    dxy2 = torch.sum(diff[..., :2] * diff[..., :2], dim=-1)  # [P, C, L]
    return col_start, col_len, rel, (colflat, zlo, zhi, dxy2,
                                     centers[:, :, 2])


class CSRGrid(NamedTuple):
    """Footholds sorted by cell id + prefix offsets (tensors on one device)."""

    xs: torch.Tensor  # [F] f32, cell-sorted
    ys: torch.Tensor  # [F]
    zs: torch.Tensor  # [F]
    starts: torch.Tensor  # [n_cells + 1] int32
    origin: torch.Tensor  # [3] f32
    cell_size: float
    dims: tuple[int, int, int]


def _empty_grid(cell_size: float, dev) -> CSRGrid:
    z = torch.zeros(0, dtype=torch.float32, device=dev)
    return CSRGrid(
        xs=z, ys=z.clone(), zs=z.clone(),
        starts=torch.zeros(2, dtype=torch.int32, device=dev),
        origin=torch.zeros(3, dtype=torch.float32, device=dev),
        cell_size=float(cell_size), dims=(1, 1, 1),
    )


def build_csr_grid(footholds: np.ndarray, cell_size: float,
                   device=None) -> CSRGrid:
    """Sort ``[F, 3]`` footholds by cell id (z-fastest) on the host (stable
    sort: within a cell the input order is kept), build the offsets, and
    put the arrays on ``device`` (``None`` = the CUDA card)."""
    dev = resolve_device(device)
    fh = np.ascontiguousarray(footholds, dtype=np.float32)
    if fh.shape[0] == 0:
        return _empty_grid(cell_size, dev)
    if fh.shape[0] >= 2 ** 31:
        raise ValueError("the int32 offsets hold fewer than 2^31 footholds")
    origin = fh.min(axis=0)
    idx = np.floor((fh - origin) / cell_size).astype(np.int64)
    dims = tuple(int(d) + 1 for d in idx.max(axis=0))
    n_cells = int(np.asarray(dims, np.int64).prod())
    flat = cell_indices(fh, origin, cell_size, dims, "csr_grid")
    order = np.argsort(flat, kind="stable")
    srt = fh[order]
    counts = np.bincount(flat, minlength=n_cells)
    starts = np.zeros(n_cells + 1, np.int32)
    np.cumsum(counts, out=starts[1:], dtype=np.int32)
    return CSRGrid(
        xs=torch.from_numpy(np.ascontiguousarray(srt[:, 0])).to(dev),
        ys=torch.from_numpy(np.ascontiguousarray(srt[:, 1])).to(dev),
        zs=torch.from_numpy(np.ascontiguousarray(srt[:, 2])).to(dev),
        starts=torch.from_numpy(starts).to(dev),
        origin=torch.from_numpy(origin).to(dev),
        cell_size=float(cell_size),
        dims=dims,
    )


def build_csr_grid_device(
    z_lattice: np.ndarray,
    xs_axis: np.ndarray,
    ys_axis: np.ndarray,
    cell_size: float,
    device=None,
) -> CSRGrid:
    """CSR grid assembled ON DEVICE from a lattice terrain.

    Lattice terrains (every ``moon_ground``/``flat_grid`` map, and the
    reference's own maps.py grids) carry no information in x/y beyond
    their axis vectors, so this path copies ONLY the height field plus the
    two f32 axes to the device (1/3 of the bytes) and rebuilds the
    cell-sorted SoA there: x/y regenerated by gathering the axis values
    (bit-identical to the host lattice by construction — the axes ARE the
    host's f32 values), cell ids in the same f32 op order as
    :func:`build_csr_grid` (int64), a stable device argsort (within-cell
    order = lattice order, as the host's stable sort gives), and a
    bincount + cumsum for the offsets.

    ``terrain[i] = (xs_axis[i // ny_lat], ys_axis[i % ny_lat],
    z_lattice[i])`` — the row-major x-outer layout of
    terrain/maps.py (np.meshgrid indexing="ij").
    """
    dev = resolve_device(device)
    z = np.ascontiguousarray(z_lattice, dtype=np.float32)
    xa = np.ascontiguousarray(xs_axis, dtype=np.float32)
    ya = np.ascontiguousarray(ys_axis, dtype=np.float32)
    nx_lat, ny_lat = xa.shape[0], ya.shape[0]
    if z.shape[0] != nx_lat * ny_lat:
        raise ValueError("z_lattice length != nx * ny")
    if z.shape[0] == 0:
        return _empty_grid(cell_size, dev)
    if z.shape[0] >= 2 ** 31:
        raise ValueError("the int32 offsets hold fewer than 2^31 footholds")
    # origin/dims mirror build_csr_grid's f32 host arithmetic exactly
    origin = np.array([xa.min(), ya.min(), z.min()], np.float32)
    cs = np.float32(cell_size)
    dims = (
        int(np.floor((xa.max() - origin[0]) / cs)) + 1,
        int(np.floor((ya.max() - origin[1]) / cs)) + 1,
        int(np.floor((z.max() - origin[2]) / cs)) + 1,
    )
    nx, ny, nz = dims

    zd = torch.from_numpy(z).to(dev)
    xad = torch.from_numpy(xa).to(dev)
    yad = torch.from_numpy(ya).to(dev)
    od = torch.from_numpy(origin).to(dev)
    cst = f32_scalar(cs, dev)
    i = torch.arange(z.shape[0], dtype=torch.int64, device=dev)
    x = xad[i // ny_lat]
    y = yad[i % ny_lat]
    del i
    cx = torch.floor((x - od[0]) / cst).to(torch.int64)
    cy = torch.floor((y - od[1]) / cst).to(torch.int64)
    cz = torch.floor((zd - od[2]) / cst).to(torch.int64)
    cell = (cx * ny + cy) * nz + cz
    del cx, cy, cz
    order = torch.argsort(cell, stable=True)
    counts = torch.bincount(cell, minlength=nx * ny * nz)
    starts = torch.zeros(nx * ny * nz + 1, dtype=torch.int32, device=dev)
    starts[1:] = torch.cumsum(counts, dim=0).to(torch.int32)
    return CSRGrid(
        xs=x[order], ys=y[order], zs=zd[order], starts=starts,
        origin=od, cell_size=float(cell_size), dims=dims,
    )


def ball_columns(offsets: np.ndarray) -> np.ndarray:
    """Decompose an offset ball into ``[C, 4]`` (dx, dy, dz_lo, dz_hi)
    columns, statically ordered nearest-first (horizontal distance, then
    index) — each column is one contiguous CSR slice per pose."""
    offs = np.asarray(offsets)
    cols: dict[tuple[int, int], list[int]] = {}
    for i, j, k in offs:
        cols.setdefault((int(i), int(j)), []).append(int(k))
    rows = []
    for (i, j), ks in cols.items():
        ks = sorted(ks)
        if ks != list(range(ks[0], ks[-1] + 1)):
            raise ValueError("ball z-range not contiguous")
        rows.append((i, j, ks[0], ks[-1]))
    rows.sort(key=lambda r: (r[0] * r[0] + r[1] * r[1], r[:2]))
    return np.asarray(rows, np.int32)


def _column_occupancy(csr: CSRGrid, quantile: float) -> float:
    """The ``quantile`` of per-(x, y) column occupancy (full z-extent) —
    a conservative upper proxy for any pose's per-column candidate
    count."""
    starts = csr.starts.cpu().numpy()
    nx, ny, nz = csr.dims
    per_xy = starts[nz::nz][: nx * ny] - starts[0:-1:nz][: nx * ny]
    occ = per_xy[per_xy > 0]
    return float(np.quantile(occ, quantile)) if occ.size else 0.0


def suggest_window(
    csr: CSRGrid, quantile: float = 0.90,
    lo: int = 1024, hi: int = 8192,
) -> int:
    """Density-aware candidate window for the CSR solvers: the column
    occupancy rounded up to a power of two, clamped to ``[lo, hi]`` (a
    window tracks column occupancy: wider than a column wastes a partial
    window per column, narrower multiplies the queue steps)."""
    occ = max(1.0, _column_occupancy(csr, quantile))
    w = 1 << int(np.ceil(np.log2(occ)))
    return int(min(max(w, lo), hi))


def suggest_zclip(csr: CSRGrid, window: int, quantile: float = 0.90) -> bool:
    """Whether per-round z-subrange clipping pays for this grid.

    Clipping shortens column slices to the missing legs' union ball
    chord, but whole windows are evaluated — so it only saves work when
    columns span multiple windows; where columns fit one window the
    per-round ``[A, C, L]`` clip math is pure overhead.
    """
    return _column_occupancy(csr, quantile) > window


def suggest_rounds(
    csr: CSRGrid, columns: np.ndarray, window: int,
    quantile: float = 0.90, first: int = 8,
) -> tuple:
    """Density-aware early-exit schedule for the CSR solvers.

    A round over pose fraction ``f`` with quota ``S`` costs roughly
    ``f x P x S`` queue steps no matter how many poses actually need it,
    so the schedule that minimizes wasted (pose, window) slots keeps every
    round's ``f x S`` product constant: start with a SMALL full-pose round
    (most poses on continuous terrain decide within a few windows) and
    extend a doubling-quota / halving-fraction ladder until the cumulative
    quota covers a worst-case pose's full queue.

    The queue size is estimated from the grid itself: the ``quantile``
    of per-(x, y) column occupancy (full z-extent — a conservative
    upper proxy for any pose's z-window) converted to window chunks,
    times the ball's column count, quantized to the next power of two.
    The fraction floor is 1/256; after the first unbounded tail a widening
    ladder of unbounded tails (x4 up to 1/2) follows, each of which fully
    finishes the undecided poses it gathers and costs next to nothing once
    nothing is undecided, so the full-width safety round only works in the
    pathological case.
    """
    len_col = _column_occupancy(csr, quantile)
    chunks = max(1, int(np.ceil(len_col / window)))
    q = max(2 * first, int(np.asarray(columns).shape[0]) * chunks)
    q = 1 << int(np.ceil(np.log2(q)))
    rounds = []
    quota, frac, done = first, 1.0, 0
    while done + quota < q and frac > 1.0 / 256.0:
        rounds.append((quota, frac))
        done += quota
        quota *= 2
        frac /= 2.0
    rounds.append((0, frac))  # unbounded tail for the stragglers
    f2 = frac
    while f2 < 0.5:
        f2 = min(4.0 * f2, 0.5)
        rounds.append((0, f2))
    return tuple(rounds)


def _column_queue(cl_, rel_, legs_, scanned_, undecided, window: int):
    """Per-pose window queue over still-wanted columns.

    Returns ``(want [A, C], cum [A, C])`` where ``cum`` is the inclusive
    cumsum of per-column chunk counts (``ceil(len / window)`` for wanted
    columns, 0 otherwise, so an empty column queues nothing) — chunk q of a
    pose's queue decodes to (column, offset-within-column) by searching
    ``cum``.
    """
    want = wanted(rel_, legs_, scanned_, undecided)
    chunks = torch.where(want, (cl_ + (window - 1)) // window, 0)
    cum = torch.cumsum(chunks, dim=1)
    return want, cum


def _decode_chunks(cs_, cl_, cum, q, window: int):
    """Chunks ``q [A, S]`` of each pose's queue as ``(column [A, S], start
    [A, S], remaining [A, S], live [A, S])``: the column chunk q falls in
    (``sum(cum <= q)``, by binary search), the chunk's first element, the
    elements left in its column from there, and whether the pose's queue
    reaches that far."""
    C = cum.shape[1]
    col = torch.searchsorted(cum, q, right=True)
    colc = torch.clamp(col, max=C - 1)
    prev = torch.where(
        colc > 0, torch.gather(cum, 1, torch.clamp(colc - 1, min=0)), 0)
    within = q - prev
    start = torch.gather(cs_, 1, colc) + within * window
    rem = torch.gather(cl_, 1, colc) - within * window
    live = q < cum[:, -1:]
    return colc, start, rem, live


def _empty_result(P, L, dev):
    return (torch.zeros((P, L), dtype=torch.bool, device=dev),
            torch.zeros(P, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


def _check_solver_args(decide, window, backend):
    make_undecided(decide, 0)  # validate ``decide`` eagerly
    if int(window) < 1:
        raise ValueError(f"window must be positive, got {window}")
    if backend not in ("auto", "torch"):
        raise ValueError(f"backend must be 'auto' or 'torch', got {backend!r}")


def make_csr_solver(
    robot: LegDimensions, window: int = 2048,
    rounds: tuple = _DEFAULT_ROUNDS, decide: str = "legs",
    backend: str = "auto",
):
    """Windowed CSR positionability solver (gathered windows).

    ``solve(body [P,3], quats [P,4], grid: CSRGrid fields as args,
    columns [C,4], cell_size=, k=, dims=) -> (legs [P,L], quorum [P],
    overflow)``, all tensors on the device of ``body``.  ``window`` is the
    candidate chunk per kernel call; ``rounds`` are (n_windows,
    pose_fraction) (0 = no limit, bounded by each pose's own queue).
    ``backend="auto"`` sends the windows to the multi-leg CUDA kernel on a
    card (its plain version for CPU tensors); ``"torch"`` uses the plain
    version wherever the tensors live.

    A full-width safety round is always appended, so results are
    unconditionally exact: when the scheduled rounds already decided
    every pose, the safety round walks ZERO steps (its only cost is the
    queue bookkeeping); when quotas starved, it finishes the stragglers.
    ``overflow`` reports whether the safety round had to do real work
    (i.e. the schedule was undersized).

    ``decide`` picks the exactness contract / stopping rule:

    * ``"legs"`` (default): every leg bit is resolved exactly — a pose
      scans until each leg either succeeded or exhausted its relevant
      columns.
    * ``"quorum"``: only the quorum bit is guaranteed exact.  A pose
      stops as soon as the quorum is DECIDED: achieved (``found >= k``)
      or impossible (``found + still-open legs < k``).  With ``k == L``
      one proven-infeasible leg kills the pose immediately — the
      octree's per-node early-out (several_leg_octree.cu:117-131) as a
      scan-scheduling rule; for such poses the other legs' bits are
      under-reported (never over-reported), so the final
      ``sum(legs) >= k`` test still returns the exact quorum.

    Every round reads one scalar back (its longest queue);
    ``solve.stats["syncs"]`` counts them.
    """
    _check_solver_args(decide, window, backend)
    window = int(window)
    kernel_fn = make_multileg_kernel(robot)
    if backend == "torch":
        kernel_fn = kernel_fn.plain
    L = leg_count(robot)
    mount_vec, reach_l = robot_geometry(robot)
    stats = {"syncs": 0}

    def solve(body, quats, xs, ys, zs, starts, origin, columns,
              cell_size: float, k: int, dims: tuple):
        P = body.shape[0]
        C = columns.shape[0]
        F = xs.shape[0]
        dev = body.device
        if F == 0 or P == 0:
            return _empty_result(P, L, dev)
        col_start, col_len, rel = _pose_columns(
            body, quats, starts, origin, columns, cell_size, dims, mount_vec,
            reach_l,
        )
        tab = oriented_tables(body, quats, robot)
        k_eff = int(k if k else L)
        undecided = make_undecided(decide, k_eff)
        pos = torch.arange(window, device=dev)[None, :]

        def run_round(per_pose, rel_, legs_, scanned_, n_windows):
            """Walk up to n_windows chunks of each pose's column queue."""
            tab_, cs_, cl_ = per_pose
            want, cum = _column_queue(cl_, rel_, legs_, scanned_, undecided,
                                      window)
            limit = int(cum[:, -1].max())
            stats["syncs"] += 1
            if n_windows:
                limit = min(limit, n_windows)
            for q in range(limit):
                qq = torch.full((cum.shape[0], 1), q, dtype=torch.int64,
                                device=dev)
                _, start, rem, live = _decode_chunks(cs_, cl_, cum, qq, window)
                idxs = torch.clamp(start + pos, 0, F - 1)
                mask = live & (pos < rem)

                def take(comp):
                    return torch.where(mask, comp[idxs], SENTINEL)

                legs_ = kernel_fn(tab_, take(xs), take(ys), take(zs), legs_)
            # columns fully consumed this round become scanned; a column
            # cut mid-way is re-queued next round (correct, mildly
            # wasteful)
            scanned_ = scanned_ | (want & (cum <= limit))
            return legs_, scanned_

        legs, scanned, over_quota = run_schedule(
            tuple(rounds) + ((0, 1.0),),  # full-width safety round
            (tab, col_start, col_len), rel,
            torch.zeros((P, L), dtype=torch.bool, device=dev),
            torch.zeros((P, C), dtype=torch.bool, device=dev),
            undecided, run_round,
        )
        quorum = torch.sum(legs, dim=-1) >= k_eff
        return legs, quorum, over_quota

    solve.stats = stats
    return solve


def make_csr_dma_solver(
    robot: LegDimensions, window: int = 2048,
    rounds: tuple = _DEFAULT_ROUNDS, decide: str = "legs",
    zclip: bool = True, backend: str = "auto",
):
    """CSR positionability solver with IN-KERNEL candidate streaming.

    Same contract, schedule semantics, ``decide`` modes and ``backend``
    choice as :func:`make_csr_solver`, but the candidate windows are not
    gathered: per-(pose, step) CSR start offsets, window lengths and leg
    bit masks go to the CSR window kernel as ``[A, S]`` matrices, the
    foothold component arrays stay where they are, and the kernel reads
    each window in place (ops/cuda_multileg.py ``csr_window_kernel``).  A
    bounded round is ONE launch over its quota of steps; an unbounded
    round reads its longest queue back once and launches it whole (in
    slabs of at most 1024 steps).

    Every step carries the bit mask of legs its column still serves
    (relevant AND missing at queue-build time) and the kernel evaluates
    only those.  Per-leg predication is EXACT: relevance is a superset of
    reachability (a leg's reachable points lie inside its reach ball), so
    a leg absent from the mask cannot gain a bit from that chunk, and found
    legs are monotone.  Windows start at their column's own offset and end
    with the column, so both solvers evaluate the same candidates and give
    the same bits in both ``decide`` modes.

    With ``zclip`` each round clips every column slice to the union
    z-range of the legs that still need it (see ``clipped_slices``).

    The pose axis is padded to a multiple of 8 with far-away identity
    poses (relevant to no column: zero queue work) so that the compaction
    rounds gather the same pose counts for any ``P``; the pad is sliced
    off the results.  ``solve.stats["syncs"]`` counts the scalars read
    back (one per unbounded round).
    """
    _check_solver_args(decide, window, backend)
    window = int(window)
    kernel_fn = make_csr_window_kernel(robot)
    if backend == "torch":
        kernel_fn = kernel_fn.plain
    L = leg_count(robot)
    mount_vec, reach_l = robot_geometry(robot)
    stats = {"syncs": 0}

    def solve(body, quats, xs, ys, zs, starts, origin, columns,
              cell_size: float, k: int, dims: tuple):
        P_in = body.shape[0]
        C = columns.shape[0]
        F = xs.shape[0]
        dev = body.device
        if F == 0 or P_in == 0:
            return _empty_result(P_in, L, dev)
        pose_pad = (-P_in) % POSE_ROWS
        if pose_pad:
            body = torch.cat(
                [body, torch.full((pose_pad, 3), SENTINEL, dtype=body.dtype,
                                  device=dev)])
            ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=quats.dtype,
                                 device=dev)
            quats = torch.cat([quats, ident.expand(pose_pad, 4)])
        P = P_in + pose_pad

        if zclip:
            _, _, rel, zinfo = _pose_columns(
                body, quats, starts, origin, columns, cell_size, dims,
                mount_vec, reach_l, with_zclip=True,
            )
            colflat, col_zlo, col_zhi, dxy2, cz = zinfo
            cz_abs = body[:, 2:3] + cz  # [P, L] absolute ball-center z
            reach2 = (torch.as_tensor(np.asarray(reach_l, np.float32),
                                      device=dev) ** 2)[None, None, :]
            oz = origin[2]
            cst = f32_scalar(cell_size, dev)
        else:
            col_start, col_len, rel = _pose_columns(
                body, quats, starts, origin, columns, cell_size, dims,
                mount_vec, reach_l,
            )
        tab = oriented_tables(body, quats, robot)
        k_eff = int(k if k else L)
        undecided = make_undecided(decide, k_eff)
        leg_bit = (1 << torch.arange(L, dtype=torch.int64, device=dev))

        def clipped_slices(colflat_, zlo_, zhi_, dxy2_, cza_, need):
            """Per-(pose, column) CSR (start, len) clipped to the union
            z-range of the legs in ``need`` [A, C, L].

            Exact superset: leg l's reachable footholds in a column lie
            within ``cz +- sqrt(reach^2 - dxy2)`` (its ball's z-chord at
            the column's horizontal distance), so clipping the slice to
            the union over still-needed legs can only drop points no
            needed leg could reach.  The union only narrows as legs are
            found (monotone), so marking a clipped column scanned stays
            valid for later rounds."""
            dz = torch.sqrt(torch.clamp(reach2 - dxy2_, min=0.0))
            any_need = torch.any(need, dim=-1)
            neg = -3e38
            zlo_u = -torch.amax(
                torch.where(need, -(cza_[:, None, :] - dz), neg), dim=-1)
            zhi_u = torch.amax(
                torch.where(need, cza_[:, None, :] + dz, neg), dim=-1)
            zlo_u = torch.where(any_need, zlo_u, 0.0)
            zhi_u = torch.where(any_need, zhi_u, -1.0)
            zl = torch.maximum(
                torch.floor((zlo_u - oz) / cst).to(torch.int64), zlo_)
            zh = torch.minimum(
                torch.floor((zhi_u - oz) / cst).to(torch.int64), zhi_)
            ok = any_need & (zh >= zl)
            zlc = torch.clamp(zl, 0, dims[2] - 1)
            zhc = torch.clamp(zh, 0, dims[2] - 1)
            st = starts[colflat_ + zlc].to(torch.int64)
            ln = torch.where(
                ok, starts[colflat_ + zhc + 1].to(torch.int64) - st, 0)
            return st, ln

        def steps_for(cs_, cl_, cum, legbits, q0, S):
            """Start offsets, lengths and leg bit masks (int32 ``[A, S]``)
            of chunks q0 .. q0+S of each pose's queue.  ``legbits [A, C]``
            is the bit mask of legs each column still serves; steps beyond
            a pose's queue get mask 0 and length 0, the kernel's skip
            marker."""
            A = cs_.shape[0]
            q = (q0 + torch.arange(S, dtype=torch.int64, device=dev))[None, :]
            q = q.expand(A, S).contiguous()
            colc, start, rem, live = _decode_chunks(cs_, cl_, cum, q, window)
            i32 = torch.int32
            starts_mat = torch.where(live, start, 0).to(i32)
            lens_mat = torch.where(
                live, torch.clamp(rem, 0, window), 0).to(i32)
            mask_mat = torch.where(
                live, torch.gather(legbits, 1, colc), 0).to(i32)
            return starts_mat, lens_mat, mask_mat

        def run_round(per_pose, rel_, legs_, scanned_, n_windows):
            # legs each column still serves, and (when zclip) the column
            # slice clipped to their union z-range (both exact: relevance
            # is a superset of reachability, found legs are monotone)
            need0 = rel_ & ~legs_[:, None, :]
            if zclip:
                (tab_, colflat_, zlo_, zhi_, dxy2_, cza_) = per_pose
                cs_, cl_ = clipped_slices(
                    colflat_, zlo_, zhi_, dxy2_, cza_, need0)
            else:
                tab_, cs_, cl_ = per_pose
            want, cum = _column_queue(cl_, rel_, legs_, scanned_, undecided,
                                      window)
            need = need0 & want[:, :, None]
            legbits = torch.sum(need.to(torch.int64) * leg_bit, dim=-1)
            if n_windows:
                q_done = n_windows
            else:
                q_done = int(cum[:, -1].max())
                stats["syncs"] += 1
            for q0 in range(0, q_done, _MAX_STEPS):
                mats = steps_for(cs_, cl_, cum, legbits, q0,
                                 min(_MAX_STEPS, q_done - q0))
                legs_ = kernel_fn(tab_, legs_, *mats, xs, ys, zs)
            scanned_ = scanned_ | (want & (cum <= q_done))
            return legs_, scanned_

        per_pose = (
            (tab, colflat, col_zlo, col_zhi, dxy2, cz_abs) if zclip
            else (tab, col_start, col_len)
        )
        legs, scanned, over_quota = run_schedule(
            tuple(rounds) + ((0, 1.0),),  # full-width safety round
            per_pose, rel,
            torch.zeros((P, L), dtype=torch.bool, device=dev),
            torch.zeros((P, C), dtype=torch.bool, device=dev),
            undecided, run_round,
        )
        quorum = torch.sum(legs, dim=-1) >= k_eff
        return legs[:P_in], quorum[:P_in], over_quota

    solve.stats = stats
    return solve

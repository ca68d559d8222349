"""Rank-mesh sharding of the movability solvers on ``torch.distributed``.

Layout (the JAX package's parallel/sharding.py, with ranks for devices):

* **points / poses axis -> data parallel** over every rank, or over the
  mesh's ``poses`` axis: the per-point evaluators are embarrassingly
  parallel, so point and body-pose batches split across ranks with no
  communication but the gather of the result.
* **foothold axis -> optional second mesh axis** ``points``: each rank
  reduces reachability over its own footholds, and the "any foothold" OR is
  an ``all_reduce`` of the int32 leg bits over the rank's row (the ranks of
  one pose shard): the reference's warp vote and ``__shared__`` flag OR
  (several_leg.cu:92-129) across ranks.

A mesh is a ``(poses, points)`` grid of the ranks of the default process
group, rank ``r`` at ``divmod(r, points)``; each rank evaluates its shard on
its own device, with the same kernels as the unsharded call.  A split that
does not divide gives the leading ranks one row more; every rank's rows are
padded to the largest count for the gather and the pad rows' results are
dropped.  A mesh of one rank calls the unsharded function directly: no
copy, no collective.  Every sharded function returns the whole result on
every rank, on the rank's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from legmov_tpu_torch.models.leg import LegDimensions
from legmov_tpu_torch.models.robot import leg_count
from legmov_tpu_torch.ops import cuda_kernels as ck
from legmov_tpu_torch.ops.positionability import (
    positionable,
    reachable_legs,
)
from legmov_tpu_torch.parallel.multihost import PoseShard, rank_device


@dataclasses.dataclass
class RankMesh:
    """A ``(poses, points)`` grid of every rank of the default group.

    ``groups[(kind, host)]``: the process group of this rank's ``"row"``
    (one pose index, every points index: the foothold OR), ``"col"`` (one
    points index, every pose index: the pose gather) or ``"all"``, for
    device tensors (``host=False``) or host tensors (``host=True``; gloo,
    the same groups unless the default backend is NCCL).  ``stats`` counts
    the collectives and the host<->device copies the gathers add."""

    shape: tuple
    rank: int
    coords: tuple
    device: torch.device
    nccl: bool
    groups: dict
    stats: dict

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def host_group(self):
        """Every rank, for host tensors (None: a world of one)."""
        return self.groups.get(("all", True))


def make_mesh(n_devices: int | None = None, points_axis: int = 1,
              devices=None) -> RankMesh:
    """Build a ``(poses, points)`` mesh over every rank.

    ``points_axis`` ranks split the foothold axis, the rest the poses.
    ``n_devices`` (if given) must be the world size: a mesh spans every rank
    of the default group.  ``devices`` is where this rank computes (``None``
    = its card, ``"cpu"`` the host).  Every rank calls this, in the same
    order as its other group calls (``dist.new_group`` is collective).
    """
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    n = world if n_devices is None else int(n_devices)
    points_axis = int(points_axis)
    if n != world:
        raise ValueError(f"a mesh spans every rank: asked for {n}, the world "
                         f"has {world}")
    if points_axis < 1 or n % points_axis != 0:
        raise ValueError(f"{n} ranks not divisible by points_axis={points_axis}")
    dev = rank_device(devices)
    shape = (n // points_axis, points_axis)
    nccl = up and dist.get_backend() == "nccl"
    groups = {}
    if world > 1:
        members = {
            "row": [list(range(i * points_axis, (i + 1) * points_axis))
                    for i in range(shape[0])],
            "col": [list(range(j, n, points_axis)) for j in range(points_axis)],
        }
        mine = {"row": rank // points_axis, "col": rank % points_axis}
        for host in ((False, True) if nccl else (False,)):
            backend = "gloo" if host else None
            for kind, lists in members.items():
                made = [dist.new_group(m, backend=backend) for m in lists]
                groups[kind, host] = made[mine[kind]]
            groups["all", host] = (dist.new_group(backend="gloo") if host
                                   else dist.group.WORLD)
        if not nccl:
            for kind in ("row", "col", "all"):
                groups[kind, True] = groups[kind, False]
    return RankMesh(shape=shape, rank=rank, coords=divmod(rank, points_axis),
                    device=dev, nccl=nccl, groups=groups,
                    stats={"collectives": 0, "copies": 0})


def split_counts(n: int, parts: int) -> list[int]:
    """Rows of each of ``parts`` contiguous ranges of ``n``: the leading
    ones ``ceil(n / parts)``, the rest what is left (possibly 0)."""
    q = -(-n // parts)
    return [max(0, min(q, n - i * q)) for i in range(parts)]


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(dev) if dtype is None else t.to(dev, dtype)


def _local(mesh: RankMesh, x, parts: int, index: int, dtype=torch.float32):
    """``(rows of part index on the rank's device, every part's count)``;
    ``x`` is the whole array or this rank's :class:`PoseShard`."""
    if isinstance(x, PoseShard):
        if len(x.counts) != parts:
            raise ValueError("a PoseShard splits over every rank")
        return _tensor(x.local, mesh.device, dtype), list(x.counts)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    counts = split_counts(int(x.shape[0]), parts)
    lo = sum(counts[:index])
    return _tensor(x[lo:lo + counts[index]], mesh.device, dtype), counts


def _wire(mesh: RankMesh, t: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The tensor a collective takes, and whether it is a host tensor: under
    gloo a device tensor goes to the host (a counted copy)."""
    if mesh.nccl and t.is_cuda:
        return t, False
    if t.is_cuda:
        mesh.stats["copies"] += 1
    return t.cpu(), True


def _home(mesh: RankMesh, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` back on the device ``like`` came from (a counted copy)."""
    if like.is_cuda and not t.is_cuda:
        mesh.stats["copies"] += 1
    return t.to(like.device)


def gather_rows(mesh: RankMesh, t: torch.Tensor, counts, kind: str = "all"):
    """Concatenate every member's ``[counts[i], ...]`` rows of group
    ``kind`` in member order, on every member: one ``all_gather`` of the rows
    padded to the largest count, the pad rows dropped.  The result lies where
    ``t`` does."""
    m = max(counts)
    pad = m - t.shape[0]
    x = t.to(torch.uint8) if t.dtype == torch.bool else t
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    wire, host = _wire(mesh, x.contiguous())
    parts = [torch.empty_like(wire) for _ in counts]
    dist.all_gather(parts, wire, group=mesh.groups[kind, host])
    mesh.stats["collectives"] += 1
    out = torch.cat([p[:c] for p, c in zip(parts, counts)])
    out = _home(mesh, out, t)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def _any_over(mesh: RankMesh, bits: torch.Tensor, kind: str) -> torch.Tensor:
    """OR of int32 ``bits`` over group ``kind`` (a SUM ``all_reduce``)."""
    wire, host = _wire(mesh, bits.to(torch.int32).contiguous())
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.groups[kind, host])
    mesh.stats["collectives"] += 1
    return _home(mesh, wire, bits) > 0


def gather_level(mesh: RankMesh, flags: np.ndarray, over: bool, total: int):
    """A solve level's flags from every rank: ``flags [n, 3]`` bool are this
    rank's contiguous share (:func:`split_counts` of ``total``), ``over`` its
    overflow word.  One ``all_gather`` of host bytes (each rank's rows padded
    to the largest share, one more row for the overflow word); returns
    ``(flags [total, 3], over ORed over the ranks)`` on every rank."""
    counts = split_counts(total, mesh.size)
    mine = np.zeros((counts[0] + 1, 3), np.uint8)
    mine[:flags.shape[0]] = flags
    mine[-1] = over
    parts = [torch.empty(mine.shape, dtype=torch.uint8)
             for _ in range(mesh.size)]
    dist.all_gather(parts, torch.from_numpy(mine), group=mesh.host_group)
    mesh.stats["collectives"] += 1
    got = torch.stack(parts).numpy()
    out = np.concatenate([p[:c] for p, c in zip(got, counts)]).astype(bool)
    return out, bool(got[:, -1].any())


def stage_for_mesh(mesh: RankMesh):
    """``(to_sharded, to_repl)``: this rank's contiguous share of an array's
    leading axis (split over every rank) on its device, and the whole array
    on its device.  Dtypes are kept."""

    def to_sharded(arr):
        return _local(mesh, arr, mesh.size, mesh.rank, None)[0]

    def to_repl(arr):
        return _tensor(arr, mesh.device)

    return to_sharded, to_repl


def sharded_reachability(mesh: RankMesh):
    """``(points [N, 3], leg) -> [N] bool`` with N split over every rank;
    each rank runs K1 (ops/cuda_kernels.py ``make_reachability_kernel``) on
    its slice."""

    def fn(points, leg: LegDimensions) -> torch.Tensor:
        kernel = ck.make_reachability_kernel(leg)
        if mesh.size == 1:
            return kernel(_tensor(points, mesh.device, torch.float32))
        local, counts = _local(mesh, points, mesh.size, mesh.rank)
        return gather_rows(mesh, kernel(local), counts)

    return fn


def sharded_distance(mesh: RankMesh):
    """``(points [N, 3], leg) -> ([N] bool, [N, 3])`` with N split over every
    rank; each rank runs K2's point driver on its slice.  The two outputs
    travel as one ``[N, 4]`` int32 gather (the vector's bits unchanged)."""

    def fn(points, leg: LegDimensions):
        kernel = ck.make_distance_kernel(leg)
        if mesh.size == 1:
            return kernel(_tensor(points, mesh.device, torch.float32))
        local, counts = _local(mesh, points, mesh.size, mesh.rank)
        ok, vec = kernel(local)
        packed = torch.cat([ok.to(torch.int32)[:, None],
                            vec.contiguous().view(torch.int32)], dim=1)
        got = gather_rows(mesh, packed, counts)
        return got[:, 0] != 0, got[:, 1:].contiguous().view(torch.float32)

    return fn


def sharded_positionable(mesh: RankMesh, k: int | None = None,
                         chunk: int = 0):
    """Pose-feasibility sweep sharded over the mesh.

    ``(body_pos [P, 3], body_quat [P, 4] or None, footholds [F, 3], robot)
    -> [P] bool`` with poses split over the ``poses`` axis and footholds over
    the ``points`` axis.  Each rank computes per-(pose, leg) "any local
    foothold reachable" (ops/positionability.py ``reachable_legs``, ``chunk``
    poses at a time); the OR over the rank's row is an ``all_reduce`` of the
    int32 leg bits, then legs are counted against the quorum ``k`` (default:
    every leg) and the pose shards gathered over the rank's column.
    ``body_pos`` and ``body_quat`` may be this rank's :class:`PoseShard`
    (a mesh with ``points_axis=1``).
    """

    def fn(body_pos, body_quat, footholds, robot: LegDimensions):
        dev = mesh.device
        if mesh.size == 1:
            b = _tensor(body_pos, dev, torch.float32)
            q = None if body_quat is None else _tensor(body_quat, dev,
                                                       torch.float32)
            return positionable(b, q, _tensor(footholds, dev, torch.float32),
                                robot, k, chunk)
        b, counts = _local(mesh, body_pos, mesh.shape[0], mesh.coords[0])
        q = (None if body_quat is None else
             _local(mesh, body_quat, mesh.shape[0], mesh.coords[0])[0])
        f = _local(mesh, footholds, mesh.shape[1], mesh.coords[1])[0]
        legs = reachable_legs(b, q, f, robot, chunk)
        if mesh.shape[1] > 1:
            legs = _any_over(mesh, legs, "row")
        quorum = torch.sum(legs, dim=-1) >= int(
            leg_count(robot) if k is None else k)
        if mesh.shape[0] > 1:
            quorum = gather_rows(mesh, quorum, counts, "col")
        return quorum

    return fn


def sharded_csr_positionable(mesh: RankMesh, solver, columns, cell_size: float,
                             dims: tuple, k: int = 0):
    """Map-scale CSR positionability with poses split over every rank.

    ``solver`` is an ops/csr_grid.py ``make_csr_solver`` (K3) or
    ``make_csr_dma_solver`` (K4's round kernel) instance; the CSR foothold
    arrays are replicated (12 B a point) and each rank's early exit runs on
    its own poses, so the only collective is the quorum's gather.
    ``(body_pos, body_quat, xs, ys, zs, starts, origin) -> [P] bool``.
    """

    def fn(body_pos, body_quat, xs, ys, zs, starts, origin):
        to_sharded, to_repl = stage_for_mesh(mesh)
        grid = [to_repl(a) for a in (xs, ys, zs, starts, origin)]
        cols = to_repl(columns)
        if mesh.size == 1:
            b = _tensor(body_pos, mesh.device, torch.float32)
            q = _tensor(body_quat, mesh.device, torch.float32)
            return solver(b, q, *grid, cols, cell_size=cell_size, k=k,
                          dims=dims)[1]
        b, counts = _local(mesh, body_pos, mesh.size, mesh.rank)
        q = _local(mesh, body_quat, mesh.size, mesh.rank)[0]
        _, quorum, _ = solver(b, q, *grid, cols, cell_size=cell_size, k=k,
                              dims=dims)
        return gather_rows(mesh, quorum, counts)

    return fn


def sharded_grid_positionable(mesh: RankMesh, k: int = 0):
    """Map-scale positionability over the bucket grid with poses split over
    every rank and the grid table replicated.
    ``(body_pos [P, 3], body_quat [P, 4], grid: FootholdGrid, robot,
    offsets [K, 3]) -> [P] bool`` (ops/grid.py ``grid_reachable_legs``)."""
    from legmov_tpu_torch.ops.grid import grid_reachable_legs

    def fn(body_pos, body_quat, grid, robot: LegDimensions, offsets):
        dev = mesh.device
        g = grid._replace(points=grid.points.to(dev),
                          counts=grid.counts.to(dev),
                          origin=grid.origin.to(dev))
        if isinstance(offsets, torch.Tensor):
            offsets = offsets.cpu().numpy()
        if mesh.size == 1:
            return grid_reachable_legs(
                _tensor(body_pos, dev, torch.float32),
                _tensor(body_quat, dev, torch.float32), g, robot, k=k,
                offsets=offsets)[1]
        b, counts = _local(mesh, body_pos, mesh.size, mesh.rank)
        q = _local(mesh, body_quat, mesh.size, mesh.rank)[0]
        _, quorum = grid_reachable_legs(b, q, g, robot, k=k, offsets=offsets)
        return gather_rows(mesh, quorum, counts)

    return fn


def sharded_cell_eval(mesh: RankMesh, ev):
    """Shard a dense hierarchical cell evaluator over every rank.

    ``ev`` is models/hier_solver.py ``_eval_cells`` or one of its fused twins
    (``make_fast_cell_eval``, ops/cuda_multileg_dist.py
    ``make_cell_eval_rot``): positional ``(centers [C, 3], parent_valid [C],
    half, parent_half, footholds, quats, robot)`` plus keywords, three
    ``[C]`` flag vectors back.  The cell axis splits over the ranks, the
    rest is replicated, and the three flag vectors travel in one gather.
    """

    def fn(centers, parent_valid, half, parent_half, footholds, quats, robot,
           **kw):
        to_sharded, to_repl = stage_for_mesh(mesh)
        fh, qs = to_repl(footholds), to_repl(quats)
        if mesh.size == 1:
            return ev(to_repl(centers), to_repl(parent_valid), half,
                      parent_half, fh, qs, robot, **kw)
        c, counts = _local(mesh, centers, mesh.size, mesh.rank)
        pv = _local(mesh, parent_valid, mesh.size, mesh.rank, torch.bool)[0]
        if c.shape[0]:
            flags = torch.stack(ev(c, pv, half, parent_half, fh, qs, robot,
                                   **kw), dim=1)
        else:
            flags = torch.zeros((0, 3), dtype=torch.bool, device=c.device)
        return gather_rows(mesh, flags, counts).unbind(1)

    return fn


def sharded_csr_cell_eval(mesh: RankMesh, ev):
    """Shard the CSR-streaming cell evaluator (ops/csr_cell_eval.py
    ``make_csr_cell_eval``) over every rank: the cells and their parent
    flags split, the level tables and the CSR arrays are replicated, the flag
    vectors (and the audit counts, when ``ev`` returns them) travel in one
    gather and the overflow flag is ORed over every rank."""

    def fn(centers, parent_valid, *rest, **kw):
        to_sharded, to_repl = stage_for_mesh(mesh)
        rest = [to_repl(a) if isinstance(a, (torch.Tensor, np.ndarray))
                else a for a in rest]
        if mesh.size == 1:
            return ev(to_repl(centers), to_repl(parent_valid), *rest, **kw)
        c, counts = _local(mesh, centers, mesh.size, mesh.rank)
        pv = _local(mesh, parent_valid, mesh.size, mesh.rank, torch.bool)[0]
        if c.shape[0]:
            res = ev(c, pv, *rest, **kw)
        else:
            res = ev(to_repl(centers)[:1], to_repl(parent_valid)[:1], *rest,
                     **kw)
            res = [r[:0] if r.dim() else torch.zeros_like(r) for r in res]
        v, e, lf, over = res[:4]
        cols = [v[:, None], e[:, None], lf[:, None], *res[4:]]
        got = gather_rows(mesh, torch.cat([x.to(torch.int32) for x in cols],
                                          dim=1), counts)
        over = _any_over(mesh, over.reshape(1), "all")[0]
        out = (got[:, 0] > 0, got[:, 1] > 0, got[:, 2] > 0, over)
        return out + ((got[:, 3:],) if len(res) > 4 else ())

    return fn

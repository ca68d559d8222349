"""CSR-streaming hierarchical cell evaluator with role-masked early exit.

The hierarchical solver's deep (orientation-active) levels dominate its
wall time.  The dense evaluators (models/hier_solver.py ``_eval_cells`` and
the fused item kernel of ops/cuda_multileg_dist.py) evaluate EVERY (cell,
orientation) item against a per-batch foothold subset as wide as the batch's
bounding box.  This evaluator replaces that with the CSR machinery of
ops/csr_grid.py, shaped for cells instead of poses:

* footholds live device-resident in cell-sorted CSR form (12 B/point, built
  once per solve);
* each cell's candidate set is its own elongated box (the exact ``pre``
  prefilter bound, several_leg_octree.cu:76-82) decomposed into x-SLABS —
  for a fixed x-cell, the (y-range x full z) block is ONE contiguous CSR
  range, so a deep cell's box is ~3-5 contiguous slices instead of dozens of
  short (x, y) columns;
* a slab is cut into CHUNKS of at most ``window`` elements from the slab's
  own start (the last chunk ends with the slab), and a cell's queue is the
  list of its chunks (:func:`build_cell_queue`);
* every (chunk, orientation) carries a ROLE BYTE derived from exact
  reach-ball geometry: a candidate can be *reachable* by leg ``l`` only
  inside the ball of radius ``reach_l`` around the quat-rotated mount point,
  and *boundary-crossing* only inside that ball inflated by the cell
  circumradius.  From ball-vs-chunk-box tests the queue packs which legs can
  cross (bits 0-5), whether a SHARED-valid item is possible (``V``, bit 6:
  >= k legs' reach balls hit the box) and whether an edge item is possible
  (``E``, bit 7: > L-k inflated balls hit);
* the kernels SKIP chunks that cannot change the cell's remaining undecided
  flags and skip masked-out legs inside evaluated chunks.  Exact by
  monotonicity + the superset property of the ball masks;
* the shared-rule kernel also tests each element against the same balls
  (:func:`element_balls`), so that a leg's pipeline runs only on the
  elements it can reach or cross;
* the per-orientation workspace tables are one ``[S, W]`` table per level
  (:func:`level_tables`): they depend only on the orientation, not the cell.

Three kernels (source ``csrc/cell_kernels.cu``) walk the queues, one warp
a cell: quat-major (:func:`cell_eval_quat_major`, the per-leg rule's
default), chunk-major shared (:func:`cell_eval_shared`) and chunk-major
per-leg (:func:`cell_eval_cm_perleg`: valid walked chunk-major over every
orientation, edge one candidate orientation at a time, and a lookahead that
stops a cell once its flags are decided).  Beside each stands its plain
PyTorch version (``*_plain``), which walks the queue in the kernel's order
with its skip rules and work counters, vectorised over cells.  A wrapper
runs the plain version for CPU tensors only; for a CUDA tensor it launches
or raises, and counts its launches in its ``launches`` attribute.

Exactness: the slab set covers the elongated box (superset); every streamed
candidate is a real foothold; the in-kernel ``pre`` test is the same exact
box test the dense path applies per item; the ball masks are supersets of
where ok/crossed can hold, so skipped chunks and masked-out legs contribute
exactly nothing.  Flags match the dense evaluators bit for bit.

Reference anchor: several_leg_octree.cu:19-151 ``validity_child`` item
semantics (via the shared item of ops/cuda_multileg_dist.py);
octree_util.cu.h:153-159 ``isInBox`` prefilter.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from legmov_tpu_torch.models.leg import LegDimensions
from legmov_tpu_torch.models.robot import leg_count
from legmov_tpu_torch.ops import cuda_multileg_dist as cmd
from legmov_tpu_torch.ops import quaternion as quat
from legmov_tpu_torch.ops.grid import f32_scalar
from legmov_tpu_torch.ops.solve_schedule import robot_geometry
from legmov_tpu_torch.spans import phase

_f32 = np.float32

#: static x-slab offset cap: levels whose elongated box spans more than
#: 2*R_CAP+1 grid cells per axis fall back to the dense evaluators
R_CAP = 6

#: the kernels' seven work counters a cell (``audit=True``), in their order:
#: chunks evaluated, (chunk, orientation) items evaluated, per-leg pipeline
#: passes, the chunk elements behind each of the three, and the leg
#: pipelines run on elements inside the cell's elongated box (``item_leg``'s
#: runs: csrc/cell_kernels.cu ``work``)
AUDIT_COUNTERS = ("chunks_evaluated", "chunk_quat_evals", "leg_evals",
                  "chunk_elems", "item_elems", "leg_elems",
                  "leg_elems_in_box")

#: ball-mask slack (mm) absorbing fp32 rounding of the mask tests and of
#: the distance pipeline whose outputs they bound
_BALL_EPS = _f32(2.0)

#: a candidate this far away fails every elongated-box prefilter
SENTINEL = 1e9

#: elements one pass of :func:`build_cell_queue`'s per-chunk ball tests
#: holds at a time (``[cells, chunks, S, L]`` float32 temporaries)
_MASK_TILE = 1 << 25

MAX_WINDOW = 40960  # the shared kernel keeps 16 bits per chunk element
MAX_QUATS = 64


def slab_queue_host_max(
    centers: np.ndarray, elong: np.ndarray, starts: np.ndarray,
    origin: np.ndarray, cell_size: float, dims, window: int,
) -> int:
    """Host-side max total chunk count over ``centers`` (sizes the queue
    width before the device call).  Mirrors the device queue build below
    (same slab decomposition, same ceil-div)."""
    nx, ny, nz = dims
    c32 = np.asarray(centers, _f32)
    e32 = np.asarray(elong, _f32)
    o32 = np.asarray(origin, _f32)
    cs32 = _f32(cell_size)
    # f32 arithmetic in the SAME operation order as the device build, so
    # the floors agree bit-for-bit; +1 chunk/cell slack and the device
    # over-flag guard any residual divergence
    base = np.floor((c32 - o32) / cs32).astype(np.int64)
    dx_lo = np.floor((c32[:, 0] - e32[0] - o32[0]) / cs32)
    dx_hi = np.floor((c32[:, 0] + e32[0] - o32[0]) / cs32)
    cy_lo = np.clip(
        np.floor((c32[:, 1] - e32[1] - o32[1]) / cs32), 0, ny - 1
    ).astype(np.int64)
    cy_hi = np.clip(
        np.floor((c32[:, 1] + e32[1] - o32[1]) / cs32), 0, ny - 1
    ).astype(np.int64)
    tot = np.zeros(c32.shape[0], np.int64)
    for dx in range(-R_CAP, R_CAP + 1):
        cxc = base[:, 0] + dx
        ok = (
            (cxc >= 0) & (cxc < nx)
            & (cxc >= dx_lo) & (cxc <= dx_hi)
            & (cy_hi >= cy_lo)
        )
        cxs = np.clip(cxc, 0, nx - 1)
        st = starts[(cxs * ny + cy_lo) * nz].astype(np.int64)
        en = starts[(cxs * ny + cy_hi) * nz + nz].astype(np.int64)
        ln = np.where(ok, en - st, 0)
        tot += np.where(ln > 0, -(-ln // window), 0)
    return int(tot.max()) + 1 if tot.size else 0


def ball_mask_params(quats: torch.Tensor, robot: LegDimensions, half,
                     margin: float):
    """Role-mask geometry for :func:`build_cell_queue`.

    Returns ``(rmounts [S, L, 3], reach_l [L], r_cell)``: the quat-rotated
    leg mount vectors and per-leg reach-ball radii (coxa + femur + tibia —
    every workspace point is within arm's length of the mount) as tensors on
    the quaternions' device, and the crossing inflation radius as a float
    (cell circumradius under BOTH crossing branches: the sphere test ``dv2 <
    h2 + margin`` and the box test ``|dv| <= half + margin``) plus the fp32
    slack."""
    mount_vec, reach_l = robot_geometry(robot)
    dev = quats.device
    mounts = torch.as_tensor(mount_vec, dtype=torch.float32, device=dev)
    rmounts = quat.rotate(quats.to(torch.float32)[:, None, :],
                          mounts[None, :, :])  # [S, L, 3]
    h = np.asarray(half, _f32)
    hm = h + _f32(margin)
    h2m = float(np.sum(h * h) + _f32(margin))
    r_cell = float(_f32(
        np.sqrt(max(h2m, float(np.sum(hm * hm)))) + _BALL_EPS))
    return (rmounts,
            torch.as_tensor(np.asarray(reach_l, _f32), device=dev), r_cell)


def _ball_radii(reach_l: torch.Tensor, r_cell: float):
    """``(r_ok, r_in) [L]``: leg l's reach-ball radius for ok (its reach
    plus the fp32 slack) and for crossed (its reach plus the crossing
    radius ``r_cell`` of :func:`ball_mask_params`)."""
    return reach_l + float(_BALL_EPS), reach_l + float(r_cell)


class Balls(NamedTuple):
    """Every leg's reach balls in the body frame, for the shared-rule
    kernel's per-element test (CPU tensors)."""

    mounts: torch.Tensor  # [L, 3] float32 coxa mounts, the balls' centres
    ok2: torch.Tensor  # [L] float32 r_ok squared
    in2: torch.Tensor  # [L] float32 r_in squared


def element_balls(robot: LegDimensions, r_cell: float) -> Balls:
    """The balls of :func:`build_cell_queue`'s role masks for one element:
    centred on the unrotated coxa mounts (an element's body-frame vector is
    its world offset from the cell un-rotated, so the distance is the one
    the masks bound), with the masks' squared radii, bit for bit."""
    mount_vec, reach_l = robot_geometry(robot)
    r_ok, r_in = _ball_radii(torch.as_tensor(np.asarray(reach_l, _f32)),
                             r_cell)
    return Balls(torch.as_tensor(mount_vec, dtype=torch.float32),
                 r_ok * r_ok, r_in * r_in)


def ball_params(params, balls: Balls):
    """A copy of the kernels' parameter block ``params`` that switches the
    shared-rule kernel's per-element test on with ``balls``."""
    p = type(params).from_buffer_copy(params)
    L = balls.ok2.shape[0]
    if L != p.n_legs:
        raise ValueError(f"balls for {L} legs, parameters for {p.n_legs}")
    p.balls = 1
    ok2, in2 = balls.ok2.tolist(), balls.in2.tolist()
    for l, (x, y, z) in enumerate(balls.mounts.tolist()):
        p.ball_x[l], p.ball_y[l], p.ball_z[l] = x, y, z
        p.ball_ok2[l], p.ball_in2[l] = ok2[l], in2[l]
    return p


def level_tables(quats, half, parent_half, robot: LegDimensions,
                 margin: float, reach: float, blocks=None) -> torch.Tensor:
    """``[S, W]`` per-orientation tables for the cell-evaluation kernels, a
    CPU tensor.

    The leg workspace blocks depend only on the orientation — not the cell
    — so one row per quat serves every cell of the level; the kernels read
    the cell position / parent-valid from their own operand instead of the
    table's body / pv slots (zeroed here).  ``quats`` is the host copy of
    the level's orientations (numpy ``[S, 4]`` or a CPU tensor): the table
    is built on the host and the caller moves it to the card with the
    level's other constants (models/hier_solver.py, one asynchronous copy a
    level), so that no level reads the device back.  ``blocks`` is
    ``cuda_multileg_dist.leg_blocks(quats, robot)`` when the caller keeps
    it."""
    if isinstance(quats, torch.Tensor):
        if quats.device.type != "cpu":
            raise ValueError("level_tables takes the host copy of the "
                             "orientations, not a device tensor")
        quats = quats.numpy()
    quats_h = np.ascontiguousarray(quats, dtype=_f32)
    S = quats_h.shape[0]
    if blocks is None:
        blocks = cmd.leg_blocks(quats_h, robot)
    return cmd.tables_from_blocks(
        torch.as_tensor(blocks), torch.arange(S), torch.from_numpy(quats_h),
        torch.zeros((S, 3), dtype=torch.float32),
        torch.zeros(S, dtype=torch.bool), half, parent_half, margin, reach)


class CellQueue(NamedTuple):
    """Per-cell chunk queues (tensors on one device)."""

    cst: torch.Tensor  # [C, CH] int32 element start of chunk ch
    cln: torch.Tensor  # [C, CH] int32 elements in chunk ch (0 = none)
    role: torch.Tensor  # [C, CH, S] uint8 role byte per orientation
    tot: torch.Tensor  # [C] int32 chunks the cell needs
    over: torch.Tensor  # 0-d bool: some cell needs more than CH chunks


def build_cell_queue(
    centers, elong, rmounts, reach_l, r_cell: float, starts, origin, *,
    cell_size: float | torch.Tensor, dims, k: int, shared: bool, window: int,
    q_steps: int,
    chunk_masks: bool = True,
) -> CellQueue:
    """Chunk queues and role bytes of ``centers [C, 3]``.

    ``elong [3]`` is the elongated box half-extent (parent half + reach),
    ``rmounts, reach_l, r_cell`` come from :func:`ball_mask_params`,
    ``starts / origin / cell_size / dims`` from the CSR grid (``cell_size``
    a float, or the float32 value as a 0-d tensor on the cells' device),
    ``q_steps`` is the queue width (at least :func:`slab_queue_host_max` of
    the batch).

    ``chunk_masks`` (default on): role bytes computed per CHUNK from its own
    covered cell range instead of inherited from the whole slab; ``False``
    gives the per-slab masks.  Flags are identical either way.
    """
    dev = centers.device
    C = centers.shape[0]
    S, L = int(rmounts.shape[0]), int(rmounts.shape[1])
    nx, ny, nz = (int(d) for d in dims)
    CH = int(q_steps)
    i64 = torch.int64
    # a 0-d tensor made once a solve: from a float it is uploaded here, a
    # blocking copy on a card
    cs = (cell_size if isinstance(cell_size, torch.Tensor)
          else f32_scalar(cell_size, dev))
    w = int(window)
    starts_i = starts.to(i64)
    base = torch.floor((centers - origin) / cs).to(i64)

    # per-cell x-slab CSR ranges: for fixed x-cell, (y-range x all z) is one
    # contiguous CSR slice (z-fastest sort)
    dx_lo = torch.floor((centers[:, 0] - elong[0] - origin[0]) / cs).to(i64)
    dx_hi = torch.floor((centers[:, 0] + elong[0] - origin[0]) / cs).to(i64)
    cy_lo = torch.clamp(
        torch.floor((centers[:, 1] - elong[1] - origin[1]) / cs).to(i64),
        0, ny - 1)
    cy_hi = torch.clamp(
        torch.floor((centers[:, 1] + elong[1] - origin[1]) / cs).to(i64),
        0, ny - 1)

    # ball centers = cell center + quat-rotated mounts [C, S, L, 3]
    bc = centers[:, None, None, :] + rmounts[None, :, :, :]
    r_ok, r_in = _ball_radii(reach_l, r_cell)
    r_ok2 = r_ok * r_ok  # [L]
    r_in2 = r_in * r_in
    leg_bit = (1 << torch.arange(L, device=dev, dtype=torch.int32))
    bz_lo = origin[2]
    bz_hi = origin[2] + float(nz) * cs

    def role_bytes(d2):
        """Role byte from squared ball-centre-to-box distances [..., L]."""
        okhit = d2 <= r_ok2
        inhit = d2 <= r_in2
        inflb = torch.sum(inhit.to(torch.int32) * leg_bit, dim=-1)
        vb = (okhit.sum(dim=-1) >= k).to(torch.int32)
        eb = (inhit.sum(dim=-1) > (L - k)).to(torch.int32)
        return inflb, vb, eb

    if not chunk_masks:
        # the slab box is the slab's x-cell column over its clamped y-range
        # and the grid's full z-extent (conservative superset of every
        # chunk cut from the slab)
        by_lo = origin[1] + cy_lo.to(torch.float32) * cs  # [C]
        by_hi = origin[1] + (cy_hi + 1).to(torch.float32) * cs
        cdy = torch.clamp(bc[..., 1], by_lo[:, None, None],
                          by_hi[:, None, None]) - bc[..., 1]
        cdz = torch.clamp(bc[..., 2], bz_lo, bz_hi) - bc[..., 2]
        dyz2 = cdy * cdy + cdz * cdz  # [C, S, L]

    sts, lens, bits, bxs = [], [], [], []
    for dx in range(-R_CAP, R_CAP + 1):
        cxc = base[:, 0] + dx
        ok = ((cxc >= 0) & (cxc < nx) & (cxc >= dx_lo) & (cxc <= dx_hi)
              & (cy_hi >= cy_lo))
        cxs = torch.clamp(cxc, 0, nx - 1)
        st = starts_i[(cxs * ny + cy_lo) * nz]
        en = starts_i[(cxs * ny + cy_hi) * nz + nz]
        sts.append(st)
        lens.append(torch.where(ok, en - st, 0))
        bx_lo = origin[0] + cxs.to(torch.float32) * cs  # [C]
        bxs.append(bx_lo)
        if not chunk_masks:
            cdx = torch.clamp(bc[..., 0], bx_lo[:, None, None],
                              (bx_lo + cs)[:, None, None]) - bc[..., 0]
            inflb, vb, eb = role_bytes(cdx * cdx + dyz2)  # [C, S]
            bits.append(inflb | (vb << 6) | (eb << 7))
    slab_st = torch.stack(sts, dim=1)  # [C, 2R+1]
    slab_len = torch.stack(lens, dim=1)
    slab_bx = torch.stack(bxs, dim=1)
    chunks = torch.where(slab_len > 0, (slab_len + (w - 1)) // w, 0)
    cum = torch.cumsum(chunks, dim=1)
    tot = cum[:, -1]  # [C]

    # chunk ch of a cell: its slab, its index within the slab, its range
    t = torch.arange(CH, device=dev, dtype=i64)[None, :]  # [1, CH]
    live = t < tot[:, None]  # [C, CH]
    slab = torch.sum(cum[:, None, :] <= t[:, :, None], dim=-1)
    slabc = torch.clamp(slab, max=2 * R_CAP)
    prev = torch.where(
        slabc > 0,
        torch.gather(cum, 1, torch.clamp(slabc - 1, min=0)), 0)
    within = t - prev
    st_k = torch.gather(slab_st, 1, slabc)
    ln_k = torch.gather(slab_len, 1, slabc)
    e0 = st_k + within * w
    cln = torch.where(live, torch.clamp(ln_k - within * w, 0, w), 0)
    cst = torch.where(live, e0, 0)

    def inter_bounds(r, m):
        """[C, S, 3] per-axis bounds on any point lying in >= ``m`` of the
        L balls ``B(bc_l, r_l)`` at once.

        If x is in >= m balls then per axis at least m intervals
        [c_l - r_l, c_l + r_l] contain x_d, so x_d >= the m-th smallest
        lower endpoint and x_d <= the m-th largest upper endpoint.  Exact
        refutation: a chunk box disjoint from these bounds on any axis
        cannot hold such a point."""
        lo = torch.sort(bc - r[None, None, :, None], dim=2).values
        hi = torch.sort(bc + r[None, None, :, None], dim=2).values
        return lo[:, :, m - 1, :], hi[:, :, L - m, :]

    def ball_bits(rows):
        """Per-CHUNK role bytes [R, CH, S] of the cells ``rows`` (a slice).

        Each chunk's own covered cell range is recovered from its CSR
        element range (searchsorted on the grid's starts — z-fastest sort
        means a chunk's covered flat-cell range is contiguous), giving a
        box as narrow as the chunk actually is: y at cell granularity, z
        too when the chunk sits inside one y-column."""
        bc_r = bc[rows]
        e0_r = e0[rows]
        e1 = torch.maximum(
            torch.minimum(e0_r + w, st_k[rows] + ln_k[rows]), e0_r + 1)
        ncell = nx * ny * nz
        f0 = torch.clamp(
            torch.searchsorted(starts_i, e0_r.contiguous(), right=True) - 1,
            0, ncell - 1)
        f1 = torch.clamp(
            torch.searchsorted(starts_i, (e1 - 1).contiguous(),
                               right=True) - 1,
            0, ncell - 1)
        y0 = (f0 // nz) % ny
        y1 = (f1 // nz) % ny
        byl = origin[1] + y0.to(torch.float32) * cs
        byh = origin[1] + (y1 + 1).to(torch.float32) * cs
        same = y0 == y1
        bzl = torch.where(
            same, origin[2] + (f0 % nz).to(torch.float32) * cs, bz_lo)
        bzh = torch.where(
            same, origin[2] + ((f1 % nz) + 1).to(torch.float32) * cs, bz_hi)
        bxl = torch.gather(slab_bx[rows], 1, slabc[rows])

        def clipd(v, lo, hi):
            # [R, S, L] ball coords vs [R, CH] box bounds
            vv = v[:, None, :, :]
            return torch.clamp(vv, lo[:, :, None, None],
                               hi[:, :, None, None]) - vv

        cdx_c = clipd(bc_r[..., 0], bxl, bxl + cs)
        cdy_c = clipd(bc_r[..., 1], byl, byh)
        cdz_c = clipd(bc_r[..., 2], bzl, bzh)
        iflb, vbc, ebc = role_bytes(
            cdx_c * cdx_c + cdy_c * cdy_c + cdz_c * cdz_c)  # [R, CH, S]
        if shared:
            def box_meets(lo_b, hi_b):
                # [R, S, 3] bounds vs [R, CH] chunk box -> [R, CH, S]
                return (
                    ((bxl + cs)[:, :, None] >= lo_b[:, None, :, 0])
                    & (bxl[:, :, None] <= hi_b[:, None, :, 0])
                    & (byh[:, :, None] >= lo_b[:, None, :, 1])
                    & (byl[:, :, None] <= hi_b[:, None, :, 1])
                    & (bzh[:, :, None] >= lo_b[:, None, :, 2])
                    & (bzl[:, :, None] <= hi_b[:, None, :, 2])
                )

            # shared-valid items need a candidate in >= k reach balls AT
            # ONCE (several_leg_octree.cu:91-116) — the per-ball hit count
            # can't see that; the order-statistics bounds can.  Edge items
            # analogously need > L-k crossing legs on ONE candidate
            # (inflated radii) — only binding when k < L.
            vbc = vbc * box_meets(v_lo[rows], v_hi[rows]).to(torch.int32)
            if e_lo is not None:
                ebc = ebc * box_meets(e_lo[rows], e_hi[rows]).to(torch.int32)
        return iflb | (vbc << 6) | (ebc << 7)

    if chunk_masks:
        if shared:
            v_lo, v_hi = inter_bounds(r_ok, k)
            e_m = L - k + 1
            e_lo, e_hi = (inter_bounds(r_in, e_m) if e_m > 1
                          else (None, None))
        role = torch.zeros((C, CH, S), dtype=torch.int32, device=dev)
        step = max(1, _MASK_TILE // max(CH * S * L, 1))
        for lo in range(0, C, step):
            rows = slice(lo, min(lo + step, C))
            role[rows] = ball_bits(rows)
    else:
        slab_bits = torch.stack(bits, dim=1)  # [C, 2R+1, S]
        role = torch.gather(
            slab_bits, 1, slabc[:, :, None].expand(C, CH, S))
    role = (role * live[:, :, None]).to(torch.uint8)
    return CellQueue(
        cst=cst.to(torch.int32).contiguous(),
        cln=cln.to(torch.int32).contiguous(),
        role=role.contiguous(),
        tot=tot.to(torch.int32).contiguous(),
        over=torch.any(tot > CH),
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions of the three kernel forms
# ---------------------------------------------------------------------------

def _popcount(m: torch.Tensor, bits: int = 6) -> torch.Tensor:
    return sum(((m >> b) & 1) for b in range(bits))


class _Walk:
    """What the three plain forms share: the chunk's own elements of a set
    of cells, the item getter for one orientation, the work counters."""

    def __init__(self, queue, cellinfo, legtab, xs, ys, zs, consts, k):
        self.q, self.cellinfo, self.legtab = queue, cellinfo, legtab
        self.xs, self.ys, self.zs = xs, ys, zs
        self.consts, self.k, self.L = consts, k, len(consts)
        self.dev = cellinfo.device
        self.C, self.CH, self.S = queue.role.shape
        self.pv = cellinfo[:, 3] > 0.5
        self.tot = torch.clamp(queue.tot.to(torch.int64), max=self.CH)
        self.n_steps = int(self.tot.max()) if self.C else 0
        self.width = int(queue.cln.max()) if self.C and self.CH else 0
        self.pos = torch.arange(self.width, device=self.dev)[None, :]
        self.counts = torch.zeros((self.C, 7), dtype=torch.int64,
                                  device=self.dev)

    def live(self, ch):
        return (ch < self.tot) & (self.q.cln[:, ch] > 0)

    def role(self, ch, q):
        rb = self.q.role[:, ch, q].to(torch.int32)
        return rb & 0x3F, ((rb >> 6) & 1) != 0, ((rb >> 7) & 1) != 0

    def head(self, rows, ch, q, with_pv=True):
        """Getter, prefilter and body-frame vectors of chunk ``ch`` of the
        cells ``rows`` under orientation ``q`` (each an int, or a tensor
        with one per row): the chunk's own elements, the rest of the width
        filled with far sentinels."""
        F = self.xs.shape[0]
        st = self.q.cst[rows, ch].to(torch.int64)[:, None]
        ln = self.q.cln[rows, ch][:, None]
        idx = torch.clamp(st + self.pos, 0, max(F - 1, 0))
        own = self.pos < ln

        def take(comp):
            return torch.where(own, comp[idx], SENTINEL)

        info = self.cellinfo[rows]
        pvf = (self.pv[rows].to(torch.float32)[:, None] if with_pv
               else torch.zeros((rows.numel(), 1), device=self.dev))
        legtab = self.legtab

        def s(i):
            if 4 <= i <= 6:  # cell center = item position
                return info[:, i - 4:i - 3]
            if i == 7:  # parent_valid (shared-rule item term)
                return pvf
            v = legtab[q, i]
            return v[:, None] if v.dim() else v

        pre, vx, vy, vz = cmd.item_head_plain(
            s, take(self.xs), take(self.ys), take(self.zs))
        return s, pre, vx, vy, vz

    def leg(self, rows, go, s, l, pre, vx, vy, vz):
        """Leg ``l`` on the cells ``rows``, zeroed where ``go`` (``[R]``,
        or ``[R, W]`` per element) is off; counts the pipelines that ran on
        an element inside the box."""
        okp, crossed = cmd.item_leg_plain(s, l, self.consts[l], pre, vx, vy,
                                          vz)
        go = go if go.dim() == 2 else go[:, None]
        self.counts[rows, 6] += (pre & go).sum(dim=1)
        return okp & go, crossed & go

    def count(self, rows, cols, amount):
        for c, a in zip(cols, amount):
            self.counts[rows, c] += a

    def out(self, valid, edge, leaf):
        flags = torch.stack([valid, edge, leaf], dim=1).to(torch.int32)
        return torch.cat([flags, self.counts.to(torch.int32)], dim=1)


def cell_eval_quat_major_plain(queue, cellinfo, legtab, xs, ys, zs, consts,
                               k: int, shared: bool,
                               skips: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the quat-major kernel: orientation-outer,
    chunk-inner over every cell at once, each cell taking the decisions the
    kernel's block takes for it.  ``[C, 10]`` int32: valid, edge, leaf, then
    chunks / (chunk, orientation) items / leg pipelines evaluated, the
    elements behind each, and the leg pipelines that ran on an element
    inside the cell's elongated box.  ``skips=False`` walks every live step
    with every leg (the flags must not change)."""
    wk = _Walk(queue, cellinfo, legtab, xs, ys, zs, consts, k)
    C, L, dev = wk.C, wk.L, wk.dev
    acc = torch.zeros((3, C), dtype=torch.bool, device=dev)
    dec = torch.zeros(C, dtype=torch.bool, device=dev)
    run = torch.zeros((C, 3, L), dtype=torch.bool, device=dev)
    all_legs = (1 << L) - 1
    for q in range(wk.S):
        for ch in range(wk.n_steps):
            infl, vbit, ebit = wk.role(ch, q)
            if not skips:
                m = torch.full_like(infl, all_legs)
                useful = wk.live(ch)
            elif shared:
                need_v = ~(acc[0] & acc[2])
                useful = (((vbit | wk.pv) & need_v) | (ebit & ~acc[1]))
                useful &= wk.live(ch)
                m = infl
            else:
                settled = (run[:, 0] & run[:, 1]).to(torch.int32)
                need = all_legs & ~torch.sum(
                    settled << torch.arange(L, device=dev), dim=1)
                m = infl & need.to(torch.int32)
                useful = ~dec & (m != 0) & wk.live(ch)
            rows = torch.nonzero(useful)[:, 0]
            if rows.numel():
                mr = m[rows]
                legs = _popcount(mr)
                ln = queue.cln[rows, ch].to(torch.int64)
                wk.count(rows, range(6), (1, 1, legs, ln, ln, ln * legs))
                s, pre, vx, vy, vz = wk.head(rows, ch, q)
                rc = torch.zeros(pre.shape, dtype=torch.int32, device=dev)
                cc = torch.zeros(pre.shape, dtype=torch.int32, device=dev)
                for l in range(L):
                    lm = ((mr >> l) & 1) != 0
                    if not bool(lm.any()):
                        continue
                    okp, crossed = wk.leg(rows, lm, s, l, pre, vx, vy, vz)
                    if shared:
                        rc += okp
                        cc += crossed
                    else:
                        run[rows, 0, l] |= okp.any(dim=1)
                        run[rows, 1, l] |= (okp & ~crossed).any(dim=1)
                        run[rows, 2, l] |= (okp | crossed).any(dim=1)
                if shared:
                    iv = ((rc >= k) | wk.pv[rows, None]) & pre
                    ie = (cc > (L - k)) & pre
                    acc[0, rows] |= iv.any(dim=1)
                    acc[1, rows] |= ie.any(dim=1)
                    acc[2, rows] |= (iv & ~ie).any(dim=1)
            if not shared:
                # the orientation's fold, at its last chunk whether or not
                # that chunk was evaluated
                f = (wk.tot - 1 == ch) & ~dec
                cnt = run[:, 0].sum(dim=1)
                nmin = run[:, 1].sum(dim=1)
                nmax = run[:, 2].sum(dim=1)
                acc[0] |= f & (cnt >= k)
                acc[1] |= f & (nmin < k) & (nmax >= k)
                if skips:
                    dec |= f & (acc[0] | wk.pv) & acc[1]
                run &= ~f[:, None, None]
    return wk.out(acc[0], acc[1], acc[2])


def _element_legs(balls, mr, k, chain_off, vx, vy, vz):
    """``[R, W]`` int32: per element the legs of the role masks ``mr [R]``
    whose pipeline it still needs, in the kernel's arithmetic (see
    csrc/cell_kernels.cu ``element_legs``): those whose r_in ball holds its
    body-frame vector, and where ``chain_off [R]`` is off none unless at
    least ``k`` of the masks' r_ok balls hold it."""
    inside = torch.zeros(vx.shape, dtype=torch.int32, device=vx.device)
    n_ok = torch.zeros(vx.shape, dtype=torch.int32, device=vx.device)
    for l in range(balls.ok2.shape[0]):
        on = (((mr >> l) & 1) != 0)[:, None]
        dx = vx - balls.mounts[l, 0]
        dy = vy - balls.mounts[l, 1]
        dz = vz - balls.mounts[l, 2]
        d2 = dx * dx + dy * dy + dz * dz
        inside |= ((d2 <= balls.in2[l]) & on).to(torch.int32) << l
        n_ok += ((d2 <= balls.ok2[l]) & on).to(torch.int32)
    return torch.where(chain_off[:, None] | (n_ok >= k), inside, 0)


def cell_eval_shared_plain(queue, cellinfo, legtab, xs, ys, zs, consts,
                           k: int, skips: bool = True,
                           balls: Balls | None = None) -> torch.Tensor:
    """Plain PyTorch version of the chunk-major shared-rule kernel (see
    :func:`cell_eval_quat_major_plain` for the result).  ``balls``
    (:func:`element_balls`) adds the kernel's per-element reach-ball test,
    which only ``skips=False`` leaves off."""
    wk = _Walk(queue, cellinfo, legtab, xs, ys, zs, consts, k)
    C, L, dev = wk.C, wk.L, wk.dev
    acc = torch.zeros((3, C), dtype=torch.bool, device=dev)
    all_legs = (1 << L) - 1
    if skips and balls is not None:
        balls = Balls(*(t.to(dev) for t in balls))
    else:
        balls = None

    def wanted(vbit, ebit):
        return ((vbit | wk.pv) & ~(acc[0] & acc[2])) | (ebit & ~acc[1])

    for ch in range(wk.n_steps):
        rbs = queue.role[:, ch, :].to(torch.int32)
        vany = (((rbs >> 6) & 1) != 0).any(dim=1)
        eany = (((rbs >> 7) & 1) != 0).any(dim=1)
        useful_c = wk.live(ch)
        if skips:
            useful_c = useful_c & wanted(vany, eany)
        ln_all = queue.cln[:, ch].to(torch.int64)
        wk.counts[:, 0] += useful_c
        wk.counts[:, 3] += useful_c * ln_all
        if not bool(useful_c.any()):
            continue
        for q in range(wk.S):
            infl, vbit, ebit = wk.role(ch, q)
            uq = useful_c & wanted(vbit, ebit) if skips else useful_c
            rows = torch.nonzero(uq)[:, 0]
            if not rows.numel():
                continue
            mr = infl[rows] if skips else torch.full_like(infl[rows], all_legs)
            ln = ln_all[rows]
            wk.count(rows, (1, 4), (1, ln))
            s, pre, vx, vy, vz = wk.head(rows, ch, q)
            rc = torch.zeros(pre.shape, dtype=torch.int32, device=dev)
            cc = torch.zeros(pre.shape, dtype=torch.int32, device=dev)
            # leg-chain early exit: once edge is settled a chunk is scanned
            # for VALID/LEAF only, so legs after l are pointless unless some
            # candidate can still reach k with every masked leg left.  A
            # partially chained chunk contributes nothing: rc is understated
            # so iv is false everywhere (cells with a valid parent never
            # chain), and edge is already set.
            chain_off = ~acc[1, rows] | wk.pv[rows]
            if not skips:
                chain_off = torch.ones_like(chain_off)
            # per element, the legs it still needs (kernel: bits 8-13 of
            # its word)
            legs = (mr[:, None] if balls is None else
                    _element_legs(balls, mr, k, chain_off, vx, vy, vz))
            viable = torch.ones_like(chain_off)
            for l in range(L):
                go = (((mr >> l) & 1) != 0) & (chain_off | viable)
                if bool(go.any()):
                    sel = go[:, None] & (((legs >> l) & 1) != 0)
                    okp, crossed = wk.leg(rows, sel, s, l, pre, vx, vy, vz)
                    rc += okp
                    cc += crossed
                    wk.count(rows, (2, 5), (go, go * ln))
                if l < L - 1:
                    rem = _popcount(mr >> (l + 1))
                    viable = rc.max(dim=1).values >= k - rem
            iv = ((rc >= k) | wk.pv[rows, None]) & pre
            ie = (cc > (L - k)) & pre
            acc[0, rows] |= iv.any(dim=1)
            acc[1, rows] |= ie.any(dim=1)
            acc[2, rows] |= (iv & ~ie).any(dim=1)
    return wk.out(acc[0], acc[1], acc[2])


def cell_eval_cm_perleg_plain(queue, cellinfo, legtab, xs, ys, zs, consts,
                              k: int, skips: bool = True,
                              exits: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the chunk-major per-leg-rule kernel (see
    :func:`cell_eval_quat_major_plain` for the result; the leaf column is
    0: the caller derives it, and ORs parent-valid into valid).

    Per (cell, orientation) the run bits (any ok, ok & !crossed, ok |
    crossed per leg) and two sticky marks, "edge is certainly false under
    this orientation" and "this orientation can no longer make the cell
    valid", read from the run bits and the lookahead (per leg, the last
    live chunk whose role byte sets it).  Valid is walked chunk-major over
    every orientation, once per chunk: the legs not yet ok.  Edge is walked
    for one candidate orientation at a time, chunk by chunk: the legs not
    yet ok & !crossed; when the candidate's edge is certainly false the
    next orientation that is not becomes the candidate and its walk starts
    again at chunk 0.  A cell stops once valid (or parent-valid, or every
    orientation's valid mark) and edge (certainly true under the
    candidate, or every orientation's edge mark) are decided.  The marks
    are read at the start (for every orientation), after each evaluated
    (chunk, orientation), and at each chunk's end (the candidate's, and
    every orientation's valid mark when the chunk is new).  A chunk counts
    once a visit where at least one orientation was evaluated.  The cells
    walk independently, one (chunk, orientation) or chunk end a step.
    ``exits=False`` walks every live chunk once with every leg its role
    byte sets until the leg is settled under that orientation (the walk
    before the exit); ``skips=False`` walks everything.  The flags never
    change."""
    wk = _Walk(queue, cellinfo, legtab, xs, ys, zs, consts, k)
    C, L, S, dev = wk.C, wk.L, wk.S, wk.dev
    i64 = torch.int64
    valid = torch.zeros(C, dtype=torch.bool, device=dev)
    edge = torch.zeros(C, dtype=torch.bool, device=dev)
    run = torch.zeros((C, S, 3, L), dtype=torch.bool, device=dev)
    edge_dead = torch.zeros((C, S), dtype=torch.bool, device=dev)
    valid_dead = torch.zeros((C, S), dtype=torch.bool, device=dev)
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    all_legs = (1 << L) - 1
    shifts = torch.arange(L, device=dev)
    qs = torch.arange(S, device=dev)
    use_exit = skips and exits
    # without the exit every orientation's walk is complete: every mark holds
    whole = not use_exit
    # the lookahead: per (cell, orientation, leg) the last live chunk whose
    # role byte sets the leg, -1 for none
    last = torch.full((C, S, L), -1, dtype=i64, device=dev)
    for ch in range(wk.n_steps):
        infl = queue.role[:, ch, :].to(i64) & 0x3F  # [C, S]
        hit = (((infl[..., None] >> shifts) & 1) != 0) & wk.live(ch)[:, None,
                                                                      None]
        last = torch.where(hit, ch, last)

    def bits_of(r):  # [..., L] bool -> leg mask
        return torch.sum(r.to(i64) << shifts, dim=-1)

    def mark(rows, qq, chv, cand, front):
        """The marks and flags of orientations ``qq [R, Q]`` of the cells
        ``rows [R]`` after chunk ``chv [R]``: the lookahead's edge marks
        where ``cand [R, Q]`` (the orientation's edge walk is complete up
        to the chunk), its valid mark where ``front [R]`` (every
        orientation's valid walk is)."""
        rr = rows[:, None]
        r = run[rr, qq]
        pend = last[rr, qq] > chv[:, None, None]
        ok, cert, anyb = r[..., 0, :], r[..., 1, :], r[..., 2, :]
        cnt, nmin, nmax = ok.sum(-1), cert.sum(-1), anyb.sum(-1)
        et = (cand & ~edge_dead[rr, qq] & (nmax >= k)
              & (nmin + (pend & ~cert).sum(-1) < k))
        edge_dead[rr, qq] |= (nmin >= k) | (
            cand & (nmax + (pend & ~anyb).sum(-1) < k))
        valid_dead[rr, qq] |= front[:, None] & (
            cnt + (pend & ~ok).sum(-1) < k)
        valid[rows] |= (cnt >= k).any(dim=1)
        edge[rows] |= et.any(dim=1)
        if use_exit:
            done[rows] = ((valid[rows] | wk.pv[rows]
                           | valid_dead[rows].all(dim=1))
                          & (edge[rows] | edge_dead[rows].all(dim=1)))

    def first_open(after):
        """Per cell, the first orientation past ``after [C]`` whose edge
        is not certainly false, S for none."""
        open_ = ~edge_dead & (qs[None, :] > after[:, None])
        return torch.where(open_.any(dim=1),
                           torch.argmax(open_.to(torch.int8), dim=1), S)

    every = torch.arange(C, device=dev)
    mark(every, qs.expand(C, S), torch.full((C,), -1, dtype=i64, device=dev),
         torch.ones((C, S), dtype=torch.bool, device=dev),
         torch.ones(C, dtype=torch.bool, device=dev))
    cand = first_open(torch.full((C,), -1, dtype=i64, device=dev))
    ch = torch.zeros(C, dtype=i64, device=dev)
    front = torch.zeros(C, dtype=i64, device=dev)  # chunks walked for valid
    qn = torch.zeros(C, dtype=i64, device=dev)     # next orientation to visit
    walked = torch.zeros(C, dtype=torch.bool, device=dev)
    while True:
        rows = torch.nonzero(~done & (ch < wk.tot))[:, 0]
        if not rows.numel():
            break
        chr_ = ch[rows]
        rb = queue.role[rows, chr_, :].to(i64) & 0x3F  # [R, S]
        r = run[rows]
        ok_m, cert_m = bits_of(r[:, :, 0]), bits_of(r[:, :, 1])
        if not skips:
            legs = torch.full_like(rb, all_legs)
        elif not use_exit:
            legs = ~cert_m
        else:
            e_open = ~(edge[rows] | edge_dead[rows].all(dim=1))
            v_open = ~(valid[rows] | wk.pv[rows]
                       | valid_dead[rows].all(dim=1))
            is_c = (qs[None, :] == cand[rows, None]) & ~edge_dead[rows]
            v_on = ((v_open & (chr_ >= front[rows]))[:, None]
                    & ~valid_dead[rows])
            legs = torch.where(e_open[:, None] & is_c, ~cert_m,
                               torch.where(v_on, ~ok_m, 0))
        live = queue.cln[rows, chr_] > 0
        m = (rb & legs & all_legs) * (live[:, None] & (qs[None, :]
                                                      >= qn[rows, None]))
        has = (m != 0).any(dim=1)
        # a (chunk, orientation) for the cells that have one left here
        ev = rows[has]
        if ev.numel():
            qe = torch.argmax((m[has] != 0).to(torch.int8), dim=1)
            me = m[has].gather(1, qe[:, None])[:, 0]
            che = chr_[has]
            legs_n = _popcount(me)
            ln = queue.cln[ev, che].to(i64)
            first = ~walked[ev]  # the chunk visit's first orientation
            wk.count(ev, (0, 1, 2, 3, 4, 5),
                     (first, 1, legs_n, first * ln, ln, ln * legs_n))
            walked[ev] = True
            s, pre, vx, vy, vz = wk.head(ev, che, qe, with_pv=False)
            for l in range(L):
                lm = ((me >> l) & 1) != 0
                if not bool(lm.any()):
                    continue
                okp, crossed = wk.leg(ev, lm, s, l, pre, vx, vy, vz)
                run[ev, qe, 0, l] |= okp.any(dim=1)
                run[ev, qe, 1, l] |= (okp & ~crossed).any(dim=1)
                run[ev, qe, 2, l] |= (okp | crossed).any(dim=1)
            mark(ev, qe[:, None], che, (qe == cand[ev])[:, None] | whole,
                 (che >= front[ev]) | whole)
            qn[ev] = qe + 1
        # the chunk's end for the others
        ce = rows[~has]
        if not ce.numel():
            continue
        chc = ch[ce]
        new = chc >= front[ce]
        front[ce] = torch.maximum(front[ce], chc + 1)
        mark(ce, qs.expand(ce.numel(), S), chc,
             (qs[None, :] == cand[ce, None]) | whole, new | whole)
        nxt = chc + 1
        if use_exit:
            e_open = ~(edge[ce] | edge_dead[ce].all(dim=1))
            c_now = cand[ce]
            dead = edge_dead[ce, torch.clamp(c_now, max=S - 1)] & (c_now < S)
            sw = ~done[ce] & e_open & dead
            cand[ce] = torch.where(sw, first_open(cand)[ce], c_now)
            nxt = torch.where(e_open, torch.where(sw, 0, nxt),
                              torch.maximum(nxt, front[ce]))
        ch[ce] = nxt
        qn[ce] = 0
        walked[ce] = False
    return wk.out(valid, edge, torch.zeros_like(valid))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_cell_args(queue, cellinfo, legtab, xs, ys, zs, consts, window):
    L = len(consts)
    dev = cellinfo.device
    cmd.check_tensor("cellinfo", cellinfo, torch.float32, 2)
    cmd.check_tensor("cst", queue.cst, torch.int32, 2, dev)
    cmd.check_tensor("cln", queue.cln, torch.int32, 2, dev)
    cmd.check_tensor("role", queue.role, torch.uint8, 3, dev)
    cmd.check_tensor("tot", queue.tot, torch.int32, 1, dev)
    cmd.check_tensor("legtab", legtab, torch.float32, 2, dev)
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs)):
        cmd.check_tensor(name, t, torch.float32, 1, dev)
        if t.shape != xs.shape:
            raise ValueError("xs, ys and zs differ in length")
    C, CH, S = queue.role.shape
    if (queue.cst.shape != (C, CH) or queue.cln.shape != (C, CH)
            or queue.tot.shape != (C,) or cellinfo.shape != (C, 4)):
        raise ValueError("queue and cellinfo shapes do not belong together")
    if legtab.shape != (S, cmd.table_width(L)):
        raise ValueError(
            f"legtab must be [{S}, {cmd.table_width(L)}], got "
            f"{tuple(legtab.shape)}")
    if not 1 <= S <= MAX_QUATS:
        raise ValueError(f"the kernels take 1 to {MAX_QUATS} orientations")
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"window must be 1 to {MAX_WINDOW}, got {window}")
    return C, CH, S


def _launch(name, counter, plain, queue, cellinfo, legtab, xs, ys, zs, consts,
            k, window, params, extra=()):
    C, CH, S = _check_cell_args(queue, cellinfo, legtab, xs, ys, zs, consts,
                                window)
    dev = cellinfo.device
    if dev.type == "cpu":
        return plain()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.zeros((C, cmd.OUT_WORDS), dtype=torch.int32, device=dev)
    if C == 0 or CH == 0:
        return out
    lib = cmd.library()
    if params is None:
        params = cmd.item_params(consts, k)
    elif params.k != k:
        raise ValueError("parameter block was built for a different quorum")
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            queue.cst.data_ptr(), queue.cln.data_ptr(), queue.role.data_ptr(),
            queue.tot.data_ptr(), cellinfo.data_ptr(), legtab.data_ptr(),
            xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), out.data_ptr(),
            C, CH, S, int(window), *extra, ctypes.byref(params), cmd.stream())
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    counter.launches += 1
    return out


def cell_eval_quat_major(queue, cellinfo, legtab, xs, ys, zs, consts, k: int,
                         shared: bool, window: int,
                         params=None) -> torch.Tensor:
    """Quat-major CSR cell evaluation: ``queue`` from
    :func:`build_cell_queue`, ``cellinfo [C, 4]`` (cell centre, parent
    valid), ``legtab [S, W]`` from :func:`level_tables`, ``xs, ys, zs [F]``
    the cell-sorted footholds -> ``[C, 10]`` int32 (see
    :func:`cell_eval_quat_major_plain`).  Every chunk must lie inside the
    arrays: the queue's do by construction, and the kernel does not clamp.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version.  ``C == 0`` or an empty queue launches nothing."""
    return _launch(
        "legmov_cell_quat_major", cell_eval_quat_major,
        lambda: cell_eval_quat_major_plain(queue, cellinfo, legtab, xs, ys,
                                           zs, consts, k, shared),
        queue, cellinfo, legtab, xs, ys, zs, consts, k, window, params,
        extra=(int(bool(shared)),))


cell_eval_quat_major.launches = 0


def cell_eval_shared(queue, cellinfo, legtab, xs, ys, zs, consts, k: int,
                     window: int, balls: Balls,
                     params=None) -> torch.Tensor:
    """Chunk-major shared-rule CSR cell evaluation (arguments and result as
    :func:`cell_eval_quat_major`), with the per-element reach-ball test of
    ``balls`` (:func:`element_balls` of the level).  ``params``, when given,
    is :func:`ball_params` of those balls."""
    if params is None:
        params = ball_params(cmd.item_params(consts, k), balls)
    elif not params.balls:
        raise ValueError("parameter block without the reach balls")
    return _launch(
        "legmov_cell_shared", cell_eval_shared,
        lambda: cell_eval_shared_plain(queue, cellinfo, legtab, xs, ys, zs,
                                       consts, k, balls=balls),
        queue, cellinfo, legtab, xs, ys, zs, consts, k, window, params)


cell_eval_shared.launches = 0


def cell_eval_cm_perleg(queue, cellinfo, legtab, xs, ys, zs, consts, k: int,
                        window: int, params=None) -> torch.Tensor:
    """Chunk-major per-leg-rule CSR cell evaluation (arguments and result as
    :func:`cell_eval_quat_major`)."""
    return _launch(
        "legmov_cell_cm_perleg", cell_eval_cm_perleg,
        lambda: cell_eval_cm_perleg_plain(queue, cellinfo, legtab, xs, ys,
                                          zs, consts, k),
        queue, cellinfo, legtab, xs, ys, zs, consts, k, window, params)


cell_eval_cm_perleg.launches = 0


def make_csr_cell_eval(
    robot: LegDimensions,
    k: int,
    n_quats: int,
    cells: int | None = None,
    q_steps: int | None = None,
    shared: bool = True,
    window: int = 2048,
    chunk_major: bool | None = None,
    audit: bool = False,
    chunk_masks: bool = True,
    plain: bool = False,
):
    """Factory: CSR-streaming cell evaluator for one robot and rule.

    ``n_quats`` orientation samples; ``cells`` and ``q_steps``, when given,
    are the one batch size and queue width the caller will use (checked on
    every call; otherwise any batch, and the queue width comes with the
    call or from the batch's own maximum).

    ``chunk_major=None`` (default) picks the reference implementation's
    per-rule form: chunk-major for the SHARED rule (every chunk streamed
    once across all orientations), quat-major for the PER-LEG rule.  Pass an
    explicit bool to override (env ``LEGMOV_CSR_QUAT_MAJOR=1`` in the hier
    solver).  Flags are identical across the forms.

    Returns ``eval(centers [C, 3], parent_valid [C], legtab [S, W],
    elong [3], rmounts [S, L, 3], reach_l [L], r_cell, xs, ys, zs, starts,
    origin, cell_size=, dims=, q_steps=None, phases=None) -> (valid, edge,
    leaf, over)`` with models/hier_solver.py ``_eval_cells`` flag semantics
    for the given ``shared`` mode.  ``legtab`` comes from
    :func:`level_tables`; the ball-mask args from :func:`ball_mask_params`.
    A call runs in the program spans (spans.py ``phase``) ``batch.queue``
    (the queue and the cells' rows) and ``batch.launch`` (the kernel
    wrapper), whose host seconds are added to ``phases`` when it is a dict.

    ``audit=True`` extends the return to ``(valid, edge, leaf, over, counts
    [C, 7] int32)``: per cell chunks evaluated, (chunk, orientation) item
    evaluations, per-leg pipeline evaluations, the elements behind each of
    the three, and the leg pipelines run on elements inside the cell's box.
    The kernels count always; the flags do not depend on it.

    ``chunk_masks``: see :func:`build_cell_queue`.  ``plain`` asks for the
    plain versions on any device.  The shared-rule chunk-major form tests
    each element against the level's :func:`element_balls` (of ``r_cell``).
    """
    L = leg_count(robot)
    if L > 6:
        raise ValueError("a role byte packs at most 6 leg bits")
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"window must be 1 to {MAX_WINDOW}, got {window}")
    S = int(n_quats)
    consts = cmd.dist_leg_constants(robot)
    params = cmd.item_params(consts, k)
    use_cm = shared if chunk_major is None else bool(chunk_major)
    form = ("shared" if use_cm and shared
            else "cm_perleg" if use_cm else "quat_major")
    fixed_steps = q_steps
    level_balls = {}  # r_cell -> the level's element_balls and ball_params

    def run(r_cell, *level):  # queue, cellinfo, legtab, xs, ys, zs
        if form == "quat_major":
            if plain:
                return cell_eval_quat_major_plain(*level, consts, k, shared)
            return cell_eval_quat_major(*level, consts, k, shared, window,
                                        params)
        if form == "cm_perleg":
            if plain:
                return cell_eval_cm_perleg_plain(*level, consts, k)
            return cell_eval_cm_perleg(*level, consts, k, window, params)
        r_cell = float(r_cell)
        if r_cell not in level_balls:
            balls = element_balls(robot, r_cell)
            level_balls[r_cell] = balls, ball_params(params, balls)
        balls, ball_block = level_balls[r_cell]
        if plain:
            return cell_eval_shared_plain(*level, consts, k, balls=balls)
        return cell_eval_shared(*level, consts, k, window, balls, ball_block)

    def eval_fn(centers, parent_valid, legtab, elong, rmounts, reach_l,
                r_cell, xs, ys, zs, starts, origin, *,
                cell_size: float | torch.Tensor,
                dims, q_steps: int | None = None,
                phases: dict | None = None):
        C = centers.shape[0]
        if cells is not None and C != cells:
            raise ValueError(f"batch of {C} cells, built for {cells}")
        if rmounts.shape[0] != S or legtab.shape[0] != S:
            raise ValueError(f"built for {S} orientations")
        steps = fixed_steps if q_steps is None else q_steps
        if steps is None:
            steps = slab_queue_host_max(
                centers.cpu().numpy(), elong.cpu().numpy(),
                starts.cpu().numpy(), origin.cpu().numpy(), float(cell_size),
                dims, window)
        with phase("batch.queue", phases):
            queue = build_cell_queue(
                centers, elong, rmounts, reach_l, r_cell, starts, origin,
                cell_size=cell_size, dims=dims, k=k, shared=shared,
                window=window, q_steps=steps, chunk_masks=chunk_masks)
            cellinfo = torch.cat(
                [centers.to(torch.float32),
                 parent_valid[:, None].to(torch.float32)], dim=1).contiguous()
        with phase("batch.launch", phases):
            res = run(r_cell, queue, cellinfo, legtab, xs, ys, zs)
        valid = res[:, 0] > 0
        edge = res[:, 1] > 0
        if shared:
            leaf = res[:, 2] > 0
        else:
            valid = valid | parent_valid
            leaf = valid & ~edge
        # queue truncation guard: the width must cover every cell's queue
        # (sized host-side via slab_queue_host_max; this flag catches any
        # residual host/device floor divergence)
        if audit:
            return valid, edge, leaf, queue.over, res[:, 3:]
        return valid, edge, leaf, queue.over

    eval_fn.consts = consts
    eval_fn.form = form
    return eval_fn

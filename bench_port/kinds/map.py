"""Traffic kind ``map``: the any-orientation body-pose map of ``cli map
--rot-sweep``.

Set-up makes the configuration's terrain on the device and the body map
(``gen/body_map.py``) on the unshifted terrain, then moves both rigidly by
a shift drawn from the seed (up to ``shift_mm`` on each axis), so that
every seed has the same candidates relative to the ground in other bits.
It builds what ``cli map`` builds: the robot, the CSR foothold grid at
``reach / subdiv``, its ball columns and the csr-dma solver with the
suggested window, rounds and z-clip, deciding the quorum bit.

A request takes every ``request_stride``-th candidate of the map from an
offset; the offsets run through a permutation of ``0 .. stride - 1`` drawn
from the seed, so ``stride`` requests cover the map once and each spans
the whole footprint and every height.  It is cut into chunks of
``pose_chunk`` positions, the tail padded with far positions as ``cli map``
pads it, and each chunk goes through the program's
``multirot_positionable`` with the configuration's sweep.  The request
ends when its feasible mask is on the host.  Each solver call runs inside
the benchmark span ``map.solve``.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import inputs
from bench_port.counts import k4
from bench_port.gen.body_map import lattice_shape, voxel_map
from bench_port.reference import map_ref
from bench_port.trace import launch_counts

#: the program's launch counters this kind reads: name -> (module, wrapper)
COUNTERS = {
    "legmov_csr_round_kernel": ("legmov_tpu_torch.ops.cuda_multileg",
                                "csr_round_kernel"),
    "legmov_multileg_kernel": ("legmov_tpu_torch.ops.cuda_multileg",
                               "multileg_kernel"),
}
#: a padded position this far away reaches nothing (``cli map``'s pad)
PAD = 1e9
#: positions the check looks near the ground at once
_NEAR_BLOCK = 1024


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def orientations(sweep: dict) -> torch.Tensor:
    """The configuration's sweep through the program's
    ``sweep_orientations`` (``cli map``'s sweep when the configuration
    states the source's)."""
    from legmov_tpu_torch.models.pipeline import sweep_orientations

    return sweep_orientations(*[(lo * np.pi, hi * np.pi, int(n))
                                for lo, hi, n in (sweep["roll_pi"],
                                                  sweep["pitch_pi"],
                                                  sweep["yaw_pi"])])


class CellRunner:
    """Set-up, requests and the check of a ``map`` cell."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, span):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.dev = torch.device(device)
        self.span = span
        if cfg["solver"]["name"] != "csr-dma":
            raise ValueError("the map kind runs cli map's csr-dma solver only")
        self.results: dict = {}
        self.per_request: list = []

    def setup(self) -> None:
        from legmov_tpu_torch.ops.csr_grid import (
            ball_columns,
            build_csr_grid,
            make_csr_dma_solver,
            suggest_rounds,
            suggest_window,
            suggest_zclip,
        )
        from legmov_tpu_torch.ops.grid import cell_size_for, neighbor_offsets

        bm, s = self.cfg["body_map"], self.cfg["solver"]
        rng = np.random.default_rng([_seed(self.seed), 15])
        mm = float(self.traffic["shift_mm"])
        shift = rng.uniform(-mm, mm, size=3).astype(np.float32)
        with self.span("make_inputs"):
            ground = inputs.terrain(self.cfg, None, self.dev)
            g = ground.cpu().numpy()
            body = voxel_map(g, float(bm["voxel"]), float(bm["z_above"]))
            self.lattice = lattice_shape(g, float(bm["voxel"]),
                                         float(bm["z_above"]))
            self.terrain = (ground + torch.from_numpy(shift).to(self.dev)
                            ).cpu().numpy()
            self.body = body + shift
        self.stride = int(bm["request_stride"])
        self.offsets = np.random.default_rng(
            [_seed(self.seed), 19]).permutation(self.stride)
        self.chunk = int(s["pose_chunk"])
        self.k = int(s["legs_for_stability"])
        self.orientations = orientations(self.cfg["sweep"])

        robot = inputs.program_robot(self.cfg)
        reach = cell_size_for(robot)
        cell = reach / int(s["subdiv"])
        self.csr = build_csr_grid(self.terrain, cell, device=self.dev)
        cols_np = ball_columns(neighbor_offsets(cell, reach))
        self.cols = torch.from_numpy(cols_np).to(self.dev)
        window = suggest_window(self.csr)
        self.solver = make_csr_dma_solver(
            robot, window=window,
            rounds=suggest_rounds(self.csr, cols_np, window),
            decide=s["decide"], zclip=suggest_zclip(self.csr, window),
            backend="auto")

    def candidates(self, i: int) -> tuple:
        """``(offset, [n, 3] float32 positions)`` of request ``i``."""
        off = int(self.offsets[i % self.stride])
        return off, self.body[off::self.stride]

    def _solve(self, b, q):
        """``cli map``'s ``solve_fn``: one orientation for a chunk."""
        c = self.csr
        with self.span("map.solve"):
            _, quorum, _ = self.solver(
                torch.from_numpy(np.ascontiguousarray(b, np.float32)
                                 ).to(self.dev),
                torch.from_numpy(np.ascontiguousarray(q, np.float32)
                                 ).to(self.dev),
                c.xs, c.ys, c.zs, c.starts, c.origin, self.cols,
                cell_size=c.cell_size, k=self.k, dims=c.dims)
        return quorum

    def request(self, i: int, keep: bool = True):
        """Decide one request's positions (``i == -1`` warms up on one
        chunk: every chunk has the same shape)."""
        from legmov_tpu_torch.models.pipeline import multirot_positionable

        off, body = self.candidates(i)
        if not keep:
            body = body[:self.chunk]
        n = body.shape[0]
        feasible = np.zeros(n, bool)
        rounds = 0
        before = launch_counts(COUNTERS)
        for lo in range(0, n, self.chunk):
            b = body[lo:lo + self.chunk]
            if b.shape[0] < self.chunk:  # one batch shape throughout
                b = np.concatenate([b, np.full(
                    (self.chunk - b.shape[0], 3), PAD, np.float32)])
            got, per_round = multirot_positionable(self._solve, b,
                                                   self.orientations)
            feasible[lo:lo + self.chunk] = got[:min(self.chunk, n - lo)]
            rounds += len(per_round)
        after = launch_counts(COUNTERS)
        if keep:
            self.results[i] = (off, feasible)
            self.per_request.append(dict(
                index=i, offset=off, poses=n, feasible=int(feasible.sum()),
                rounds=rounds,
                launches={k: after[k] - before[k] for k in after}))

    def release(self) -> None:
        """Drop what the program keeps on the device."""
        self.solver = self.csr = self.cols = None

    def _positions(self, done: list, flat: np.ndarray) -> np.ndarray:
        """``[len(flat), 3]`` positions at the indices ``flat`` into the
        requests ``done`` laid end to end."""
        ends = np.cumsum([self.results[i][1].size for i in done])
        req = np.searchsorted(ends, flat, side="right")
        out = np.zeros((flat.size, 3), np.float32)
        for r in np.unique(req):
            at = req == r
            j = flat[at] - (ends[r - 1] if r else 0)
            out[at] = self.candidates(done[r])[1][j]
        return out

    def edge(self, done: list) -> np.ndarray:
        """``[B]`` bool over the body map: the positions that a lattice
        neighbour (one voxel along x, y or z) contradicts in the answers of
        the requests ``done``, both answered: the edge of the program's map,
        where a position's verdict hangs on the least margin."""
        known = np.zeros(self.body.shape[0], bool)
        verdict = np.zeros(self.body.shape[0], bool)
        for i in done:
            off, feasible = self.results[i]
            known[off::self.stride] = True
            verdict[off::self.stride] = feasible
        known, verdict = (a.reshape(self.lattice) for a in (known, verdict))
        out = np.zeros(self.lattice, bool)
        for axis in range(3):
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[axis], hi[axis] = slice(None, -1), slice(1, None)
            lo, hi = tuple(lo), tuple(hi)
            differ = known[lo] & known[hi] & (verdict[lo] != verdict[hi])
            out[lo] |= differ
            out[hi] |= differ
        return out.ravel()

    def check(self, done: list, traced: list, want_counts: bool,
              control=None):
        """``(checks, counts, notes)``.  A seeded sample of the positions
        the window decided: ``feasible_poses`` the program called feasible
        and ``infeasible_poses`` it called infeasible that have a foothold
        inside some leg's reach ball under some orientation (positions in
        the air cannot pass the check on their own), in each class first
        those on the edge of the program's map (:meth:`edge`), then the
        rest.  The reference decides each; ``pose_mismatch`` counts those
        it decides otherwise than the program, or, with ``control`` (a
        rounding to a lower precision), than the reference with its leg
        test in that precision in the program's place.  The traced
        request's positions give the K4 count."""
        c = self.traffic["check"]
        rng = np.random.default_rng([_seed(self.seed), 33])
        claim = np.concatenate([self.results[i][1] for i in done])
        in_map = np.concatenate([self.results[i][0] + self.stride * np.arange(
            self.results[i][1].size) for i in done])
        on_edge = self.edge(done)[in_map]

        def edge_first(which):
            idx = rng.permutation(np.nonzero(which)[0])
            return np.concatenate([idx[on_edge[idx]], idx[~on_edge[idx]]])

        yes = edge_first(claim)
        no = edge_first(~claim)
        robot = inputs.reference_robot(self.cfg)
        quats = map_ref.sweep(self.cfg["sweep"])
        fh = torch.from_numpy(self.terrain).to(self.dev)
        pick = yes[:int(c["feasible_poses"])]
        want, near = int(c["infeasible_poses"]), []
        for lo in range(0, no.size, _NEAR_BLOCK):
            if len(near) >= want:
                break
            block = no[lo:lo + _NEAR_BLOCK]
            ok = map_ref.near_any_leg(self._positions(done, block), fh,
                                      quats, robot)
            near.extend(block[ok].tolist())
        pick = np.concatenate([pick, np.asarray(near[:want], np.int64)])
        poses = self._positions(done, pick)
        truth = map_ref.evaluate(poses, fh, quats, robot, self.k).stands
        got = (claim[pick] if control is None else map_ref.evaluate(
            poses, fh, quats, robot, self.k, quantize=control).stands)
        checks = {"pose_mismatch": int(np.sum(truth != got))}
        counts = {}
        if want_counts and traced:
            _, body = self.candidates(traced[0])
            m = min(int(c["count_poses"]), body.shape[0])
            draw = np.random.default_rng([_seed(self.seed), 34])
            sample = body[np.sort(draw.choice(body.shape[0], size=m,
                                              replace=False))]
            ev = map_ref.evaluate(sample, fh, quats, robot, self.k)
            counts["map_request"] = k4.request_need(ev, self.k, body.shape[0])
        notes = dict(poses_checked=int(pick.size),
                     feasible_checked=int(np.sum(claim[pick])),
                     near_infeasible_checked=len(near[:want]),
                     on_edge_checked=int(np.sum(on_edge[pick])))
        return checks, counts, notes

"""Traffic kind ``solve``: whole octree positionability solves.

Each request hands one terrain of the cell's pool to the program's
``solve_positionability`` and ends when its ``CellRecord`` is on the host.
The pool holds ``pool`` terrains made in set-up.  All share the
configuration's crater field and coarse relief; slot 0 is the reference's
flagship terrain, the others have fine relief of their own from fixed
seeds, so every run solves the same terrains.  (Fine relief drawn from the
run's seed moved a shared-rule solve's work by up to 7 %.)  The run's seed
moves each terrain rigidly by up to ``shift_mm`` on each axis, which gives
every coordinate other bits while the octree, whose root box follows the
terrain's median, does the same work, and it picks the slot the requests
start from; they take the pool in order and cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import inputs
from bench_port.counts import k6
from bench_port.reference import solve_ref
from bench_port.trace import launch_counts

#: the program's launch counters this kind reads: name -> (module, wrapper)
COUNTERS = {
    "legmov_dist_cells_kernel": ("legmov_tpu_torch.ops.cuda_kernels",
                                 "distance_cells_kernel"),
    "legmov_cell_shared_kernel": ("legmov_tpu_torch.ops.csr_cell_eval",
                                  "cell_eval_shared"),
    "legmov_cell_quat_major_kernel": ("legmov_tpu_torch.ops.csr_cell_eval",
                                      "cell_eval_quat_major"),
}


class CellRunner:
    """Set-up, requests and the check of a ``solve`` cell."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, span):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.dev = torch.device(device)
        self.span = span
        if cfg["solver"]["box_center"] != "terrain_median":
            raise ValueError("the solve kind centres the root box on the "
                             "terrain's median only")
        self.shared = {"shared": True, "per_leg": False}[traffic["rule"]]
        self.records: dict = {}
        self.per_request: list = []

    def setup(self) -> None:
        from legmov_tpu_torch.config import SolverConfig

        s = self.cfg["solver"]
        n = int(self.traffic["pool"])
        relief = int(self.cfg["terrain"]["relief_seed"])
        detail = [None] + [int(d) for d in np.random.SeedSequence(
            [relief, 15]).generate_state(n - 1, dtype=np.uint64)]
        rng = np.random.default_rng([self.seed, 15])
        mm = float(self.traffic["shift_mm"])
        shift = rng.uniform(-mm, mm, size=(n, 3)).astype(np.float32)
        with self.span("make_terrains"):
            self.pool = [
                (inputs.terrain(self.cfg, d, self.dev)
                 + torch.from_numpy(shift[i]).to(self.dev)).cpu().numpy()
                for i, d in enumerate(detail)]
        self.start = self.seed % n
        self.solver = []
        self.configs = []
        for t in self.pool:
            center = tuple(np.median(t, axis=0).tolist())
            self.solver.append(dict(
                box_center=center, box_half=s["box_half"],
                min_box=s["min_box"], max_depth=s["max_depth"],
                angle_samples=s["angle_samples"],
                angle_min_max=inputs.angle_min_max(self.cfg),
                enable_rot_below=s["enable_rot_below"],
                legs_for_stability=s["legs_for_stability"]))
            self.configs.append(SolverConfig(
                box_center=center, box_size=tuple(s["box_half"]),
                min_box=tuple(s["min_box"]), max_depth=s["max_depth"],
                angle_samples=tuple(s["angle_samples"]),
                angle_min_max=inputs.angle_min_max(self.cfg),
                enable_rot_below=s["enable_rot_below"],
                legs_for_stability=s["legs_for_stability"]))
        self.robot = inputs.program_robot(self.cfg)

    def slot(self, i: int) -> int:
        return (self.start + i) % len(self.pool)

    def request(self, i: int, keep: bool = True):
        """One whole solve."""
        from legmov_tpu_torch.models.hier_solver import solve_positionability

        s = self.cfg["solver"]
        slot = self.slot(i)
        stats: dict = {}
        before = launch_counts(COUNTERS)
        with self.span("solve_positionability"):
            rec = solve_positionability(
                self.pool[slot], self.robot, self.configs[slot],
                chunk=s["chunk"], cell_batch=s["cell_batch"],
                shared_foothold=self.shared, device=self.dev, stats=stats)
        after = launch_counts(COUNTERS)
        if keep:
            self.records[i] = (slot, rec)
            self.per_request.append(dict(
                index=i, slot=slot, cells=int(rec.centers.shape[0]),
                valid=int(rec.valid.sum()), edge=int(rec.edge.sum()),
                stats=stats,
                launches={k: after[k] - before[k] for k in after}))

    def release(self) -> None:
        """Drop what the program keeps on the device."""
        self.robot = None

    def check(self, done: list, traced: list, want_counts: bool,
              control=None):
        """``(checks, counts, notes)``.  ``done``: indices of the requests
        that completed in the window; ``traced``: those that were traced
        (always checked, and the ones whose deepest level is counted).
        With ``control`` (a function that rounds the inputs), the control
        stands in the program's place: the reference on rounded inputs
        claims the flags of the sampled cells of each record's tree."""
        c = self.traffic["check"]
        rng = np.random.default_rng([self.seed, 33])
        rest = [i for i in done if i not in traced]
        pick = list(traced)
        by_slot: dict = {}
        for i in rng.permutation(rest).tolist():
            by_slot.setdefault(self.records[i][0], []).append(i)
        while len(pick) < int(c["solves"]) and any(by_slot.values()):
            for slot in sorted(by_slot):
                if by_slot[slot] and len(pick) < int(c["solves"]):
                    pick.append(by_slot[slot].pop(0))
        robot = inputs.reference_robot(self.cfg)
        tree_bad = flag_bad = evaluated = 0
        need = []
        for i in pick:
            slot, rec = self.records[i]
            levels, bad = solve_ref.rebuild_tree(rec, self.solver[slot])
            tree_bad += bad
            fh = torch.from_numpy(self.pool[slot]).to(self.dev)
            fc = solve_ref.check_flags(
                levels, fh, robot, self.solver[slot], self.shared,
                np.random.default_rng([self.seed, i]),
                int(c["cells_per_level"]), int(c["deepest_cells"]), control)
            flag_bad += fc.mismatches
            evaluated += fc.evaluated
            if i in traced:
                need.append(k6.deepest_level(fc.deepest_need,
                                             fc.deepest_cells,
                                             self.pool[slot].shape[0]))
        checks = {"tree_mismatch_cells": tree_bad,
                  "cell_flag_mismatch": flag_bad}
        counts = {}
        if want_counts and need:
            counts["deepest_level"] = tuple(
                float(np.mean([n[j] for n in need])) for j in (0, 1))
        notes = dict(solves_checked=len(pick), cells_evaluated=evaluated)
        return checks, counts, notes

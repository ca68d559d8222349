"""The plain reference against the port's CPU path at tiny sizes, and the
control (the reference on bfloat16 inputs) against the reference."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_port import inputs
from bench_port.reference import solve_ref
from conftest import tiny_solve_config


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


@pytest.fixture(scope="module")
def solve_case():
    from legmov_tpu_torch.config import SolverConfig

    cfg = tiny_solve_config()
    terrain = inputs.terrain(cfg, 11, "cpu").numpy()
    s = cfg["solver"]
    center = tuple(np.median(terrain, axis=0).tolist())
    solver = dict(box_center=center, box_half=s["box_half"],
                  min_box=s["min_box"], max_depth=s["max_depth"],
                  angle_samples=s["angle_samples"],
                  angle_min_max=inputs.angle_min_max(cfg),
                  enable_rot_below=s["enable_rot_below"],
                  legs_for_stability=s["legs_for_stability"])
    sc = SolverConfig(box_center=center, box_size=tuple(s["box_half"]),
                      min_box=tuple(s["min_box"]), max_depth=s["max_depth"],
                      angle_samples=tuple(s["angle_samples"]),
                      angle_min_max=inputs.angle_min_max(cfg),
                      enable_rot_below=s["enable_rot_below"],
                      legs_for_stability=s["legs_for_stability"])
    return cfg, terrain, solver, sc


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_leg"])
def test_solve_reference_agrees_with_the_port(solve_case, shared):
    from legmov_tpu_torch.models.hier_solver import solve_positionability

    cfg, terrain, solver, sc = solve_case
    rec = solve_positionability(terrain, inputs.program_robot(cfg), sc,
                                shared_foothold=shared, device="cpu")
    levels, bad = solve_ref.rebuild_tree(rec, solver)
    assert bad == 0
    assert sum(int(lv.terminal.sum()) for lv in levels) == rec.centers.shape[0]
    assert levels[-1].rot  # the deepest level samples orientations
    robot = inputs.reference_robot(cfg)
    fh = torch.from_numpy(terrain)
    every = 10 ** 6
    fc = solve_ref.check_flags(levels, fh, robot, solver, shared,
                               np.random.default_rng(0), every, every)
    assert fc.mismatches == 0
    assert fc.evaluated == sum(lv.children.shape[0] for lv in levels)
    assert fc.deepest_need > 0
    # the control in the record's place: the same cells on bfloat16 inputs
    low = solve_ref.check_flags(levels, fh, robot, solver, shared,
                                np.random.default_rng(0), every, every,
                                control=_bf16)
    assert low.mismatches > 0 and low.evaluated == fc.evaluated
    # an altered record is caught: every 5th valid flag flipped
    rec.valid[::5] = ~rec.valid[::5]
    levels, _ = solve_ref.rebuild_tree(rec, solver)
    fc = solve_ref.check_flags(levels, fh, robot, solver, shared,
                               np.random.default_rng(0), every, every)
    assert fc.mismatches >= rec.valid[::5].size // 2


def test_tree_rebuild_counts_a_dropped_or_moved_cell(solve_case):
    from legmov_tpu_torch.models.hier_solver import CellRecord

    cfg, terrain, solver, sc = solve_case
    c = np.asarray([[0.0, 0.0, 0.0]], np.float32) + np.asarray(
        solver["box_center"], np.float32)
    # a record of the root's eight children, none refined
    children, half = solve_ref.split_children(
        c, np.asarray(solver["box_half"], np.float32), solver["min_box"])
    rec = CellRecord(children, np.broadcast_to(half, children.shape),
                     np.zeros(8, bool), np.zeros(8, bool), np.zeros(8, int))
    assert solve_ref.rebuild_tree(rec, solver)[1] == 0
    moved = children.copy()
    moved[3, 0] = np.nextafter(moved[3, 0], np.float32(np.inf))
    rec2 = dataclasses.replace(rec, centers=moved)
    assert solve_ref.rebuild_tree(rec2, solver)[1] == 1
    rec3 = CellRecord(children[1:], np.broadcast_to(half, (7, 3)),
                      np.zeros(7, bool), np.zeros(7, bool), np.zeros(7, int))
    levels, bad = solve_ref.rebuild_tree(rec3, solver)
    assert bad > 0  # the missing cell reads as refined, its children absent

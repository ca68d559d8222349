"""The map cell on the CPU at a tiny size: the kind's answers against
``cli map --rot-sweep``, the reference against the port's CPU path, the
faults of the timed path that ``correct`` has to catch, the control, a
count that no solver setting moves, and the manifest's entries for the
cell."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from bench_port import harness
from conftest import BENCH, REPO, make_root

SEED = 2 ** 32 + 12345
CELL = "quad-m2.map-sweep45"
#: four orientations: the CPU's stand-in for the 3 x 3 x 5 sweep
SMALL_SWEEP = dict(roll_pi=[-0.125, 0.125, 2], pitch_pi=[0.0, 0.0, 1],
                   yaw_pi=[0.0, 0.5, 2])


def tiny_map_config(voxel=700.0):
    """A 128 x 128 terrain, 700 mm voxels (432 candidates), four
    orientations, two requests a map of one chunk each."""
    with open(os.path.join(BENCH, "configs",
                           "quad-m2-moon64k-map.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "quad-map-tiny"
    cfg["terrain"]["shape"] = [128, 128]
    cfg["body_map"].update(voxel=voxel, request_stride=2)
    cfg["solver"]["pose_chunk"] = 256
    cfg["sweep"].update(SMALL_SWEEP)
    return cfg


def map_root(path, voxel=700.0):
    """A checkout with the map cell on the tiny configuration and the
    cell's own traffic, whose check samples every position of a request
    here."""
    with open(os.path.join(BENCH, "traffic", "map-sweep45.json")) as f:
        traffic = json.load(f)
    traffic["name"] = "map-tiny"
    cell = {"name": CELL, "config": "quad-map-tiny", "traffic": "map-tiny",
            "chips": 1, "why": "a CPU-sized stand-in"}
    return make_root(path, {"configs": [tiny_map_config(voxel)],
                            "traffic": [traffic], "workloads": [cell]})


def _runner(root, chunk=None):
    from bench_port.kinds import map as kind

    m = harness.load_manifest(root)
    _, cfg, traffic = harness.cell_files(m, CELL, root)
    if chunk:
        cfg["solver"]["pose_chunk"] = chunk
    d = kind.CellRunner(cfg, traffic, SEED, "cpu", harness.Spans())
    d.setup()
    return d


def test_the_kind_equals_cli_map_rot_sweep(tmp_path, monkeypatch):
    """Every request of a cycle together gives ``cli map --rot-sweep``'s
    mask on the same terrain and body map (a prepared directory), both
    under the stand-in sweep."""
    from legmov_tpu_torch import cli
    from legmov_tpu_torch import io as lio
    from legmov_tpu_torch.models import pipeline

    real = pipeline.sweep_orientations
    small = [(lo * np.pi, hi * np.pi, n) for lo, hi, n in (
        SMALL_SWEEP["roll_pi"], SMALL_SWEEP["pitch_pi"],
        SMALL_SWEEP["yaw_pi"])]
    monkeypatch.setattr(pipeline, "sweep_orientations",
                        lambda *a: real(*(a or small)))
    d = _runner(map_root(tmp_path / "root"))
    mask = np.zeros(d.body.shape[0], bool)
    seen = np.zeros(d.body.shape[0], int)
    for i in range(d.stride):
        d.request(i)
        off, got = d.results[i]
        mask[off::d.stride] = got
        seen[off::d.stride] += 1
    assert (seen == 1).all()  # a cycle of requests covers the map once
    prep = str(tmp_path / "prep")
    os.makedirs(prep)
    lio.save_points(d.terrain, os.path.join(prep, "numpy_input_t"))
    lio.save_points(d.body, os.path.join(prep, "numpy_input_b"))
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["map", "--dir", prep, "--rot-sweep", "--device", "cpu",
                  "--backend", "torch", "--pose-chunk", "256"])
    want = np.load(os.path.join(prep, "body_feasible.npy"))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(mask, want)
    # the records: rounds from per_round, no multi-leg kernel on this path
    for r in d.per_request:
        assert r["rounds"] == 4 and r["launches"][
            "legmov_multileg_kernel"] == 0


def test_the_configured_sweep_is_cli_maps_and_the_references():
    """The configuration's 45 orientations through the program are ``cli
    map``'s default sweep, and the reference's own equal them bit for
    bit."""
    from bench_port.kinds import map as kind
    from bench_port.reference import map_ref
    from legmov_tpu_torch.models.pipeline import sweep_orientations

    with open(os.path.join(BENCH, "configs",
                           "quad-m2-moon64k-map.json")) as f:
        sweep = json.load(f)["sweep"]
    got = kind.orientations(sweep)
    assert got.shape == (45, 4)
    assert torch.equal(got, sweep_orientations())
    assert torch.equal(map_ref.sweep(sweep), got)


def test_a_traced_run_is_correct_and_reports_the_cells_metrics(tmp_path):
    root = map_root(tmp_path)
    r = harness.run(CELL, SEED, 0.5, True, device="cpu", root=root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["pose_mismatch"]["value"] == 0
    assert r["samples"]["feasible_checked"] > 0
    assert r["samples"]["near_infeasible_checked"] > 0
    # the CPU runs no kernel: the kernel readers read nothing, the rest do
    assert set(r["metrics"]) == {"map_rounds", "idle_share.map"}
    assert r["metrics"]["map_rounds"]["value"] == 4
    r = harness.run(CELL, SEED, 0.5, False, device="cpu", root=root)
    assert set(r["metrics"]) == {"setup_s", "map_poses_per_s"}


def _flip_one(real):
    calls = []

    def sweep(solve_fn, body, orientations=None):
        feasible, per_round = real(solve_fn, body, orientations)
        calls.append(1)
        if len(calls) == 2:  # the first chunk after the warm one
            feasible = feasible.copy()
            feasible[0] = ~feasible[0]
        return feasible, per_round
    return sweep


def _drop_orientation(real):
    def sweep(solve_fn, body, orientations=None):
        return real(solve_fn, body, orientations[1:])
    return sweep


def _half_left_out(real):
    def sweep(solve_fn, body, orientations=None):
        b = np.array(body, np.float32)
        b[b.shape[0] // 2:] = 1e9
        return real(solve_fn, b, orientations)
    return sweep


def _state_unchanged(real):
    def sweep(solve_fn, body, orientations=None):
        return np.zeros(body.shape[0], bool), [0] * len(orientations)
    return sweep


@pytest.mark.parametrize("fault", [_flip_one, _drop_orientation,
                                   _half_left_out, _state_unchanged],
                         ids=["answer_altered", "orientation_dropped",
                              "half_left_out", "state_unchanged"])
def test_map_faults_read_not_correct(tmp_path, monkeypatch, fault):
    import legmov_tpu_torch.models.pipeline as pipe

    monkeypatch.setattr(pipe, "multirot_positionable",
                        fault(pipe.multirot_positionable))
    # a short window: a fault that returns at once makes few requests
    r = harness.run(CELL, SEED, 0.01, False, device="cpu",
                    root=map_root(tmp_path))
    assert not r["correct"]
    assert r["checks"]["pose_mismatch"]["value"] > 0


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def test_the_control_reads_not_correct(tmp_path):
    """The reference with its leg test in bfloat16, in the program's place,
    judged by the run's own check, reads not correct; the program on the
    same run reads correct.  The map is finer here (350 mm voxels): the
    control misses only where a verdict hangs on a millimetre, and on the
    700 mm map no sampled position does."""
    root = map_root(tmp_path, voxel=350.0)
    r = harness.run(CELL, SEED, 0.01, False, device="cpu", root=root,
                    control=_bf16)
    assert not r["correct"]
    assert r["checks"]["pose_mismatch"]["value"] > 0
    assert harness.run(CELL, SEED, 0.01, False, device="cpu",
                       root=root)["correct"]


def _k4_count(root, chunk=None):
    d = _runner(root, chunk)
    d.request(0)
    return d.check([0], [0], want_counts=True)[1]


@pytest.mark.parametrize("settings", ["pose_chunk", "window_rounds"])
def test_the_k4_count_does_not_move_with_solver_settings(tmp_path,
                                                         monkeypatch,
                                                         settings):
    from legmov_tpu_torch.ops import csr_grid

    root = map_root(tmp_path)
    want = _k4_count(root)
    if settings == "window_rounds":
        monkeypatch.setattr(csr_grid, "suggest_window", lambda csr: 64)
        monkeypatch.setattr(csr_grid, "suggest_rounds",
                            lambda csr, cols, window: ((2, 1.0), (0, 0.5)))
    assert _k4_count(root, 128 if settings == "pose_chunk" else None) == want
    ops, n_bytes = want["map_request"]
    assert ops > 0 and n_bytes > 0


def test_the_map_config_gives_the_sources_candidate_count():
    """before.py's voxel rule on the configuration's terrain: 80 x 160 x 84
    candidates; a request takes 1/32 of them."""
    from bench_port import inputs
    from bench_port.gen.body_map import voxel_map

    with open(os.path.join(BENCH, "configs",
                           "quad-m2-moon64k-map.json")) as f:
        cfg = json.load(f)
    t = inputs.terrain(cfg, None, "cpu").numpy()
    body = voxel_map(t, cfg["body_map"]["voxel"], cfg["body_map"]["z_above"])
    assert body.shape == (1_075_200, 3) and body.dtype == np.float32
    assert body.shape[0] % cfg["body_map"]["request_stride"] == 0


def test_the_manifest_entries_of_the_map_cell():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        m = json.load(f)
    cell = {w["name"]: w for w in m["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["config"] == "quad-m2-moon64k-map"
    e2e = [x for x in m["end_to_end"] if CELL in x.get("workloads", [CELL])]
    assert {x["name"] for x in e2e} == {"setup_s", "map_poses_per_s"}
    per = [x for x in m["per_layer"] if CELL in x.get("workloads", [CELL])]
    assert {x["name"] for x in per} == {
        "k4_ms", "k4_roofline", "map_queue_device_ms", "map_rounds",
        "idle_share.map"}
    assert all(x["moves"] == "map_poses_per_s"
               and x["workloads"] == [CELL] for x in per)


def test_the_map_kind_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.kinds.map, bench_port.reference.map_ref\n"
            "import bench_port.counts.k4\n"
            "from bench_port import harness\n"
            "print(harness.forbidden_modules())" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_edge_is_where_answered_lattice_neighbours_disagree():
    """``edge`` marks both positions of every pair of lattice neighbours
    whose answers differ, and only pairs whose both answers it has."""
    from bench_port.kinds import map as kind

    d = kind.CellRunner.__new__(kind.CellRunner)
    d.lattice, d.stride = (2, 3, 4), 2
    d.body = np.zeros((24, 3), np.float32)
    answer = np.zeros(d.lattice, bool)
    answer[1, 2, 3] = True  # flat index 23: request offset 1
    flat = answer.ravel()
    d.results = {0: (0, flat[0::2]), 1: (1, flat[1::2])}
    want = np.zeros(d.lattice, bool)
    for at in ((1, 2, 3), (0, 2, 3), (1, 1, 3), (1, 2, 2)):
        want[at] = True
    assert np.array_equal(d.edge([0, 1]).reshape(d.lattice), want)
    want[1, 2, 2] = False  # flat index 22 is request 0's, not answered
    assert np.array_equal(d.edge([1]).reshape(d.lattice), want)

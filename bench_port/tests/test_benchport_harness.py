"""The harness on the CPU at tiny sizes: a whole run past the look for a
card, a cell added by new files and entries alone, the faults of the timed
path that ``correct`` has to catch, counts that no solver setting moves,
and the exits without a card or without the program."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port import harness
from conftest import REPO, make_root, tiny_solve_config, tiny_traffic

SEED = 2 ** 32 + 12345


def _run(root, cell, trace=False, seconds=0.5):
    return harness.run(cell, SEED, seconds, trace, device="cpu", root=root)


@pytest.mark.parametrize("cell", ["quad-m2.solve-shared",
                                  "quad-m2.solve-perleg"])
def test_a_traced_run_reports_the_cells_metrics(tiny_root, cell):
    r = _run(tiny_root, cell, trace=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    m = harness.load_manifest(tiny_root)
    # the CPU runs no kernel: the kernel readers read nothing, the rest do
    rule = cell.split("-")[-1].replace("perleg", "per_leg")
    assert {"solve_host_syncs." + rule, "idle_share." + rule} <= set(
        r["metrics"])
    assert set(r["metrics"]) <= {x["name"]
                                 for x in harness.metrics_of(m, cell, True)}
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_by_files_and_entries_alone(tmp_path):
    """A new configuration, traffic mix and cell, and metrics of their own:
    new files and entries, no edit of a file the benchmark has (the new
    metrics' quantities already have readers)."""
    cfg = tiny_solve_config("quad-tiny-k3")
    cfg["solver"]["legs_for_stability"] = 3
    traffic = tiny_traffic("solve-shared")
    traffic.update(name="solve-k3-tiny", shift_mm=50.0)
    cell = {"name": "quad-tiny-k3.solve-k3", "config": "quad-tiny-k3",
            "traffic": "solve-k3-tiny", "chips": 1, "why": "a test cell"}
    root = make_root(tmp_path, {"configs": [cfg], "traffic": [traffic],
                                "workloads": [cell]})
    m = harness.load_manifest(root)
    m["end_to_end"].append({
        "name": "solve_s.k3", "unit": "s", "better": "lower", "bound": 0.1,
        "source": "host_clock", "workloads": [cell["name"]]})
    m["per_layer"].append({
        "name": "solve_host_syncs.k3", "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "solve host loop",
        "moves": "solve_s.k3", "workloads": [cell["name"]]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    r = _run(root, cell["name"])
    assert r["correct"]
    assert set(r["metrics"]) == {"setup_s", "solve_s.k3"}
    # the per-layer entry finds its quantity's reader
    assert [x["name"] for x in harness.metrics_of(m, cell["name"], True)
            ] == ["solve_host_syncs.k3"]
    assert callable(harness.reader("solve_host_syncs.k3", root))


@pytest.mark.parametrize("key,value", [("loop", "open"), ("clients", 4)])
def test_a_traffic_file_the_harness_cannot_drive_is_refused(
        tmp_path, key, value):
    traffic = tiny_traffic("solve-shared")
    traffic.update({"name": "solve-odd", key: value})
    cell = {"name": "quad-tiny.solve-odd", "config": "quad-tiny",
            "traffic": "solve-odd", "chips": 1, "why": "a test cell"}
    root = make_root(tmp_path, {"traffic": [traffic], "workloads": [cell]})
    with pytest.raises(ValueError, match="closed loop"):
        harness.cell_files(harness.load_manifest(root), cell["name"], root)


def test_a_box_centre_the_solve_kind_cannot_place_is_refused():
    from bench_port.kinds import solve

    cfg = tiny_solve_config()
    cfg["solver"]["box_center"] = [0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="median"):
        solve.CellRunner(cfg, tiny_traffic("solve-shared"), SEED, "cpu",
                         harness.Spans())


def _flip_valid(real):
    def solve(*a, **kw):
        rec = real(*a, **kw)
        rec.valid[::3] = ~rec.valid[::3]
        return rec
    return solve


def _drop_half_deepest(real):
    def solve(*a, **kw):
        rec = real(*a, **kw)
        deep = np.nonzero(rec.depth == rec.depth.max())[0][::2]
        keep = np.ones(rec.depth.size, bool)
        keep[deep] = False
        for f in ("centers", "halves", "valid", "edge", "depth"):
            setattr(rec, f, getattr(rec, f)[keep])
        return rec
    return solve


def _stale_deepest(real):
    """The deepest level returned as its parents left it: no cell of it
    refined or judged."""
    def solve(*a, **kw):
        rec = real(*a, **kw)
        deep = rec.depth == rec.depth.max()
        rec.valid[deep] = False
        rec.edge[deep] = False
        return rec
    return solve


@pytest.mark.parametrize("fault", [_flip_valid, _drop_half_deepest,
                                   _stale_deepest],
                         ids=["answer_altered", "half_left_out",
                              "state_unchanged"])
def test_solve_faults_read_not_correct(tiny_root, monkeypatch, fault):
    import legmov_tpu_torch.models.hier_solver as hs

    monkeypatch.setattr(hs, "solve_positionability",
                        fault(hs.solve_positionability))
    r = _run(tiny_root, "quad-m2.solve-perleg")
    assert not r["correct"]


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("cell", ["quad-m2.solve-shared",
                                  "quad-m2.solve-perleg"])
def test_the_control_reads_not_correct(tiny_root, cell):
    """The reference on bfloat16 inputs, in the program's place, judged by
    the run's own check, reads not correct; the program on the same run
    reads correct."""
    m = harness.load_manifest(tiny_root)
    _, _, traffic = harness.cell_files(m, cell, tiny_root)
    # every cell of the tiny octree (the cell's own samples are larger
    # than a tiny level)
    traffic["check"].update(cells_per_level=10 ** 6, deepest_cells=10 ** 6)
    with open(os.path.join(tiny_root, "bench_port", "traffic",
                           m_traffic(m, cell) + ".json"), "w") as f:
        json.dump(traffic, f)
    r = harness.run(cell, SEED, 0.5, False, device="cpu", root=tiny_root,
                    control=_bf16)
    assert not r["correct"]
    assert r["checks"]["cell_flag_mismatch"]["value"] > 0
    assert _run(tiny_root, cell)["correct"]


def m_traffic(manifest, cell):
    return {w["name"]: w["traffic"] for w in manifest["workloads"]}[cell]


def _counts(root, cell, **changes):
    import importlib

    m = harness.load_manifest(root)
    _, cfg, traffic = harness.cell_files(m, cell, root)
    for key, value in changes.items():
        (cfg["solver"] if key in ("cell_batch", "chunk") and
         "solver" in cfg else traffic)[key] = value
    kind = importlib.import_module("bench_port.kinds." + traffic["kind"])
    d = kind.CellRunner(cfg, traffic, SEED, "cpu", harness.Spans())
    d.setup()
    d.request(0)
    return d.check([0], [0], want_counts=True)[1]


def test_counts_do_not_move_with_solver_settings(tiny_root):
    a = _counts(tiny_root, "quad-m2.solve-shared")
    b = _counts(tiny_root, "quad-m2.solve-shared", cell_batch=64, chunk=97)
    assert a == b and a["deepest_level"][0] > 0


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "legmov_tpu", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert harness.forbidden_modules() == ["jaxlib", "legmov_tpu"]


def test_no_run_loads_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.harness, bench_port.kinds.solve, "
            "bench_port.reference.solve_ref\n"
            "from bench_port import harness\n"
            "print(harness.forbidden_modules())" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    base = os.path.join(REPO, "bench_port", "reference")
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert "import legmov_tpu" not in text
                assert "from legmov_tpu" not in text
                assert "import jax" not in text


def _cli(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "quad-m2.solve-shared", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True, env=env)


def test_run_without_a_card_prints_no_result():
    p = _cli(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "bench_port"),
                    os.path.join(tmp_path, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = _cli(tmp_path, {"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""

"""PyTorch port: ``python -m legmov_tpu_torch.bench_sweep`` and
``bench_report`` on the CPU.

The sweep's sizes are the reference protocol's eleven (and the LM-IK
mode's seven), its grids equal the JAX tool's (``tools/bench_sweep.py``,
loaded by path); tiny sweeps of the CPU modes write one well-formed row a
rep and a ``device.json``, and a rerun skips what is there.  The report's
aggregation equals the JAX tool's (``tools/bench_report.py``) on seeded
synthetic rows.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from legmov_tpu_torch import bench_report, bench_sweep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [66160650, 16544544, 4136608, 1034152, 258656, 64664, 16166, 4110,
         1035, 280, 72]
IK_SIZES = [662634, 165753, 41705, 10560, 2640, 660, 168]


def _tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_eleven_sizes_and_the_seven_of_ik():
    pitches = bench_sweep.ref_pitches()
    assert pitches == _tool("bench_sweep").ref_pitches()
    assert [bench_sweep.grid_size(p) for p in pitches] == SIZES
    assert [bench_sweep.grid_size(p)
            for p in bench_sweep.ref_pitches(bench_sweep.MIN_PIX_IK)] == IK_SIZES


@pytest.mark.parametrize("pix", [40.96, 20.48, 10.24])
def test_grids_equal_the_jax_tools(pix):
    want = _tool("bench_sweep").ref_grid(pix)
    got = bench_sweep.ref_grid(pix)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == bench_sweep.grid_size(pix)


def test_launch_iters_grow_as_the_batch_shrinks():
    iters = [bench_sweep.launch_iters(n) for n in SIZES]
    assert iters == sorted(iters)
    assert iters[0] == 4 and iters[-1] == 200
    plain = [bench_sweep.launch_iters(n, "plain") for n in SIZES]
    assert plain == sorted(plain) and plain[0] == 4 and plain[-1] == 10


def _rows(path):
    with open(path) as f:
        rows = [line.strip().split(";") for line in f if line.strip()]
    return [(int(n), float(ns)) for n, ns in rows]


@pytest.mark.parametrize("impl,names,sizes", [
    ("plain", ("rtorch_cpu.csv", "dtorch_cpu.csv"), [72, 280, 1035, 4110]),
    ("oracle", ("rcpu.csv", "dcpu.csv"), [72, 280, 1035, 4110]),
    ("ik", ("ik.csv",), [168, 660, 2640]),
])
def test_tiny_cpu_sweeps_write_rows_and_resume(impl, names, sizes, tmp_path,
                                               capsys):
    argv = ["--impl", impl, "--device", "cpu", "--max-points", "5000",
            "--reps", "2", "--cpu-point-cap", "64", "--out", str(tmp_path)]
    res = bench_sweep.main(argv)
    assert sorted(res) == sorted(names)
    with open(tmp_path / "device.json") as f:
        machines = json.load(f)
    for name in names:
        rows = _rows(tmp_path / name)
        assert [n for n, _ in rows] == [n for n in sizes for _ in range(2)]
        assert all(np.isfinite(ns) and ns > 0 for _, ns in rows)
        info = machines[name]
        assert info["device"] == "cpu" and info["label"].startswith("cpu: ")
        assert info["threads"] == (torch.get_num_threads()
                                   if impl == "plain" else 1)
        assert [r["n"] for r in res[name]] == sizes
    capsys.readouterr()
    # a rerun finds every row and times nothing
    assert bench_sweep.main(argv) == {}
    out = capsys.readouterr().out
    assert out.count("rows present, skip") == len(sizes) * len(names)
    for name in names:
        assert len(_rows(tmp_path / name)) == 2 * len(sizes)


def test_the_kernel_sweep_runs_on_the_card_only(tmp_path):
    with pytest.raises(SystemExit, match="card"):
        bench_sweep.main(["--impl", "kernel", "--device", "cpu", "--out",
                          str(tmp_path)])
    assert not os.path.exists(tmp_path / "rgpu.csv")


def test_rows_of_another_machine_are_refused(tmp_path):
    (tmp_path / "rtorch_cpu.csv").write_text("72;1.0\n")
    (tmp_path / "device.json").write_text(json.dumps(
        {"rtorch_cpu.csv": {"label": "cpu: another machine, 64 threads"}}))
    with pytest.raises(SystemExit, match="another machine"):
        bench_sweep.main(["--impl", "plain", "--device", "cpu", "--out",
                          str(tmp_path), "--max-points", "100"])
    assert (tmp_path / "rtorch_cpu.csv").read_text() == "72;1.0\n"


def _synthetic(seed):
    rng = np.random.default_rng(seed)
    rows = {}
    for n in SIZES:
        k = int(rng.integers(1, 30))
        rows[n] = rng.lognormal(0.0, 0.5, k).tolist()
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_and_curve_equal_the_jax_tools(seed):
    tool = _tool("bench_report")
    rows = _synthetic(seed)
    assert bench_report.aggregate(rows) == tool.aggregate(rows)
    assert bench_report.aggregate(rows, 100) == tool.aggregate(rows, 100)
    for a, b in zip(bench_report.curve(rows), tool.curve(rows)):
        np.testing.assert_array_equal(a, b)


def test_load_csv_equals_the_jax_tools(tmp_path):
    path = tmp_path / "rgpu.csv"
    path.write_text("72;1.5\n\n72;2.5\n1034152;0.25\n")
    assert bench_report.load_csv(str(path)) == _tool("bench_report").load_csv(
        str(path))


def _write_sweep(d, name, rows, label):
    with open(d / name, "w") as f:
        for n, samples in rows.items():
            for s in samples:
                f.write(f"{n};{s}\n")
    path = d / "device.json"
    known = json.loads(path.read_text()) if path.exists() else {}
    known[name] = {"label": label}
    path.write_text(json.dumps(known))


def test_report_labels_and_speed_ups(tmp_path, capsys):
    ours = tmp_path / "ours"
    ours.mkdir()
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    _write_sweep(ours, "rgpu.csv", {20000: [0.01, 0.01, 0.01]}, card)
    _write_sweep(ours, "dtorch_cpu.csv", {20000: [546.6] * 3},
                 "cpu: some model, 8 threads")
    res = bench_report.main(["--ours", str(ours), "--out",
                             str(tmp_path / "r.png")])
    lines = res["lines"]
    assert any(line.startswith(f"K1 reach ({card})") for line in lines)
    assert (f"speed-up of K1 reach ({card}) over GTX 1080 Ti (reach, 0.403 "
            "ns/pt from BASELINE.md): 40.30x") in lines
    assert ("speed-up of plain dist (cpu: some model, 8 threads) over "
            "i5-12600K (dist, 273.3 ns/pt from BASELINE.md): 0.50x") in lines
    assert capsys.readouterr().out.count("speed-up") == 2
    # the reference's own CSVs take the place of BASELINE.md's figures
    ref = tmp_path / "ref"
    (ref / "pc").mkdir(parents=True)
    (ref / "pc" / "rgpu.csv").write_text("20000;0.5\n20000;0.5\n")
    lines = bench_report.report(str(ours), str(ref))["lines"]
    assert any(line.startswith("GTX 1080 Ti reach") for line in lines)
    assert (f"speed-up of K1 reach ({card}) over GTX 1080 Ti (reach, 0.5 "
            f"ns/pt from {ref}/pc/rgpu.csv): 50.00x") in lines

"""PyTorch port: it stands alone (no jax, nothing of legmov_tpu), never
drops to the CPU by itself, and its CUDA wrappers run their plain versions
for CPU tensors only."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "legmov_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_pulls_in_neither_jax_nor_legmov_tpu():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import legmov_tpu_torch, legmov_tpu_torch.cli\n"
        "import legmov_tpu_torch.ops.cuda_kernels, legmov_tpu_torch.viz\n"
        "import legmov_tpu_torch.terrain, legmov_tpu_torch.oracle\n"
        "import legmov_tpu_torch.stats, legmov_tpu_torch.io\n"
        "import legmov_tpu_torch.ops.quaternion, legmov_tpu_torch.ops.orientation\n"
        "import legmov_tpu_torch.ops.collision, legmov_tpu_torch.ops.positionability\n"
        "import legmov_tpu_torch.ops.solve_schedule, legmov_tpu_torch.ops.grid\n"
        "import legmov_tpu_torch.ops.csr_grid, legmov_tpu_torch.ops.cuda_multileg\n"
        "import legmov_tpu_torch.models.robot, legmov_tpu_torch.models.pipeline\n"
        "import legmov_tpu_torch.map_bench\n"
        "import legmov_tpu_torch.ops.cuda_multileg_dist\n"
        "import legmov_tpu_torch.ops.csr_cell_eval\n"
        "import legmov_tpu_torch.models.hier_solver\n"
        "import legmov_tpu_torch.reach_probe, legmov_tpu_torch.ops.trig32\n"
        "import legmov_tpu_torch.models.adaptive_field\n"
        "import legmov_tpu_torch.oracle.ik_oracle, legmov_tpu_torch.native\n"
        "import legmov_tpu_torch.parallel, legmov_tpu_torch.parallel.sharding\n"
        "import legmov_tpu_torch.parallel.multihost, legmov_tpu_torch.profiling\n"
        "import legmov_tpu_torch.dryrun, legmov_tpu_torch.multihost_dryrun\n"
        "import legmov_tpu_torch.scaling_bench, legmov_tpu_torch.solver_fuzz\n"
        "import legmov_tpu_torch.hier_fuzz, legmov_tpu_torch.ops\n"
        "import legmov_tpu_torch.ref_image_check, legmov_tpu_torch.live_view\n"
        "import legmov_tpu_torch.visualize_solve, legmov_tpu_torch.circle_figure\n"
        "import legmov_tpu_torch.render_solve_cells, legmov_tpu_torch.quick_view\n"
        "import legmov_tpu_torch.bench_sweep, legmov_tpu_torch.bench_report\n"
        "from legmov_tpu_torch.ops.cuda_multileg import (\n"
        "    make_adaptive_grid_solver, make_fused_grid_solver, pad_grid_soa)\n"
        "bad = [m for m in set(sys.modules) - before if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'legmov_tpu' or m.startswith('legmov_tpu.')"
        " or m == 'tools' or m.startswith('tools.')"
        " or m == 'matplotlib' or m.startswith('matplotlib.')]\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_sources_name_neither_jax_nor_legmov_tpu():
    pat = re.compile(r"^\s*(from|import)\s+(jax|legmov_tpu)(\.|\s|$)", re.M)
    files = _port_sources()
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            hit = pat.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_same_layout_as_jax_package():
    """A reader finds the counterpart of a module by path."""
    for rel in ("config.py", "io.py", "stats.py", "viz.py", "cli.py",
                "models/leg.py", "models/workspace.py", "ops/frames.py",
                "ops/plane.py", "ops/reachability.py", "ops/distance.py",
                "terrain/perlin.py", "terrain/maps.py", "oracle/numpy_ref.py",
                "models/robot.py", "models/pipeline.py", "ops/quaternion.py",
                "ops/orientation.py", "ops/collision.py",
                "ops/positionability.py", "ops/solve_schedule.py",
                "ops/grid.py", "ops/csr_grid.py", "ops/csr_cell_eval.py",
                "models/hier_solver.py", "models/adaptive_field.py",
                "oracle/ik_oracle.py", "native.py", "parallel/__init__.py",
                "parallel/sharding.py", "parallel/multihost.py",
                "profiling.py"):
        assert os.path.exists(os.path.join(REPO, "legmov_tpu", rel)), rel
        assert os.path.exists(os.path.join(PKG, rel)), rel
    import legmov_tpu
    import legmov_tpu_torch

    assert set(legmov_tpu_torch.__all__) == set(legmov_tpu.__all__)
    # and so does every subpackage
    import importlib

    for sub in ("ops", "models", "oracle", "terrain", "parallel"):
        j = importlib.import_module(f"legmov_tpu.{sub}")
        t = importlib.import_module(f"legmov_tpu_torch.{sub}")
        assert t.__all__ == j.__all__, sub
        for name in t.__all__:
            assert hasattr(t, name), (sub, name)
    # the kernels' modules are named after their route
    for j, t in (("ops/pallas_kernels.py", "ops/cuda_kernels.py"),
                 ("ops/pallas_multileg.py", "ops/cuda_multileg.py"),
                 ("ops/pallas_multileg_dist.py", "ops/cuda_multileg_dist.py"),
                 ("../tools/map_solve_bench.py", "map_bench.py"),
                 ("../tools/reach_kernel_probe.py", "reach_probe.py"),
                 # the tools and dry runs of the parallel layer, and the
                 # fuzzers (the on-chip fuzz is the solver fuzz on a card)
                 ("../__graft_entry__.py", "dryrun.py"),
                 ("../tools/multihost_dryrun.py", "multihost_dryrun.py"),
                 ("../tools/scaling_bench.py", "scaling_bench.py"),
                 ("../tools/solver_fuzz.py", "solver_fuzz.py"),
                 ("../tools/onchip_fuzz.py", "solver_fuzz.py"),
                 ("../tools/hier_fuzz.py", "hier_fuzz.py"),
                 # the viewers and the N-sweep
                 ("../tools/ref_image_check.py", "ref_image_check.py"),
                 ("../tools/live_view.py", "live_view.py"),
                 ("../tools/visualize_solve.py", "visualize_solve.py"),
                 ("../tools/circle_figure.py", "circle_figure.py"),
                 ("../tools/render_solve_cells.py", "render_solve_cells.py"),
                 ("../tools/quick_view.py", "quick_view.py"),
                 ("../tools/bench_sweep.py", "bench_sweep.py"),
                 ("../tools/bench_report.py", "bench_report.py")):
        assert os.path.exists(os.path.join(REPO, "legmov_tpu", j)), j
        assert os.path.exists(os.path.join(PKG, t)), t


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card case")
    import legmov_tpu_torch as T
    from legmov_tpu_torch import cli
    from legmov_tpu_torch.config import resolve_device

    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.reachability_batch(pts, T.get_m2_leg())
    with pytest.raises(RuntimeError, match="CUDA"):
        T.distance_batch(pts, T.get_m2_leg())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    d = str(tmp_path / "data")
    cli.main(["prepare", "--dir", d, "--pix-size", "100", "--voxel", "400"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["evaluate", "--dir", d])
    assert not os.path.exists(os.path.join(d, "out_reachability.bin"))


def test_cpu_tensor_runs_the_plain_version():
    import legmov_tpu_torch as T
    from legmov_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.uniform(-650, 650, (512, 3)).astype(np.float32))
    x, y, z = (t[:, i].contiguous() for i in range(3))
    leg = T.get_m2_leg()
    r_before = ck.reachability_kernel.launches
    d_before = ck.distance_kernel.launches
    kr, kd = ck.make_reachability_kernel(leg), ck.make_distance_kernel(leg)
    assert torch.equal(kr.soa(x, y, z),
                       ck.reachability_kernel_plain(x, y, z, kr.consts))
    ok, dx, dy, dz = kd.soa(x, y, z)
    want = ck.distance_kernel_plain(x, y, z, kd.consts)
    for g, w in zip((ok, dx, dy, dz), want):
        assert torch.equal(g, w)
    # nothing was launched or built, and the counters did not move
    assert ck.reachability_kernel.launches == r_before
    assert ck.distance_kernel.launches == d_before
    assert ck._bound is None


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card case")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert '"ok"' not in r.stdout


def test_parameter_blocks_are_packed():
    """Every member of the kernels' parameter blocks is 4 bytes wide, so the
    ctypes mirror and the C struct agree without padding; the library checks
    the sizes again when it is loaded."""
    import ctypes

    from legmov_tpu_torch.ops import cuda_kernels as ck
    from legmov_tpu_torch.ops import cuda_multileg_dist as cmd

    for cls in (ck._ReachParams, ck._DistParams, cmd._ItemParams):
        total = 0
        for _, ctype in cls._fields_:
            assert ctypes.sizeof(ctype) % 4 == 0
            total += ctypes.sizeof(ctype)
        assert ctypes.sizeof(cls) == total
        # a by-value kernel parameter
        assert ctypes.sizeof(cls) < 4096
    # the item block holds six legs, and the source has the same widths
    assert cmd.MAX_LEGS == 6 and cmd.table_width(cmd.MAX_LEGS) == 1024
    with open(os.path.join(PKG, "csrc", "cell_kernels.cu")) as f:
        src = f.read()
    for name, value in (("CK_MAX_LEGS", cmd.MAX_LEGS), ("CK_HDR", cmd._HDR),
                        ("CK_LEG_BLOCK", cmd.LEG_BLOCK),
                        ("CK_OUT_WORDS", cmd.OUT_WORDS),
                        ("CK_MAX_W", cmd.table_width(cmd.MAX_LEGS))):
        assert re.search(rf"#define {name} {value}\b", src), name


def test_cell_library_signatures_match_the_c_launchers():
    """The ctypes argument lists of ``cuda_multileg_dist.signatures`` have
    the C functions' parameters, one for one: a pointer for a pointer, a
    64-bit int for ``long long``, an int for ``int``."""
    import ctypes

    from legmov_tpu_torch.ops import cuda_multileg_dist as cmd

    with open(os.path.join(PKG, "csrc", "cell_kernels.cu")) as f:
        src = f.read()
    found = dict(re.findall(r'extern "C" int (legmov_\w+)\(([^)]*)\)', src))
    sigs = cmd.signatures()
    assert set(found) == set(sigs)
    for name, params in found.items():
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            if "*" in p:
                kinds.append("pointer")
            elif p.startswith("long long"):
                kinds.append(ctypes.c_longlong)
            else:
                assert p.startswith("int "), (name, p)
                kinds.append(ctypes.c_int)
        want = [t if t in (ctypes.c_longlong, ctypes.c_int) else "pointer"
                for t in sigs[name]]
        assert kinds == want, name


def test_build_module_is_lazy_and_keyed_by_source(tmp_path, monkeypatch):
    from legmov_tpu_torch.ops import _build

    assert os.path.exists(_build.SOURCE)
    monkeypatch.setenv("LEGMOV_TORCH_BUILD_DIR", str(tmp_path))
    p = _build.library_path()
    assert p.startswith(str(tmp_path)) and p.endswith(".so")
    names = _build.sources()
    assert set(names) == {"leg_kernels", "multileg_kernels", "cell_kernels"}
    assert names["leg_kernels"] == _build.SOURCE
    paths = {_build.library_path(n) for n in names}
    assert len(paths) == 3 and all(q.startswith(str(tmp_path)) for q in paths)
    assert _build.build_log("multileg_kernels") == ""
    assert "fmad=false" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    monkeypatch.delenv("LEGMOV_TORCH_BUILD_DIR")
    assert _build.build_dir() == os.path.join(REPO, "build")


def test_every_kernel_source_is_plain_c_and_names_what_it_replaces():
    """The sources build with nvcc alone (no PyTorch header) and each
    ``__global__`` kernel says which TPU kernel it stands for."""
    from legmov_tpu_torch.ops import _build

    kernels = {"leg_kernels": ("legmov_reach_kernel", "legmov_dist_kernel"),
               "multileg_kernels": ("legmov_multileg_kernel",
                                    "legmov_csr_window_kernel"),
               "cell_kernels": ("legmov_item_kernel",
                                "legmov_cell_quat_major_kernel",
                                "legmov_cell_shared_kernel",
                                "legmov_cell_cm_perleg_kernel")}
    for name, path in _build.sources().items():
        with open(path) as f:
            src = f.read()
        includes = re.findall(r"#include\s*[<\"]([^>\"]+)", src)
        assert includes == ["cuda_runtime.h"], (name, includes)
        assert "Replaces the Pallas kernel" in src, name
        for k in kernels[name]:
            assert re.search(r"__global__[^;{]*\b" + k + r"\b", src), k
        # one "Replaces" note per kernel
        assert src.count("Replaces the Pallas kernel") == len(kernels[name])
    # and the packaging files ship whatever lies under csrc/
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        assert 'legmov_tpu_torch = ["csrc/*.cu", "csrc/*.cpp"]' in f.read()
    with open(os.path.join(REPO, "MANIFEST.in")) as f:
        text = f.read()
    assert "recursive-include legmov_tpu_torch/csrc *.cu" in text
    assert "recursive-include legmov_tpu_torch/csrc *.cpp" in text


def test_map_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card case")
    from legmov_tpu_torch import map_bench
    from legmov_tpu_torch.ops import csr_grid, grid

    pts = np.zeros((4, 3), np.float32)
    for fn in (lambda: csr_grid.build_csr_grid(pts, 100.0),
               lambda: grid.build_grid(pts, 100.0),
               lambda: csr_grid.build_csr_grid_device(
                   np.zeros(4, np.float32), np.zeros(2, np.float32),
                   np.zeros(2, np.float32), 100.0),
               lambda: map_bench.main(["--points", "1", "--poses", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_solve_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card case")
    from legmov_tpu_torch import cli
    from legmov_tpu_torch.models.hier_solver import solve_positionability
    from legmov_tpu_torch.models.robot import get_moonbot_robot
    from legmov_tpu_torch.ops import csr_cell_eval as cce
    from legmov_tpu_torch.ops import cuda_multileg_dist as cmd

    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_positionability(pts, get_moonbot_robot())
    d = str(tmp_path / "data")
    cli.main(["prepare", "--dir", d, "--pix-size", "100", "--voxel", "400"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["solve", "--dir", d, "--box", "1000"])
    assert not os.path.exists(os.path.join(d, "robot_reach.npy"))
    with pytest.raises(SystemExit, match="--device cuda"):
        cli.main(["solve", "--dir", d, "--device", "cpu", "--backend", "cuda"])
    # nothing was built or launched on the way
    assert cmd._bound is None
    assert cmd.multileg_distance_kernel.launches == 0
    assert (cce.cell_eval_quat_major.launches, cce.cell_eval_shared.launches,
            cce.cell_eval_cm_perleg.launches) == (0, 0, 0)


def test_map_bench_runs_on_the_cpu_when_asked(capsys):
    import json

    from legmov_tpu_torch import map_bench

    map_bench.main(["--points", "65536", "--poses", "24", "--pose-chunk", "16",
                    "--legs", "4", "--device", "cpu", "--reps", "1",
                    "--device-csr"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["metric"] == "positionability_poses_per_s"
    assert line["poses_timed"] == 24 and line["terrain_points"] == 65536
    assert line["device"] == "cpu" and line["device_csr"] is True
    assert 0 < line["feasible_poses"] <= 24
    assert line["kernel_launches_per_chunk"] == 0


def test_parallel_layer_and_tools_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card case")
    from legmov_tpu_torch import (
        bench_sweep,
        circle_figure,
        dryrun,
        hier_fuzz,
        live_view,
        multihost_dryrun,
        ref_image_check,
        scaling_bench,
        solver_fuzz,
        visualize_solve,
    )
    from legmov_tpu_torch.parallel import make_mesh, multihost

    for fn in (lambda: ref_image_check.main([]),
               lambda: live_view.main([]),
               lambda: visualize_solve.main([]),
               lambda: circle_figure.main([]),
               lambda: bench_sweep.main([]),
               lambda: bench_sweep.main(["--impl", "oracle"]),
               lambda: dryrun.main(["--ranks", "2"]),
               lambda: multihost_dryrun.main([]),
               lambda: scaling_bench.main([]),
               lambda: solver_fuzz.main(["--trials", "1"]),
               lambda: hier_fuzz.main(["--trials", "1"]),
               lambda: make_mesh(),
               lambda: multihost.rank_device(),
               lambda: multihost.initialize_distributed(),
               lambda: multihost.choose_backend(),
               lambda: multihost.run_ranks(dryrun.run_cases, 2, [], 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    assert multihost.choose_backend("cpu") == "gloo"
    assert multihost.rank_device("cpu") == torch.device("cpu")


def test_spawned_ranks_import_neither_jax_nor_legmov_tpu(tmp_path):
    """Two CPU ranks run a mesh solve and the point paths with ``jax`` and
    ``legmov_tpu`` made unimportable (packages that raise, first on the
    path, which spawned processes inherit)."""
    for name in ("jax", "jaxlib", "legmov_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not for the port')\n")
    code = (
        "from legmov_tpu_torch import dryrun\n"
        "cases = [c for c in dryrun.dryrun_cases(2)\n"
        "         if c['name'] in ('reachability', 'positionable', 'solve shared')]\n"
        "res = dryrun.spawn(cases, 2, device='cpu', timeout=120)\n"
        "print('RANKS', len(res), sorted(res[1]['cases']))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=200)
    assert r.returncode == 0, r.stdout + r.stderr
    assert ("RANKS 2 ['positionable', 'reachability', 'solve shared']"
            in r.stdout)


def test_tools_write_under_build_by_default():
    """No tool of the port writes under ``bdata/`` (the JAX package's
    records) by default: every ``--out`` default lies under ``build/``."""
    pat = re.compile(r'add_argument\(\s*"--out",\s*default="([^"]*)"')
    found = {}
    for name in ("ref_image_check", "live_view", "visualize_solve",
                 "circle_figure", "render_solve_cells", "quick_view",
                 "bench_sweep", "bench_report"):
        with open(os.path.join(PKG, f"{name}.py")) as f:
            src = f.read()
        found[name] = pat.findall(src)
        assert "bdata" not in "".join(found[name]), name
    assert all(len(v) == 1 and v[0].startswith("build/")
               for v in found.values()), found

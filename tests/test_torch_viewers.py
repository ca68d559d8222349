"""PyTorch port: the viewers on the CPU, held to the JAX package's tools
(loaded by path from ``tools/``, their plotting stubbed).

* ``live_view``: frames at 64 x 48 and 16 mm a pixel, both slice axes,
  against the JAX tool's ``make_frame_fn(..., use_pallas=False)``.  The
  JAX frame is jitted, so XLA:CPU fuses its multiply-adds (ROADMAP.md §3):
  the norms are held to tests/test_distance.py:32-38's rtol 5e-4, atol
  2e-2.  A three-frame headless run.
* ``circle_figure``: the validity grid equal to the JAX tool's (its
  ``plane_validate``) bit for bit, the same circles and corners.
* ``visualize_solve``: the 3,200-pose lattice at the defaults equal to the
  JAX tool's (its solver replaced by a recorder that only keeps the poses),
  and at a 1,000 mm lattice (32 poses; the plain ``grid_reachable_legs``
  takes about 4 s for them on one CPU thread) the feasible mask equal to
  the JAX tool's; the fused solver's plain backend equal to
  ``grid_reachable_legs``, leg bit for leg bit.
* ``render_solve_cells`` and ``quick_view`` on tiny files.
"""

import importlib.util
import os
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legmov_tpu as J
from legmov_tpu_torch import circle_figure, live_view, quick_view
from legmov_tpu_torch import io as lio
from legmov_tpu_torch import render_solve_cells, visualize_solve
from legmov_tpu_torch.map_bench import terrain_at
from legmov_tpu_torch.models.leg import get_m2_leg, get_moonbot_leg
from legmov_tpu_torch.models.robot import HEX_MOUNTS, make_robot
from legmov_tpu_torch.ops import cuda_multileg
from legmov_tpu_torch.ops.grid import build_grid, cell_size_for, neighbor_offsets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGS = {"m2": (J.get_m2_leg, get_m2_leg),
        "moonbot": (J.get_moonbot_leg, get_moonbot_leg)}
W, H, SCALE = 64, 48, 16.0
POINTS = 65536
PITCH = 1000.0


def _tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_pyplot(n_axes):
    plt = mock.MagicMock()
    axes = [mock.MagicMock() for _ in range(n_axes)]
    plt.subplots.return_value = (mock.MagicMock(),
                                 axes[0] if n_axes == 1 else tuple(axes))
    return plt, axes


def _run_tool(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    mod.main()


# --------------------------------------------------------------- live_view

@pytest.fixture(scope="module")
def frames():
    tool = _tool("live_view")
    return (tool.make_frame_fn(J.get_m2_leg(), W, H, SCALE, use_pallas=False),
            live_view.make_frame_fn(get_m2_leg(), W, H, SCALE, "cpu"))


@pytest.mark.parametrize("axis_is_z", [True, False])
@pytest.mark.parametrize("cut", [0.0, 100.0, -200.0])
def test_live_view_frame_matches_the_jax_tool(frames, cut, axis_is_z):
    j_frame, t_frame = frames
    want = np.asarray(j_frame(jnp.float32(cut), jnp.bool_(axis_is_z)))
    got = t_frame(cut, axis_is_z)
    assert got.dtype == torch.float32 and tuple(got.shape) == (H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=2e-2)
    # the plain version is what a CPU frame runs
    assert torch.equal(t_frame.plain(cut, axis_is_z), got)


def test_live_view_headless_run(tmp_path, capsys):
    res = live_view.main(["--device", "cpu", "--width", str(W), "--height",
                          str(H), "--scale", str(SCALE), "--frames", "3",
                          "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["frames"] == 3 and res["fps"] > 0
    # nothing launched on the CPU
    assert res["launches"] == 0 and "K2 launches 0" in out
    assert res["device"].startswith("cpu: ")
    if importlib.util.find_spec("matplotlib") is not None:
        assert sorted(os.listdir(tmp_path)) == sorted(
            f"{t}_{m}.png" for t in ("first", "mid", "last")
            for m in ("norm", "deriv"))


def test_live_view_interactive_needs_a_display(monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="display"):
        live_view.main(["--device", "cpu", "--width", "8", "--height", "8",
                        "--interactive"])


def test_derivative_shade_is_the_tools():
    img = np.random.default_rng(5).random((H, W)).astype(np.float32)
    np.testing.assert_array_equal(live_view.derivative_shade(img),
                                  _tool("live_view").derivative_shade(img))


# ----------------------------------------------------------- circle_figure

@pytest.mark.parametrize("name", list(LEGS))
def test_circle_figure_matches_the_jax_tool(name, tmp_path, monkeypatch):
    tool = _tool("circle_figure")
    plt, (ax,) = _stub_pyplot(1)
    monkeypatch.setattr(tool, "plt", plt)
    _run_tool(tool, ["--leg", name, "--out", str(tmp_path / "c.png")],
              monkeypatch)
    data = circle_figure.figure_data(LEGS[name][1](), "cpu")
    np.testing.assert_array_equal(data["valid"], ax.imshow.call_args[0][0].T)
    assert 0 < data["valid"].mean() < 1
    plots = [c.args for c in ax.plot.call_args_list]
    centres = [(a[0], a[1]) for a in plots if a[2:] == ("k+",)]
    lines = [a for a in plots if a[2:] in (("-",), ("--",))]
    assert len(data["circles"]) == len(centres) == len(lines)
    for (cx, cy, rad, att), (tx, ty), line in zip(data["circles"], centres,
                                                  lines):
        assert (cx, cy) == (tx, ty)
        assert att == (line[2] == "-")
        np.testing.assert_allclose(rad, line[0][0] - cx, rtol=1e-9, atol=1e-9)
    (ok,) = [a for a in plots if a[2:] == ("ro",)]
    (bad,) = [a for a in plots if a[2:] == ("rx",)]
    cv = data["corner_valid"]
    np.testing.assert_array_equal(data["corners"][cv, 0], ok[0])
    np.testing.assert_array_equal(data["corners"][cv, 1], ok[1])
    np.testing.assert_array_equal(data["corners"][~cv, 0], bad[0])
    np.testing.assert_array_equal(data["corners"][~cv, 1], bad[1])


# --------------------------------------------------------- visualize_solve

def _tool_lattice(argv, monkeypatch, solve=True):
    """The JAX tool's poses and feasible mask, its ``grid_reachable_legs``
    wrapped by a recorder (with ``solve`` False the recorder returns no
    legs and only keeps the poses) and its plotting stubbed."""
    tool = _tool("visualize_solve")
    plt, _ = _stub_pyplot(2)
    monkeypatch.setattr(tool, "plt", plt)
    rec = []
    real = tool.grid_reachable_legs

    def recorder(bp, quats, grid, robot, k, offsets):
        if solve:
            legs, quorum = real(bp, quats, grid, robot, k=k, offsets=offsets)
        else:
            quorum = jnp.zeros(bp.shape[0], bool)
            legs = None
        rec.append((np.asarray(bp), np.asarray(quorum)))
        return legs, quorum

    monkeypatch.setattr(tool, "grid_reachable_legs", recorder)
    _run_tool(tool, argv, monkeypatch)
    body = np.concatenate([r[0] for r in rec])
    quorum = np.concatenate([r[1] for r in rec])
    live = body[:, 0] < 1e8  # the tool pads each chunk with 1e9 poses
    return body[live], quorum[live]


def test_visualize_solve_lattice_at_the_defaults_is_the_tools(tmp_path,
                                                               monkeypatch):
    want, _ = _tool_lattice(["--points", str(POINTS), "--out",
                             str(tmp_path / "j.png")], monkeypatch,
                            solve=False)
    _, _, _, body = visualize_solve.body_lattice(terrain_at(POINTS), 100.0,
                                                 180.0)
    assert body.shape == (3200, 3)
    np.testing.assert_array_equal(body, want)


@pytest.fixture(scope="module")
def port_map(tmp_path_factory):
    out = tmp_path_factory.mktemp("vs") / "map.png"
    return visualize_solve.main(["--device", "cpu", "--points", str(POINTS),
                                 "--grid-pitch", str(PITCH), "--chunk", "16",
                                 "--out", str(out)])


def test_visualize_solve_mask_is_the_tools(port_map, tmp_path, monkeypatch):
    body, quorum = _tool_lattice(
        ["--points", str(POINTS), "--grid-pitch", str(PITCH), "--chunk", "64",
         "--out", str(tmp_path / "j.png")], monkeypatch)
    assert body.shape == (32, 3)
    np.testing.assert_array_equal(port_map["body"], body)
    np.testing.assert_array_equal(port_map["feasible"], quorum)
    assert 0 < quorum.sum() < quorum.size
    assert port_map["legs"].shape == (32, 6)


def test_fused_plain_backend_equals_grid_reachable_legs(port_map):
    robot = make_robot(HEX_MOUNTS)
    reach = cell_size_for(robot)
    grid = build_grid(terrain_at(POINTS), reach / 2, device="cpu")
    offsets = torch.from_numpy(neighbor_offsets(reach / 2, reach).astype(
        np.int64))
    comps, cap = cuda_multileg.pad_grid_soa(grid)
    fn = cuda_multileg.make_fused_grid_solver(robot, cap, backend="torch")
    body = torch.from_numpy(port_map["body"])
    quats = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(body.shape[0], 4)
    legs, quorum, overflow = fn(body, quats, *comps, grid.counts, grid.origin,
                                grid.cell_size, offsets,
                                top_k=int(offsets.shape[0]), k=6,
                                dims=grid.dims)
    assert not bool(overflow.any())
    np.testing.assert_array_equal(legs.numpy(), port_map["legs"])
    np.testing.assert_array_equal(quorum.numpy(), port_map["feasible"])


# ------------------------------------------------ render_solve_cells, quick_view

def test_render_solve_cells_draws_a_tiny_solve(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(3)
    lio.save_points(rng.uniform(-500, 500, (200, 3)).astype(np.float32),
                    str(tmp_path / "numpy_input_t"))
    lio.save_points(rng.uniform(-500, 500, (7, 3)).astype(np.float32),
                    str(tmp_path / "out_valid_cells_"))
    out = tmp_path / "cells.png"
    assert render_solve_cells.main(["--dir", str(tmp_path), "--out",
                                    str(out)]) == 7
    assert out.exists() and "(7 valid cells)" in capsys.readouterr().out


def test_quick_view_draws_a_dump(tmp_path):
    pytest.importorskip("matplotlib")
    path = tmp_path / "out_reachability.bin"
    (np.arange(6 * 5) % 2).astype(np.uint8).tofile(path)
    out = tmp_path / "q.png"
    img = quick_view.main([str(path), "--shape", "6", "5", "--dtype",
                           "uint8", "--out", str(out)])
    assert img.shape == (6, 5) and out.exists()
    with pytest.raises(ValueError, match="fewer"):
        quick_view.main([str(path), "--shape", "7", "5", "--dtype", "uint8",
                         "--out", str(out)])


@pytest.mark.parametrize("tool", [render_solve_cells, quick_view])
def test_drawing_tools_say_when_matplotlib_is_missing(tool, tmp_path,
                                                      monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = (["--dir", str(tmp_path)] if tool is render_solve_cells
            else [str(tmp_path / "x.bin"), "--shape", "2", "2"])
    with pytest.raises(RuntimeError, match="matplotlib"):
        tool.main(argv + ["--out", str(tmp_path / "x.png")])

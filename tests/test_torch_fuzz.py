"""PyTorch port: the two solver fuzzers (``python -m
legmov_tpu_torch.solver_fuzz``, ``python -m legmov_tpu_torch.hier_fuzz``).

On the CPU they run the kernels' plain versions (two trials each, the
solver fuzzer's terrains cut to their first 1,500 footholds after the draw).
Their draws are the JAX package's tools' draws for the same seed, held here
by running ``tools/solver_fuzz.py`` and ``tools/hier_fuzz.py`` (loaded by
path) with their solvers replaced by recorders.  A planted fault (one leg or
flag bit flipped, passed in through the fuzz loop's arguments) must make the
fuzzer print FAIL with the seed and exit 1.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from legmov_tpu_torch import hier_fuzz, solver_fuzz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(5)


def _tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_solver_fuzz_runs_on_the_cpu(capsys):
    assert solver_fuzz.main(["--device", "cpu", "--trials", "2",
                             "--max-footholds", "1500"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line[:11] for line in out[:2]] == ["OK  seed=0 ", "OK  seed=1 "]
    for name in ("csr", "dma", "quorum_mode", "fused", "adaptive"):
        assert f"{name}=True" in out[0]
    assert out[-1] == "2/2 trials exact"


def test_hier_fuzz_runs_on_the_cpu(capsys):
    assert hier_fuzz.main(["--device", "cpu", "--trials", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line[:11] for line in out[:2]] == ["OK  seed=0 ", "OK  seed=1 "]
    assert out[-1] == "2/2 trials exact"


def test_a_flipped_leg_bit_fails_the_solver_fuzz(capsys):
    def flip(name, solver):
        if name != "dma":
            return solver

        def flipped(*a, **kw):
            legs, quorum, over = solver(*a, **kw)
            legs = legs.clone()
            legs[0, 0] = ~legs[0, 0]
            return legs, quorum, over
        return flipped

    assert solver_fuzz.main(["--device", "cpu", "--trials", "1", "--seed",
                             "0", "--max-footholds", "1500"], wrap=flip) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("FAIL seed=0 ") and "dma=False" in out[0]
    assert "csr=True" in out[0] and out[-1] == "0/1 trials exact"


def test_a_flipped_flag_fails_the_hier_fuzz(capsys):
    def solve(*a, backend, **kw):
        rec = hier_fuzz.solve_positionability(*a, backend=backend, **kw)
        if backend == "auto":
            rec.valid[0] = ~rec.valid[0]
        return rec

    assert hier_fuzz.main(["--device", "cpu", "--trials", "1", "--seed",
                           "2"], solve=solve) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("FAIL seed=2 ") and out[-1] == "0/1 trials exact"


def _record_solver_fuzz(seeds, monkeypatch):
    """The JAX tool's draws, trial by trial: its main() with every solver
    and grid build replaced by recorders."""
    tool = _tool("solver_fuzz")
    trials = []

    def make_robot(mounts, leg_fn):
        trials.append(dict(mounts=tuple(mounts), leg=leg_fn.__name__))
        return types.SimpleNamespace(body=np.zeros(len(mounts)))

    def topk(body, quats, g, robot, offs, top_k, k):
        trials[-1].update(k=k, body=np.asarray(body), rpy=quats)
        P, L = body.shape[0], len(trials[-1]["mounts"])
        return np.zeros((P, L), bool), np.zeros(P, bool), None

    def build_grid(fh, cell):
        trials[-1].update(footholds=np.asarray(fh), cell=cell)
        return types.SimpleNamespace(counts=0, origin=0, cell_size=cell,
                                     dims=(1, 1, 1))

    def solver_factory(kind):
        def make(robot, window, interpret, rounds, super_step=None,
                 decide="legs"):
            trials[-1].update({f"{kind}_window": window,
                               f"{kind}_rounds": rounds})
            if super_step is not None:
                trials[-1]["super_step"] = super_step

            def solve(body, *a, **kw):
                L = len(trials[-1]["mounts"])
                return (np.zeros((body.shape[0], L), bool),
                        np.zeros(body.shape[0], bool), np.asarray(False))
            return solve
        return make

    monkeypatch.setattr(tool, "make_robot", make_robot)
    monkeypatch.setattr(tool, "cell_size_for", lambda robot: 600.0)
    monkeypatch.setattr(tool, "grid_reachable_legs_topk", topk)
    monkeypatch.setattr(tool, "build_grid", build_grid)
    monkeypatch.setattr(tool, "build_csr_grid", lambda fh, cell: (
        types.SimpleNamespace(xs=0, ys=0, zs=0, starts=0, origin=0,
                              cell_size=cell, dims=(1, 1, 1))))
    monkeypatch.setattr(tool, "pad_grid_soa", lambda g: ((0, 0, 0), 1 << 30))
    monkeypatch.setattr(tool, "make_csr_solver", solver_factory("csr"))
    monkeypatch.setattr(tool, "make_csr_dma_solver", solver_factory("dma"))
    monkeypatch.setattr(tool, "quat", types.SimpleNamespace(
        from_rpy=lambda r, p, y: np.stack([r, p, y], -1)))
    monkeypatch.setattr(sys, "argv", ["solver_fuzz.py", "--trials",
                                      str(len(seeds)), "--seed",
                                      str(seeds[0])])
    with pytest.raises(SystemExit) as done:
        tool.main()
    assert done.value.code == 0
    return trials


def _record_hier_fuzz(seeds, monkeypatch):
    tool = _tool("hier_fuzz")
    trials = []

    def make_robot(mounts, leg_fn):
        trials.append(dict(mounts=tuple(mounts), leg=leg_fn.__name__))
        return None

    def solve(fh, robot, cfg, **kw):
        trials[-1].update(footholds=fh, cfg=cfg, shared=kw["shared_foothold"])
        return types.SimpleNamespace(centers=np.zeros((1, 3)),
                                     valid=np.zeros(1, bool),
                                     edge=np.zeros(1, bool))

    monkeypatch.setattr(tool, "make_robot", make_robot)
    monkeypatch.setattr(tool, "solve_positionability", solve)
    monkeypatch.setattr(sys, "argv", ["hier_fuzz.py", "--trials",
                                      str(len(seeds)), "--seed",
                                      str(seeds[0])])
    with pytest.raises(SystemExit) as done:
        tool.main()
    assert done.value.code == 0
    # each trial solves twice (two backends)
    return trials


@pytest.fixture(scope="module")
def jax_draws():
    with pytest.MonkeyPatch.context() as mp:
        return (_record_solver_fuzz(list(SEEDS), mp),
                _record_hier_fuzz(list(SEEDS), mp))


@pytest.mark.parametrize("seed", SEEDS)
def test_solver_fuzz_draws_equal_the_jax_tools(jax_draws, seed):
    want = jax_draws[0][seed - SEEDS[0]]
    got = solver_fuzz.draw_trial(seed)
    np.testing.assert_allclose(got["mounts"], want["mounts"], rtol=0,
                               atol=1e-12)
    assert f"get_{got['leg']}_leg" == want["leg"]
    assert got["k"] == want["k"]
    assert got["subdiv"] == round(600.0 / want["cell"])
    for key in ("footholds", "body", "rpy"):
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key])
    assert got["window"] == want["csr_window"] == want["dma_window"]
    assert got["rounds"] == want["csr_rounds"] == want["dma_rounds"]
    assert got["super_step"] == want["super_step"]
    assert got["poses"] == want["body"].shape[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_hier_fuzz_draws_equal_the_jax_tools(jax_draws, seed):
    want = jax_draws[1][seed - SEEDS[0]]
    got = hier_fuzz.draw_trial(seed)
    np.testing.assert_allclose(got["mounts"], want["mounts"], rtol=0,
                               atol=1e-12)
    assert f"get_{got['leg']}_leg" == want["leg"]
    np.testing.assert_array_equal(got["footholds"], want["footholds"])
    assert got["footholds"].dtype == want["footholds"].dtype
    assert got["shared"] == want["shared"]
    for field in ("box_center", "box_size", "min_box", "max_depth",
                  "legs_for_stability", "enable_rot_below", "angle_samples"):
        assert getattr(got["cfg"], field) == getattr(want["cfg"], field), \
            field

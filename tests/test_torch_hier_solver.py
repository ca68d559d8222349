"""PyTorch port: the hierarchical (octree-rule) solve against the JAX package.

``solve_positionability(device="cpu")`` runs the fused evaluators' plain
versions (``backend="auto"``) or the eager evaluator (``backend="torch"``);
the JAX solver runs its XLA evaluators (``use_pallas="off"``).

Tolerances.  Host helpers (``_split_children``, ``_morton_order``,
``_total_reach``, ``orientation_samples``): equal.  Terminal cells: the
``CellRecord``s equal as sets of rows (centre, half-extent, valid, edge,
depth): cell order carries no meaning.
Cell flags of single levels: ``assert_array_equal``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from legmov_tpu.config import SolverConfig as JConfig
from legmov_tpu.models import hier_solver as jhs
from legmov_tpu.models import robot as jrobot
from legmov_tpu_torch.config import SolverConfig as TConfig
from legmov_tpu_torch.models import hier_solver as ths
from legmov_tpu_torch.models import robot as trobot

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)


def ring_footholds(radius=330.0, n=24, z=-120.0):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack(
        [radius * np.cos(ang), radius * np.sin(ang), np.full(n, z)], -1
    ).astype(np.float32)


SMALL = dict(box_center=(0.0, 0.0, 0.0), box_size=(800.0, 800.0, 400.0),
             min_box=(50.0, 50.0, 50.0), max_depth=2, legs_for_stability=1)
# the deepest level (parents of half-extent 200) samples three rolls, the
# identity first
ROT = dict(box_center=(0.0, 0.0, 0.0), box_size=(800.0, 800.0, 400.0),
           min_box=(100.0, 100.0, 100.0), max_depth=2, legs_for_stability=2,
           enable_rot_below=250.0, angle_samples=(3, 1, 1),
           angle_min_max=((-0.7, 0.7), (0.0, 0.0), (0.0, 0.0)))
# one sample per axis sits at the range's lower end: sample 0 is no identity
TILTED = dict(ROT, angle_samples=(2, 1, 1),
              angle_min_max=TConfig().angle_min_max)


def _rows(rec):
    table = np.concatenate(
        [rec.centers, rec.halves, rec.valid[:, None], rec.edge[:, None],
         rec.depth[:, None]], axis=1)
    return set(map(tuple, table.tolist()))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_host_helpers_equal_jax():
    rng = np.random.default_rng(1)
    for cfg in (SMALL, ROT, {}):
        got = ths.orientation_samples(TConfig(**cfg))
        want = jhs.orientation_samples(JConfig(**cfg))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0], [1, 0, 0, 0])
    tilted = ths.orientation_samples(TConfig(**TILTED))
    np.testing.assert_array_equal(
        tilted, jhs.orientation_samples(JConfig(**TILTED)))
    assert tilted.shape == (2, 4) and tilted[0, 0] < 1
    centers = rng.uniform(-900, 900, (37, 3)).astype(np.float32)
    for half, min_box in (([400, 400, 200], [50, 50, 50]),
                          ([40, 40, 20], [30, 30, 30]),
                          ([20, 20, 20], [30, 30, 30])):
        half = np.asarray(half, np.float32)
        min_box = np.asarray(min_box, np.float32)
        ch_t, hh_t = ths._split_children(centers, half, min_box)
        ch_j, hh_j = jhs._split_children(centers, half, min_box)
        np.testing.assert_array_equal(ch_t, ch_j)
        np.testing.assert_array_equal(hh_t, hh_j)
        np.testing.assert_array_equal(ths._morton_order(ch_t, hh_t),
                                      jhs._morton_order(ch_j, hh_j))
    for jr, tr in ((jrobot.get_moonbot_robot(), trobot.get_moonbot_robot()),
                   (jrobot.get_m2_robot(), trobot.get_m2_robot())):
        assert ths._total_reach(tr) == jhs._total_reach(jr)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_leg"])
@pytest.mark.parametrize("cfg", [SMALL, ROT], ids=["identity", "rot"])
def test_solve_equals_jax_solver(cfg, shared):
    """Terminal cells and flags, for every way the port evaluates a level."""
    fh = ring_footholds()
    want = jhs.solve_positionability(
        fh, jrobot.get_moonbot_robot(), JConfig(**cfg), chunk=32,
        cell_batch=64, shared_foothold=shared, use_pallas="off")
    robot = trobot.get_moonbot_robot()
    rows = _rows(want)
    assert want.valid.any() and len(rows) == want.centers.shape[0]
    kinds = set()
    for backend, candidates in (("auto", "auto"), ("auto", "dense"),
                                ("torch", "auto"), ("torch", "csr")):
        stats = {}
        got = ths.solve_positionability(
            fh, robot, TConfig(**cfg), chunk=32, cell_batch=64,
            shared_foothold=shared, device="cpu", backend=backend,
            candidates=candidates, csr_window=128, csr_cell_chunk=96,
            stats=stats)
        assert _rows(got) == rows, (backend, candidates)
        assert got.centers.dtype == np.float32 and got.valid.dtype == bool
        # one read of the device per level
        assert stats["host_syncs"] == stats["levels"] == got.depth.max() + 1
        kinds |= {(lv["rot"], lv["kind"]) for lv in stats["per_level"]}
    if cfg is ROT:
        assert (True, "csr") in kinds and (True, "dense") in kinds
        assert want.depth.max() == 2
    else:
        assert kinds == {(False, "dense")}


@pytest.mark.parametrize("shared", [True, False])
def test_first_sample_other_than_identity(shared):
    """Levels without orientation sampling evaluate sample 0, whatever it
    is: the fused evaluators agree with the eager one (which is what the JAX
    solver computes, see the hexapod case below)."""
    fh = ring_footholds()
    robot = trobot.get_moonbot_robot()
    kw = dict(chunk=32, cell_batch=64, shared_foothold=shared, device="cpu",
              csr_window=128)
    eager = ths.solve_positionability(fh, robot, TConfig(**TILTED),
                                      backend="torch", **kw)
    for candidates in ("csr", "dense"):
        fused = ths.solve_positionability(fh, robot, TConfig(**TILTED),
                                          candidates=candidates, **kw)
        assert _rows(fused) == _rows(eager)
    assert eager.valid.any() and eager.depth.max() == 2


def test_environment_switches_keep_the_flags(monkeypatch, capsys):
    fh = ring_footholds()
    robot = trobot.get_moonbot_robot()
    kw = dict(chunk=32, cell_batch=64, shared_foothold=True, device="cpu",
              csr_window=128)
    base = ths.solve_positionability(fh, robot, TConfig(**ROT), **kw)
    for name, value in (("LEGMOV_CSR_QUAT_MAJOR", "1"),
                        ("LEGMOV_CSR_CHUNK_MASKS", "0"),
                        ("LEGMOV_HIER_CS_FRAC", "0.5")):
        monkeypatch.setenv(name, value)
        got = ths.solve_positionability(fh, robot, TConfig(**ROT), **kw)
        monkeypatch.delenv(name)
        assert _rows(got) == _rows(base), name
    assert capsys.readouterr().out == ""
    # the per-level breakdown and the work counters are profile=True's
    got = ths.solve_positionability(fh, robot, TConfig(**ROT), profile=True,
                                    **kw)
    assert _rows(got) == _rows(base)
    out = capsys.readouterr().out
    assert "[hier-audit] depth=2" in out and "leg_elems_in_box=" in out
    assert "[hier] depth=2" in out and "host synchronisations" in out
    assert "level.fetch=" in out and "batch.queue=" in out


@pytest.mark.parametrize("shared", [True, False])
def test_fast_cell_eval_equals_eval_cells_on_an_identity_level(shared):
    rng = np.random.default_rng(6)
    robot = trobot.get_moonbot_robot()
    fh = np.concatenate([ring_footholds(), ring_footholds(radius=420.0, n=17)])
    centers = rng.uniform(-500, 500, (40, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-50, 250, 40)
    pv = rng.random(40) < 0.2
    half = np.asarray([100.0, 100.0, 50.0], np.float32)
    quats = _t(ths.orientation_samples(TConfig()))
    args = (_t(centers), _t(pv), half, 2 * half, _t(fh), quats, robot)
    for k, margin in ((1, 50.0 / 3.0), (3, 0.0)):
        kw = dict(k=k, margin=margin, reach=ths._total_reach(robot), chunk=16,
                  shared=shared)
        want = ths._eval_cells(*args, use_rot=False, **kw)
        got = ths.make_fast_cell_eval(robot)(*args, use_rot=False, **kw)
        for g, w, name in zip(got, want, ("valid", "edge", "leaf")):
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
        assert want[0].any() and want[1].any()
    # and the JAX evaluator, on the same level
    jwant = jhs._eval_cells(
        jnp.asarray(centers), jnp.asarray(pv), jnp.asarray(half),
        jnp.asarray(2 * half), jnp.asarray(fh[:32]),
        jnp.asarray(quats.numpy()), jrobot.get_moonbot_robot(), k=3,
        margin=0.0, reach=ths._total_reach(robot), chunk=16, use_rot=False,
        shared=shared)
    got = ths.make_fast_cell_eval(robot)(
        _t(centers), _t(pv), half, 2 * half, _t(fh[:32]), quats, robot, k=3,
        margin=0.0, reach=ths._total_reach(robot), chunk=16, shared=shared)
    for g, w in zip(got, jwant):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_empty_terrain_and_bad_arguments():
    robot = trobot.get_moonbot_robot()
    fh = np.zeros((0, 3), np.float32)
    for backend in ("auto", "torch"):
        for shared in (True, False):
            res = ths.solve_positionability(
                fh, robot, TConfig(**SMALL), chunk=32, cell_batch=64,
                shared_foothold=shared, device="cpu", backend=backend)
            assert not res.valid.any() and not res.edge.any()
            assert res.centers.shape == (8, 3) and (res.depth == 0).all()
    with pytest.raises(ValueError):
        ths.solve_positionability(fh, robot, device="cpu", backend="pallas")
    with pytest.raises(ValueError):
        ths.solve_positionability(fh, robot, device="cpu", candidates="all")
    with pytest.raises(ValueError):
        ths.solve_positionability(fh, robot, device="cpu", backend="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ths.solve_positionability(fh, robot)


def test_hexapod_shared_four_of_six_equals_jax_solver():
    """4 of 6 legs on one foothold, orientation-active from the root."""
    fh = np.concatenate([ring_footholds(), ring_footholds(radius=150.0, n=9)])
    cfg = dict(box_center=(0.0, 0.0, 0.0), box_size=(400.0, 400.0, 200.0),
               min_box=(100.0, 100.0, 100.0), max_depth=1,
               legs_for_stability=4, enable_rot_below=1000.0,
               angle_samples=(1, 2, 1))
    want = jhs.solve_positionability(
        fh, jrobot.get_moonbot_robot(jrobot.HEX_MOUNTS), JConfig(**cfg),
        chunk=32, cell_batch=64, shared_foothold=True, use_pallas="off")
    robot = trobot.get_moonbot_robot(trobot.HEX_MOUNTS)
    for candidates in ("csr", "dense"):
        got = ths.solve_positionability(
            fh, robot, TConfig(**cfg), chunk=32, cell_batch=64,
            shared_foothold=True, device="cpu", candidates=candidates,
            csr_window=64)
        assert _rows(got) == _rows(want), candidates
    assert want.edge.any() and want.depth.max() == 1

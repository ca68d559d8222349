"""PyTorch port: the rank-mesh layer (legmov_tpu_torch/parallel/) on four
CPU ranks over gloo, against the unsharded port and the JAX package.

One module-scoped run spawns four ranks (a ``(2, 2)`` mesh: poses over two,
footholds over two) that meet through a file store in a temporary directory
and compute every case of ``tests/test_sharding.py`` (same shapes and seeds)
with the port's sharded functions and the unsharded calls, plus ragged
splits (13 rows over four ranks), one level of cells through each cell
evaluator, and ``solve_positionability(mesh=...)`` on that test's footholds
and configuration (with three orientation samples, the identity first, so
that the JAX solver compiles in seconds) under both rules.  The tests below assert on the parts.

Tolerances.  Sharded against unsharded: bit for bit, on every rank.
Reachability, positionable and grid positionable against the JAX package's
``reachability_batch``, ``positionable_batch`` and ``grid_reachable_legs``:
equal.  Distance against the JAX package: the contract of
``tests/test_distance.py`` (``ok`` equal, norms within rtol 5e-4 / atol
2e-2, at least 99.5 % of vectors within 2e-2 + 2e-4 |v|: fp32 ties between
equidistant boundary candidates may flip).  The mesh solve against the JAX
solver (``use_pallas="off"``): equal as sets of rows.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from legmov_tpu import get_m2_leg as j_m2_leg
from legmov_tpu.config import SolverConfig as JConfig
from legmov_tpu.models import hier_solver as jhs
from legmov_tpu.models import robot as jrobot
from legmov_tpu.ops import quaternion as jquat
from legmov_tpu.ops.distance import distance_batch as j_distance
from legmov_tpu.ops.grid import build_grid as j_build_grid
from legmov_tpu.ops.grid import grid_reachable_legs as j_grid_legs
from legmov_tpu.ops.grid import neighbor_offsets as j_offsets
from legmov_tpu.ops.positionability import positionable_batch as j_positionable
from legmov_tpu.ops.reachability import reachability_batch as j_reach
from legmov_tpu.terrain import flat_grid
from legmov_tpu_torch import dryrun
from legmov_tpu_torch.models import robot as trobot
from legmov_tpu_torch.parallel import make_mesh
from legmov_tpu_torch.parallel.multihost import (
    gather_to_host,
    global_pose_batch,
)
from legmov_tpu_torch.parallel.sharding import split_counts, stage_for_mesh

# many small eager operations: more threads only contend with the other
# test workers of a parallel run (each rank takes one thread too)
torch.set_num_threads(1)

RANKS = 4


def _quats(rng, n, lim):
    rpy = rng.uniform(-lim, lim, (n, 3)).astype(np.float32)
    return np.asarray(jquat.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]),
                      np.float32)


def _cases():
    """The cases of tests/test_sharding.py (same seeds and shapes), ragged
    splits, a level of cells per evaluator, and the mesh solves."""
    out = []
    rng = np.random.default_rng(7)
    pts = rng.uniform(-400, 400, (1024, 3)).astype(np.float32)
    out.append(dict(name="reachability", kind="reachability", points=pts,
                    leg="m2"))
    rng = np.random.default_rng(8)
    pts = rng.uniform(-400, 400, (1024, 3)).astype(np.float32)
    out.append(dict(name="distance", kind="distance", points=pts, leg="m2"))

    rng = np.random.default_rng(9)
    body = rng.uniform(-150, 150, (16, 3)).astype(np.float32)
    quats = _quats(rng, 16, 0.3)
    fh = rng.uniform(-450, 450, (128, 3)).astype(np.float32)
    out.append(dict(name="positionable", kind="positionable", body=body,
                    quats=quats, footholds=fh, robot=trobot.get_m2_robot(),
                    k=3))
    # 13 poses over the two pose shards (7 + 6), 5 footholds over the two
    # foothold shards (3 + 2)
    out.append(dict(name="positionable ragged", kind="positionable",
                    body=body[:13], quats=quats[:13], footholds=fh[:5],
                    robot=trobot.get_m2_robot(), k=1))
    out.append(dict(name="reachability ragged", kind="reachability",
                    points=pts[:13], leg="m2"))

    rng = np.random.default_rng(12)
    body = (rng.uniform(-1000, 1000, (64, 3)) * [1, 1, 0.1]).astype(
        np.float32)
    fh = flat_grid((-1500, 1501), (-1500, 1501), 90.0, z=-130.0)
    out.append(dict(name="grid positionable", kind="grid_positionable",
                    body=body, quats=_quats(rng, 64, 0.2),
                    footholds=np.asarray(fh, np.float32),
                    robot=trobot.get_moonbot_robot(), k=3))

    for name, seed, pitch, solver, extra in (
            ("csr", 12, 90.0, "csr", {}),
            ("csr-dma", 13, 120.0, "csr-dma",
             dict(rounds=((2, 1.0), (0, 0.25))))):
        rng = np.random.default_rng(seed)
        fh = flat_grid((-1200, 1201), (-1200, 1201), pitch, z=-130.0)
        body = (rng.uniform(-300, 300, (64, 3)) * [1, 1, 0.3]).astype(
            np.float32)
        case = dict(name=name, kind="csr_positionable", body=body,
                    quats=_quats(rng, 64, 0.2),
                    footholds=np.asarray(fh, np.float32),
                    robot=trobot.get_m2_robot(), k=3, solver=solver,
                    window=256, **extra)
        out.append(case)
    out.append(dict(case, name="csr-dma ragged", body=case["body"][:13],
                    quats=case["quats"][:13]))

    rng = np.random.default_rng(21)
    fh = rng.uniform(-700, 700, (600, 3)).astype(np.float32)
    fh[:, 2] = rng.uniform(-180, -100, 600)
    cells = rng.uniform(-250, 250, (37, 3)).astype(np.float32)
    cells[:, 2] = rng.uniform(-40, 40, 37)
    for ev in ("eager", "fast", "rot", "csr"):
        out.append(dict(name=f"cells {ev}", kind="cells", evaluator=ev,
                        centers=cells, parent_valid=rng.random(37) < 0.25,
                        half=(37.5, 37.5, 37.5), parent_half=(75.0,) * 3,
                        footholds=fh, robot=trobot.get_moonbot_robot(), k=2,
                        shared=ev != "rot", angle_samples=(3, 1, 1)))
    for shared in (True, False):
        out.append(dict(
            name=f"solve {'shared' if shared else 'per-leg'}", kind="solve",
            footholds=fh, robot=trobot.get_moonbot_robot(), cfg=SOLVE_CFG,
            kw=dict(chunk=128, cell_batch=64, shared_foothold=shared,
                    candidates="csr", csr_window=128, csr_cell_chunk=64)))
    return out


SOLVE_CFG = dict(box_center=(0.0, 0.0, 0.0), box_size=(600.0, 600.0, 150.0),
                 min_box=(80.0, 80.0, 80.0), max_depth=1,
                 legs_for_stability=2, enable_rot_below=200.0,
                 angle_samples=(3, 1, 1))
CASES = _cases()
NAMES = [c["name"] for c in CASES]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def ranks():
    return dryrun.spawn(CASES, RANKS, device="cpu", points_axis=2,
                        strict=False, timeout=300)


def test_make_mesh_shape_and_counts(ranks):
    assert [tuple(r["shape"]) for r in ranks] == [(2, 2)] * RANKS
    assert [tuple(r["coords"]) for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    one = make_mesh(devices="cpu")  # no process group: a world of one
    assert one.shape == (1, 1) and one.size == 1 and one.groups == {}
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(points_axis=2, devices="cpu")
    with pytest.raises(ValueError, match="spans every rank"):
        make_mesh(n_devices=4, devices="cpu")
    # a world of one stages whole arrays and calls straight through
    to_sharded, to_repl = stage_for_mesh(one)
    a = np.arange(12, dtype=np.int32).reshape(4, 3)
    for stage in (to_sharded, to_repl):
        got = stage(a)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), a)
    np.testing.assert_array_equal(gather_to_host(torch.from_numpy(a), one), a)
    shard = global_pose_batch(a, one)
    assert shard.offset == 0 and shard.counts == (4,) and shard.total == 4
    assert split_counts(13, 4) == [4, 4, 4, 1]
    assert split_counts(2, 4) == [1, 1, 0, 0]
    assert split_counts(0, 3) == [0, 0, 0]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_equals_unsharded_on_every_rank(ranks, name):
    first = None
    for r in ranks:
        case = r["cases"][name]
        got, want = case["values"]
        assert case["equal"], (r["rank"], name)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        first = got if first is None else first
        for a, b in zip(got, first):  # every rank holds the whole result
            np.testing.assert_array_equal(a, b)
    if BY_NAME[name]["kind"] != "solve":
        # one gather or OR at a time: never more than two collectives
        assert 1 <= ranks[0]["cases"][name]["collectives"] <= 3


@pytest.mark.parametrize("name", ["reachability", "reachability ragged",
                                  "positionable", "positionable ragged",
                                  "grid positionable"])
def test_equal_to_the_jax_package(ranks, name):
    c = BY_NAME[name]
    got = ranks[0]["cases"][name]["values"][0][0]
    if c["kind"] == "reachability":
        want = j_reach(jnp.asarray(c["points"]), j_m2_leg())
    elif c["kind"] == "positionable":
        want = j_positionable(jnp.asarray(c["body"]), jnp.asarray(c["quats"]),
                              jnp.asarray(c["footholds"]),
                              jrobot.get_m2_robot(), k=c["k"])
    else:
        robot = jrobot.get_moonbot_robot()
        reach = float(np.max(np.asarray(robot.body) + robot.coxa_length
                             + robot.femur_length + robot.tibia_length))
        g = j_build_grid(c["footholds"], reach / 2)
        _, want = j_grid_legs(jnp.asarray(c["body"]), jnp.asarray(c["quats"]),
                              g, robot, k=3,
                              offsets=jnp.asarray(j_offsets(reach / 2, reach)))
    assert got.dtype == bool
    np.testing.assert_array_equal(got, np.asarray(want))


def test_distance_meets_the_jax_contract(ranks):
    c = BY_NAME["distance"]
    ok, vec = ranks[0]["cases"]["distance"]["values"][0]
    ok_j, vec_j = (np.asarray(a) for a in j_distance(jnp.asarray(c["points"]),
                                                     j_m2_leg()))
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_allclose(np.linalg.norm(vec, axis=-1),
                               np.linalg.norm(vec_j, axis=-1),
                               rtol=5e-4, atol=2e-2)
    comp = np.all(np.abs(vec - vec_j) <= 2e-2 + 2e-4 * np.abs(vec_j), axis=-1)
    assert comp.mean() > 0.995, f"{(~comp).sum()} vector mismatches"


def test_mesh_solve_keeps_one_fetch_and_one_gather_a_level(ranks):
    for name in NAMES:
        if BY_NAME[name]["kind"] != "solve":
            continue
        infos = [r["cases"][name]["info"] for r in ranks]
        for info in infos:
            assert info["host_syncs"] == info["levels"] == 2, name
            assert info["collectives"] == info["levels"], name
        assert len({(i["cells"], i["valid"], i["edge"]) for i in infos}) == 1
        assert infos[0]["valid"] > 0, name


def test_mesh_solve_equals_the_jax_solver(ranks):
    c = BY_NAME["solve shared"]
    want = jhs.solve_positionability(
        c["footholds"], jrobot.get_moonbot_robot(), JConfig(**c["cfg"]),
        chunk=128, cell_batch=64, shared_foothold=True, use_pallas="off")
    got = ranks[0]["cases"]["solve shared"]["values"][0]

    def rows(centers, halves, valid, edge, depth):
        t = np.concatenate([centers, halves, valid[:, None], edge[:, None],
                            depth[:, None]], axis=1)
        return set(map(tuple, t.tolist()))

    assert rows(*got) == rows(want.centers, want.halves, want.valid,
                              want.edge, want.depth)
    assert len(rows(*got)) == got[0].shape[0]

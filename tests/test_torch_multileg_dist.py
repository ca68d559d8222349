"""PyTorch port: the fused multi-leg distance item (tables, plain version of
the item kernel, the dense orientation-active cell evaluator) against the JAX
package.

On the CPU the wrappers run the kernels' plain versions (that is what a CPU
tensor gets); the CUDA kernel itself is held against the same plain version
on the card by ``chip_smoke.py``.

Tolerances.  Layout constants and leg constants: equal.  ``leg_blocks`` /
``oriented_dist_tables``: bit-equal to the port's own ``build_workspace`` of
the oriented leg and to the JAX tables (both sides take the JAX package's
float32 trig: glibc's, through ops/trig32.py on the port's side).
Booleans out of the plain item kernel:
``assert_array_equal``, fed the JAX tables through ``dist_tables_from_numpy``
so that both sides evaluate the same bits.  Cell flags of
``make_cell_eval_rot`` against JAX ``_eval_cells``: ``assert_array_equal``.
"""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from legmov_tpu.models import hier_solver as jhs
from legmov_tpu.models import robot as jrobot
from legmov_tpu.ops import pallas_multileg_dist as jd
from legmov_tpu.ops import quaternion as jq
from legmov_tpu_torch.models import robot as trobot
from legmov_tpu_torch.models.workspace import build_workspace
from legmov_tpu_torch.ops import cuda_multileg_dist as td
from legmov_tpu_torch.ops import orientation as tori

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

ROBOTS = {
    "quad_moonbot": (jrobot.get_moonbot_robot, trobot.get_moonbot_robot, ()),
    "hex_m2": (jrobot.make_robot, trobot.make_robot, ("HEX_MOUNTS",)),
}
L, P, C, K = 4, 8, 256, 2  # the JAX test's size (tests/test_pallas_multileg.py)


def _robots(name):
    jf, tf, args = ROBOTS[name]
    return (jf(*[getattr(jrobot, a) for a in args]),
            tf(*[getattr(trobot, a) for a in args]))


def _t(a):
    return torch.from_numpy(np.array(a))


def _items(seed=42):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-200, 200, (P, 3)).astype(np.float32)
    rpy = rng.uniform(-0.2, 0.2, (P, 3)).astype(np.float32)
    quats = np.array(jq.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]))
    pvalid = rng.random(P) < 0.3
    cand = rng.uniform(-700, 700, (P, C, 3)).astype(np.float32)
    return centers, quats, pvalid, cand


HALF = np.asarray([60.0, 60.0, 60.0], np.float32)
PARENT_HALF = np.asarray([120.0, 120.0, 120.0], np.float32)
MARGIN, REACH = 16.0, 710.0


def _jax_table(robot, centers, quats, pvalid):
    return np.asarray(jd.oriented_dist_tables(
        jnp.asarray(centers), jnp.asarray(quats), jnp.asarray(pvalid),
        jnp.asarray(HALF), jnp.asarray(PARENT_HALF), robot, MARGIN, REACH))


@pytest.fixture(scope="module")
def jax_kernel():
    """One interpret-mode compile of the JAX kernel serves every case."""
    return jd.make_multileg_distance_kernel(
        jrobot.get_moonbot_robot(), C, k=K, interpret=True)


def _comps(c):
    return [_t(np.ascontiguousarray(c[..., i])) for i in range(3)]


def test_layout_equals_jax():
    for n in (1, 4, 6):
        assert td.table_width(n) == jd.table_width(n)
    assert td.table_width(4) == 640 and td.table_width(6) == 1024
    for name in ("_CX", "_CY", "_CR", "_CR2", "_CHI2", "_CLO2", "_ATT",
                 "_CORX", "_CORY", "_CORV", "_MID_DIR", "_MID_NEG",
                 "_SAT_DIR", "_SAT_NEG", "LEG_BLOCK", "_HDR"):
        assert getattr(td, name) == getattr(jd, name), name


@pytest.mark.parametrize("name", list(ROBOTS))
def test_dist_leg_constants_equal_jax(name):
    j, t = _robots(name)
    assert td.dist_leg_constants(t) == jd.dist_leg_constants(j)
    assert td.HEAD_FLOPS == 39 and td.LEG_FLOPS == 860


def test_item_parameter_block_is_packed():
    total = 0
    for _, ctype in td._ItemParams._fields_:
        assert ctypes.sizeof(ctype) % 4 == 0
        total += ctypes.sizeof(ctype)
    assert ctypes.sizeof(td._ItemParams) == total < 4096
    consts = td.dist_leg_constants(trobot.make_robot(trobot.HEX_MOUNTS))
    p = td.item_params(consts, 4)
    assert (p.n_legs, p.table_width, p.k) == (6, 1024, 4)
    assert p.dir_c[5 * 5 + 4] == np.float32(consts[5]["d_mid"][0])
    assert p.big == np.float32(3.4e38)
    with pytest.raises(ValueError):
        td.item_params(consts + consts[:1], 4)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_tables_equal_own_workspace_and_match_jax(name):
    j, t = _robots(name)
    n = trobot.leg_count(t)
    centers, quats, pvalid, _ = _items(5)
    want = _jax_table(j, centers, quats, pvalid)
    got = td.oriented_dist_tables(_t(centers), _t(quats), _t(pvalid), HALF,
                                  PARENT_HALF, t, MARGIN, REACH)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    # bit-equal to build_workspace(rotate_leg_data(q, leg)) of the port
    for p in (0, 3, 7):
        for l in (0, n - 1):
            ws = build_workspace(
                tori.rotate_leg_data(_t(quats[p]), trobot.leg_of(t, l)))
            off = 16 + l * 151
            np.testing.assert_array_equal(
                got[p, off:off + 16], ws.circle_x.reshape(-1))
            np.testing.assert_array_equal(
                got[p, off + 80:off + 96], ws.circle_lo2.reshape(-1))
            np.testing.assert_array_equal(
                got[p, off + 112:off + 122], ws.corner_xy[:, 0])
            np.testing.assert_array_equal(
                got[p, off + 145:off + 149], ws.sat_dir.reshape(-1))
    # header and padding: exact
    np.testing.assert_array_equal(got[:, :16], want[:, :16])
    np.testing.assert_array_equal(got[:, 16 + n * 151:], 0.0)
    # leg blocks: the JAX tables, bit for bit (ROADMAP.md, fault F2)
    blocks_g = got[:, 16:16 + n * 151].reshape(P, n, 151)
    blocks_w = want[:, 16:16 + n * 151].reshape(P, n, 151)
    worst = {int(c): float(np.abs(blocks_g[..., c].astype(np.float64)
                                  - blocks_w[..., c]).max())
             for c in np.flatnonzero((blocks_g != blocks_w).any(axis=(0, 1)))}
    print(f"{name}: largest absolute difference per differing column: {worst}")
    assert blocks_g.tobytes() == blocks_w.tobytes(), worst
    # identity orientation: no pitch shift, so the blocks are bit-equal
    ident = np.tile(np.asarray([[1.0, 0, 0, 0]], np.float32), (P, 1))
    np.testing.assert_array_equal(
        td.oriented_dist_tables(_t(centers), _t(ident), _t(pvalid), HALF,
                                PARENT_HALF, t, MARGIN, REACH).numpy(),
        _jax_table(j, centers, ident, pvalid))


@pytest.mark.parametrize("rows", ["per_item", "shared_row", "special_values"])
def test_plain_item_kernel_equals_jax_kernel(jax_kernel, rows):
    """All 3L + 3 lanes, fed the JAX tables."""
    j, t = _robots("quad_moonbot")
    centers, quats, pvalid, cand = _items()
    if rows == "shared_row":
        cand = np.repeat(cand[:1], P, axis=0)
    if rows == "special_values":
        cand[0, :8] = np.nan
        cand[1, :8] = np.inf
        cand[2] = 1e9
        cand[3, ::2] = -np.inf
    jt = _jax_table(j, centers, quats, pvalid)
    want = np.asarray(jax_kernel(
        jnp.asarray(jt), *[jnp.asarray(cand[..., i]) for i in range(3)]
    ))[:, :3 * L + 3]
    consts = td.dist_leg_constants(t)
    tab = td.dist_tables_from_numpy(jt, L)
    comps = _comps(cand[:1] if rows == "shared_row" else cand)
    before = td.multileg_distance_kernel.launches
    got = td.multileg_distance_kernel(tab, *comps, consts, K)
    assert got.dtype == torch.bool and tuple(got.shape) == (P, 3 * L + 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    # a CPU tensor ran the plain version: nothing launched, nothing built
    assert td.multileg_distance_kernel.launches == before
    assert td._bound is None
    fn = td.make_multileg_distance_kernel(t, cand_cols=C, k=K)
    assert torch.equal(fn(tab, *comps), got)
    work = {}
    assert torch.equal(fn.plain(tab, *comps, work=work), got)
    assert work["pairs"] == P * C and 0 < work["pre_pairs"] <= P * C


def test_item_kernel_shapes_and_errors():
    _, t = _robots("quad_moonbot")
    centers, quats, pvalid, cand = _items()
    consts = td.dist_leg_constants(t)
    tab = td.oriented_dist_tables(_t(centers), _t(quats), _t(pvalid), HALF,
                                  PARENT_HALF, t, MARGIN, REACH)
    for p, c in ((0, 16), (3, 0), (1, 1)):
        got = td.multileg_distance_kernel(
            tab[:p].contiguous(), *_comps(cand[:p, :c]), consts, K)
        assert tuple(got.shape) == (p, 15) and not got[:, :12].any()
    with pytest.raises(ValueError):
        td.multileg_distance_kernel(tab, *_comps(cand[:3]), consts, K)
    with pytest.raises(ValueError):
        td.multileg_distance_kernel(tab[:, :512].contiguous(), *_comps(cand),
                                    consts, K)
    with pytest.raises(TypeError):
        td.multileg_distance_kernel(tab.double(), *_comps(cand), consts, K)
    with pytest.raises(ValueError):
        td.make_multileg_distance_kernel(t, cand_cols=128, k=K)(
            tab, *_comps(cand))
    with pytest.raises(ValueError):
        td.dist_tables_from_numpy(np.zeros((2, 600), np.float32), 4)


@pytest.mark.parametrize("shared", [True, False])
def test_cell_eval_rot_equals_jax_eval_cells(shared):
    j, t = _robots("quad_moonbot")
    rng = np.random.default_rng(3)
    cells, S, k = 6, 3, 2
    centers = rng.uniform(-250, 250, (cells, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(80, 160, cells)
    pv = rng.random(cells) < 0.3
    rpy = rng.uniform(-0.3, 0.3, (S, 3)).astype(np.float32)
    quats = np.array(jq.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]), np.float32)
    quats[0] = [1, 0, 0, 0]
    fh = rng.uniform(-900, 900, (600, 3)).astype(np.float32)
    fh[:, 2] = rng.uniform(-150, -60, 600)
    half = np.asarray([40.0, 40.0, 40.0], np.float32)
    parent_half = 2 * half
    want = jhs._eval_cells(
        jnp.asarray(centers), jnp.asarray(pv), jnp.asarray(half),
        jnp.asarray(parent_half), jnp.asarray(fh), jnp.asarray(quats), j,
        k=k, margin=0.0, reach=711.0, chunk=300, use_rot=True, shared=shared)
    ev = td.make_cell_eval_rot(t, k=k, cand_chunk=256)
    got = ev(_t(centers), _t(pv), half, parent_half, _t(fh), _t(quats), t,
             k=k, margin=0.0, reach=711.0, chunk=300, use_rot=True,
             shared=shared)
    for g, w, name in zip(got, want, ("valid", "edge", "leaf")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert np.asarray(want[0]).any() and np.asarray(want[1]).any()
    with pytest.raises(ValueError):
        ev(_t(centers), _t(pv), half, parent_half, _t(fh), _t(quats), t,
           k=k + 1)


def _cell_batch(seed=3, cells=6, S=3, F=600):
    """A small orientation-active batch: cells above seeded footholds,
    three orientation samples (the first the identity)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-250, 250, (cells, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(80, 160, cells)
    pv = rng.random(cells) < 0.3
    rpy = rng.uniform(-0.3, 0.3, (S, 3)).astype(np.float32)
    quats = np.array(jq.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]), np.float32)
    quats[0] = [1, 0, 0, 0]
    fh = rng.uniform(-900, 900, (F, 3)).astype(np.float32)
    fh[:, 2] = rng.uniform(-150, -60, F)
    return centers, pv, quats, fh


CELL_HALF = np.asarray([40.0, 40.0, 40.0], np.float32)
CELL_REACH = 711.0


@pytest.fixture(scope="module")
def jax_cells():
    """JAX ``_eval_cells`` on :func:`_cell_batch` under both rules (one
    compile each, at three orientation samples)."""
    j, _ = _robots("quad_moonbot")
    centers, pv, quats, fh = _cell_batch()
    return {shared: [np.asarray(w) for w in jhs._eval_cells(
        jnp.asarray(centers), jnp.asarray(pv), jnp.asarray(CELL_HALF),
        jnp.asarray(2 * CELL_HALF), jnp.asarray(fh), jnp.asarray(quats), j,
        k=2, margin=0.0, reach=CELL_REACH, chunk=300, use_rot=True,
        shared=shared)] for shared in (True, False)}


@pytest.mark.parametrize("cand_chunk", [64, 256, 4096])
@pytest.mark.parametrize("shared", [True, False])
def test_cell_driver_plain_version_equals_jax_eval_cells(jax_cells, shared,
                                                        cand_chunk):
    """``make_cell_eval_rot(..., plain=True)``, the cell driver's plain
    version, gives JAX ``_eval_cells``'s flags whatever its foothold window
    (so it equals itself across windows), and so does the wrapper on CPU
    tensors (which runs the plain version and launches nothing)."""
    _, t = _robots("quad_moonbot")
    centers, pv, quats, fh = _cell_batch()
    before = td.item_cells_kernel.launches
    for plain in (True, False):
        ev = td.make_cell_eval_rot(t, k=2, cand_chunk=cand_chunk, plain=plain)
        got = ev(_t(centers), _t(pv), CELL_HALF, 2 * CELL_HALF, _t(fh),
                 _t(quats), t, k=2, margin=0.0, reach=CELL_REACH,
                 shared=shared)
        for g, w, name in zip(got, jax_cells[shared],
                              ("valid", "edge", "leaf")):
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert jax_cells[shared][0].any() and jax_cells[shared][1].any()
    assert td.item_cells_kernel.launches == before and td._bound is None


def _level(t, quats, half=CELL_HALF, margin=0.0, reach=CELL_REACH):
    blocks = torch.as_tensor(td.leg_blocks(quats, t))
    return td.level_table(blocks, _t(quats), half, 2 * half, margin, reach)


@pytest.mark.parametrize("shared", [True, False])
def test_cell_driver_special_batches_equal_the_eager_evaluator(shared):
    """NaN, inf and 1e9 footholds, no footholds, a foothold count off the
    kernel's tile, one orientation, every parent valid and one cell: the
    wrapper (its plain version on the CPU) against the port's eager
    ``_eval_cells``, an independent formulation of the same flags."""
    from legmov_tpu_torch.models import hier_solver as ths

    _, t = _robots("quad_moonbot")
    centers, pv, quats, fh = _cell_batch(seed=5, cells=5, F=300)
    odd = fh.copy()
    odd[0:3] = np.nan
    odd[3:6, 1] = np.inf
    odd[6:9, 2] = -np.inf
    odd[9:40] = 1e9
    consts = td.dist_leg_constants(t)
    cases = [(centers, pv, fh[:257], quats), (centers, pv, odd, quats),
             (centers, pv, fh[:0], quats), (centers, pv, fh, quats[:1]),
             (centers, np.ones_like(pv), fh, quats),
             (centers[:1], pv[:1], fh, quats)]
    for c, p, f, q in cases:
        got = td.item_cells_kernel(_t(c), _t(p), _t(f), _level(t, q), consts,
                                   2, shared)
        want = ths._eval_cells(_t(c), _t(p), CELL_HALF, 2 * CELL_HALF, _t(f),
                               _t(q), t, k=2, margin=0.0, reach=CELL_REACH,
                               chunk=128, use_rot=True, shared=shared)
        assert tuple(got.shape) == (3, c.shape[0]) and got.dtype == torch.bool
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def _walk(centers, pv, fh, lt, consts, k, shared):
    """The cell driver's need counted pair by pair: (box tests,
    un-rotations, leg pipelines) of a walk over each cell's footholds in
    order that stops once the cell is settled (``item_cells_need``)."""
    L, S = len(consts), lt.shape[0]
    e = lt[0, 13:16].numpy()
    tab = td.item_rows(_t(centers), _t(pv), lt)
    box = unrot = legs = 0
    for ci, c in enumerate(centers):
        flags, chain = 0, False
        settled = np.zeros((S, L), bool)
        seen = np.zeros((S, L, 2), bool)  # ok, ok & ~crossed
        for f in fh:
            if (shared and flags == 7) or (not shared and settled.all()):
                break
            box += 1
            r = f - c
            if not ((r > -e) & (r <= e)).all():
                continue
            for q in range(S):
                row = tab[ci * S + q:ci * S + q + 1]
                _, outs = td.item_math_plain(
                    lambda i: row[:, i:i + 1], consts,
                    *(_t(f[None, i:i + 1]) for i in range(3)))
                ok = [bool(o[0, 0]) for o, _ in outs]
                cr = [bool(x[0, 0]) for _, x in outs]
                if shared:
                    unrot += 1
                    rc = 0
                    for l in range(L):
                        legs += 1
                        rc += ok[l]
                        if chain and l < L - 1 and rc + (L - 1 - l) < k:
                            break
                    iv = sum(ok) >= k or bool(pv[ci])
                    ie = sum(cr) > L - k
                    flags |= iv | (ie << 1) | ((iv and not ie) << 2)
                elif not settled[q].all():
                    unrot += 1
                    for l in range(L):
                        if not settled[q, l]:
                            legs += 1
                            seen[q, l] |= (ok[l], ok[l] and not cr[l])
            settled |= seen.all(axis=-1)
            chain = bool(flags & 2) and not pv[ci]
    return box, unrot, legs


@pytest.mark.parametrize("shared", [True, False])
def test_cell_driver_bound_count_against_a_brute_count(shared):
    """``item_cells_need`` (what decides a batch's flags, from the plain
    item's bits) against the walk counted pair by pair, with NaN footholds
    and a cell far from every foothold; ``item_cells_flops`` prices the
    counts."""
    _, t = _robots("quad_moonbot")
    centers, pv, quats, fh = _cell_batch(seed=7, cells=6, F=160)
    fh[:3] = np.nan
    centers[5] = [5000.0, 0.0, 100.0]
    pv[:2] = [True, False]
    consts = td.dist_leg_constants(t)
    lt = _level(t, quats)
    need = td.item_cells_need(_t(centers), _t(pv), _t(fh), lt, consts, 2,
                              shared)
    box, unrot, legs = _walk(centers, pv, fh, lt, consts, 2, shared)
    assert need.tolist() == [box, unrot, legs]
    assert 0 < legs < unrot * 4 and (box < 6 * 160 or not shared)
    assert td.item_cells_flops(*need.tolist()) == (
        box * td.BOX_FLOPS + unrot * td.UNROTATE_FLOPS + legs * td.LEG_FLOPS)
    none = td.item_cells_need(_t(centers), _t(pv), _t(fh[:0]), lt, consts,
                              2, shared)
    assert none.tolist() == [0, 0, 0]


def test_cell_driver_wrapper_refuses_what_the_kernel_does_not_take():
    _, t = _robots("quad_moonbot")
    centers, pv, quats, fh = _cell_batch()
    consts = td.dist_leg_constants(t)
    lt = _level(t, quats)
    c, p, f = _t(centers), _t(pv), _t(fh)
    with pytest.raises(TypeError):
        td.item_cells_kernel(c.double(), p, f, lt, consts, 2, True)
    with pytest.raises(TypeError):
        td.item_cells_kernel(c, p.int(), f, lt, consts, 2, True)
    with pytest.raises(ValueError):
        td.item_cells_kernel(c, p[:2].contiguous(), f, lt, consts, 2, True)
    with pytest.raises(ValueError):
        td.item_cells_kernel(c, p, f[:, :2].contiguous(), lt, consts, 2, True)
    with pytest.raises(ValueError):
        td.item_cells_kernel(c, p, f, lt[:, :600].contiguous(), consts, 2,
                             True)
    with pytest.raises(ValueError, match="contiguous"):
        td.item_cells_kernel(c, p, f.t().contiguous().t(), lt, consts, 2,
                             True)
    empty = td.item_cells_kernel(c[:0], p[:0], f, lt, consts, 2, True)
    assert tuple(empty.shape) == (3, 0)


def _circle_points(tab, consts, body, quats, thetas, steps):
    """World points on every leg's sixteen slot circles (in the port's
    table ``tab``) at the radius and at the edges of its margin band,
    built in float64 and rounded once, then moved by ``steps`` ulp along
    each axis: (points [N, 3] float32, item index [N])."""
    pts, item = [], []
    for p in range(tab.shape[0]):
        w, u = float(quats[p, 0]), quats[p, 1:].astype(np.float64)
        for l, c in enumerate(consts):
            off = td._HDR + l * td.LEG_BLOCK
            for k in range(16):
                cx, cy = float(tab[p, off + td._CX + k]), float(
                    tab[p, off + td._CY + k])
                r = float(tab[p, off + td._CR + k])
                for rr in (r, r + 1e-3, r - 1e-3):
                    for th in thetas:
                        rho = cx + rr * np.cos(th) + c["coxa_len"]
                        if rho <= 1.0:
                            continue
                        zc = cy + rr * np.sin(th)
                        px = rho * c["cp"] + zc * c["sp"]
                        vz = -rho * c["sp"] + zc * c["cp"]
                        x0 = px + c["body"]
                        v = np.array([x0 * c["ca"], -x0 * c["sa"], vz])
                        tq = 2 * np.cross(u, v)
                        base = (v + w * tq + np.cross(u, tq)
                                + body[p]).astype(np.float32)
                        for ax in range(3):
                            for d in steps:
                                q = base.copy()
                                for _ in range(abs(d)):
                                    q[ax] = np.nextafter(
                                        q[ax], np.float32(np.sign(d) * np.inf))
                                pts.append(q)
                                item.append(p)
    return np.asarray(pts, np.float32), np.asarray(item)


#: item bits that flip in the search below when each side uses its own
#: tables (ROADMAP.md, fault F2, closed: none since the tables are the JAX
#: package's bit for bit)
K5_FLIPS = {"quad_moonbot": 0, "hex_m2": 0}


@pytest.mark.parametrize("name", list(ROBOTS))
def test_item_bits_on_the_oriented_circles_against_jax(name):
    """Footholds within a few ulp of every leg's oriented slot circles (and
    of the edges of their margin bands), one candidate a row: the plain
    item's per-leg ok and crossed bits against the JAX item
    (``make_item_math``, the kernel's body), fed the same tables and each
    side its own (ROADMAP.md, fault F2)."""
    j, t = _robots(name)
    L = trobot.leg_count(t)
    # the items of the table tests (same shapes: the JAX tables compile once)
    body, quats, pv, _ = _items()
    tab_t = td.oriented_dist_tables(_t(body), _t(quats), _t(pv), HALF,
                                    PARENT_HALF, t, MARGIN, REACH).numpy()
    tab_j = _jax_table(j, body, quats, pv)
    consts_t = td.dist_leg_constants(t)
    item_j = jd.make_item_math(jd.dist_leg_constants(j))
    pts, item = _circle_points(tab_t[:2], consts_t, body.astype(np.float64),
                               quats, (0.4, -1.0), range(-3, 4))

    def port(tab):
        rows = torch.from_numpy(tab[item])
        _, outs = td.item_math_plain(
            lambda i: rows[:, i:i + 1], consts_t,
            *(torch.from_numpy(pts[:, i:i + 1].copy()) for i in range(3)))
        return np.stack([o[:, 0].numpy() for pair in outs for o in pair], 1)

    def jax(tab):
        rows = jnp.asarray(tab[item])
        _, outs = item_j(lambda i: rows[:, i:i + 1],
                         *(jnp.asarray(pts[:, i:i + 1]) for i in range(3)))
        return np.stack([np.asarray(o)[:, 0] for pair in outs for o in pair],
                        1)

    want = jax(tab_j)
    assert want.shape == (pts.shape[0], 2 * L) and 0 < want.mean() < 1
    np.testing.assert_array_equal(port(tab_j), want)
    flips = np.argwhere(port(tab_t) != want)
    for i, b in flips[:3]:
        print(f"{name}: {'crossed' if b % 2 else 'ok'} of leg {b // 2} "
              f"flips at {pts[i].tolist()} (item {item[i]}: body "
              f"{body[item[i]].tolist()}, quaternion "
              f"{quats[item[i]].tolist()})")
    print(f"{name}: {len(flips)} flips of {want.size} ok / crossed bits")
    assert len(flips) == K5_FLIPS[name] == 0
    np.testing.assert_array_equal(port(tab_t), want)

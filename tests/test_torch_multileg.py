"""PyTorch port: per-pose tables and the multi-leg / CSR window kernels'
plain versions against the JAX package.

On the CPU the wrappers run the kernels' plain versions (that is what a CPU
tensor gets); the CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``.

Tolerances.  Leg constants, the table layout and ``oriented_tables``:
equal to the JAX package's, bit for bit (both take the JAX package's
float32 trig: glibc's, through ops/trig32.py on the port's side); against
the port's own ``build_workspace`` of the same oriented leg the tables are
bit-equal too.  Booleans out of the plain kernels: ``assert_array_equal``,
fed the JAX tables through ``tables_from_numpy`` and each side its own.
"""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from legmov_tpu.models import robot as jrobot
from legmov_tpu.ops import pallas_multileg as jml
from legmov_tpu.ops import quaternion as jq
from legmov_tpu_torch.models import robot as trobot
from legmov_tpu_torch.models.workspace import build_workspace
from legmov_tpu_torch.ops import cuda_multileg as cm
from legmov_tpu_torch.ops import orientation as tori
from legmov_tpu_torch.ops.quaternion import IDENTITY

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

ROBOTS = {
    "quad_moonbot": (jrobot.get_moonbot_robot, trobot.get_moonbot_robot, ()),
    "quad_m2": (jrobot.get_m2_robot, trobot.get_m2_robot, ()),
    "hex_m2": (jrobot.make_robot, trobot.make_robot, ("HEX_MOUNTS",)),
}


def _robots(name):
    jf, tf, args = ROBOTS[name]
    return (jf(*[getattr(jrobot, a) for a in args]),
            tf(*[getattr(trobot, a) for a in args]))


def _t(a):
    return torch.from_numpy(np.array(a))


def _poses(P, seed, spread=0.25):
    rng = np.random.default_rng(seed)
    body = (rng.uniform(-300, 300, (P, 3)) * [1, 1, 0.3]).astype(np.float32)
    rpy = rng.uniform(-spread, spread, (P, 3)).astype(np.float32)
    return body, np.array(jq.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]))


def _cands(P, C, seed, special=True):
    c = np.random.default_rng(seed).uniform(-600, 600, (P, C, 3)).astype(
        np.float32)
    if special and P >= 4 and C >= 8:
        c[0, :8] = np.nan
        c[1, :8] = np.inf
        c[2] = 1e9
        c[3, ::2] = -np.inf
    return c


def _comps(c):
    return [_t(np.ascontiguousarray(c[..., i])) for i in range(3)]


def test_layout_equals_jax():
    for L in (1, 4, 6):
        assert cm.table_width(L) == jml.table_width(L)
    assert cm.table_width(4) == 256 and cm.table_width(6) == 384
    for name in ("_AX", "_AY", "_R2K", "_HI2K", "_LO2K", "_FAL", "_MID_DIR",
                 "_MID_NEG", "_SAT_DIR", "_SAT_NEG", "LEG_BLOCK", "_HDR",
                 "_INNER", "_OUTER", "_FAN", "_FAP", "_WN", "_WP"):
        assert getattr(cm, name) == getattr(jml, name), name


@pytest.mark.parametrize("name", list(ROBOTS))
def test_leg_constants_equal_jax(name):
    j, t = _robots(name)
    assert cm.leg_constants(t) == jml.leg_constants(j)
    consts = cm.leg_constants(t)
    assert [cm.leg_flops(c) for c in consts] == [84] * len(consts)
    assert cm.UNROTATE_FLOPS == 33


@pytest.mark.parametrize("name", list(ROBOTS))
def test_oriented_tables_match_jax(name):
    j, t = _robots(name)
    L = trobot.leg_count(t)
    body, quats = _poses(64, 21, spread=0.4)
    want = np.asarray(jml.oriented_tables(jnp.asarray(body), jnp.asarray(quats), j))
    got = cm.oriented_tables(_t(body), _t(quats), t)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    diff = np.flatnonzero((got != want).any(axis=0))
    assert got.tobytes() == want.tobytes(), (
        f"{name}: columns {diff.tolist()} differ, by up to "
        f"{np.abs(got.astype(np.float64) - want).max():.3e}")


@pytest.mark.parametrize("name", list(ROBOTS))
def test_oriented_tables_bit_equal_to_build_workspace(name):
    """Row for row the blocks of the oriented legs' own workspaces: at the
    identity (the plain workspace of each leg) and at seeded orientations."""
    _, t = _robots(name)
    L = trobot.leg_count(t)
    body, quats = _poses(12, 22, spread=0.5)
    quats[0] = IDENTITY
    tab = cm.oriented_tables(_t(body), _t(quats), t).numpy()
    oriented = tori.rotate_leg_data(_t(quats)[:, None, :], t)
    for p in range(12):
        for l in range(L):
            leg = trobot.leg_of(t, l).replace(
                tibia_absolute_pos=np.float32(oriented.tibia_absolute_pos[p, l]),
                tibia_absolute_neg=np.float32(oriented.tibia_absolute_neg[p, l]))
            if p == 0:
                assert leg == trobot.leg_of(t, l)
            want = cm.leg_block_from_workspace(leg, build_workspace(leg))
            got = tab[p, 7 + l * 43: 7 + (l + 1) * 43]
            assert got.tobytes() == want.tobytes(), (p, l, got - want)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_plain_multileg_equals_jax_kernel_bit_for_bit(name):
    """JAX tables in, through ``tables_from_numpy``: the plain version and
    the JAX kernel (interpret mode) give the same bits, NaN, inf and
    far-sentinel rows included."""
    j, t = _robots(name)
    L = trobot.leg_count(t)
    P, C = 8, 256
    body, quats = _poses(P, 23)
    cands = _cands(P, C, 24)
    j_tab = jml.oriented_tables(jnp.asarray(body), jnp.asarray(quats), j)
    fn = jml.make_multileg_kernel(j, C, interpret=True)
    want = np.asarray(fn(j_tab, *(jnp.asarray(cands[..., i]) for i in range(3))))
    tab = cm.tables_from_numpy(np.asarray(j_tab), L)
    k3 = cm.make_multileg_kernel(t, C)
    none = torch.zeros((P, L), dtype=torch.bool)
    got = k3(tab, *_comps(cands), none)
    assert got.dtype == torch.bool and tuple(got.shape) == (P, L)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, k3.plain(tab, *_comps(cands), none))
    assert want.any() and not want[2].any()
    with pytest.raises(ValueError, match="cand_cols"):
        k3(tab, *_comps(cands[:, :128]), none)


@pytest.mark.parametrize("P", [0, 1, 7, 9])
@pytest.mark.parametrize("C", [0, 128, 1000])
def test_plain_multileg_ragged_shapes_equal_the_tensor_path(P, C):
    """Any P and C, against the independent formulation of
    ops/orientation.py on the port's own tables."""
    t = trobot.make_robot(trobot.HEX_MOUNTS)
    body, quats = _poses(P, 25)
    cands = _cands(P, C, 26, special=False)
    tab = cm.oriented_tables(_t(body), _t(quats), t)
    got = cm.make_multileg_kernel(t)(tab, *_comps(cands),
                                     torch.zeros((P, 6), dtype=torch.bool))
    assert tuple(got.shape) == (P, 6) and got.dtype == torch.bool
    rel = _t(cands) - _t(body)[:, None, :]
    want = tori.reachability_oriented_poses(rel, _t(quats), t).any(dim=-1) \
        if P and C else torch.zeros((P, 6), dtype=torch.bool)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _queue(A, S, W, F, L, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, W + 1, (A, S)).astype(np.int32)
    starts = rng.integers(0, F - W, (A, S)).astype(np.int32)
    masks = rng.integers(0, 1 << L, (A, S)).astype(np.int32)
    masks[rng.random((A, S)) < 0.25] = 0
    legs_in = rng.random((A, L)) < 0.15
    return _t(starts), _t(lens), _t(masks), _t(legs_in)


@pytest.mark.parametrize("A,S,W", [(0, 3, 64), (1, 1, 64), (7, 5, 100),
                                   (9, 12, 256)])
def test_plain_csr_window_is_the_or_of_masked_windows(A, S, W):
    t = trobot.get_m2_robot()
    L, F = 4, 3000
    rng = np.random.default_rng(27)
    pts = rng.uniform(-600, 600, (F, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.2 - 130
    pts[50:58] = np.nan
    pts[60:68] = np.inf
    pts[70:90] = 1e9
    xs, ys, zs = _comps(pts)
    body, quats = _poses(A, 28)
    tab = cm.oriented_tables(_t(body), _t(quats), t)
    starts, lens, masks, legs_in = _queue(A, S, W, F, L, 29)
    k4 = cm.make_csr_window_kernel(t)
    work = {}
    got = k4.plain(tab, legs_in, starts, lens, masks, xs, ys, zs, work=work)
    assert torch.equal(got, k4(tab, legs_in, starts, lens, masks, xs, ys, zs))
    want = legs_in.clone()
    points = leg_points = 0
    for a in range(A):
        for s in range(S):
            lo, n, m = int(starts[a, s]), int(lens[a, s]), int(masks[a, s])
            need = [l for l in range(L) if m >> l & 1 and not want[a, l]]
            if need and n:
                points += n
                leg_points += n * len(need)
            if not n or not m:
                continue
            window = [c[lo:lo + n][None, :] for c in (xs, ys, zs)]
            bits = cm.multileg_kernel_plain(tab[a:a + 1], *window, k4.consts)[0]
            for l in range(L):
                if m >> l & 1:
                    want[a, l] |= bits[l]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (work["points"], work["leg_points"]) == (points, leg_points)
    dead = k4(tab, legs_in, starts, lens, torch.zeros_like(masks), xs, ys, zs)
    assert torch.equal(dead, legs_in)


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    t = trobot.get_m2_robot()
    before = (cm.multileg_kernel.launches, cm.csr_window_kernel.launches)
    body, quats = _poses(5, 30)
    tab = cm.oriented_tables(_t(body), _t(quats), t)
    g = _comps(_cands(5, 128, 31))
    none = torch.zeros((5, 4), dtype=torch.bool)
    assert torch.equal(cm.multileg_kernel(tab, *g, none, cm.leg_constants(t)),
                       cm.multileg_kernel_plain(tab, *g, cm.leg_constants(t)))
    assert (cm.multileg_kernel.launches, cm.csr_window_kernel.launches) == before
    assert cm._bound is None


def test_wrappers_refuse_what_the_kernels_do_not_take():
    t = trobot.get_m2_robot()
    consts = cm.leg_constants(t)
    body, quats = _poses(4, 32)
    tab = cm.oriented_tables(_t(body), _t(quats), t)
    g = _comps(_cands(4, 128, 33))
    legs = torch.zeros((4, 4), dtype=torch.bool)
    with pytest.raises(TypeError):
        cm.multileg_kernel(tab.double(), *g, legs, consts)
    with pytest.raises(ValueError):
        cm.multileg_kernel(tab[:, :100].contiguous(), *g, legs, consts)
    with pytest.raises(ValueError):
        cm.multileg_kernel(tab, g[0], g[1], g[2][:, :64].contiguous(), legs,
                           consts)
    with pytest.raises(ValueError, match="contiguous"):
        cm.multileg_kernel(tab, g[0].t().contiguous().t(), g[1], g[2], legs,
                           consts)
    st = torch.zeros((4, 2), dtype=torch.int32)
    xs = torch.zeros(10)
    with pytest.raises(TypeError):
        cm.csr_window_kernel(tab, legs, st.long(), st, st, xs, xs, xs, consts)
    with pytest.raises(ValueError):
        cm.csr_window_kernel(tab, legs[:, :3].contiguous(), st, st, st, xs, xs,
                             xs, consts)
    with pytest.raises(ValueError):
        cm.multileg_params(consts * 2)
    with pytest.raises(ValueError):
        cm.tables_from_numpy(np.zeros((3, 100), np.float32), 4)


def test_parameter_block_is_packed():
    total = 0
    for _, ctype in cm._MultilegParams._fields_:
        assert ctypes.sizeof(ctype) % 4 == 0
        total += ctypes.sizeof(ctype)
    assert ctypes.sizeof(cm._MultilegParams) == total < 4096
    p = cm.multileg_params(cm.leg_constants(trobot.make_robot(trobot.HEX_MOUNTS)))
    assert p.n_legs == 6 and p.table_width == 384


def test_found_legs_input_is_ored_in():
    """``legs_in`` (legs found before the launch) comes back ORed into the
    bits, through the wrapper, the factory and the plain version alike; the
    CSR solver passes its found legs that way."""
    t = trobot.make_robot(trobot.HEX_MOUNTS)
    consts = cm.leg_constants(t)
    body, quats = _poses(9, 34)
    tab = cm.oriented_tables(_t(body), _t(quats), t)
    g = _comps(_cands(9, 300, 35))
    legs_in = torch.from_numpy(np.random.default_rng(36).random((9, 6)) < 0.4)
    base = cm.multileg_kernel_plain(tab, *g, consts)
    want = base | legs_in
    assert not torch.equal(want, base)
    assert torch.equal(cm.multileg_kernel_plain(tab, *g, consts, legs_in), want)
    assert torch.equal(cm.multileg_kernel(tab, *g, legs_in, consts), want)
    k3 = cm.make_multileg_kernel(t)
    assert torch.equal(k3(tab, *g, legs_in), want)
    assert torch.equal(k3.plain(tab, *g, legs_in), want)
    every = torch.ones((9, 6), dtype=torch.bool)
    assert k3(tab, *g, every).all()
    with pytest.raises(TypeError):
        cm.multileg_kernel(tab, *g, legs_in.int(), consts)
    with pytest.raises(ValueError):
        cm.multileg_kernel(tab, *g, legs_in[:, :4].contiguous(), consts)


def test_bound_count_against_a_brute_count():
    """``multileg_need``: a walk over each pose's candidates in order reads
    them until every leg not found before is found, un-rotates the ones
    that are not padding and runs each missing leg on them up to its first
    hit; ``multileg_flops`` prices the counts."""
    t = trobot.get_m2_robot()
    consts = cm.leg_constants(t)
    rng = np.random.default_rng(37)
    P, C, L = 6, 40, 4
    body, quats = _poses(P, 38)
    tab = cm.oriented_tables(_t(body), _t(quats), t)
    cands = _cands(P, C, 39)
    cands[4, 3:30] = 1e9              # padding inside a row
    cands[5, :, 0] = body[5, 0] + 2e8  # a row that is all padding
    g = _comps(cands)
    legs_in = _t(rng.random((P, L)) < 0.3)
    legs_in[1] = True
    hits = np.stack([
        cm.multileg_kernel_plain(tab[p:p + 1].repeat(C, 1),
                                 *(x[p][:, None] for x in g), consts).numpy()
        for p in range(P)])  # [P, C, L]: candidate c alone
    read = unrot = 0
    evals = [0] * L
    for p in range(P):
        missing = {l for l in range(L) if not legs_in[p, l]}
        for c in range(C):
            if not missing:
                break
            read += 1
            if (np.abs(cands[p, c] - body[p]) > cm.FAR).any():
                continue
            unrot += 1
            for l in sorted(missing):
                evals[l] += 1
                if hits[p, c, l]:
                    missing.discard(l)
    need = cm.multileg_need(tab, *g, consts, legs_in)
    assert need.tolist() == [read, unrot, *evals]
    assert 0 < unrot < read < P * C and sum(evals) < unrot * L
    assert cm.multileg_flops(need, consts) == unrot * cm.UNROTATE_FLOPS + sum(
        n * cm.leg_flops(c) for n, c in zip(evals, consts))
    empty = cm.multileg_need(tab[:0], *(x[:0] for x in g), consts,
                             legs_in[:0])
    assert empty.tolist() == [0] * (2 + L)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_far_candidates_reach_no_leg(name):
    """A candidate :data:`FAR` (1e8 mm) or further from the body in one
    axis, or infinitely far, reaches no leg in the plain version, under any
    orientation: the kernel skips such candidates unevaluated.  A leg that
    reaches FAR / 1e3 or further is refused."""
    _, t = _robots(name)
    L = trobot.leg_count(t)
    P = 16
    body, quats = _poses(P, 40, spread=0.6)
    tab = cm.oriented_tables(_t(body), _t(quats), t)
    rng = np.random.default_rng(41)
    C = 48
    c = (body[:, None, :] + rng.uniform(-700, 700, (P, C, 3))).astype(
        np.float32)
    axis = rng.integers(0, 3, (P, C))
    # just past FAR (float32 steps of 8 mm there, bodies within 1e3 mm)
    far = np.array([cm.FAR + 1024, 1e9, np.inf])
    off = far[rng.integers(0, 3, (P, C))] * rng.choice([-1, 1], (P, C))
    at = np.take_along_axis(body[:, None, :].repeat(C, 1), axis[..., None], 2)
    np.put_along_axis(c, axis[..., None], (at + off[..., None]).astype(
        np.float32), 2)
    d = np.abs(c - body[:, None, :]).max(axis=-1)  # float32, as the kernel
    assert (d > cm.FAR).all() and (d < cm.FAR + 2048).any()
    got = cm.multileg_kernel_plain(tab, *_comps(c), cm.leg_constants(t))
    assert not got.any()
    near = cm.multileg_kernel_plain(
        tab, *_comps((body[:, None, :] + rng.uniform(-700, 700, (P, C, 3)))
                     .astype(np.float32)), cm.leg_constants(t))
    assert near.any()
    assert max(cm.leg_reach(trobot.leg_of(t, l)) for l in range(L)) < 1e4
    big = trobot.stack_legs([trobot.leg_of(t, 0)._replace(
        femur_length=np.float32(2e5))])
    with pytest.raises(ValueError, match="reaches"):
        cm.oriented_tables(_t(body[:1]), _t(quats[:1]), big)


def _circle_points(tab, consts, body, quats, thetas, steps):
    """World points on every leg's six circles (in the port's table ``tab``)
    at the radius and at the edges of its margin band (r, r +- 0.001 mm),
    built in float64 and rounded once, then moved by ``steps`` ulp along
    each axis: (points [N, 3] float32, pose index [N])."""
    pts, pose = [], []
    for p in range(tab.shape[0]):
        w, u = float(quats[p, 0]), quats[p, 1:].astype(np.float64)
        for l, c in enumerate(consts):
            off = 7 + l * 43
            for k in range(6):
                cx = -0.5 * float(tab[p, off + k])
                cy = -0.5 * float(tab[p, off + 6 + k])
                r2 = float(tab[p, off + 12 + k]) + cx * cx + cy * cy
                if r2 <= 0:
                    continue
                r = np.sqrt(r2)
                for rr in (r, r + 1e-3, r - 1e-3):
                    for th in thetas:
                        # plane point -> coxa frame (azimuth 0) -> body frame
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
                                pose.append(p)
    return np.asarray(pts, np.float32), np.asarray(pose)


#: leg bits that flip in the search below when each side uses its own
#: tables (ROADMAP.md, fault F2, closed: none since the tables are the JAX
#: package's bit for bit)
K3_FLIPS = {"quad_moonbot": 0, "quad_m2": 0, "hex_m2": 0}


@pytest.mark.parametrize("name", list(ROBOTS))
def test_leg_bits_on_the_oriented_circles_against_jax(name):
    """Footholds within a few ulp of the oriented circles (and of the edges
    of their margin bands), one candidate a row.  Fed the same (JAX) tables,
    the plain version's leg bits equal the JAX kernel body's
    (``tile_one_leg_bit``) everywhere; each side on its own tables too
    (ROADMAP.md, fault F2: the tables are equal, so no bit flips)."""
    j, t = _robots(name)
    L = trobot.leg_count(t)
    body, quats = _poses(3, 38, spread=0.3)
    tab_t = cm.oriented_tables(_t(body), _t(quats), t).numpy()
    tab_j = np.asarray(jml.oriented_tables(jnp.asarray(body),
                                           jnp.asarray(quats), j))
    consts_t, consts_j = cm.leg_constants(t), jml.leg_constants(j)
    pts, pose = _circle_points(tab_t, consts_t, body.astype(np.float64),
                               quats, (0.3, 1.2, -0.7), range(-4, 5))

    def port(tab):
        rows = torch.from_numpy(tab[pose])

        def s(i):
            return rows[:, i:i + 1]

        v = cm._unrotate_plain(s, *(torch.from_numpy(pts[:, i:i + 1].copy())
                                    for i in range(3)))
        return np.stack([cm._one_leg_plain(s, l, c, *v)[:, 0].numpy()
                         for l, c in enumerate(consts_t)], 1)

    def jax(tab):
        rows = jnp.asarray(tab[pose])

        def s(i):
            return rows[:, i:i + 1]

        v = jml.tile_unrotate(s, *(jnp.asarray(pts[:, i:i + 1])
                                   for i in range(3)))
        return np.stack([np.asarray(jml.tile_one_leg_bit(s, l, c, *v))[:, 0]
                         for l, c in enumerate(consts_j)], 1)

    want = jax(tab_j)
    assert want.shape == (pts.shape[0], L) and 0 < want.mean() < 1
    np.testing.assert_array_equal(port(tab_j), want)
    flips = np.argwhere(port(tab_t) != want)
    for i, l in flips[:3]:
        print(f"{name}: leg {l} flips at {pts[i].tolist()} (pose body "
              f"{body[pose[i]].tolist()}, quaternion "
              f"{quats[pose[i]].tolist()})")
    print(f"{name}: {len(flips)} flips of {want.size} leg bits")
    assert len(flips) == K3_FLIPS[name] == 0
    np.testing.assert_array_equal(port(tab_t), want)

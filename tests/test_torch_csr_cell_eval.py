"""PyTorch port: the CSR cell evaluator (queue build, the plain versions of
the three cell-kernel forms) against the JAX package.

On the CPU the wrappers run the kernels' plain versions; the CUDA kernels are
held against the same plain versions on the card by ``chip_smoke.py``.  The
JAX tests tie the Pallas kernels to ``_eval_cells`` (interpret mode, minutes
per combination), so here the plain forms are held against JAX
``_eval_cells`` directly.

Tolerances.  ``slab_queue_host_max``, ``reach_l``, ``r_cell``: equal.
Rotated mounts: rtol/atol 1e-6 of the mount radius (``quaternion.rotate``
differs in the last bit, and only the superset masks depend on it).  The
queue: exact set properties against a numpy brute force.  Cell flags:
``assert_array_equal``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from legmov_tpu.models import hier_solver as jhs
from legmov_tpu.models import robot as jrobot
from legmov_tpu.ops import csr_cell_eval as jce
from legmov_tpu.ops import csr_grid as jcg
from legmov_tpu.ops import quaternion as jq
from legmov_tpu_torch.models import robot as trobot
from legmov_tpu_torch.ops import csr_cell_eval as cce
from legmov_tpu_torch.ops import cuda_multileg_dist as cmd
from legmov_tpu_torch.ops.csr_grid import build_csr_grid

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

REACH = 711.0
HALF = np.asarray([40.0, 40.0, 40.0], np.float32)
PARENT_HALF = np.asarray([80.0, 80.0, 80.0], np.float32)
MARGIN = 16.0
ELONG = PARENT_HALF + np.float32(REACH)
S, CELLS, WINDOW = 3, 8, 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed=0, n=1200):
    """The JAX test's draw (tests/test_csr_cell_eval.py)."""
    rng = np.random.default_rng(seed)
    fh = rng.uniform(-1500, 1500, (n, 3)).astype(np.float32)
    fh[:, 2] = rng.uniform(-200, -100, n)
    rpy = rng.uniform(-0.3, 0.3, (S, 3)).astype(np.float32)
    quats = np.array(jq.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]), np.float32)
    quats[0] = [1, 0, 0, 0]
    centers = rng.uniform(-1200, 1200, (CELLS, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(50, 150, CELLS)
    pv = rng.random(CELLS) < 0.3
    return fh, quats, centers, pv


class _Level:
    """Everything one level's evaluation needs, on the CPU."""

    def __init__(self, robot, fh, quats, window=WINDOW):
        self.robot, self.window = robot, window
        self.csr = build_csr_grid(fh, 400.0, device="cpu")
        self.quats = _t(quats)
        self.legtab = cce.level_tables(self.quats, HALF, PARENT_HALF, robot,
                                       MARGIN, REACH)
        self.rm, self.rl, self.rc = cce.ball_mask_params(
            self.quats, robot, HALF, MARGIN)

    def queue(self, centers, k, shared, masks=True, steps=None):
        c = self.csr
        if steps is None:
            steps = cce.slab_queue_host_max(
                centers, ELONG, c.starts.numpy(), c.origin.numpy(),
                c.cell_size, c.dims, self.window)
        return cce.build_cell_queue(
            _t(centers), _t(ELONG), self.rm, self.rl, self.rc, c.starts,
            c.origin, cell_size=c.cell_size, dims=c.dims, k=k, shared=shared,
            window=self.window, q_steps=steps, chunk_masks=masks)

    def evaluate(self, centers, pv, k, shared, **kw):
        c = self.csr
        ev = cce.make_csr_cell_eval(self.robot, k=k, n_quats=S, shared=shared,
                                    window=self.window, **kw)
        return ev(_t(centers), _t(pv), self.legtab, _t(ELONG), self.rm,
                  self.rl, self.rc, c.xs, c.ys, c.zs, c.starts, c.origin,
                  cell_size=c.cell_size, dims=c.dims)


def _jax_flags(robot, fh, quats, centers, pv, k, shared, chunk):
    return [np.asarray(a) for a in jhs._eval_cells(
        jnp.asarray(centers), jnp.asarray(pv), jnp.asarray(HALF),
        jnp.asarray(PARENT_HALF), jnp.asarray(fh), jnp.asarray(quats), robot,
        k=k, margin=MARGIN, reach=REACH, chunk=chunk, use_rot=True,
        shared=shared)]


def test_host_queue_size_and_ball_params_equal_jax():
    fh, quats, centers, _ = _scene()
    tcsr = build_csr_grid(fh, 400.0, device="cpu")
    jcsr = jcg.build_csr_grid(fh, 400.0)
    assert tcsr.dims == tuple(jcsr.dims)
    np.testing.assert_array_equal(tcsr.starts.numpy(), np.asarray(jcsr.starts))
    for window in (256, 384, 100):  # no 1024-element anchoring at these
        args = (centers, ELONG, np.asarray(jcsr.starts),
                np.asarray(jcsr.origin), jcsr.cell_size, jcsr.dims, window)
        assert cce.slab_queue_host_max(*args) == jce.slab_queue_host_max(*args)
    assert cce.slab_queue_host_max(centers[:0], *args[1:]) == 0
    assert cce.R_CAP == jce.R_CAP and cce._BALL_EPS == jce._BALL_EPS
    for jr, tr in ((jrobot.get_moonbot_robot(), trobot.get_moonbot_robot()),
                   (jrobot.make_robot(jrobot.HEX_MOUNTS),
                    trobot.make_robot(trobot.HEX_MOUNTS))):
        jm, jl, jc = jce.ball_mask_params(jnp.asarray(quats), jr, HALF, MARGIN)
        tm, tl, tc = cce.ball_mask_params(_t(quats), tr, HALF, MARGIN)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(jm).max()))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tc == float(jc)


def test_level_tables_are_item_tables_without_a_cell():
    fh, quats, _, _ = _scene()
    robot = trobot.get_moonbot_robot()
    lt = cce.level_tables(_t(quats), HALF, PARENT_HALF, robot, MARGIN, REACH)
    want = cmd.oriented_dist_tables(
        torch.zeros((S, 3)), _t(quats), torch.zeros(S, dtype=torch.bool),
        HALF, PARENT_HALF, robot, MARGIN, REACH)
    assert torch.equal(lt, want) and tuple(lt.shape) == (S, 640)
    blocks = torch.as_tensor(cmd.leg_blocks(quats, robot))
    assert torch.equal(cce.level_tables(_t(quats), HALF, PARENT_HALF, robot,
                                        MARGIN, REACH, blocks=blocks), lt)


def test_level_constants_come_from_the_host_copy():
    """F1: ``level_tables`` takes the host copy of the orientations (numpy
    or a CPU tensor, one table either way) and refuses a device tensor;
    ``build_cell_queue`` takes the cell size as a 0-d tensor made once a solve and
    gives the queue it gives for the float; ``hier_solver._upload`` keeps
    each array's dtype and shape, 0-d included."""
    from legmov_tpu_torch.models import hier_solver as ths

    fh, quats, centers, _ = _scene(seed=5)
    robot = trobot.get_moonbot_robot()
    lt = cce.level_tables(quats, HALF, PARENT_HALF, robot, MARGIN, REACH)
    assert lt.device.type == "cpu" and lt.dtype == torch.float32
    assert torch.equal(cce.level_tables(_t(quats), HALF, PARENT_HALF, robot,
                                        MARGIN, REACH), lt)
    with pytest.raises(ValueError, match="host copy"):
        cce.level_tables(torch.empty((S, 4), device="meta"), HALF,
                         PARENT_HALF, robot, MARGIN, REACH)
    lv = _Level(robot, fh, quats)
    c = lv.csr
    cs, flag, one = ths._upload(torch.device("cpu"),
                                np.asarray(c.cell_size, np.float32),
                                np.zeros(4, bool), np.ones((2, 3), np.int32))
    assert cs.shape == () and cs.dtype == torch.float32
    assert flag.dtype == torch.bool and one.shape == (2, 3)
    steps = cce.slab_queue_host_max(centers, ELONG, c.starts.numpy(),
                                    c.origin.numpy(), c.cell_size, c.dims,
                                    WINDOW)
    kw = dict(dims=c.dims, k=3, shared=True, window=WINDOW, q_steps=steps)
    args = (_t(centers), _t(ELONG), lv.rm, lv.rl, lv.rc, c.starts, c.origin)
    want = cce.build_cell_queue(*args, cell_size=c.cell_size, **kw)
    got = cce.build_cell_queue(*args, cell_size=cs, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want.tot.max()) > 0


@pytest.mark.parametrize("shared,k,masks", [(True, 3, True), (False, 4, True),
                                            (True, 4, False)])
def test_queue_against_brute_force(shared, k, masks):
    """Every foothold inside a cell's elongated box lies in exactly one live
    chunk of that cell, and every role bit is set wherever the plain item
    gives ok or crossed (leg bits), a valid item (V) or an edge item (E) on
    a chunk's own element: the superset property the skips rest on."""
    fh, quats, centers, pv = _scene(seed=4, n=6000)
    robot = trobot.get_moonbot_robot()
    lv = _Level(robot, fh, quats, window=128)
    q = lv.queue(centers, k, shared, masks)
    assert not bool(q.over)
    C, CH, _ = q.role.shape
    xs, ys, zs = (a.numpy() for a in (lv.csr.xs, lv.csr.ys, lv.csr.zs))
    pts = np.stack([xs, ys, zs], -1)
    cst, cln, tot = q.cst.numpy(), q.cln.numpy(), q.tot.numpy()
    assert tot.max() + 1 == CH and tot.max() > 13  # multi-chunk slabs
    for c in range(C):
        cover = np.zeros(pts.shape[0], np.int64)
        for ch in range(CH):
            assert (cln[c, ch] > 0) == (ch < tot[c])
            assert cln[c, ch] <= 128
            cover[cst[c, ch]:cst[c, ch] + cln[c, ch]] += 1
        rel = pts - centers[c]
        pre = np.all((rel > -ELONG) & (rel <= ELONG), axis=1)
        assert pre.any()
        assert (cover[pre] == 1).all() and cover.max() == 1
    # role bytes: supersets of what the plain item finds
    consts = cmd.dist_leg_constants(robot)
    cellinfo = torch.cat([_t(centers), torch.zeros(C, 1)], dim=1)
    wk = cce._Walk(q, cellinfo, lv.legtab, lv.csr.xs, lv.csr.ys, lv.csr.zs,
                   consts, k)
    rows = torch.arange(C)
    role = q.role.numpy().astype(np.int64)
    seen = np.zeros(8, bool)
    for ch in range(int(tot.max())):
        for qi in range(S):
            s, pre, vx, vy, vz = wk.head(rows, ch, qi)
            rc = np.zeros(tuple(pre.shape), np.int64)
            cc = np.zeros(tuple(pre.shape), np.int64)
            for l in range(4):
                okp, cr = cmd.item_leg_plain(s, l, consts[l], pre, vx, vy, vz)
                hit = (okp | cr).any(dim=1).numpy()
                assert ((role[:, ch, qi] >> l) & 1)[hit].all(), (ch, qi, l)
                seen[l] |= hit.any()
                rc += okp.numpy()
                cc += cr.numpy()
            v_hit = (rc >= k).any(axis=1)
            e_hit = (cc > 4 - k).any(axis=1)
            assert ((role[:, ch, qi] >> 6) & 1)[v_hit].all(), (ch, qi, "V")
            assert ((role[:, ch, qi] >> 7) & 1)[e_hit].all(), (ch, qi, "E")
            seen[6] |= v_hit.any()
            seen[7] |= e_hit.any()
    assert seen[:4].all() and seen[7]  # the draw exercises the bits
    # dead chunks carry no role
    live = np.arange(CH)[None, :] < tot[:, None]
    assert (role[~live] == 0).all()
    if masks:  # per-chunk masks are never wider than the per-slab ones
        wide = lv.queue(centers, k, shared, masks=False).role.numpy()
        assert ((role & ~wide.astype(np.int64)) == 0).all()
        assert (role != wide).any()


@pytest.mark.parametrize("shared,k", [(True, 3), (True, 4), (False, 3),
                                      (False, 4)])
def test_plain_forms_equal_jax_eval_cells(shared, k):
    """k=3 exercises partial-quorum V/E role masks; k=4 (= leg count) is the
    case where valid items only exist in the all-ball intersection."""
    fh, quats, centers, pv = _scene()
    want = _jax_flags(jrobot.get_moonbot_robot(), fh, quats, centers, pv, k,
                      shared, chunk=400)
    lv = _Level(trobot.get_moonbot_robot(), fh, quats)
    base = None
    for chunk_major in (True, False):
        for kw in ({}, {"audit": True}, {"chunk_masks": False},
                   {"plain": True}):
            got = lv.evaluate(centers, pv, k, shared, chunk_major=chunk_major,
                              **kw)
            assert len(got) == (5 if kw.get("audit") else 4)
            assert not bool(got[3])
            for g, w, name in zip(got[:3], want, ("valid", "edge", "leaf")):
                np.testing.assert_array_equal(
                    g.numpy(), w, err_msg=f"{name} cm={chunk_major} {kw}")
            if kw.get("audit"):
                cnt = got[4].numpy()
                assert cnt.shape == (CELLS, 7) and cnt.sum(axis=0)[0] > 0
                assert cnt.sum(axis=0)[2] >= cnt.sum(axis=0)[1]
                assert cnt.sum(axis=0)[5] >= cnt.sum(axis=0)[6] > 0
                base = base if base is not None else cnt
    if k == 3:
        assert want[0].sum() > 0 and want[1].sum() > 0


@pytest.mark.parametrize("shared", [True, False])
def test_flags_do_not_depend_on_the_skips(shared):
    """With every skip switched off (every role bit set, every live step
    walked with every leg) the three forms give the flags they give with
    them; the skips only save work."""
    fh, quats, centers, pv = _scene(seed=9)
    k = 3
    robot = trobot.get_moonbot_robot()
    lv = _Level(robot, fh, quats)
    q = lv.queue(centers, k, shared)
    consts = cmd.dist_leg_constants(robot)
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    args = (cellinfo, lv.legtab, lv.csr.xs, lv.csr.ys, lv.csr.zs, consts, k)
    forms = ([lambda qq, **kw: cce.cell_eval_shared_plain(qq, *args, **kw),
              lambda qq, **kw: cce.cell_eval_quat_major_plain(
                  qq, *args, True, **kw)] if shared else
             [lambda qq, **kw: cce.cell_eval_cm_perleg_plain(qq, *args, **kw),
              lambda qq, **kw: cce.cell_eval_quat_major_plain(
                  qq, *args, False, **kw)])
    full = q._replace(role=torch.where(q.cln[:, :, None] > 0, 255, 0).to(
        torch.uint8).expand_as(q.role).contiguous())
    ref = forms[0](q)
    assert tuple(ref.shape) == (CELLS, cmd.OUT_WORDS)
    assert ref[:, :2].any()
    for form in forms:
        with_skips = form(q)
        without = form(full, skips=False)
        assert torch.equal(with_skips[:, :3], ref[:, :3])
        assert torch.equal(without[:, :3], ref[:, :3])
        # and they do save work
        assert int(with_skips[:, 8].sum()) < int(without[:, 8].sum())
    if shared:
        # the shared kernel's per-element reach balls: the same flags, fewer
        # pipelines on elements inside the box; off without the skips
        balls = cce.element_balls(robot, lv.rc)
        with_balls = forms[0](q, balls=balls)
        assert torch.equal(with_balls[:, :3], ref[:, :3])
        assert int(with_balls[:, 9].sum()) < int(ref[:, 9].sum())
        assert torch.equal(forms[0](full, skips=False, balls=balls),
                           forms[0](full, skips=False))


@pytest.mark.parametrize("shared", [True, False])
def test_words_do_not_depend_on_the_order_of_the_cells(shared):
    """Each kernel walks a cell alone (a warp or a block of its own), so a
    cell's words may not depend on the other cells of the batch: the plain
    forms over a permuted queue, scattered back, give the flags and all 7
    counters of every cell in queue order."""
    fh, quats, centers, pv = _scene(seed=6)
    k = 3
    robot = trobot.get_moonbot_robot()
    lv = _Level(robot, fh, quats)
    q = lv.queue(centers, k, shared)
    o = torch.from_numpy(np.random.default_rng(6).permutation(CELLS))
    consts = cmd.dist_leg_constants(robot)
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    permuted = cce.CellQueue(q.cst[o], q.cln[o], q.role[o], q.tot[o], q.over)
    tail = (lv.legtab, lv.csr.xs, lv.csr.ys, lv.csr.zs, consts, k)
    balls = cce.element_balls(robot, lv.rc)
    forms = ([lambda qq, ci: cce.cell_eval_shared_plain(qq, ci, *tail),
              lambda qq, ci: cce.cell_eval_shared_plain(qq, ci, *tail,
                                                        balls=balls)]
             if shared else [])
    forms.append(lambda qq, ci: cce.cell_eval_quat_major_plain(
        qq, ci, *tail, shared))
    for form in forms:
        want = form(q, cellinfo)
        got = form(permuted, cellinfo[o])
        back = torch.empty_like(got)
        back[o] = got
        assert torch.equal(back, want)
        assert want[:, 3].sum() > 0


def _element_level(name):
    """A level for the per-element ball tests: ``_scene``'s moonbot level,
    or an M2 level as the depth-7 solve has it (20 mm cells, no margin, the
    solver's 27 orientations, of which every fourth)."""
    from legmov_tpu_torch.models import hier_solver as ths
    from legmov_tpu_torch.config import SolverConfig

    if name == "moonbot":
        _, quats, centers, _ = _scene(seed=9)
        return (trobot.get_moonbot_robot(), quats, centers[:3], HALF,
                PARENT_HALF, MARGIN, REACH)
    robot = trobot.get_m2_robot()
    quats = ths.orientation_samples(SolverConfig())[::4]
    half = np.full(3, 10.0, np.float32)
    centers = np.random.default_rng(3).uniform(-300, 300, (3, 3)).astype(
        np.float32)
    return (robot, quats, centers, half, 2 * half, 0.0,
            ths._total_reach(robot))


@pytest.mark.parametrize("name", ["moonbot", "m2"])
def test_element_balls_skip_only_what_the_pipeline_leaves_out(name):
    """The shared kernel's per-element test (plain arithmetic:
    ``_element_legs``) on footholds on thin shells just inside and just
    outside each leg's r_ok and r_in balls, inside the r_in ball, and on
    NaN, inf and SENTINEL rows: a leg it skips outside the chain gives
    neither ok nor crossed, and in the chain an element it drops has fewer
    than k ok legs while an element it keeps has its skipped legs give
    neither.  Its balls are the role masks' own, bit for bit."""
    robot, quats, centers, half, parent_half, margin, reach = \
        _element_level(name)
    L = trobot.leg_count(robot)
    qt = _t(quats)
    legtab = cce.level_tables(qt, half, parent_half, robot, margin, reach)
    rm, rl, rc = cce.ball_mask_params(qt, robot, half, margin)
    balls = cce.element_balls(robot, rc)
    r_ok, r_in = rl + float(cce._BALL_EPS), rl + rc
    assert torch.equal(balls.ok2, r_ok * r_ok)
    assert torch.equal(balls.in2, r_in * r_in)
    from legmov_tpu_torch.ops import quaternion as tq
    np.testing.assert_allclose(
        tq.rotate(qt[:, None, :], balls.mounts[None]).numpy(), rm.numpy(),
        atol=1e-3)
    consts = cmd.dist_leg_constants(robot)
    rng = np.random.default_rng(21)
    seen = np.zeros(4, bool)
    for c in centers:
        for q in range(quats.shape[0]):
            pts = []
            for l in range(L):
                bc = c + rm[q, l].numpy()
                for r in (float(r_ok[l]), float(r_in[l])):
                    for rr in (r - 0.05, r + 0.05):
                        d = rng.normal(size=(48, 3))
                        d /= np.linalg.norm(d, axis=1, keepdims=True)
                        pts.append(bc + rr * d)
                u = rng.normal(size=(96, 3))
                u *= (float(r_in[l]) * rng.random((96, 1)) ** (1 / 3)
                      / np.linalg.norm(u, axis=1, keepdims=True))
                pts.append(bc + u)
            pts = np.concatenate(pts).astype(np.float32)
            pts[:3] = [np.nan, np.inf, -np.inf]
            pts[3] = cce.SENTINEL
            xs, ys, zs = (torch.from_numpy(
                np.ascontiguousarray(pts[None, :, i])) for i in range(3))

            def s(i):
                if 4 <= i <= 6:
                    return torch.tensor(float(c[i - 4]))
                return legtab[q, i] if i != 7 else torch.tensor(0.0)

            pre, vx, vy, vz = cmd.item_head_plain(s, xs, ys, zs)
            assert not pre[0, :4].any()
            outs = [cmd.item_leg_plain(s, l, consts[l], pre, vx, vy, vz)
                    for l in range(L)]
            ok = torch.stack([o[0] for o in outs], dim=-1)[0]
            cr = torch.stack([o[1] for o in outs], dim=-1)[0]
            p0 = pre[0]
            all_legs = torch.tensor([(1 << L) - 1])
            for chain in (False, True):
                for k in ((L, L - 1) if chain else (L,)):
                    legs = cce._element_legs(
                        balls, all_legs, k, torch.tensor([not chain]), vx,
                        vy, vz)[0]
                    run = ((legs[:, None] >> torch.arange(L)) & 1) != 0
                    kept = p0 & (legs != 0)
                    skipped = kept[:, None] & ~run
                    assert not (ok & skipped).any() and not (
                        cr & skipped).any(), (name, chain, k)
                    if chain:
                        dropped = p0 & (legs == 0)
                        assert (ok[dropped].sum(dim=1) < k).all()
                    else:
                        assert not (legs[:4] != 0).any()
                        seen[:2] |= (bool((p0 & ~run.all(1)).any()),
                                     bool((p0 & run.any(1)).any()))
            seen[2] |= bool(ok.any())
            seen[3] |= bool(cr.any())
    assert seen.all(), seen  # skips and runs, ok and crossed, all reached


def test_ball_params_switch_the_test_on_in_a_copy():
    """``ball_params`` sets the kernel's ball fields in a copy of the
    parameter block and refuses balls of another leg count; the wrapper
    on CPU tensors is the plain version with the same balls, and refuses
    a block without them."""
    robot = trobot.get_moonbot_robot()
    consts = cmd.dist_leg_constants(robot)
    base = cmd.item_params(consts, 3)
    balls = cce.element_balls(robot, 60.0)
    p = cce.ball_params(base, balls)
    assert base.balls == 0 and p.balls == 1 and p.k == 3
    f = cmd._ItemParams
    for lo, hi in ((0, f.balls.offset), (f.margin2.offset, f.ball_x.offset)):
        assert bytes(p)[lo:hi] == bytes(base)[lo:hi]
    for l in range(4):
        assert (p.ball_x[l], p.ball_y[l], p.ball_z[l]) == tuple(
            float(v) for v in balls.mounts[l])
        assert p.ball_ok2[l] == float(balls.ok2[l])
        assert p.ball_in2[l] == float(balls.in2[l])
    with pytest.raises(ValueError, match="legs"):
        cce.ball_params(
            base, cce.element_balls(trobot.get_moonbot_robot(
                trobot.HEX_MOUNTS), 60.0))
    fh, quats, centers, pv = _scene(seed=9)
    lv = _Level(robot, fh, quats)
    q = lv.queue(centers, 3, True)
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    tail = (lv.legtab, lv.csr.xs, lv.csr.ys, lv.csr.zs, consts, 3)
    b = cce.element_balls(robot, lv.rc)
    want = cce.cell_eval_shared_plain(q, cellinfo, *tail, balls=b)
    assert torch.equal(cce.cell_eval_shared(q, cellinfo, *tail, WINDOW, b),
                       want)
    assert torch.equal(
        cce.cell_eval_shared(q, cellinfo, *tail, WINDOW, b,
                             cce.ball_params(base, b)), want)
    with pytest.raises(ValueError, match="balls"):
        cce.cell_eval_shared(q, cellinfo, *tail, WINDOW, b, base)


@pytest.mark.parametrize("mounts,k,seed", [("quad", 3, 9), ("quad", 4, 9),
                                           ("quad", 4, 11), ("hex", 4, 2),
                                           ("hex", 3, 12)])
def test_element_balls_keep_every_flag_and_cut_the_pipelines(mounts, k,
                                                             seed):
    """The shared walk with the per-element balls against the walk
    without: the same flags and chunk and item counters; no more leg
    passes (the chain's vote can stop sooner), and fewer pipelines."""
    robot = trobot.get_moonbot_robot(
        trobot.QUAD_MOUNTS if mounts == "quad" else trobot.HEX_MOUNTS)
    fh, quats, centers, pv = (_tall_scene(seed) if seed > 10
                              else _scene(seed=seed))
    lv = _Level(robot, fh, quats)
    q = lv.queue(centers, k, True)
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    tail = (lv.legtab, lv.csr.xs, lv.csr.ys, lv.csr.zs,
            cmd.dist_leg_constants(robot), k)
    off = cce.cell_eval_shared_plain(q, cellinfo, *tail)
    on = cce.cell_eval_shared_plain(q, cellinfo, *tail,
                                    balls=cce.element_balls(robot, lv.rc))
    same = [0, 1, 2, 3, 4, 6, 7]
    assert torch.equal(on[:, same], off[:, same])
    assert (on[:, [5, 8]] <= off[:, [5, 8]]).all()
    assert int(on[:, 9].sum()) < int(off[:, 9].sum())
    assert (on[:, 9] <= off[:, 9]).all()


def test_hexapod_shared_four_of_six_equals_jax():
    """L = 6: six leg bits per role byte, 3 x 6 run bits per orientation."""
    fh, quats, centers, pv = _scene(seed=2)
    k = 4
    want = _jax_flags(jrobot.get_moonbot_robot(jrobot.HEX_MOUNTS), fh, quats,
                      centers, pv, k, True, chunk=400)
    robot = trobot.get_moonbot_robot(trobot.HEX_MOUNTS)
    lv = _Level(robot, fh, quats)
    for chunk_major in (True, False):
        got = lv.evaluate(centers, pv, k, True, chunk_major=chunk_major)
        for g, w in zip(got[:3], want):
            np.testing.assert_array_equal(g.numpy(), w)
    # the per-leg forms agree with each other on six legs
    a = lv.evaluate(centers, pv, k, False, chunk_major=True)
    b = lv.evaluate(centers, pv, k, False, chunk_major=False)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert a[0].any()
    assert lv.legtab.shape == (S, 1024)


def test_wrappers_run_the_plain_versions_on_cpu_tensors_and_check_shapes():
    fh, quats, centers, pv = _scene()
    robot = trobot.get_moonbot_robot()
    lv = _Level(robot, fh, quats)
    q = lv.queue(centers, 3, True)
    consts = cmd.dist_leg_constants(robot)
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    tail = (lv.legtab, lv.csr.xs, lv.csr.ys, lv.csr.zs, consts, 3)
    b = cce.element_balls(robot, lv.rc)
    before = (cce.cell_eval_quat_major.launches, cce.cell_eval_shared.launches,
              cce.cell_eval_cm_perleg.launches)
    assert torch.equal(
        cce.cell_eval_shared(q, cellinfo, *tail, WINDOW, b),
        cce.cell_eval_shared_plain(q, cellinfo, *tail, balls=b))
    assert torch.equal(
        cce.cell_eval_quat_major(q, cellinfo, *tail, False, WINDOW),
        cce.cell_eval_quat_major_plain(q, cellinfo, *tail, False))
    assert torch.equal(
        cce.cell_eval_cm_perleg(q, cellinfo, *tail, WINDOW),
        cce.cell_eval_cm_perleg_plain(q, cellinfo, *tail))
    assert before == (cce.cell_eval_quat_major.launches,
                      cce.cell_eval_shared.launches,
                      cce.cell_eval_cm_perleg.launches)
    assert cmd._bound is None  # nothing was built
    with pytest.raises(ValueError):
        cce.cell_eval_shared(q, cellinfo[:4].contiguous(), *tail, WINDOW, b)
    with pytest.raises(ValueError):
        cce.cell_eval_shared(q, cellinfo, lv.legtab[:2].contiguous(),
                             *tail[1:], WINDOW, b)
    with pytest.raises(TypeError):
        cce.cell_eval_shared(q._replace(role=q.role.to(torch.int32)),
                             cellinfo, *tail, WINDOW, b)
    with pytest.raises(ValueError):
        cce.cell_eval_shared(q, cellinfo, *tail, cce.MAX_WINDOW + 1, b)
    with pytest.raises(ValueError):
        cce.make_csr_cell_eval(robot, k=3, n_quats=S, cells=16)(
            _t(centers), _t(pv), lv.legtab, _t(ELONG), lv.rm, lv.rl, lv.rc,
            lv.csr.xs, lv.csr.ys, lv.csr.zs, lv.csr.starts, lv.csr.origin,
            cell_size=lv.csr.cell_size, dims=lv.csr.dims)
    # an undersized queue is reported, not silently truncated
    short = lv.queue(centers, 3, True, steps=2)
    assert bool(short.over) and short.role.shape[1] == 2
    # no cells, and cells far from every foothold
    none = lv.evaluate(centers[:0], pv[:0], 3, True)
    assert all(t.numel() == 0 for t in none[:3])
    far = lv.evaluate(centers + np.float32(1e6), pv, 3, True)
    assert not far[0].any() and not far[1].any()  # pv needs a candidate too


def _tall_scene(seed):
    """``_scene`` with the cells spread from 50 to 650 mm above the
    footholds' band: some reach it with every leg, some with a few, some
    not at all, so that valid and edge are each true and false, and every
    mark of the chunk-major per-leg walk is reached."""
    fh, quats, centers, pv = _scene(seed=seed)
    centers[:, 2] = np.random.default_rng(seed + 100).uniform(50, 650, CELLS)
    return fh, quats, centers, pv


def _cm_walks(lv, q, centers, pv, k, every=True):
    """The chunk-major per-leg walk on queue ``q`` with its exit and the
    quat-major walk; with ``every`` also the walk without the exit (the
    walk before it) and the walk with no skip at all."""
    consts = cmd.dist_leg_constants(lv.robot)
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    args = (cellinfo, lv.legtab, lv.csr.xs, lv.csr.ys, lv.csr.zs, consts, k)
    walks = {"exit": cce.cell_eval_cm_perleg_plain(q, *args),
             "quat-major": cce.cell_eval_quat_major_plain(q, *args, False)}
    if every:
        full = q._replace(role=torch.where(q.cln[:, :, None] > 0, 255, 0).to(
            torch.uint8).expand_as(q.role).contiguous())
        walks["no exit"] = cce.cell_eval_cm_perleg_plain(q, *args,
                                                         exits=False)
        walks["no skip"] = cce.cell_eval_cm_perleg_plain(full, *args,
                                                         skips=False)
    return walks


def _perleg_flags(words, pv):
    """valid, edge, leaf as the per-leg rule's caller reads the words."""
    valid = (words[:, 0] > 0).numpy() | pv
    edge = (words[:, 1] > 0).numpy()
    return valid, edge, valid & ~edge


@pytest.mark.parametrize("seed,k", [(11, 3), (11, 4), (12, 4)])
def test_cm_perleg_exit_keeps_the_flags_and_cuts_the_work(seed, k):
    """The chunk-major per-leg walk with its exit gives JAX ``_eval_cells``'
    flags, as do the walk without the exit, the walk with no skip and the
    quat-major walk; on this draw the exit fires (some cell walks fewer
    chunks than without it) and the evaluated (chunk, orientation) items,
    leg pipelines and the elements behind them fall.  (Chunk visits may
    not: a new edge candidate walks the chunks again from the first.)"""
    fh, quats, centers, pv = _tall_scene(seed)
    want = _jax_flags(jrobot.get_moonbot_robot(), fh, quats, centers, pv, k,
                      False, chunk=400)
    assert want[0].any() and not want[0].all()
    assert want[1].any() and not want[1].all()
    lv = _Level(trobot.get_moonbot_robot(), fh, quats)
    q = lv.queue(centers, k, False)
    walks = _cm_walks(lv, q, centers, pv, k)
    for name, words in walks.items():
        for g, w, flag in zip(_perleg_flags(words, pv), want,
                              ("valid", "edge", "leaf")):
            np.testing.assert_array_equal(g, w, err_msg=f"{flag} {name}")
    ex, no = walks["exit"][:, 3:], walks["no exit"][:, 3:]
    assert (ex[:, 0] < no[:, 0]).any()
    work = [1, 2, 4, 5, 6]
    assert (ex.sum(dim=0)[work] < no.sum(dim=0)[work]).all()
    assert (walks["no exit"][:, 3:].sum(dim=0)
            <= walks["no skip"][:, 3:].sum(dim=0)).all()
    # the CPU wrapper is the walk with its exit
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    assert torch.equal(
        cce.cell_eval_cm_perleg(q, cellinfo, lv.legtab, lv.csr.xs, lv.csr.ys,
                                lv.csr.zs, cmd.dist_leg_constants(lv.robot),
                                k, WINDOW), walks["exit"])


@pytest.mark.parametrize("k", [3, 4])
def test_cm_perleg_walk_over_more_than_32_orientations(k):
    """The kernel keeps orientations q and q + 32 in one lane: 34
    orientations, the first 17 twice over, give the flags that the walk
    with its exit gives over the 17, and so does the quat-major walk."""
    fh, _, centers, pv = _tall_scene(13)
    rpy = np.random.default_rng(13).uniform(-0.3, 0.3, (17, 3)).astype(
        np.float32)
    q17 = np.array(jq.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]), np.float32)
    q17[0] = [1, 0, 0, 0]
    few = slice(0, 4)
    centers, pv = centers[few], pv[few]
    robot = trobot.get_moonbot_robot()
    lv = _Level(robot, fh, q17, window=1024)
    consts = cmd.dist_leg_constants(robot)
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    want = np.stack(_perleg_flags(cce.cell_eval_cm_perleg_plain(
        lv.queue(centers, k, False), cellinfo, lv.legtab, lv.csr.xs,
        lv.csr.ys, lv.csr.zs, consts, k), pv))
    assert want[0].any() and want[1].any()
    lv = _Level(robot, fh, np.concatenate([q17, q17]), window=1024)
    q = lv.queue(centers, k, False)
    assert q.role.shape[2] == 34
    for name, words in _cm_walks(lv, q, centers, pv, k,
                                 every=False).items():
        np.testing.assert_array_equal(np.stack(_perleg_flags(words, pv)),
                                      want, err_msg=name)


def test_cm_perleg_words_do_not_depend_on_the_order_of_the_cells():
    """K6c walks a cell in a warp of its own: the walk with its exit over a
    permuted queue, scattered back, gives every cell's ten words (so that
    a batch may also be checked in slices)."""
    fh, quats, centers, pv = _tall_scene(12)
    k = 4
    robot = trobot.get_moonbot_robot()
    lv = _Level(robot, fh, quats)
    q = lv.queue(centers, k, False)
    o = torch.from_numpy(np.random.default_rng(12).permutation(CELLS))
    cellinfo = torch.cat([_t(centers), _t(pv)[:, None].float()], dim=1)
    tail = (lv.legtab, lv.csr.xs, lv.csr.ys, lv.csr.zs,
            cmd.dist_leg_constants(robot), k)
    want = cce.cell_eval_cm_perleg_plain(q, cellinfo, *tail)
    got = cce.cell_eval_cm_perleg_plain(
        cce.CellQueue(q.cst[o], q.cln[o], q.role[o], q.tot[o], q.over),
        cellinfo[o], *tail)
    back = torch.empty_like(got)
    back[o] = got
    assert torch.equal(back, want)
    halves = torch.cat([cce.cell_eval_cm_perleg_plain(
        cce.CellQueue(q.cst[s], q.cln[s], q.role[s], q.tot[s], q.over),
        cellinfo[s], *tail) for s in (slice(0, 3), slice(3, CELLS))])
    assert torch.equal(halves, want)

"""PyTorch port: ops/trig32.py's float32 ``sin``, ``cos``, ``atan2``,
``asin`` and ``sqrt`` against the JAX package's (``jnp`` on the CPU, jitted),
the tables built with them against the JAX package's, bit for bit, and the
plain square roots at the circles' band edges (ROADMAP.md, faults F2 and
F3).

Every comparison is of bits (NaN against NaN); no tolerance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legmov_tpu.models import hier_solver as jhs
from legmov_tpu.models import robot as jrobot
from legmov_tpu.models.workspace import build_workspace as j_build_workspace
from legmov_tpu.ops import orientation as jori
from legmov_tpu.ops import pallas_multileg_dist as jd
from legmov_tpu.ops import quaternion as jq
import legmov_tpu as J
import legmov_tpu_torch as T
from legmov_tpu_torch.models import hier_solver as ths
from legmov_tpu_torch.models import robot as trobot
from legmov_tpu_torch.models.workspace import build_workspace
from legmov_tpu_torch.ops import csr_cell_eval as cce
from legmov_tpu_torch.ops import cuda_multileg_dist as cmd
from legmov_tpu_torch.ops import orientation as tori
from legmov_tpu_torch.ops import quaternion as tq
from legmov_tpu_torch.ops import trig32

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

N = 1_000_000
F32 = np.float32
ROBOTS = {
    "quad_moonbot": (jrobot.get_moonbot_robot, trobot.get_moonbot_robot, ()),
    "quad_m2": (jrobot.get_m2_robot, trobot.get_m2_robot, ()),
    "hex_m2": (jrobot.make_robot, trobot.make_robot, ("HEX_MOUNTS",)),
}
tr = importlib.import_module("legmov_tpu_torch.ops.reachability")
jr = importlib.import_module("legmov_tpu.ops.reachability")


def _robots(name):
    jf, tf, args = ROBOTS[name]
    return (jf(*[getattr(jrobot, a) for a in args]),
            tf(*[getattr(trobot, a) for a in args]))


def _same_bits(got, want, what, flushed=False):
    """Bit equality, NaN against NaN.  ``flushed``: where ``want`` is a zero
    and ``got`` a subnormal of the same sign, XLA:CPU flushed a subnormal
    result to zero (its arithmetic runs with flush-to-zero); those count as
    equal, and nothing else does."""
    got = np.asarray(got, F32)
    want = np.asarray(want, F32)
    assert got.shape == want.shape, what
    bad = (got.view(np.uint32) != want.view(np.uint32)) & ~(
        np.isnan(got) & np.isnan(want))
    if flushed:
        sub = (np.abs(got) < np.finfo(F32).tiny) & (want == 0) & (
            np.signbit(got) == np.signbit(want))
        bad &= ~sub
    idx = np.flatnonzero(bad.reshape(-1))[:5]
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {got.size} differ, e.g. "
        f"{[(got.reshape(-1)[i], want.reshape(-1)[i]) for i in idx]}")


def _specials(subnormal=True):
    """Zeros, NaN, infinities, pi/2, pi, two turns and the branch points of
    the algorithms, both signs.  ``subnormal=False`` leaves out subnormal
    inputs: XLA:CPU's arithmetic treats them as zero (and flushes subnormal
    results), which trig32 does not copy (no table gets near them)."""
    pi = F32(np.pi)
    big = [F32(0.75), np.nextafter(F32(0.75), F32(0)), F32(2.0 ** -12),
           np.nextafter(F32(2.0 ** -12), F32(0)), F32(120.0),
           np.nextafter(F32(120.0), F32(0)), F32(1e5), F32(3.4e38),
           F32(1e-30), pi / 2, pi, 2 * pi, F32(4 * np.pi), F32(1.0),
           F32(np.inf)] + ([F32(1e-40), F32(1.4e-45)] if subnormal else [])
    v = np.asarray(big, F32)
    return np.concatenate([[0.0, -0.0, np.nan], v, -v]).astype(F32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("part", ["angles", "every_magnitude"])
def test_sincos_equal_xla(part):
    """``sin``/``cos`` against jitted ``jnp.sin``/``jnp.cos`` on 10^6 seeded
    inputs: the angles the tables take (half angles of quaternions and the
    limits shifted by a pitch, within two turns), or every magnitude from
    1e-6 to 3e38 (glibc's large-argument reduction), plus the specials."""
    rng = np.random.default_rng(71)
    if part == "angles":
        x = rng.uniform(-4 * np.pi, 4 * np.pi, N)
    else:
        x = rng.choice([-1, 1], N) * 10.0 ** rng.uniform(-6, 38.5, N)
    x = np.concatenate([x.astype(F32), _specials()])
    s, c = trig32.sincos(_t(x))
    assert s.dtype == c.dtype == torch.float32
    _same_bits(s.numpy(), jax.jit(jnp.sin)(x), "sin")
    _same_bits(c.numpy(), jax.jit(jnp.cos)(x), "cos")
    _same_bits(trig32.sin(_t(x[:1000])).numpy(), s.numpy()[:1000], "sin()")
    _same_bits(trig32.cos(_t(x[:1000])).numpy(), c.numpy()[:1000], "cos()")


def test_atan2_equals_xla():
    """``atan2`` against jitted ``jnp.arctan2``: 10^6 seeded pairs from the
    range ``to_rpy`` gives it and across magnitudes (quotients whose
    arctangent is a normal number), and every pair of specials (zeros of
    both signs, infinities, NaN, x = 1)."""
    rng = np.random.default_rng(72)
    y = rng.uniform(-2, 2, N // 2)
    x = rng.uniform(-2, 2, N // 2)
    scale = 10.0 ** rng.uniform(-10, 10, (2, N // 2))
    sp = _specials(subnormal=False)
    gy, gx = np.meshgrid(sp, sp)
    y = np.concatenate([y, y * scale[0], gy.ravel(),
                        rng.uniform(-3, 3, 1000)]).astype(F32)
    x = np.concatenate([x, x * scale[1], gx.ravel(),
                        np.ones(1000)]).astype(F32)
    _same_bits(trig32.atan2(_t(y), _t(x)).numpy(),
               jax.jit(jnp.arctan2)(y, x), "atan2", flushed=True)


def test_asin_and_sqrt_equal_xla():
    """``asin`` against jitted ``jnp.arcsin`` on 10^6 seeded inputs in
    [-1, 1] and the specials; ``sqrt`` correctly rounded (numpy's and XLA's
    square root) on 10^6 seeded inputs and the specials, where float32
    ``torch.sqrt`` on the CPU is not."""
    rng = np.random.default_rng(73)
    a = np.concatenate([rng.uniform(-1, 1, N).astype(F32),
                        _specials(subnormal=False),
                        np.asarray([1.0000001, -1.0000001], F32)])
    _same_bits(trig32.asin(_t(a)).numpy(), jax.jit(jnp.arcsin)(a), "asin")
    r = np.concatenate([rng.uniform(0, 4e5, N).astype(F32),
                        np.abs(_specials(subnormal=False))])
    got = trig32.sqrt(_t(r)).numpy()
    _same_bits(got, np.sqrt(r), "sqrt against numpy")
    _same_bits(got, jax.jit(jnp.sqrt)(r), "sqrt against jnp")
    tiny = np.asarray([1e-40, 1.4e-45, 1e-38], F32)
    _same_bits(trig32.sqrt(_t(tiny)).numpy(), np.sqrt(tiny),
               "sqrt of subnormals")
    _same_bits(trig32.sqrt(_t(np.asarray([-1.0, -0.0], F32))).numpy(),
               np.asarray([np.nan, -0.0], F32), "sqrt of negatives")
    assert trig32._HPI1 + trig32._HPI2 == trig32._HPI
    assert (trig32._HPI - trig32._HPI1) - trig32._HPI2 == 0.0


def test_host_sincos_is_the_tensor_form():
    angles = [-0.7853981852531433, 2.0943951, 1e-9, 130.0, -3.0]
    s, c = trig32.host_sincos(angles)
    ts, tc = trig32.sincos(torch.tensor(angles, dtype=torch.float32))
    assert s == ts.tolist() and c == tc.tolist()
    assert all(isinstance(v, float) for v in s + c)


def _quats(n, seed, spread=0.5):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-spread, spread, (n, 3)).astype(F32)
    return rpy, np.array(jq.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]))


@pytest.mark.parametrize("fn", ["from_rpy", "from_axis_angle", "to_rpy",
                                "pitch_in_frame", "orientation_samples"])
def test_quaternion_functions_equal_jax_bit_for_bit(fn):
    """Each quaternion function the tables start from, on seeded inputs
    (the JAX side eager, as its tables are built)."""
    rpy, q = _quats(512, 74, spread=1.5)
    if fn == "from_rpy":
        got = tq.from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2])
        want = q
    elif fn == "from_axis_angle":
        axis = np.random.default_rng(75).normal(size=(512, 3)).astype(F32)
        ang = (rpy[:, 0] * 4).astype(F32)
        got = tq.from_axis_angle(_t(axis), _t(ang))
        want = jq.from_axis_angle(jnp.asarray(axis), jnp.asarray(ang))
    elif fn == "to_rpy":
        got = tq.to_rpy(_t(q))
        want = jq.to_rpy(jnp.asarray(q))
    elif fn == "pitch_in_frame":
        yaw = np.random.default_rng(76).uniform(-np.pi, np.pi, 512).astype(F32)
        got = tq.pitch_in_frame(_t(q), _t(yaw))
        want = jq.pitch_in_frame(jnp.asarray(q), jnp.asarray(yaw))
        _same_bits(tq.pitch_in_frames(_t(q), *tq.frame_quats(yaw)).numpy(),
                   got.numpy(), "pitch_in_frames")
    else:
        from legmov_tpu.config import SolverConfig as JConfig
        from legmov_tpu_torch.config import SolverConfig as TConfig

        got = ths.orientation_samples(TConfig())
        want = jhs.orientation_samples(JConfig())
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    _same_bits(got, want, fn)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_oriented_workspaces_equal_jax_bit_for_bit(name):
    """``rotate_leg_data`` and ``build_workspace`` of every leg under
    seeded orientations (and the identity): every field, bit for bit."""
    j, t = _robots(name)
    _, q = _quats(4, 77)
    q[0] = tq.IDENTITY
    for p in range(q.shape[0]):
        for l in range(trobot.leg_count(t)):
            jl = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[l]), j)
            jo = jori.rotate_leg_data(jnp.asarray(q[p]), jl)
            to = tori.rotate_leg_data(_t(q[p]), trobot.leg_of(t, l))
            for k in ("tibia_absolute_pos", "tibia_absolute_neg"):
                _same_bits(np.asarray(getattr(to, k)),
                           np.asarray(getattr(jo, k)), f"{k} {p} {l}")
            want = j_build_workspace(jo)
            got = build_workspace(to)
            for k in want._fields:
                _same_bits(np.asarray(getattr(got, k), F32),
                           np.asarray(getattr(want, k), F32),
                           f"{name} pose {p} leg {l} {k}")


HALF = np.asarray([20.0, 20.0, 20.0], F32)
PARENT_HALF = np.asarray([40.0, 40.0, 40.0], F32)


@pytest.mark.parametrize("name", list(ROBOTS))
def test_leg_blocks_and_level_tables_equal_jax(name):
    """K5's leg blocks (``leg_blocks``) and the K6 level tables
    (``level_tables``, built on the host from the host quaternions) against
    the JAX package's ``oriented_dist_tables``, bit for bit."""
    j, t = _robots(name)
    L = trobot.leg_count(t)
    _, q = _quats(9, 78)
    want = np.asarray(jd.oriented_dist_tables(
        jnp.zeros((9, 3), jnp.float32), jnp.asarray(q),
        jnp.zeros(9, bool), jnp.asarray(HALF), jnp.asarray(PARENT_HALF), j,
        16.0, 711.0))
    blocks = cmd.leg_blocks(q, t)
    _same_bits(blocks, want[:, cmd._HDR:cmd._HDR + L * cmd.LEG_BLOCK],
               "leg_blocks")
    lt = cce.level_tables(q, HALF, PARENT_HALF, t, 16.0, 711.0)
    assert lt.device.type == "cpu"
    _same_bits(lt.numpy(), want, "level_tables")
    _same_bits(cce.level_tables(_t(q), HALF, PARENT_HALF, t, 16.0,
                                711.0).numpy(), want, "from a CPU tensor")


def _band_edge_points(leg, thetas, phis, steps):
    """World points whose coxa-plane coordinates lie on the edges of every
    circle's margin band (r +- 0.001 mm: where a circle test changes), built
    in float64 and rounded once, then moved by ``steps`` ulp along x."""
    ws = build_workspace(leg)
    cx, cy, r = (np.asarray(a, np.float64).reshape(-1)
                 for a in (ws.circle_x, ws.circle_y, ws.circle_r))
    pitch, body = float(leg.coxa_pitch), float(leg.body)
    cl = float(leg.coxa_length)
    cp, sp = np.cos(-pitch), np.sin(-pitch)
    pts = []
    for k in range(cx.size):
        for rr in (r[k] + 1e-3, r[k] - 1e-3):
            for th in thetas:
                rho = cx[k] + rr * np.cos(th) + cl
                z = cy[k] + rr * np.sin(th)
                if rho <= 1.0:
                    continue
                for ph in phis:
                    x, y = rho * np.cos(ph), rho * np.sin(ph)
                    base = np.asarray([x * cp + z * sp + body, y,
                                       -x * sp + z * cp], F32)
                    for d in steps:
                        q = base.copy()
                        q[0] = q[0] + F32(d) * np.spacing(q[0])
                        pts.append(q)
    return np.asarray(pts, F32)


@pytest.mark.parametrize("leg", ["m2", "moonbot"])
def test_plain_roots_at_the_band_edges_equal_jax(leg, monkeypatch):
    """F3: the plain reachability (ops/reachability.py, ``rho =
    sqrt(x^2 + y^2)``) at footholds on the circles' band edges, one ulp
    apart along x, equals the JAX package's bit for bit.  The search
    reaches the case: a root one ulp low (what float32 ``torch.sqrt`` on
    the CPU gives for some inputs) flips bits there, and the count of
    those the CPU's own float32 ``torch.sqrt`` flips is printed."""
    jl, tl = {"m2": (J.get_m2_leg(), T.get_m2_leg()),
              "moonbot": (J.get_moonbot_leg(), T.get_moonbot_leg())}[leg]
    pts = _band_edge_points(tl, np.linspace(-2.5, 2.5, 161),
                            (-0.6, -0.2, 0.0, 0.3, 0.7), range(-3, 4))
    want = np.asarray(jr.reachability(jnp.asarray(pts), jl))
    assert 0.1 < want.mean() < 0.9
    got = tr.reachability(_t(pts), tl).numpy()
    np.testing.assert_array_equal(got, want)
    exact = trig32.sqrt

    def low(d):
        r = exact(d)
        return torch.nextafter(r, torch.zeros_like(r))

    monkeypatch.setattr(trig32, "sqrt", low)
    one_low = tr.reachability(_t(pts), tl).numpy()
    monkeypatch.setattr(trig32, "sqrt", torch.sqrt)
    cpu = tr.reachability(_t(pts), tl).numpy()
    print(f"{leg}: {pts.shape[0]} points; a root one ulp low flips "
          f"{int((one_low != want).sum())} bits, float32 torch.sqrt on this "
          f"CPU {int((cpu != want).sum())}")
    assert (one_low != want).sum() > 0

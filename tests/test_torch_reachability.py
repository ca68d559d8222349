"""PyTorch port: reachability vs the JAX package, on the CPU.

The same seeded points go through both sides; reachability booleans must be
EQUAL, NaN/inf rows included.  Held against each other: the JAX XLA entry
point, the JAX Pallas kernel in interpret mode (the very program
tests/test_pallas.py compiles: default factory arguments, (20000, 3)
points), the port's tensor formulation (ops/reachability.py), the plain
version of the port's CUDA kernel (which the wrappers run for CPU tensors)
and the port's scalar oracle.
"""

import ctypes
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import legmov_tpu as J
from legmov_tpu.models.workspace import build_workspace as j_build_workspace
from legmov_tpu.ops.pallas_kernels import (
    make_reachability_kernel as j_make_reachability_kernel,
)
import legmov_tpu_torch as T
from legmov_tpu_torch.models.workspace import workspace_from_numpy
from legmov_tpu_torch.ops import cuda_kernels as ck
from legmov_tpu_torch.ops.reachability import reachability_ws, reachability_xyz
from legmov_tpu_torch.oracle import oracle_reachability

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

LEGS = {
    "moonbot": (J.get_moonbot_leg, T.get_moonbot_leg),
    "m2": (J.get_m2_leg, T.get_m2_leg),
}


@pytest.fixture(scope="module")
def pts():
    """20000 uniform(-650, 650) points, the first 32 rows NaN/inf/0 mixes
    (same construction as tests/test_pallas.py)."""
    rng = np.random.default_rng(11)
    p = rng.uniform(-650, 650, (20000, 3)).astype(np.float32)
    p[:32] = np.array([np.nan, np.inf, -np.inf, 0.0], np.float32)[
        np.random.default_rng(3).integers(0, 4, (32, 3))
    ]
    return p


@pytest.mark.parametrize("name", list(LEGS))
def test_matches_jax_xla_and_pallas(name, pts):
    j_leg, t_leg = (f() for f in LEGS[name])
    want = np.asarray(J.reachability_batch(jnp.asarray(pts), j_leg))
    pallas = np.asarray(
        j_make_reachability_kernel(j_leg, interpret=True)(jnp.asarray(pts)))
    np.testing.assert_array_equal(pallas, want)

    got = T.reachability_batch(pts, t_leg, device="cpu")
    assert got.dtype == torch.bool and got.shape == (20000,)
    np.testing.assert_array_equal(got.numpy(), want)

    kr = ck.make_reachability_kernel(t_leg)
    plain = kr(torch.from_numpy(pts))
    assert plain.dtype == torch.bool and plain.shape == (20000,)
    np.testing.assert_array_equal(plain.numpy(), pallas)
    assert want.any() and not want[:32].any()


@pytest.mark.parametrize("name", list(LEGS))
def test_same_tables_carried_across(name, pts):
    """With the JAX workspace carried over, nothing but the per-point
    arithmetic differs between the two sides."""
    j_leg, _ = (f() for f in LEGS[name])
    j_ws = j_build_workspace(j_leg)
    ws = workspace_from_numpy(
        {k: np.asarray(v) for k, v in j_ws._asdict().items()})
    want = np.asarray(J.reachability_batch(jnp.asarray(pts), j_leg))
    t = torch.from_numpy(pts)
    np.testing.assert_array_equal(reachability_ws(t, ws).numpy(), want)
    np.testing.assert_array_equal(
        reachability_xyz(t[:, 0], t[:, 1], t[:, 2], ws).numpy(), want)
    consts = ck.reach_consts(ws)
    np.testing.assert_array_equal(
        ck.reachability_kernel_plain(t[:, 0], t[:, 1], t[:, 2], consts).numpy(),
        want)


@pytest.mark.parametrize("name", list(LEGS))
def test_matches_oracle(name, pts):
    _, t_leg = (f() for f in LEGS[name])
    sub = pts[32:1056]
    want = oracle_reachability(sub, t_leg)
    np.testing.assert_array_equal(
        T.reachability_batch(sub, t_leg, device="cpu").numpy(), want)
    kr = ck.make_reachability_kernel(t_leg)
    np.testing.assert_array_equal(kr(torch.from_numpy(sub)).numpy(), want)
    assert want.any() and (~want).any()


@pytest.mark.parametrize("n", [0, 1, 7, 129, 1000])
def test_ragged_and_empty(n, pts):
    j_leg, t_leg = (f() for f in LEGS["m2"])
    sub = pts[32:32 + n]
    want = np.asarray(J.reachability_batch(jnp.asarray(sub), j_leg))
    got = T.reachability_batch(sub, t_leg, device="cpu")
    assert got.shape == (n,) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    plain = ck.make_reachability_kernel(t_leg)(torch.from_numpy(sub))
    assert plain.shape == (n,) and plain.dtype == torch.bool
    np.testing.assert_array_equal(plain.numpy(), want)


def test_soa_entry_matches_aos(pts):
    kr = ck.make_reachability_kernel(T.get_m2_leg())
    t = torch.from_numpy(pts)
    x, y, z = (t[:, i].contiguous() for i in range(3))
    assert torch.equal(kr.soa(x, y, z), kr(t))


def test_constants_match_pallas_factory():
    """Six unique circles, every one with the interval collapse legal, for
    both shipped legs — what the Pallas factory bakes in."""
    for _, make in LEGS.values():
        c = ck.reach_consts(make())
        assert len(c.circles) == 6 and all(c.collapse)
        p = ck.reach_params(c)
        assert p.n_circles == 6
        for cfg in range(4):
            assert p.pos_mask[cfg] & p.neg_mask[cfg] == 0
            assert bin(p.pos_mask[cfg] | p.neg_mask[cfg]).count("1") == 4


def test_wrapper_rejects_bad_inputs(pts):
    kr = ck.make_reachability_kernel(T.get_m2_leg())
    t = torch.from_numpy(pts)
    with pytest.raises(TypeError):
        kr(pts)  # numpy, not a tensor
    with pytest.raises(ValueError):
        kr(t[:, :2])
    with pytest.raises(TypeError):
        kr(t.double())
    with pytest.raises(ValueError):
        kr.soa(t[:, 0], t[:100, 1], t[:, 2])
    with pytest.raises(ValueError):
        kr.soa(t[:, 0], t[:, 1].contiguous(), t[:, 2])  # strides 3, 1, 3


# ---------------------------------------------------------------------------
# the parameter block, its interval collapses, and a set of
# points that mixes the configurations within every warp
# ---------------------------------------------------------------------------

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "legmov_tpu_torch", "csrc", "leg_kernels.cu")


def _source():
    with open(SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("name", list(LEGS))
def test_mixed_set_matches_pallas(name):
    """On points whose every warp meets all four (upper, ext)
    configurations, valid and invalid queries (and NaN, +-inf, -0.0 rows),
    the plain version the wrappers run on the CPU equals the JAX Pallas
    kernel in interpret mode."""
    j_leg, t_leg = (f() for f in LEGS[name])
    p = ck.special_rows(ck.mixed_points(t_leg, 4096, 29)).numpy()
    want = np.asarray(
        j_make_reachability_kernel(j_leg, interpret=True)(jnp.asarray(p)))
    got = ck.make_reachability_kernel(t_leg)(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[64:].any() and not want[64:].all()


@pytest.mark.parametrize("name", list(LEGS))
def test_mixed_set_mixes_every_warp(name):
    """Every 32 consecutive points of ``mixed_points`` span K1's four
    configurations, valid and invalid queries and both of K2's dual-finish
    winners; the set is the same for a seed and another for another."""
    _, t_leg = (f() for f in LEGS[name])
    p = ck.mixed_points(t_leg, 2048, 31)
    assert p.shape == (2048, 3) and p.dtype == torch.float32
    x, y, z = (p[:, i].contiguous() for i in range(3))
    cfg = ck.reach_configuration(x, y, z, ck.reach_consts(t_leg))
    valid = ck.reachability_kernel_plain(x, y, z, ck.reach_consts(t_leg))
    use_d = ck._distance_parts(x, y, z, ck.dist_consts(t_leg)).use_d
    for lo in range(0, 2048 - 32 + 1, 7):
        w = slice(lo, lo + 32)
        assert set(cfg[w].tolist()) == {0, 1, 2, 3}
        assert valid[w].any() and (~valid[w]).any()
        assert use_d[w].any() and (~use_d[w]).any()
    assert torch.equal(p, ck.mixed_points(t_leg, 2048, 31))
    assert not torch.equal(p, ck.mixed_points(t_leg, 2048, 32))


@pytest.mark.parametrize("cleared", ["first", "all"])
@pytest.mark.parametrize("name", list(LEGS))
def test_collapse_cleared_gives_the_same_bits(name, cleared):
    """A parameter block with interval collapses cleared sends K1 to its
    generic instance, which then runs the full interval test for those
    circles; on the shipped legs, whose collapses are legal, the plain
    version gives the same booleans that way (NaN, +-inf and -0.0 rows
    included), which is what the card holds the generic instance to."""
    _, t_leg = (f() for f in LEGS[name])
    c = ck.reach_consts(t_leg)
    assert len(c.circles) == 6 and all(c.collapse)
    off = ((False,) + c.collapse[1:] if cleared == "first"
           else (False,) * len(c.collapse))
    p = ck.special_rows(ck.mixed_points(t_leg, 4096, 41))
    x, y, z = (p[:, i].contiguous() for i in range(3))
    want = ck.reachability_kernel_plain(x, y, z, c)
    got = ck.reachability_kernel_plain(x, y, z, c._replace(collapse=off))
    assert torch.equal(got, want)
    assert want[64:].any() and not want[64:].all()
    rp = ck.reach_params(c._replace(collapse=off))
    assert list(rp.collapse[:6]) == [int(v) for v in off]


def _c_struct_bytes(src, name):
    """Bytes of ``struct name`` in the source: every member is 4 bytes,
    arrays sized by literals or the source's #defines."""
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", src, re.S).group(1)
    words = 0
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        typ, names = decl.split(" ", 1)
        assert typ in ("float", "int", "unsigned"), decl
        for member in names.split(","):
            dims = re.findall(r"\[(\w+)\]", member)
            words += int(np.prod([int(defines.get(d, d)) for d in dims]))
    return 4 * words


def test_parameter_blocks_mirror_the_c_structs():
    src = _source()
    for name, block in (("ReachParams", ck._ReachParams),
                        ("DistParams", ck._DistParams)):
        assert ctypes.sizeof(block) == _c_struct_bytes(src, name)


@pytest.mark.parametrize("name", list(LEGS))
def test_reach_params_hold_the_constants(name):
    """The block the wrapper fills: each unique circle's linear form and
    collapse, and per configuration the circles its four slots test
    attractively and repulsively."""
    c = ck.reach_consts(LEGS[name][1]())
    p = ck.reach_params(c)
    assert (p.body, p.cp, p.sp, p.coxa_length) == (c.body, c.cp, c.sp,
                                                   c.coxa_length)
    assert p.n_circles == len(c.circles)
    for i, (ax, ay, r2k, hi2k, lo2k) in enumerate(c.circles):
        got = (p.ax[i], p.ay[i], p.r2k[i], p.hi2k[i], p.lo2k[i])
        assert got == tuple(float(np.float32(v))
                            for v in (ax, ay, r2k, hi2k, lo2k))
        assert p.collapse[i] == int(c.collapse[i])
    for r in range(2):
        for e in range(2):
            slots = c.slot_map[r][e]
            pos = sum(1 << ci for ci, a in slots if a)
            neg = sum(1 << ci for ci, a in slots if not a)
            assert (p.pos_mask[r * 2 + e], p.neg_mask[r * 2 + e]) == (pos, neg)
    assert p.mid_neg == int(c.mid.neg)
    assert [p.sat_neg[i] for i in range(2)] == [int(s.neg) for s in c.sat]

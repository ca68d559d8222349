"""PyTorch port: distance vs the JAX package, on the CPU.

The same seeded points go through the JAX XLA entry point, the JAX Pallas
kernel in interpret mode (the program tests/test_pallas.py compiles), the
port's tensor formulation (ops/distance.py) and the plain version of the
port's CUDA kernel.  Contract (tests/test_distance.py:32-40): ``ok`` equal;
norms rtol 5e-4, atol 2e-2; per-component agreement
``|d| <= 2e-2 + 2e-4 |v|`` on more than 99.5 % of the points.  The reason
for the slack: ties between equidistant boundary candidates flip under
float32 rounding, and the kernels' cross-product angle tests differ from
the ``atan2`` compares of the tensor path at the last ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import legmov_tpu as J
from legmov_tpu.models.workspace import build_workspace as j_build_workspace
from legmov_tpu.ops.pallas_kernels import (
    make_distance_kernel as j_make_distance_kernel,
)
import legmov_tpu_torch as T
from legmov_tpu_torch.models.leg import leg_factory
from legmov_tpu_torch.models.workspace import workspace_from_numpy
from legmov_tpu_torch.ops import cuda_kernels as ck
from legmov_tpu_torch.ops.distance import distance_ws
from legmov_tpu_torch.oracle import oracle_distance

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

LEGS = {
    "moonbot": (J.get_moonbot_leg, T.get_moonbot_leg),
    "m2": (J.get_m2_leg, T.get_m2_leg),
}


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(11)
    return rng.uniform(-650, 650, (20000, 3)).astype(np.float32)


def assert_distance_contract(ok_g, v_g, ok_w, v_w):
    ok_g, v_g, ok_w, v_w = (np.asarray(a) for a in (ok_g, v_g, ok_w, v_w))
    np.testing.assert_array_equal(ok_g, ok_w)
    np.testing.assert_allclose(
        np.linalg.norm(v_g, axis=1), np.linalg.norm(v_w, axis=1),
        rtol=5e-4, atol=2e-2,
    )
    comp_ok = np.all(np.abs(v_g - v_w) <= 2e-2 + 2e-4 * np.abs(v_w), axis=-1)
    assert comp_ok.mean() > 0.995, f"{(~comp_ok).sum()} vector mismatches"


@pytest.mark.parametrize("name", list(LEGS))
def test_matches_jax_xla_and_pallas(name, pts):
    j_leg, t_leg = (f() for f in LEGS[name])
    ok_x, v_x = J.distance_batch(jnp.asarray(pts), j_leg)
    ok_p, v_p = j_make_distance_kernel(j_leg, interpret=True)(jnp.asarray(pts))

    ok_t, v_t = T.distance_batch(pts, t_leg, device="cpu")
    assert ok_t.dtype == torch.bool and ok_t.shape == (20000,)
    assert v_t.dtype == torch.float32 and v_t.shape == (20000, 3)
    assert_distance_contract(ok_t.numpy(), v_t.numpy(), ok_x, v_x)
    assert_distance_contract(ok_t.numpy(), v_t.numpy(), ok_p, v_p)

    kd = ck.make_distance_kernel(t_leg)
    ok_k, v_k = kd(torch.from_numpy(pts))
    assert ok_k.dtype == torch.bool and v_k.shape == (20000, 3)
    assert_distance_contract(ok_k.numpy(), v_k.numpy(), ok_p, v_p)
    assert_distance_contract(ok_k.numpy(), v_k.numpy(), ok_x, v_x)
    assert np.asarray(ok_x).any()


@pytest.mark.parametrize("name", list(LEGS))
def test_same_tables_carried_across(name, pts):
    j_leg, _ = (f() for f in LEGS[name])
    j_ws = j_build_workspace(j_leg)
    ws = workspace_from_numpy(
        {k: np.asarray(v) for k, v in j_ws._asdict().items()})
    ok_x, v_x = J.distance_batch(jnp.asarray(pts), j_leg)
    ok_t, v_t = distance_ws(torch.from_numpy(pts), ws)
    assert_distance_contract(ok_t.numpy(), v_t.numpy(), ok_x, v_x)
    consts = ck.dist_consts(ws)
    t = torch.from_numpy(pts)
    ok_k, dx, dy, dz = ck.distance_kernel_plain(t[:, 0], t[:, 1], t[:, 2], consts)
    assert_distance_contract(
        ok_k.numpy(), torch.stack([dx, dy, dz], -1).numpy(), ok_x, v_x)


@pytest.mark.parametrize("name", list(LEGS))
def test_matches_oracle(name, pts):
    _, t_leg = (f() for f in LEGS[name])
    sub = pts[:1024]
    ok_o, v_o = oracle_distance(sub, t_leg)
    ok_t, v_t = T.distance_batch(sub, t_leg, device="cpu")
    assert_distance_contract(ok_t.numpy(), v_t.numpy(), ok_o, v_o)
    ok_k, v_k = ck.make_distance_kernel(t_leg)(torch.from_numpy(sub))
    assert_distance_contract(ok_k.numpy(), v_k.numpy(), ok_o, v_o)
    assert ok_o.any() and (~ok_o).any()


@pytest.mark.parametrize("n", [0, 1, 7, 129, 1000])
def test_ragged_and_empty(n, pts):
    j_leg, t_leg = (f() for f in LEGS["m2"])
    sub = pts[:n]
    ok_t, v_t = T.distance_batch(sub, t_leg, device="cpu")
    ok_k, v_k = ck.make_distance_kernel(t_leg)(torch.from_numpy(sub))
    for ok, v in ((ok_t, v_t), (ok_k, v_k)):
        assert ok.shape == (n,) and ok.dtype == torch.bool
        assert v.shape == (n, 3) and v.dtype == torch.float32
    if n:
        ok_x, v_x = J.distance_batch(jnp.asarray(sub), j_leg)
        # too few points for a share: every vector must agree
        for ok, v in ((ok_t, v_t), (ok_k, v_k)):
            np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_x))
            np.testing.assert_allclose(
                v.numpy(), np.asarray(v_x), rtol=2e-4, atol=2e-2)


def test_soa_entry_matches_aos(pts):
    kd = ck.make_distance_kernel(T.get_m2_leg())
    t = torch.from_numpy(pts)
    x, y, z = (t[:, i].contiguous() for i in range(3))
    ok_s, dx, dy, dz = kd.soa(x, y, z)
    ok_a, vec = kd(t)
    assert torch.equal(ok_s, ok_a)
    assert torch.equal(torch.stack([dx, dy, dz], dim=-1), vec)


def test_nan_rows_match_pallas(pts):
    """NaN/inf inputs: the plain version keeps the Pallas kernel's ``ok``
    (its attract bits come from ``xp == xp``)."""
    p = pts.copy()
    p[:32] = np.array([np.nan, np.inf, -np.inf, 0.0], np.float32)[
        np.random.default_rng(3).integers(0, 4, (32, 3))
    ]
    j_leg, t_leg = (f() for f in LEGS["m2"])
    ok_p, _ = j_make_distance_kernel(j_leg, interpret=True)(jnp.asarray(p))
    ok_k, _ = ck.make_distance_kernel(t_leg)(torch.from_numpy(p))
    np.testing.assert_array_equal(ok_k.numpy(), np.asarray(ok_p))


def test_unsupported_leg_raises():
    """Coxa limits past +-pi/2 put the mega thresholds outside (-pi, pi)."""
    wide = leg_factory(0.0, 181.0, 0.0, 65.5, 129.0, 160.0,
                       100.0, 90.0, 120.0, -5.0, -5.0)
    with pytest.raises(ValueError, match="mega-clamp"):
        ck.make_distance_kernel(wide)
    # the tensor formulation serves such a leg
    ok, vec = T.distance_batch(np.zeros((4, 3), np.float32), wide, device="cpu")
    assert ok.shape == (4,) and vec.shape == (4, 3)


def test_flop_counts():
    for _, make in LEGS.values():
        leg = make()
        assert ck.reach_flops_per_point(ck.reach_consts(leg)) == 74
    assert ck.dist_flops_per_point(ck.dist_consts(T.get_moonbot_leg())) == 579
    assert ck.dist_flops_per_point(ck.dist_consts(T.get_m2_leg())) == 591


# ---------------------------------------------------------------------------
# the point kernel's parameter block, the work a set of points needs, and a
# set that mixes configurations within every warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(LEGS))
def test_mixed_set_matches_pallas(name):
    """On points whose every warp meets all four configurations, valid and
    invalid queries and both dual-finish winners, the plain version the
    wrappers run on the CPU keeps the JAX Pallas kernel's ``ok`` (the 64
    NaN, +-inf and -0.0 rows included) and its vectors within the contract
    on the finite rows."""
    j_leg, t_leg = (f() for f in LEGS[name])
    p = ck.special_rows(ck.mixed_points(t_leg, 4096, 37)).numpy()
    ok_p, v_p = j_make_distance_kernel(j_leg, interpret=True)(jnp.asarray(p))
    ok_k, v_k = ck.make_distance_kernel(t_leg)(torch.from_numpy(p))
    np.testing.assert_array_equal(ok_k.numpy(), np.asarray(ok_p))
    assert_distance_contract(ok_k.numpy()[64:], v_k.numpy()[64:],
                             np.asarray(ok_p)[64:], np.asarray(v_p)[64:])
    assert np.asarray(ok_p)[64:].any() and not np.asarray(ok_p)[64:].all()


@pytest.mark.parametrize("name", list(LEGS))
def test_dist_params_hold_the_constants(name):
    """The block the wrapper fills: the 16 (configuration, slot) circles at
    ``(upper * 2 + ext) * 4 + slot``, their polarity, the live corners in
    order with their linear forms, and the five threshold directions."""
    c = ck.dist_consts(LEGS[name][1]())
    p = ck.dist_params(c)
    f32 = lambda v: float(np.float32(v))
    for r in range(2):
        for e in range(2):
            for s in range(4):
                i = (r * 2 + e) * 4 + s
                for short in ("x", "y", "r", "r2", "hi2", "lo2"):
                    field = {"x": "cx", "y": "cy"}.get(short, short)
                    assert getattr(p, field)[i] == f32(c.tabs[short][r][e][s])
                assert p.att[i] == int(c.att[r][e][s])
    assert p.n_corners == len(c.corners)
    for j, (pcx, pcy, ax, ay, kc) in enumerate(c.corners):
        assert (p.corner_x[j], p.corner_y[j], p.corner_ax[j], p.corner_ay[j],
                p.corner_k[j]) == tuple(f32(v) for v in (pcx, pcy, ax, ay, kc))
    for k, d in enumerate(c.dirs):
        assert (p.dir_c[k], p.dir_s[k], p.dir_neg[k]) == (f32(d.c), f32(d.s),
                                                         int(d.neg))
    assert (p.margin2, p.big) == (f32(c.margin2), f32(c.big))


def test_flops_needed_count_what_each_point_reads():
    """A point needs both branches' heads, the tail of each branch whose
    vector is read (both where the results agree, the winner's alone where
    they differ), and a tail's corners only for an invalid query: a far
    point all of it (dist_flops_per_point), a reachable point with one
    valid branch one tail and no corners."""
    leg = T.get_m2_leg()
    c = ck.dist_consts(leg)
    full = ck.dist_flops_per_point(c)
    head = 14 + 17 + 2 * ck.DIST_HEAD_FLOPS
    corner = full - head - 2 * ck.DIST_TAIL_FLOPS
    assert corner > 0 and corner % 2 == 0
    far = torch.tensor([[5e4, 0.0, 0.0]])
    assert ck.dist_flops_needed(*far.T.contiguous(), c) == full
    p = ck.mixed_points(leg, 4096, 41)
    x, y, z = (p[:, i].contiguous() for i in range(3))
    parts = ck._distance_parts(x, y, z, c)
    one = torch.nonzero(parts.res != parts.resf).flatten()
    assert one.numel() > 0
    i = int(one[0])
    assert ck.dist_flops_needed(x[i:i + 1], y[i:i + 1], z[i:i + 1], c) == (
        head + ck.DIST_TAIL_FLOPS)
    # the count is a sum over the points, and never above the full count
    total = ck.dist_flops_needed(x, y, z, c)
    assert total == sum(ck.dist_flops_needed(x[k:k + 512], y[k:k + 512],
                                             z[k:k + 512], c)
                        for k in range(0, 4096, 512))
    assert head * 4096 < total < full * 4096

"""PyTorch port: leg parameters, workspace tables and FK vs the JAX package.

Tolerances: leg parameters and every workspace table field must be
bit-equal (the port takes the JAX package's float32 trig, glibc's, through
ops/trig32.py); the message names the worst field in ulp.
Forward kinematics: rtol 1e-6 (per-point float32 trig of two libraries).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import legmov_tpu as J
from legmov_tpu.models.workspace import build_workspace as j_build_workspace
import legmov_tpu_torch as T
from legmov_tpu_torch.models.leg import leg_from_numpy
from legmov_tpu_torch.models.workspace import (
    build_workspace,
    workspace_from_numpy,
    workspace_tensors,
)

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

LEGS = {
    "moonbot": (J.get_moonbot_leg, T.get_moonbot_leg),
    "m2": (J.get_m2_leg, T.get_m2_leg),
}


def _as_numpy_dict(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _ulps(a, b):
    """Distance in float32 ulps (of the larger magnitude) between arrays."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / scale


@pytest.mark.parametrize("name", list(LEGS))
def test_leg_factory_bit_equal(name):
    j_leg, t_leg = (f(0.25) for f in LEGS[name])
    assert t_leg._fields == j_leg._fields
    for k in t_leg._fields:
        got, want = np.asarray(getattr(t_leg, k)), np.asarray(getattr(j_leg, k))
        assert got.dtype == np.float32 and got.shape == ()
        assert got.tobytes() == want.tobytes(), k


@pytest.mark.parametrize("name", list(LEGS))
def test_build_workspace_matches_jax(name):
    j_leg, t_leg = (f() for f in LEGS[name])
    want = _as_numpy_dict(j_build_workspace(j_leg))
    got = _as_numpy_dict(build_workspace(t_leg))
    assert list(got) == list(want)
    worst = ("", 0.0)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        if want[k].dtype == bool:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            u = float(_ulps(got[k], want[k]).max())
            if u > worst[1]:
                worst = (k, u)
    assert worst[1] == 0.0, f"worst field {worst[0]}: {worst[1]} ulp"
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", list(LEGS))
def test_from_numpy_round_trip(name):
    j_leg, t_leg = (f() for f in LEGS[name])
    carried = leg_from_numpy(_as_numpy_dict(j_leg))
    assert carried == t_leg
    j_ws = _as_numpy_dict(j_build_workspace(j_leg))
    ws = workspace_from_numpy(j_ws)
    for k, v in ws._asdict().items():
        assert isinstance(v, np.ndarray)
        assert v.dtype == (bool if j_ws[k].dtype == bool else np.float32), k
        assert v.tobytes() == j_ws[k].tobytes(), k
    # and on to tensors, unchanged
    wt = workspace_tensors(ws, "cpu")
    for k, v in wt._asdict().items():
        assert isinstance(v, torch.Tensor)
        np.testing.assert_array_equal(v.numpy(), j_ws[k], err_msg=k)
    assert workspace_tensors(wt, "cpu") is wt


def test_forward_kinematics_matches_jax():
    rng = np.random.default_rng(5)
    ang = rng.uniform(-2.0, 2.0, (4096, 3)).astype(np.float32)
    want = np.asarray(J.forward_kinematics(jnp.asarray(ang), J.get_moonbot_leg()))
    got = T.forward_kinematics(torch.from_numpy(ang), T.get_moonbot_leg())
    assert got.dtype == torch.float32 and got.shape == (4096, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    # a numpy input works too and batches keep their leading axes
    got2 = T.forward_kinematics(ang.reshape(64, 64, 3), T.get_moonbot_leg())
    np.testing.assert_array_equal(got2.reshape(-1, 3).numpy(), got.numpy())

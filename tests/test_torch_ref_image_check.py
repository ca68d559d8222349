"""PyTorch port: ``python -m legmov_tpu_torch.ref_image_check`` on the CPU.

The landmarks of the two slices equal the committed records
(``bdata/refcheck/landmarks.json`` at the M2 leg's tibia of 135 mm,
``bdata/refcheck_hist/landmarks.json`` at ``--tibia 160``); the reach bits
equal the JAX package's ``reachability`` bit for bit; the distances meet
the JAX ``distance`` within tests/test_distance.py:32-38's contract; the
landmark function equals the JAX tool's (``tools/ref_image_check.py``,
loaded by path).
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legmov_tpu as J
from legmov_tpu_torch import ref_image_check as ric
from legmov_tpu_torch.models.leg import get_m2_leg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = {135.0: "bdata/refcheck/landmarks.json",
           160.0: "bdata/refcheck_hist/landmarks.json"}


def _tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _legs(tibia):
    t, j = get_m2_leg(), J.get_m2_leg()
    if tibia != 135.0:
        t = t._replace(tibia_length=np.float32(tibia))
        j = j._replace(tibia_length=jnp.float32(tibia))
    return t, j


@pytest.fixture(scope="module")
def checked():
    return {tibia: ric.check(_legs(tibia)[0], "cpu") for tibia in RECORDS}


@pytest.mark.parametrize("tibia", list(RECORDS))
def test_landmarks_equal_the_committed_records(tibia, tmp_path, monkeypatch,
                                               capsys):
    # the images have a test of their own
    monkeypatch.setattr(ric, "write_images", lambda arrays, out: False)
    argv = ["--device", "cpu", "--out", str(tmp_path)]
    if tibia != 135.0:
        argv += ["--tibia", f"{tibia:g}"]
    ric.main(argv)
    with open(tmp_path / "landmarks.json") as f:
        got = json.load(f)
    with open(os.path.join(REPO, RECORDS[tibia])) as f:
        want = json.load(f)
    assert got["tibia_length"] == tibia
    assert want.get("tibia_length", tibia) == tibia
    assert got["side"] == want["side"] and got["top"] == want["top"]
    assert "images not written: no matplotlib" in capsys.readouterr().out


def test_slices_are_the_tools(checked):
    arrays = checked[135.0][1]
    assert arrays["side"][0].shape == (11421, 3)
    assert arrays["top"][0].shape == (22701, 3)
    assert np.all(arrays["side"][0][:, 1] == 0)
    assert np.all(arrays["top"][0][:, 2] == np.float32(ric.Z_CUT))


@pytest.mark.parametrize("tibia", list(RECORDS))
def test_reach_bits_equal_jax(tibia, checked):
    _, j_leg = _legs(tibia)
    for pts, reach, _ in checked[tibia][1].values():
        want = np.asarray(J.reachability(jnp.asarray(pts), j_leg))
        assert reach.dtype == bool
        np.testing.assert_array_equal(reach, want)


@pytest.mark.parametrize("tibia", list(RECORDS))
def test_distances_meet_the_contract(tibia, checked):
    _, j_leg = _legs(tibia)
    for pts, _, vec in checked[tibia][1].values():
        _, want = J.distance(jnp.asarray(pts), j_leg)
        want = np.asarray(want)
        np.testing.assert_allclose(np.linalg.norm(vec, axis=1),
                                   np.linalg.norm(want, axis=1),
                                   rtol=5e-4, atol=2e-2)
        comp_ok = np.all(np.abs(vec - want) <= 2e-2 + 2e-4 * np.abs(want),
                         axis=-1)
        assert comp_ok.mean() > 0.995, f"{(~comp_ok).sum()} vector mismatches"


def test_landmarks_equal_the_tools_on_a_random_mask():
    tool = _tool("ref_image_check")
    rng = np.random.default_rng(13)
    pts = rng.uniform(-400, 600, (5000, 3)).astype(np.float32)
    for p in (0.3, 0.0):
        mask = rng.random(5000) < p
        assert ric.landmarks(pts, mask) == tool.landmarks(pts, mask)


def test_default_output_is_under_build(tmp_path, monkeypatch):
    monkeypatch.setattr(ric, "write_images", lambda arrays, out: False)
    monkeypatch.chdir(tmp_path)
    ric.main(["--device", "cpu"])
    assert os.listdir(tmp_path) == ["build"]
    assert os.listdir(tmp_path / "build" / "refcheck") == ["landmarks.json"]


def test_the_four_images_are_written(checked, tmp_path):
    pytest.importorskip("matplotlib")
    assert ric.write_images(checked[135.0][1], str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "distance_side.png", "distance_top.png", "reachability_side.png",
        "reachability_top.png"]

"""The terrain generator gives the same terrain for the same seed, another
for another, and the flagship terrain of the port bit for bit."""

import numpy as np
import torch

from bench_port.gen.moon import moon_ground

ARGS = ((128, 128), (-2000.0, 2000.0), (-6000.0, 2000.0), 50, 42)


def test_terrain_is_the_ports_flagship_without_a_detail_seed():
    from legmov_tpu_torch.terrain import moon_ground as port

    ours = moon_ground(*ARGS, None, 1000.0, "cpu").numpy()
    theirs = port(shape=(128, 128), seed=42)
    np.testing.assert_array_equal(ours, theirs)


def test_terrain_depends_on_the_detail_seed_only_in_its_fine_relief():
    a = moon_ground(*ARGS, 2 ** 40 + 3, 1000.0, "cpu")
    b = moon_ground(*ARGS, 2 ** 40 + 3, 1000.0, "cpu")
    c = moon_ground(*ARGS, 2 ** 40 + 4, 1000.0, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(a[:, :2], c[:, :2])
    # the fine relief is +-30 mm at most (three octaves, persistence 0.2)
    assert float((a[:, 2] - c[:, 2]).abs().max()) < 2 * 30.0 * 1.25 * 1.5

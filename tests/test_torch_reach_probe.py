"""PyTorch port: the reach probe (``python -m legmov_tpu_torch.reach_probe``)
and its io-only floor kernel (K7), against ``tools/reach_kernel_probe.py``.

On the CPU the io-only kernel's plain version is held against the tool's
Pallas kernel in interpret mode, bit for bit; the CUDA kernel itself is held
against the same plain version on the card by ``chip_smoke.py``.  The
wrapper and the probe refuse CPU tensors: K7 has no path of its own.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from legmov_tpu_torch import reach_probe
from legmov_tpu_torch.ops import cuda_kernels as ck

# many small eager operations: more threads only contend with the other
# test workers of a parallel run
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    """``tools/reach_kernel_probe.py``, loaded by path."""
    path = os.path.join(REPO, "tools", "reach_kernel_probe.py")
    spec = importlib.util.spec_from_file_location("reach_kernel_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _points(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-700, 700, (n, 3)).astype(np.float32)
    # sums that land on 0 and on either side of it, and NaN/inf rows
    p[:50, 2] = -(p[:50, 0] + p[:50, 1])
    p[50:60] = np.nan
    p[60:70, 0] = np.inf
    p[70:80, 1] = -np.inf
    p[80:90] = [np.inf, -np.inf, 1.0]
    p[90:100, 2] = np.nan
    p[100:110] = [-0.0, 0.0, -0.0]
    return p


def test_io_only_plain_equals_the_tool_kernel():
    """5,000 seeded points (not a multiple of the tool's 256 x 128 tile)
    with NaN and inf rows: the plain version's bits equal the tool's
    ``make_io_only(interpret=True).soa``."""
    p = _points(5000, 81)
    comps = [np.ascontiguousarray(p[:, i]) for i in range(3)]
    want = np.asarray(_tool().make_io_only(interpret=True).soa(*comps))
    got = ck.io_only_plain(*(torch.from_numpy(c) for c in comps))
    assert got.dtype == torch.bool and got.shape == (5000,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.8 and not want[50:60].any()


def test_io_only_kernel_and_probe_refuse_cpu_tensors():
    x = torch.zeros(16)
    before = ck.io_only_kernel.launches
    with pytest.raises(ValueError, match="card"):
        ck.io_only_kernel(x, x, x)
    with pytest.raises(ValueError, match="card"):
        reach_probe.probe(1024, 1, device="cpu")
    with pytest.raises(TypeError):
        ck.io_only_kernel(x.double(), x, x)
    assert ck.io_only_kernel.launches == before


def test_probe_grid_is_the_benchmark_grid():
    """``make_grid`` gives bench.py's points: the same count and envelope;
    values equal where XLA does not fuse the linspace's multiply-add, one
    float32 rounding apart where it does."""
    import bench

    for n in (1000, 1 << 16):
        got = reach_probe.make_grid(n)
        want = np.asarray(bench.make_grid(n))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert (got == want).mean() > 0.5
    g = reach_probe.make_grid(1 << 18)
    assert g.shape == (1 << 18, 3)
    assert g.min(axis=0).tolist() == [-100.0, -400.0, -350.0]
    assert g.max(axis=0).tolist() == [601.0, 401.0, 51.0]

"""PyTorch port: the two-process dry run of the multi-host layer
(``python -m legmov_tpu_torch.multihost_dryrun --device cpu``), small mode:
64 poses and 256 footholds, each worker holding its own pose shard and the
foothold OR crossing the process boundary, every result equal to the
single-process ``positionable``.  The JAX package's counterpart
(tests/test_multihost.py) is marked slow for JAX's start-up cost; the port's
workers start in seconds."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_positionable_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "legmov_tpu_torch.multihost_dryrun",
         "--device", "cpu", "--timeout", "100"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIHOST OK" in out.stdout
    for proc in (0, 1):
        assert (f"proc {proc}: rows {32 * proc}..{32 * proc + 32} of 64"
                in out.stdout), out.stdout
    assert "backend gloo" in out.stdout

"""PyTorch port: legmov_tpu_torch/profiling.py against legmov_tpu/profiling.py.

``StageTimer`` writes the JAX timer's lines (times masked), and ``trace``
writes a Chrome trace on the CPU."""

import json
import os
import re

import torch

from legmov_tpu import profiling as jprof
from legmov_tpu_torch import profiling as tprof

torch.set_num_threads(1)

STAGES = ("build grid", "solve", "fetch flags")


def _lines(path):
    with open(path) as f:
        return [re.sub(r"\d+\.\d{3} ms$", "<t> ms", line.rstrip("\n"))
                for line in f]


def test_stage_timer_writes_the_jax_timers_lines(tmp_path, capsys):
    for name, mod in (("jax.txt", jprof), ("torch.txt", tprof)):
        path = str(tmp_path / name)
        timer = mod.StageTimer(path=path, echo=True)
        for stage in STAGES:
            with timer.stage(stage, sync=torch.zeros(3) if mod is tprof
                             else None):
                sum(range(1000))
        # appended, as the reference's timing_results.txt
        with timer.stage(STAGES[0]):
            pass
        assert [n for n, _ in timer.records] == [*STAGES, STAGES[0]]
        assert all(dt >= 0 for _, dt in timer.records)
    want = _lines(tmp_path / "jax.txt")
    assert want == [f"{s}: <t> ms" for s in (*STAGES, STAGES[0])]
    assert _lines(tmp_path / "torch.txt") == want
    echoed = capsys.readouterr().out.splitlines()
    assert len(echoed) == 2 * len(want)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as prof:
        x = torch.arange(1000, dtype=torch.float32)
        (x * x).sum()
    path = tmp_path / "trace" / "trace.json"
    assert path.exists()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mul" for e in prof.key_averages())


def test_launch_counters_name_every_kernel():
    counts = tprof.launch_counts()
    assert set(counts) == set(tprof.COUNTERS)
    assert set(tprof.LAUNCHERS) == set(tprof.COUNTERS) - {"io_only"}
    assert all(isinstance(n, int) and n >= 0 for n in counts.values())

"""PyTorch port: the solve's program spans and phase clocks, its work
counters, and the benchmark's readers of them.

A small CSR solve (the ``ring_footholds`` / ``ROT`` set-up of
test_torch_hier_solver.py: two identity levels on the dense path, one
orientation-active level on the CSR path) runs on the CPU under
``torch.profiler`` and without it.  The readers of ``bench_port/metrics``
run on hand-built traces.
"""

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port import trace as tr
from bench_port.counts import k6
from legmov_tpu_torch import spans
from legmov_tpu_torch.config import SolverConfig as TConfig
from legmov_tpu_torch.models import hier_solver as ths
from legmov_tpu_torch.models import robot as trobot
from legmov_tpu_torch.ops import csr_cell_eval as cce
from test_torch_hier_solver import ROT, _rows, ring_footholds

torch.set_num_threads(1)

#: the spans of a solve whose identity levels take the dense path and whose
#: deepest level takes the CSR path
SPANS = {"solve", "solve.prepare", "level", "level.split", "level.tables",
         "level.upload", "level.fetch", "level.unpack", "batch.queue_max",
         "batch.upload", "batch.queue", "batch.launch", "batch.subset"}


def _solve(shared=True, **kw):
    stats: dict = {}
    rec = ths.solve_positionability(
        ring_footholds(), trobot.get_moonbot_robot(), TConfig(**ROT),
        chunk=32, cell_batch=64, shared_foothold=shared, device="cpu",
        csr_window=128, stats=stats, **kw)
    return rec, stats


@pytest.mark.parametrize("shared", [True, False])
def test_a_traced_solve_opens_every_span_inside_the_solve(shared):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced, _ = _solve(shared)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(spans.PREFIX)]
    names = {e.name()[len(spans.PREFIX):] for e in events}
    assert names == SPANS
    # host-only ranges: no user annotation, so none mirrored onto a device
    assert not any(e.is_user_annotation() for e in events)
    solve = [e for e in events if e.name() == "legmov.solve"]
    assert len(solve) == 1
    lo = solve[0].start_ns()
    hi = lo + solve[0].duration_ns()
    assert all(lo <= e.start_ns() and e.start_ns() + e.duration_ns() <= hi
               for e in events)
    # one level span a level, each inside the solve
    assert sum(e.name() == "legmov.level" for e in events) == 3
    untraced, _ = _solve(shared)
    assert _rows(traced) == _rows(untraced)


def test_without_a_profiler_no_range_is_opened(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name} was opened")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    seconds: dict = {}
    with spans.phase("a", seconds) as p:
        sum(range(1000))
    with spans.phase("a", seconds):
        pass
    assert seconds["a"] >= p.seconds > 0.0
    rec, stats = _solve()
    assert rec.valid.any() and stats["host_s"]["solve"] > 0.0


@pytest.mark.parametrize("shared", [True, False])
def test_levels_carry_host_seconds_and_work_counters(shared):
    _, stats = _solve(shared)
    assert stats["host_syncs"] == stats["levels"] == 3
    host = stats["host_s"]
    assert host["solve"] >= host["solve.prepare"] > 0.0
    levels = stats["per_level"]
    assert host["solve"] >= sum(lv["host_s"]["level"] for lv in levels)
    for lv in levels:
        s = lv["host_s"]
        inner = sum(v for k, v in s.items() if k != "level")
        assert s["level"] >= inner > 0.0
        assert {"level.split", "level.fetch", "level.unpack",
                "batch.launch"} <= set(s)
        assert ("audit" in lv) == (lv["kind"] == "csr")
    deepest = levels[-1]
    assert deepest["kind"] == "csr"
    assert {"level.tables", "level.upload", "batch.queue_max",
            "batch.upload", "batch.queue"} <= set(deepest["host_s"])
    audit = deepest["audit"]
    assert tuple(audit) == cce.AUDIT_COUNTERS
    assert 0 < audit["leg_elems_in_box"] <= audit["leg_elems"]
    assert audit["leg_evals"] <= audit["leg_elems"]
    assert audit["chunks_evaluated"] <= audit["chunk_quat_evals"]


def _ev(name, start, end):
    return tr.Event(name, start, end)


def _view(device, host, traced=(0,), per_request=(), counts=None):
    window = (0, 1000)
    trace = tr.TraceData(device, device, host,
                         [_ev("bench.request", *window)], window)
    return harness.RunView("solve", 1.0, (0.0, 1.0), [], list(per_request),
                           list(traced), trace, counts or {})


def _read(name, view):
    return harness.reader(name)(view)


def test_an_idle_gap_is_cut_by_the_innermost_program_span():
    """Device busy 0-100 and 700-1000; the gap 100-700 runs through a
    level's fetch (50-300) and the next level's split (300-500), the rest
    in the level spans (ns)."""
    device = [_ev("kernel", 0, 100), _ev("kernel", 700, 1000)]
    host = [_ev("legmov.solve", 10, 990),
            _ev("legmov.level", 20, 300), _ev("legmov.level.fetch", 50, 300),
            _ev("cudaMemcpyAsync", 60, 290),
            _ev("legmov.level", 300, 980), _ev("legmov.level.split", 300, 500)]
    view = _view(device, host, traced=(0, 1))
    # per traced solve: fetch 100-300, the rest 300-700
    assert _read("fetch_idle_s.shared", view) == pytest.approx(100e-9)
    assert _read("host_idle_s.shared", view) == pytest.approx(200e-9)
    from bench_port import spans as bspans

    assert bspans.idle_by_span(view.trace) == {
        "legmov.level.fetch": 200, "legmov.level.split": 200,
        "legmov.level": 200}
    # a program with no spans (an older one) gives the readers nothing
    old = _view(device, host[3:4])
    assert _read("fetch_idle_s.per_leg", old) is None
    assert _read("host_idle_s.per_leg", old) is None


def test_k6_leg_work_and_deepest_host_s_read_the_records():
    def request(index, ran, split):
        deepest = dict(host_s={"level.split": split, "level.tables": 0.5,
                               "batch.queue_max": 0.25,
                               "level.unpack": 0.25, "batch.queue": 9.0},
                       audit={"leg_elems_in_box": ran, "leg_elems": 10 * ran})
        return dict(index=index, stats=dict(per_level=[{}, deepest]))

    need = 1000.0
    counts = {"deepest_level": (need * k6.LEG_PIPELINE_OPS, 1.0)}
    reqs = [request(0, 3000, 1.0), request(1, 5000, 1.0),
            request(2, 7, 2.0), request(3, 7, 4.0)]
    view = _view([], [], traced=(0, 1), per_request=reqs, counts=counts)
    # the traced solves' mean over what the inputs need
    assert _read("k6_leg_work.shared", view) == pytest.approx(4.0)
    # the untraced solves' steps that launch nothing
    assert _read("deepest_host_s.per_leg", view) == pytest.approx(4.0)
    # records without the counters or the clocks (an older program)
    bare = [dict(index=i, stats=dict(per_level=[{}])) for i in range(3)]
    old = _view([], [], traced=(0,), per_request=bare, counts=counts)
    assert _read("k6_leg_work.shared", old) is None
    assert _read("deepest_host_s.shared", old) is None

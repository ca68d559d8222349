"""The program's own spans in a trace: the device's idle time cut by the
host step the program was in.

The port opens a profiler range named ``legmov.<step>`` around each host
step of its solve (``legmov_tpu_torch/spans.py``): ``legmov.solve`` around
the call, and inside it the levels, their phases and their batches.  The
profiler keeps these ranges on the host, so ``trace.read_profile`` files
them among the host events, on the device's clock.  Each part of an idle
gap of the device belongs to the innermost program span that covers it.
A program that opens no such span leaves every reader here with nothing to
read.
"""

from __future__ import annotations

from bench_port.trace import busy_and_gaps

PREFIX = "legmov."
#: the span around one whole solve
SOLVE = PREFIX + "solve"
#: the span around a level's packing and its one read of the device
FETCH = PREFIX + "level.fetch"


def program_spans(trace) -> list:
    """The program's spans among the trace's host events."""
    return [e for e in trace.host if e.name.startswith(PREFIX)]


def _innermost_segments(spans) -> list:
    """``[(start, end, name)]``: the time the spans cover, cut where any of
    them starts or ends, each piece named after the innermost span over it
    (the latest to start, of two that start together the first to end: the
    spans of one thread nest)."""
    cuts = sorted({t for s in spans for t in (s.start, s.end)})
    by_start = sorted(spans, key=lambda s: s.start)
    out, open_, j = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(by_start) and by_start[j].start <= a:
            open_.append(by_start[j])
            j += 1
        open_ = [s for s in open_ if s.end > a]
        if open_:
            inner = max(open_, key=lambda s: (s.start, -s.end))
            out.append((a, b, inner.name))
    return out


def idle_by_span(trace) -> dict:
    """span name -> device idle ns inside the traced window that the span
    is the innermost program span of."""
    _, gaps = busy_and_gaps(trace.device, trace.window)
    tot: dict = {}
    segs = _innermost_segments(program_spans(trace))
    for s, e, name in _overlap_named(gaps, segs):
        tot[name] = tot.get(name, 0) + (e - s)
    return tot


def _overlap_named(gaps, segs) -> list:
    """``[(start, end, name)]`` where a gap meets a named segment."""
    gaps, segs = sorted(gaps), sorted(segs, key=lambda x: x[0])
    out, i, j = [], 0, 0
    while i < len(gaps) and j < len(segs):
        s = max(gaps[i][0], segs[j][0])
        e = min(gaps[i][1], segs[j][1])
        if e > s:
            out.append((s, e, segs[j][2]))
        if gaps[i][1] <= segs[j][1]:
            i += 1
        else:
            j += 1
    return out


def solve_idle(view):
    """``(idle ns inside level fetches, idle ns elsewhere inside the solve
    spans)`` over the traced requests, or ``None`` where the trace holds
    no solve span."""
    t = view.trace
    if t is None or view.kind != "solve" or not view.traced:
        return None
    by_span = idle_by_span(t)
    if not any(s.name == SOLVE for s in program_spans(t)):
        return None
    fetch = by_span.get(FETCH, 0)
    return fetch, sum(by_span.values()) - fetch

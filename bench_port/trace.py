"""Reading a ``torch.profiler`` trace of the traced requests.

The profiler records the device's kernels, copies and fills (CUPTI) and
the host's operations, runtime calls and the benchmark's own spans
(``torch.profiler.record_function`` named ``bench.<span>``), all on one
clock.  This module turns them into the traced window, the device's busy
time inside it, kernel time by name, and the device's idle gaps labelled
by what the host was doing.
"""

from __future__ import annotations

import heapq
import importlib
from typing import NamedTuple

SPAN_PREFIX = "bench."
#: the benchmark's span around one request
REQUEST_SPAN = SPAN_PREFIX + "request"


class Event(NamedTuple):
    name: str
    start: int  # ns
    end: int  # ns


class TraceData(NamedTuple):
    device: list  # [Event] kernels, copies and fills on the device
    kernels: list  # [Event] the kernels alone
    host: list  # [Event] host operations and runtime calls
    spans: list  # [Event] the benchmark's spans
    window: tuple  # (start, end) ns: the traced requests

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def read_profile(prof) -> TraceData:
    """The events of a finished ``torch.profiler.profile``."""
    device, kernels, host, spans = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), int(e.start_ns()),
                   int(e.start_ns()) + int(e.duration_ns()))
        if ev.name.startswith(SPAN_PREFIX):
            # a span is also mirrored onto the device's timeline
            if not str(e.device_type()).endswith("CUDA"):
                spans.append(ev)
        elif str(e.device_type()).endswith("CUDA"):
            device.append(ev)
            low = ev.name.lower()
            if not (low.startswith("memcpy") or low.startswith("memset")):
                kernels.append(ev)
        else:
            host.append(ev)
    req = [s for s in spans if s.name == REQUEST_SPAN]
    window = ((min(s.start for s in req), max(s.end for s in req))
              if req else (0, 0))
    return TraceData(device, kernels, host, spans, window)


def busy_and_gaps(events, window):
    """``(busy ns, [(gap start, gap end)])``: the union of the events'
    intervals inside ``window``, and the idle intervals between them."""
    lo, hi = window
    busy, gaps, cursor = 0, [], lo
    for s, e in sorted((max(ev.start, lo), min(ev.end, hi)) for ev in events
                       if ev.end > lo and ev.start < hi):
        if s > cursor:
            gaps.append((cursor, s))
            cursor = s
        if e > cursor:
            busy += e - cursor
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    return busy, gaps


def kernel_seconds(kernels, pattern: str) -> float:
    """Device seconds of the kernels whose name contains ``pattern``."""
    return sum(k.end - k.start for k in kernels if pattern in k.name) * 1e-9


def top_device_ops(events, n: int = 10, width: int = 96) -> list:
    """``[[name, seconds]]`` of the ``n`` device operations (summed by
    name) that took the most time."""
    tot: dict = {}
    for ev in events:
        tot[ev.name] = tot.get(ev.name, 0) + (ev.end - ev.start)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], ns * 1e-9] for name, ns in top]


def _open_at(events, times):
    """For each of the ascending ``times``, the innermost event (latest
    start) open at that time, or ``None``."""
    evs = sorted(events, key=lambda e: e.start)
    heap, j, out = [], 0, []
    for t in times:
        while j < len(evs) and evs[j].start <= t:
            heapq.heappush(heap, (-evs[j].start, evs[j].end, evs[j].name))
            j += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def idle_gaps(trace: TraceData, gaps, n: int = 10, width: int = 96) -> list:
    """``[[label, seconds]]``: the device's idle time inside the window,
    summed by what the host was doing when each gap began (the innermost
    benchmark span, and the innermost host operation or runtime call), the
    ``n`` largest."""
    starts = [g[0] for g in gaps]
    span = _open_at(trace.spans, starts)
    op = _open_at(trace.host, starts)
    tot: dict = {}
    for (s, e), sp, o in zip(gaps, span, op):
        where = sp[len(SPAN_PREFIX):] if sp else "none"
        label = f"{where}/{o or 'none'}"[:width]
        tot[label] = tot.get(label, 0) + (e - s)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[label, ns * 1e-9] for label, ns in top]


def launch_counts(counters: dict) -> dict:
    """The program's launch counters: kernel name -> launches so far, for
    ``counters`` mapping a kernel name to ``(module, wrapper)``."""
    return {name: getattr(importlib.import_module(mod), attr).launches
            for name, (mod, attr) in counters.items()}
